"""Dirichlet-Multinomial genotype likelihoods, GQ, and CMLOD.

Reference: src/lancet/caller/genotype_likelihood.{h,cpp}. Constants:
epsilon=0.005 background error, rho=0.01 overdispersion -> precision M=99,
alpha floor 1e-6. PLs in VCF-standard unphased ordering (0/0, 0/1, 1/1,
0/2, 1/2, 2/2, ...), best genotype PL=0, GQ = second-min PL capped at 99.

CMLOD: per-ALT continuous-mixture log10 odds comparing MLE allele fractions
vs a null with the target ALT's mass redistributed; per-read base-qual
weighting via P(called s | f) = sum_t f_t P(s|t), P(s|t) = 1-eps if s==t
else eps/(K-1).

Implemented in numpy (these are O(K^2 + N*K) per variant — negligible);
lancet2_tpu_torch.ops.genotype holds the batched torch twin for the device.
"""

from __future__ import annotations

import math

import numpy as np

from lancet2_tpu_torch.base.phred import PHRED_TO_ERROR_PROB

DM_BACKGROUND_ERROR = 0.005
DM_OVERDISPERSION = 0.01
DM_ALPHA_FLOOR = 1e-6
MAX_GQ = 99
_PL_CAP = float(np.iinfo(np.uint32).max) / 2.0


def genotype_alphas(num_alleles: int) -> np.ndarray:
    """[G, K] Dirichlet concentration vectors for all diploid genotypes."""
    precision = (1.0 - DM_OVERDISPERSION) / DM_OVERDISPERSION
    num_genotypes = num_alleles * (num_alleles + 1) // 2
    alphas = np.empty((num_genotypes, num_alleles), dtype=np.float64)
    gidx = 0
    for b in range(num_alleles):
        for a in range(b + 1):
            mu = np.full(num_alleles, DM_BACKGROUND_ERROR / num_alleles)
            main = 1.0 - DM_BACKGROUND_ERROR
            if a == b:
                mu[a] += main
            else:
                mu[a] += main / 2.0
                mu[b] += main / 2.0
            alphas[gidx] = np.maximum(DM_ALPHA_FLOOR, mu * precision)
            gidx += 1
    return alphas


def log_dirichlet_multinomial(counts: np.ndarray, alphas: np.ndarray) -> float:
    counts = np.asarray(counts, dtype=np.float64)
    lp = float(np.sum(_lgamma(counts + alphas) - _lgamma(alphas)))
    alpha_sum = float(alphas.sum())
    count_alpha_sum = float((counts + alphas).sum())
    return lp + math.lgamma(alpha_sum) - math.lgamma(count_alpha_sum)


_lgamma = np.vectorize(math.lgamma)


def compute_genotype_pls(allele_counts) -> np.ndarray:
    """Phred-scaled genotype likelihoods; best genotype PL = 0."""
    counts = np.asarray(allele_counts, dtype=np.int64)
    k = counts.size
    if k == 0:
        return np.zeros(0, dtype=np.uint32)
    alphas = genotype_alphas(k)
    lls = np.array([log_dirichlet_multinomial(counts, a) for a in alphas])
    best = lls.max()
    raw = -10.0 * (lls - best) / math.log(10.0)
    return np.round(np.minimum(raw, _PL_CAP)).astype(np.uint32)


def compute_genotype_quality(pls: np.ndarray) -> int:
    """GQ = second-min PL - min PL, capped at 99."""
    if pls.size < 2:
        return 0
    part = np.partition(pls, 1)
    return int(min(int(part[1]) - int(part[0]), MAX_GQ))


def genotype_from_pl_index(best_idx: int) -> tuple[int, int]:
    """Invert VCF GL index -> (a, b) with a <= b (htslib bcf_gt2alleles walk)."""
    klen = 0
    dk = 1
    while klen < best_idx:
        dk += 1
        klen += dk
    b = dk - 1
    a = best_idx - klen + b
    return int(a), int(b)


# ---------------------------------------------------------------------------
# CMLOD
# ---------------------------------------------------------------------------


def _pileup_log_likelihood(allele_quals: list[np.ndarray], fracs: np.ndarray) -> float:
    """Sum of per-read log10 mixture probabilities over all alleles."""
    k = len(allele_quals)
    total = 0.0
    for called_as, quals in enumerate(allele_quals):
        if quals.size == 0:
            continue
        eps = PHRED_TO_ERROR_PROB[np.clip(quals, 0, 255)]
        mismatch = eps / max(1, k - 1)
        match_bonus = (1.0 - eps) - mismatch
        prob = mismatch + fracs[called_as] * match_bonus
        total += float(np.sum(np.log10(np.maximum(1e-15, prob))))
    return total


def compute_continuous_mixture_lods(
    allele_quals: list[np.ndarray],  # per-allele concatenated fwd+rev BQs
    allele_coverages: list[int],
) -> np.ndarray:
    k = len(allele_quals)
    lods = np.zeros(k, dtype=np.float64)
    if k < 2:
        return lods
    total_depth = int(sum(allele_coverages))
    if total_depth == 0:
        return lods
    frac_mle = np.asarray(allele_coverages, dtype=np.float64) / total_depth
    ll_mle = _pileup_log_likelihood(allele_quals, frac_mle)
    for target in range(1, k):
        if allele_coverages[target] == 0:
            continue
        frac_null = frac_mle.copy()
        null_mass = frac_null[target]
        frac_null[target] = 0.0
        remaining = 1.0 - null_mass
        if remaining <= 0.0:
            frac_null[:] = 0.0
            frac_null[0] = 1.0
        else:
            frac_null /= remaining
        ll_null = _pileup_log_likelihood(allele_quals, frac_null)
        lods[target] = max(0.0, ll_mle - ll_null)
    return lods


def compute_raw_posterior_base_qual(fwd_quals: np.ndarray, rev_quals: np.ndarray) -> float:
    """Edgar & Flyvbjerg Bayesian read-error aggregation -> raw PBQ
    (reference: caller/posterior_base_qual.cpp)."""
    quals = np.concatenate([np.asarray(fwd_quals), np.asarray(rev_quals)])
    if quals.size == 0:
        return 0.0
    eps = PHRED_TO_ERROR_PROB[np.clip(quals.astype(np.int64), 0, 255)]
    log_err = float(np.sum(np.log10(np.maximum(eps, 1e-300))))
    log_ok = float(np.sum(np.log10(np.maximum(1.0 - eps, 1e-300))))
    max_log = max(log_err, log_ok)
    log_sum = max_log + math.log10(1.0 + 10.0 ** (min(log_err, log_ok) - max_log))
    return -10.0 * (log_err - log_sum)
