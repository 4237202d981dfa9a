"""11-feature coverage-invariant sequence-complexity vector + LongdustQ.

Reference: src/lancet/base/sequence_complexity.{h,cpp} and
src/lancet/base/longdust_scorer.h (lh3/longdust, arXiv:2509.07357, with
GC-bias-corrected Poisson null model).

Feature groups (SEQ_CX INFO tag order):
  Context(4): HRun/Entropy at REF +-20bp, LongdustQ k=4 at +-50bp (log1p),
              LongdustQ k=7 on full REF haplotype (log1p)
  Delta(3):   ALT-REF HRun (+-5bp), entropy (+-10bp), flank LQ (+-50bp)
  TR(4):      affinity 1/(1+dist), purity, period, is-stutter-indel
All computed from assembled haplotype strings — perfectly coverage-invariant.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from lancet2_tpu_torch.base.dna import ENCODE_TABLE, revcomp_str


def format_complexity_score(val: float) -> str:
    """%.3f with trailing zeros (and bare '.') stripped."""
    txt = f"{val:.3f}"
    if "." in txt:
        txt = txt.rstrip("0").rstrip(".")
    if txt in ("-0", ""):
        txt = "0"
    return txt


# ---------------------------------------------------------------------------
# LongdustQ scorer
# ---------------------------------------------------------------------------


def _f_single(lam: float) -> float:
    """E[log(N!)] for N ~ Poisson(lam); exact series < 30, Stirling above."""
    if lam < 1e-10:
        return 0.0
    if lam >= 30.0:
        inv = 1.0 / lam
        stirling = 0.5 * math.log(2.0 * math.pi * math.e * lam) - inv / 12.0 * (
            1.0 + 0.5 * inv + 19.0 / 30.0 * inv * inv
        )
        return stirling + lam * (math.log(lam) - 1.0)
    accum = 0.0
    sum_n = 0.0
    scaled = lam
    for count in range(2, 10_001):
        sum_n += math.log(count)
        scaled *= lam / count
        z = scaled * sum_n
        if z < accum * 1e-9:
            break
        accum += z
    return accum * math.exp(-lam)


class LongdustQScorer:
    """k-mer concentration complexity q(x) = max(0, (sum log(c!) - f(l)) / l)."""

    def __init__(self, kmer_len: int = 7, max_len: int = 1024, gc_frac: float = 0.41):
        self.k = kmer_len
        self.gc = min(max(gc_frac, 0.0), 1.0)
        self.num_kmers = 1 << (2 * kmer_len)
        self.mask = self.num_kmers - 1
        self._f = np.zeros(max_len + 1)
        for ell in range(1, max_len + 1):
            self._f[ell] = self._compute_f(ell)

    def _compute_f(self, ell: int) -> float:
        k = self.k
        if abs(self.gc - 0.5) < 1e-6:
            return self.num_kmers * _f_single(ell / self.num_kmers)
        gc = min(max(self.gc, 1e-6), 1.0 - 1e-6)
        p_gc, p_at = gc / 2.0, (1.0 - gc) / 2.0
        two_pow_k = float(1 << k)
        total = 0.0
        for c in range(k + 1):
            comb = 1.0
            for j in range(1, c + 1):
                comb *= (k - j + 1) / j
            num = comb * two_pow_k
            prob = (p_gc**c) * (p_at ** (k - c))
            total += num * _f_single(ell * prob)
        return total

    def _finish(self, ell: int, multi: np.ndarray) -> float:
        if ell == 0:
            return 0.0
        multi = multi.astype(np.float64)
        if multi.size:
            # same values/op order as np.vectorize(math.lgamma)(multi + 1.0)
            # without the per-call vectorize setup cost
            vals = np.fromiter(
                (math.lgamma(m + 1.0) for m in multi), np.float64,
                count=multi.size,
            )
            sum_log_fact = float(np.sum(vals))
        else:
            sum_log_fact = 0.0
        f_val = self._f[ell] if ell < len(self._f) else self._compute_f(ell)
        return max(0.0, (sum_log_fact - f_val) / ell)

    def _score_one_strand(self, seq: str, rc: bool = False) -> float:
        k = self.k
        if len(seq) < k:
            return 0.0
        from lancet2_tpu_torch.base import native_core

        nat = native_core.longdust_counts(seq, k, rc=rc)
        if nat is not None:
            return self._finish(nat[0], nat[1])
        if rc:
            seq = revcomp_str(seq)
        codes = ENCODE_TABLE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
        # rolling 2-bit k-mer codes; N resets the window
        kmer_codes = []
        kmer = 0
        run = 0
        for base in codes:
            if base < 4:
                kmer = ((kmer << 2) | int(base)) & self.mask
                run += 1
                if run >= k:
                    kmer_codes.append(kmer)
            else:
                run = 0
        ell = len(kmer_codes)
        if ell == 0:
            return 0.0
        _, counts = np.unique(np.asarray(kmer_codes, dtype=np.int64), return_counts=True)
        return self._finish(ell, counts[counts >= 2])

    def score(self, seq: str) -> float:
        return max(self._score_one_strand(seq), self._score_one_strand(seq, rc=True))


# ---------------------------------------------------------------------------
# Tandem repeat detection
# ---------------------------------------------------------------------------


@dataclass
class TandemRepeatResult:
    period: int
    copies: float
    start_pos: int
    span_length: int
    total_errors: int
    is_exact: bool

    @property
    def purity(self) -> float:
        if self.span_length <= 0:
            return 0.0
        return 1.0 - self.total_errors / self.span_length


def _is_primitive_motif(motif: str) -> bool:
    n = len(motif)
    for period in range(1, n):
        if n % period:
            continue
        if all(motif[i] == motif[i % period] for i in range(period, n)):
            return False
    return True


def find_exact_repeats(seq: str, max_period: int = 6, min_copies: float = 2.5):
    results = []
    n = len(seq)
    for period in range(1, min(max_period, n) + 1):
        start = 0
        while start <= n - period:
            motif = seq[start : start + period]
            if period > 1 and not _is_primitive_motif(motif):
                start += 1
                continue
            match_len = period
            while start + match_len + period <= n and seq[
                start + match_len : start + match_len + period
            ] == motif:
                match_len += period
            partial = 0
            while (
                start + match_len + partial < n
                and partial < period
                and seq[start + match_len + partial] == motif[partial]
            ):
                partial += 1
            copies = (match_len + partial) / period
            if copies >= min_copies:
                results.append(
                    TandemRepeatResult(period, copies, start, match_len + partial, 0, True)
                )
                start += match_len - 1
            start += 1
    return results


def find_approx_repeats(
    seq: str, max_period: int = 6, min_copies: float = 3.0, max_edits_per_unit: int = 1
):
    results = []
    n = len(seq)
    for period in range(1, min(max_period, n) + 1):
        start = 0
        while start <= n - period:
            motif = seq[start : start + period]
            if period > 1 and not _is_primitive_motif(motif):
                start += 1
                continue
            total_span = period
            total_errors = 0
            while start + total_span + period <= n:
                unit = seq[start + total_span : start + total_span + period]
                errs = sum(1 for a, b in zip(unit, motif) if a != b)
                if errs > max_edits_per_unit:
                    break
                total_errors += errs
                total_span += period
            copies = total_span / period
            purity = 1.0 - total_errors / total_span if total_span > 0 else 0.0
            if copies >= min_copies and purity >= 0.75:
                results.append(
                    TandemRepeatResult(period, copies, start, total_span, total_errors, False)
                )
                start += total_span - 1
            start += 1
    return results


def tandem_repeat_hits(window: str):
    """find_exact_repeats(window) + find_approx_repeats(window), using the
    native C++ scan (native/assembly_core.cpp::l2t_tandem_repeats, same hit
    semantics and order) when available — the Python twins are the
    correctness baseline and the fallback."""
    from lancet2_tpu_torch.base import native_core

    nat = native_core.tandem_repeats(window)
    if nat is None:
        return find_exact_repeats(window) + find_approx_repeats(window)
    return [
        TandemRepeatResult(period, span / period, start, span, errors, exact)
        for period, start, span, errors, exact in nat
    ]


def flatten_tr_features(results, variant_pos: int, variant_length: int):
    """(dist_to_nearest, period, purity, is_stutter) for TR hits near a variant."""
    dist_nearest = -1
    period = 0
    purity = 0.0
    stutter = 0
    if not results:
        return dist_nearest, period, purity, stutter
    best = None
    var_end = variant_pos + variant_length
    for tr in results:
        tr_end = tr.start_pos + tr.span_length
        if tr.start_pos <= variant_pos < tr_end:
            dist = 0
        elif variant_pos < tr.start_pos:
            dist = tr.start_pos - var_end
        else:
            dist = variant_pos - tr_end
        dist = max(0, dist)
        if best is None or dist < best:
            best = dist
            dist_nearest, period, purity = dist, tr.period, tr.purity
        if dist <= 1 and 0 < variant_length <= tr.period:
            stutter = 1
    return dist_nearest, period, purity, stutter


# ---------------------------------------------------------------------------
# 11-feature vector
# ---------------------------------------------------------------------------


@dataclass
class SequenceComplexity:
    context_hrun: int = 0
    context_entropy: float = 0.0
    context_flank_lq: float = 0.0
    context_haplotype_lq: float = 0.0
    delta_hrun: int = 0
    delta_entropy: float = 0.0
    delta_flank_lq: float = 0.0
    tr_affinity: float = 0.0
    tr_purity: float = 0.0
    tr_period: int = 0
    is_stutter_indel: int = 0

    def format_vcf_value(self) -> str:
        fs = format_complexity_score
        return ",".join(
            [
                str(self.context_hrun),
                fs(self.context_entropy),
                fs(self.context_flank_lq),
                fs(self.context_haplotype_lq),
                str(self.delta_hrun),
                fs(self.delta_entropy),
                fs(self.delta_flank_lq),
                fs(self.tr_affinity),
                fs(self.tr_purity),
                str(self.tr_period),
                str(self.is_stutter_indel),
            ]
        )

    def merge_max(self, other: "SequenceComplexity") -> None:
        self.context_hrun = max(self.context_hrun, other.context_hrun)
        self.context_entropy = max(self.context_entropy, other.context_entropy)
        self.context_flank_lq = max(self.context_flank_lq, other.context_flank_lq)
        self.context_haplotype_lq = max(self.context_haplotype_lq, other.context_haplotype_lq)
        self.delta_hrun = max(self.delta_hrun, other.delta_hrun)
        self.delta_entropy = max(self.delta_entropy, other.delta_entropy)
        self.delta_flank_lq = max(self.delta_flank_lq, other.delta_flank_lq)
        self.tr_affinity = max(self.tr_affinity, other.tr_affinity)
        self.tr_purity = max(self.tr_purity, other.tr_purity)
        self.tr_period = max(self.tr_period, other.tr_period)
        self.is_stutter_indel = max(self.is_stutter_indel, other.is_stutter_indel)


def max_homopolymer_run(seq: str) -> int:
    if not seq:
        return 0
    max_run = run = 1
    for i in range(1, len(seq)):
        if seq[i] == seq[i - 1]:
            run += 1
            max_run = max(max_run, run)
        else:
            run = 1
    return max_run


def local_shannon_entropy(seq: str) -> float:
    if not seq:
        return 0.0
    counts = [0, 0, 0, 0]
    for ch in seq.upper():
        idx = "ACGT".find(ch)
        if idx >= 0:
            counts[idx] += 1
    total = sum(counts)
    if total <= 0:
        return 0.0
    ent = 0.0
    for c in counts:
        if c:
            p = c / total
            ent -= p * math.log2(p)
    return ent


def _extract_flank(hap: str, pos: int, length: int, flank: int) -> str:
    start = max(0, pos - flank)
    end = min(len(hap), pos + length + flank)
    return hap[start:end] if start < end else ""


class SequenceComplexityScorer:
    CONTEXT_FLANK = 20
    DELTA_HRUN_FLANK = 5
    DELTA_ENTROPY_FLANK = 10
    LQ_FLANK = 50
    TR_MOTIF_FLANK = 50

    def __init__(self, gc_frac: float = 0.41):
        self.flank_scorer = LongdustQScorer(4, 1024, gc_frac)
        self.hap_scorer = LongdustQScorer(7, 4096, gc_frac)

    def score(
        self,
        ref_hap: str, ref_pos: int, ref_len: int,
        alt_hap: str, alt_pos: int, alt_len: int,
    ) -> SequenceComplexity:
        cplx = SequenceComplexity()
        # Context (strictly REF)
        ctx = _extract_flank(ref_hap, ref_pos, ref_len, self.CONTEXT_FLANK)
        cplx.context_hrun = max_homopolymer_run(ctx)
        cplx.context_entropy = local_shannon_entropy(ctx)
        lq_win = _extract_flank(ref_hap, ref_pos, ref_len, self.LQ_FLANK)
        cplx.context_flank_lq = math.log1p(max(0.0, self.flank_scorer.score(lq_win)))
        cplx.context_haplotype_lq = math.log1p(max(0.0, self.hap_scorer.score(ref_hap)))
        # Deltas (ALT - REF)
        r5 = _extract_flank(ref_hap, ref_pos, ref_len, self.DELTA_HRUN_FLANK)
        a5 = _extract_flank(alt_hap, alt_pos, alt_len, self.DELTA_HRUN_FLANK)
        cplx.delta_hrun = max_homopolymer_run(a5) - max_homopolymer_run(r5)
        r10 = _extract_flank(ref_hap, ref_pos, ref_len, self.DELTA_ENTROPY_FLANK)
        a10 = _extract_flank(alt_hap, alt_pos, alt_len, self.DELTA_ENTROPY_FLANK)
        cplx.delta_entropy = local_shannon_entropy(a10) - local_shannon_entropy(r10)
        alt_lq_win = _extract_flank(alt_hap, alt_pos, alt_len, self.LQ_FLANK)
        alt_lq = math.log1p(max(0.0, self.flank_scorer.score(alt_lq_win)))
        cplx.delta_flank_lq = alt_lq - cplx.context_flank_lq
        # TR motif (strictly ALT)
        window = _extract_flank(alt_hap, alt_pos, alt_len, self.TR_MOTIF_FLANK)
        start = max(0, alt_pos - self.TR_MOTIF_FLANK)
        var_pos_in_window = alt_pos - start
        hits = tandem_repeat_hits(window)
        dist, period, purity, stutter = flatten_tr_features(hits, var_pos_in_window, alt_len)
        if dist < 0:
            cplx.tr_affinity, cplx.tr_purity, cplx.tr_period = 0.0, 0.0, 0
        else:
            cplx.tr_affinity = 1.0 / (1.0 + dist)
            cplx.tr_purity = purity
            cplx.tr_period = period
        cplx.is_stutter_indel = stutter
        return cplx
