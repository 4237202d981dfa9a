"""Per-(variant, sample) allele evidence aggregation + FORMAT feature math.

Reference: src/lancet/caller/variant_support.{h,cpp}, per_allele_data.h.
Evidence is deduplicated by read-name hash (first-seen strand wins). Every
FORMAT feature the reference emits is reproduced:

  AD/ADF/ADR/DP   allele depths            RMQ   per-allele RMS mapping qual
  NPBQ            posterior BQ / depth     SB    Haldane log odds strand bias
  SCA             soft-clip asymmetry      FLD   fragment length delta
  RPCD/BQCD/MQCD  Mann-Whitney Z/sqrt(N)   ASMD  allele mismatch delta
  FSSE            fragment-start entropy   AHDD  own-haplotype NM delta
  HSE             haplotype segregation    PL/GQ DM genotype likelihoods
  CMLOD           continuous mixture LOD   PRAD/PANG polar features
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from lancet2_tpu_torch.base.stats import mann_whitney_effect_size
from lancet2_tpu_torch.caller.likelihood import (
    compute_continuous_mixture_lods,
    compute_genotype_pls,
    compute_genotype_quality,
    compute_raw_posterior_base_qual,
)

REF_ALLELE_IDX = 0
STRAND_FWD, STRAND_REV = 0, 1


@dataclass
class ReadEvidence:
    insert_size: int
    alignment_start: int
    aln_score: float
    folded_read_pos: float
    rname_hash: int
    ref_nm: int
    own_hap_nm: int
    assigned_haplotype_id: int
    allele: int
    strand: int
    base_qual: int
    map_qual: int
    is_soft_clipped: bool
    is_proper_pair: bool


class _PerAlleleData:
    __slots__ = (
        "name_hashes", "fwd_base_quals", "rev_base_quals", "map_quals", "aln_scores",
        "soft_clip_count", "proper_pair_isizes", "folded_read_positions", "ref_nm_values",
        "alignment_starts", "own_hap_nm_values", "haplotype_ids",
    )

    def __init__(self):
        self.name_hashes: dict[int, int] = {}
        self.fwd_base_quals: list[int] = []
        self.rev_base_quals: list[int] = []
        self.map_quals: list[int] = []
        self.aln_scores: list[float] = []
        self.soft_clip_count = 0
        self.proper_pair_isizes: list[float] = []
        self.folded_read_positions: list[float] = []
        self.ref_nm_values: list[float] = []
        self.alignment_starts: list[int] = []
        self.own_hap_nm_values: list[float] = []
        self.haplotype_ids: list[int] = []


class VariantSupport:
    def __init__(self):
        self.allele_data: list[_PerAlleleData] = []

    def _slot(self, idx: int) -> _PerAlleleData:
        while idx >= len(self.allele_data):
            self.allele_data.append(_PerAlleleData())
        return self.allele_data[idx]

    def add_evidence(self, ev: ReadEvidence) -> None:
        data = self._slot(ev.allele)
        if ev.rname_hash in data.name_hashes:
            return  # dedup: only first-seen mate counts
        data.name_hashes[ev.rname_hash] = ev.strand
        if ev.strand == STRAND_FWD:
            data.fwd_base_quals.append(ev.base_qual)
        else:
            data.rev_base_quals.append(ev.base_qual)
        data.map_quals.append(ev.map_qual)
        data.aln_scores.append(ev.aln_score)
        if ev.is_soft_clipped:
            data.soft_clip_count += 1
        if ev.is_proper_pair and ev.insert_size != 0:
            data.proper_pair_isizes.append(float(ev.insert_size))
        data.folded_read_positions.append(ev.folded_read_pos)
        data.ref_nm_values.append(float(ev.ref_nm))
        data.alignment_starts.append(ev.alignment_start)
        data.own_hap_nm_values.append(float(ev.own_hap_nm))
        data.haplotype_ids.append(ev.assigned_haplotype_id)

    # ---- depth accessors -------------------------------------------------
    def fwd_count(self, idx: int) -> int:
        return len(self.allele_data[idx].fwd_base_quals) if idx < len(self.allele_data) else 0

    def rev_count(self, idx: int) -> int:
        return len(self.allele_data[idx].rev_base_quals) if idx < len(self.allele_data) else 0

    def total_allele_cov(self, idx: int) -> int:
        return self.fwd_count(idx) + self.rev_count(idx)

    def total_sample_cov(self) -> int:
        return sum(len(d.fwd_base_quals) + len(d.rev_base_quals) for d in self.allele_data)

    def total_ref_cov(self) -> int:
        return self.total_allele_cov(REF_ALLELE_IDX)

    def total_alt_cov(self) -> int:
        return sum(self.total_allele_cov(i) for i in range(1, len(self.allele_data)))

    # ---- per-allele metrics ---------------------------------------------
    def raw_posterior_base_qual(self, idx: int) -> float:
        if idx >= len(self.allele_data):
            return 0.0
        d = self.allele_data[idx]
        return compute_raw_posterior_base_qual(
            np.asarray(d.fwd_base_quals, dtype=np.int64),
            np.asarray(d.rev_base_quals, dtype=np.int64),
        )

    def rms_mapping_qual(self, idx: int) -> float:
        if idx >= len(self.allele_data) or not self.allele_data[idx].map_quals:
            return 0.0
        mq = np.asarray(self.allele_data[idx].map_quals, dtype=np.float64)
        return float(np.sqrt(np.mean(mq * mq)))

    def mean_aln_score(self, idx: int) -> float:
        if idx >= len(self.allele_data) or not self.allele_data[idx].aln_scores:
            return 0.0
        return float(np.mean(self.allele_data[idx].aln_scores))

    # ---- site metrics ----------------------------------------------------
    def strand_bias_log_or(self) -> float:
        rf = self.fwd_count(REF_ALLELE_IDX)
        rr = self.rev_count(REF_ALLELE_IDX)
        af = sum(self.fwd_count(i) for i in range(1, len(self.allele_data)))
        ar = sum(self.rev_count(i) for i in range(1, len(self.allele_data)))
        return math.log(((rf + 1) * (ar + 1)) / ((rr + 1) * (af + 1)))

    def soft_clip_asymmetry(self) -> float:
        alt_sc = sum(d.soft_clip_count for d in self.allele_data[1:])
        alt_total = self.total_alt_cov()
        ref_sc = self.allele_data[0].soft_clip_count if self.allele_data else 0
        ref_total = self.total_ref_cov()
        alt_frac = alt_sc / alt_total if alt_total > 0 else 0.0
        ref_frac = ref_sc / ref_total if ref_total > 0 else 0.0
        return alt_frac - ref_frac

    def _pool_alt(self, getter) -> list:
        out = []
        for d in self.allele_data[1:]:
            out.extend(getter(d))
        return out

    def _mean_alt_minus_ref(self, getter, offset: float = 0.0) -> float | None:
        if not self.allele_data:
            return None
        ref_vals = getter(self.allele_data[0])
        if not ref_vals:
            return None
        alt_vals = self._pool_alt(getter)
        if not alt_vals:
            return None
        return (float(np.mean(alt_vals)) - offset) - float(np.mean(ref_vals))

    def _ref_vs_alt_effect_size(self, getter) -> float | None:
        if not self.allele_data:
            return None
        ref_vals = getter(self.allele_data[0])
        alt_vals = self._pool_alt(getter)
        return mann_whitney_effect_size(ref_vals, alt_vals)

    def frag_length_delta(self) -> float | None:
        return self._mean_alt_minus_ref(lambda d: d.proper_pair_isizes)

    def mapping_qual_cohen_d(self) -> float | None:
        return self._ref_vs_alt_effect_size(lambda d: d.map_quals)

    def read_pos_cohen_d(self) -> float | None:
        return self._ref_vs_alt_effect_size(lambda d: d.folded_read_positions)

    def base_qual_cohen_d(self) -> float | None:
        if not self.allele_data:
            return None
        ref_bqs = self.allele_data[0].fwd_base_quals + self.allele_data[0].rev_base_quals
        alt_bqs = []
        for d in self.allele_data[1:]:
            alt_bqs.extend(d.fwd_base_quals)
            alt_bqs.extend(d.rev_base_quals)
        return mann_whitney_effect_size(ref_bqs, alt_bqs)

    def allele_mismatch_delta(self, variant_length: int = 0) -> float | None:
        return self._mean_alt_minus_ref(lambda d: d.ref_nm_values, float(variant_length))

    def _alt_pooled_entropy(self, getter, bin_func, max_bins: float) -> float | None:
        pooled = self._pool_alt(getter)
        if len(pooled) < 3:
            return None
        bins: dict = {}
        for v in pooled:
            key = bin_func(v)
            bins[key] = bins.get(key, 0) + 1
        total = float(len(pooled))
        entropy = 0.0
        for count in bins.values():
            prob = count / total
            entropy -= prob * math.log2(prob)
        max_entropy = math.log2(min(total, max_bins))
        return entropy / max_entropy if max_entropy > 0.0 else 0.0

    def compute_fsse(self) -> float | None:
        """Fragment-start entropy, 3bp binning, <=20 bins."""
        return self._alt_pooled_entropy(lambda d: d.alignment_starts, lambda s: s // 3, 20.0)

    def compute_ahdd(self) -> float | None:
        return self._mean_alt_minus_ref(lambda d: d.own_hap_nm_values)

    def compute_hse(self, total_haplotypes: int) -> float | None:
        if total_haplotypes < 2:
            return None
        return self._alt_pooled_entropy(
            lambda d: d.haplotype_ids, lambda h: h, float(total_haplotypes)
        )

    # ---- genotype likelihood wrappers ------------------------------------
    def compute_pls(self, num_alleles: int) -> np.ndarray:
        counts = [self.total_allele_cov(i) for i in range(num_alleles)]
        return compute_genotype_pls(counts)

    @staticmethod
    def compute_gq(pls: np.ndarray) -> int:
        return compute_genotype_quality(pls)

    def compute_cmlods(self, num_alleles: int) -> np.ndarray:
        if num_alleles < 2:
            return np.zeros(num_alleles)
        quals = []
        covs = []
        for i in range(num_alleles):
            if i < len(self.allele_data):
                d = self.allele_data[i]
                quals.append(np.asarray(d.fwd_base_quals + d.rev_base_quals, dtype=np.int64))
            else:
                quals.append(np.zeros(0, dtype=np.int64))
            covs.append(self.total_allele_cov(i))
        return compute_continuous_mixture_lods(quals, covs)
