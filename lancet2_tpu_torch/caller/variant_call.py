"""Final VCF record assembly: FORMAT fields, QUAL, STATE, INFO.

Reference: src/lancet/caller/variant_call.{h,cpp}, sample_format_data.cpp.
FORMAT layout (24 fields):
GT:AD:ADF:ADR:DP:RMQ:NPBQ:SB:SCA:FLD:RPCD:BQCD:MQCD:ASMD:SDFC:PRAD:PANG:CMLOD:FSSE:AHDD:HSE:PDCV:PL:GQ
QUAL = SOLOR somatic log-odds (case-control mode) or ref-hom PL (germline).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from lancet2_tpu_torch.base.stats import polar_angle, polar_radius
from lancet2_tpu_torch.caller.likelihood import genotype_from_pl_index
from lancet2_tpu_torch.caller.support import VariantSupport
from lancet2_tpu_torch.caller.variant import (
    RawVariant,
    STATE_CASE,
    STATE_CTRL,
    STATE_NAMES,
    STATE_NONE,
    STATE_SHARED,
    STATE_UNKNOWN,
    TYPE_NAMES,
)
from lancet2_tpu_torch.cbdg.read import LABEL_CASE, LABEL_CTRL

FORMAT_HEADER = (
    "GT:AD:ADF:ADR:DP:RMQ:NPBQ:SB:SCA:FLD:RPCD:BQCD:MQCD:ASMD:SDFC:PRAD:PANG:"
    "CMLOD:FSSE:AHDD:HSE:PDCV:PL:GQ"
)
MISSING_SAMPLE = "./.:.:.:.:.:.:.:.:.:.:.:.:.:.:.:.:.:.:.:.:.:.:.:."


def _fmt_opt(val: float | None, fmt: str) -> str:
    if val is None or (isinstance(val, float) and math.isnan(val)):
        return "."
    return fmt.format(val)


@dataclass
class SampleSummary:
    """Per-sample identity + role + sampled coverage (core.SampleInfo view)."""

    name: str
    tag: int  # LABEL_CTRL or LABEL_CASE
    sampled_bases: int = 0
    window_length: int = 0

    def mean_sampled_cov(self) -> float:
        if self.window_length <= 0:
            return 0.0
        return self.sampled_bases / self.window_length


class VariantCall:
    def __init__(
        self,
        variant: RawVariant,
        supports: dict[str, VariantSupport],
        samples: list[SampleSummary],
        window_length: int,
        window_index: int = 0,
        pls_lookup: dict | None = None,
    ):
        self.variant = variant
        # genome index of the producing window: deterministic duplicate
        # tie-break (the reference keeps whichever window's record arrived
        # first on a coverage tie — thread-schedule-dependent; we keep the
        # EARLIER window so -T 1/2/8 emit byte-identical VCFs)
        self.window_index = window_index
        self.chrom_index = variant.chrom_index
        self.chrom_name = variant.chrom_name
        self.pos1 = variant.genome_pos1
        self.ref_allele = variant.ref_allele
        self.alt_alleles = [a.sequence for a in variant.alts]
        self.categories = [a.vtype for a in variant.alts]
        self.variant_lengths = [a.length for a in variant.alts]
        self.window_length = window_length
        self.site_quality = 0.0
        self.total_sample_cov = 0
        self.has_alt_support = False
        self.state = STATE_UNKNOWN
        self.sample_columns: list[str] = []
        # batched device PLs (ops/genotype.batched_genotype_pls_exact),
        # keyed by sample name; None falls back to per-sample host math
        self._pls_lookup = pls_lookup
        self._finalize(supports, samples)

    # -- identity (locus level: CHROM+POS+REF) -----------------------------
    def identity(self) -> tuple:
        return (self.chrom_index, self.pos1, self.ref_allele)

    def total_coverage(self) -> int:
        return self.total_sample_cov

    def _finalize(self, supports, samples) -> None:
        case_ctrl_mode = any(s.tag == LABEL_CASE for s in samples) and any(
            s.tag == LABEL_CTRL for s in samples
        )
        self._build_format_fields(supports, samples, case_ctrl_mode)
        self._compute_state(supports, samples, case_ctrl_mode)
        self._build_info(case_ctrl_mode)

    def _build_format_fields(self, supports, samples, case_ctrl_mode) -> None:
        num_alleles = len(self.alt_alleles) + 1
        for sinfo in samples:
            support = supports.get(sinfo.name)
            if support is None:
                self.sample_columns.append(MISSING_SAMPLE)
                continue
            self.total_sample_cov += support.total_sample_cov()
            if self._pls_lookup is not None and sinfo.name in self._pls_lookup:
                pls = self._pls_lookup[sinfo.name]
            else:
                pls = support.compute_pls(num_alleles)
            self._update_site_quality(sinfo, support, supports, samples, case_ctrl_mode, pls)
            self.has_alt_support = self.has_alt_support or support.total_alt_cov() > 0
            self.sample_columns.append(
                self._render_sample(support, sinfo, num_alleles, pls)
            )

    def _render_sample(self, support: VariantSupport, sinfo: SampleSummary,
                       num_alleles: int, pls: np.ndarray) -> str:
        if pls.size:
            a, b = genotype_from_pl_index(int(np.argmin(pls)))
            gt = f"{a}/{b}"
        else:
            gt = "./."
        ad = [support.total_allele_cov(i) for i in range(num_alleles)]
        adf = [support.fwd_count(i) for i in range(num_alleles)]
        adr = [support.rev_count(i) for i in range(num_alleles)]
        rmq = [support.rms_mapping_qual(i) for i in range(num_alleles)]
        npbq = []
        for i in range(num_alleles):
            cov = support.total_allele_cov(i)
            npbq.append(support.raw_posterior_base_qual(i) / cov if cov > 0 else 0.0)

        max_var_len = max((abs(l) for l in self.variant_lengths), default=0)
        cmlods = support.compute_cmlods(num_alleles)
        cmlod_str = (
            ",".join(f"{v:.4f}" for v in cmlods[1:]) if cmlods.size >= 2 else "."
        )
        mean_cov = sinfo.mean_sampled_cov()
        sdfc = support.total_sample_cov() / mean_cov if mean_cov > 0 else None
        ad_ref = float(support.total_ref_cov())
        ad_alt = float(support.total_alt_cov())

        hse = support.compute_hse(self.variant.num_total_haps)
        pdcv = self.variant.max_path_cv

        parts = [
            gt,
            ",".join(str(x) for x in ad),
            ",".join(str(x) for x in adf),
            ",".join(str(x) for x in adr),
            str(support.total_sample_cov()),
            ",".join(f"{x:.1f}" for x in rmq),
            ",".join(f"{x:.1f}" for x in npbq),
            f"{support.strand_bias_log_or():.3f}",
            f"{support.soft_clip_asymmetry():.4f}",
            _fmt_opt(support.frag_length_delta(), "{:.1f}"),
            _fmt_opt(support.read_pos_cohen_d(), "{:.4f}"),
            _fmt_opt(support.base_qual_cohen_d(), "{:.4f}"),
            _fmt_opt(support.mapping_qual_cohen_d(), "{:.4f}"),
            _fmt_opt(support.allele_mismatch_delta(max_var_len), "{:.3f}"),
            _fmt_opt(sdfc, "{:.2f}"),
            f"{polar_radius(ad_ref, ad_alt):.4f}",
            f"{polar_angle(ad_alt, ad_ref):.4f}",
            cmlod_str,
            _fmt_opt(support.compute_fsse(), "{:.4f}"),
            _fmt_opt(support.compute_ahdd(), "{:.3f}"),
            _fmt_opt(hse, "{:.4f}"),
            _fmt_opt(pdcv, "{:.4f}"),
            ",".join(str(int(p)) for p in pls) if pls.size else ".",
            str(VariantSupport.compute_gq(pls)),
        ]
        return ":".join(parts)

    def _update_site_quality(self, sinfo, support, supports, samples, case_ctrl_mode, pls):
        if case_ctrl_mode:
            solor = self._somatic_log_odds_ratio(sinfo, supports, samples)
            self.site_quality = max(self.site_quality, solor)
        else:
            ref_hom_pl = float(pls[0]) if pls.size else 0.0
            self.site_quality = max(self.site_quality, ref_hom_pl)

    @staticmethod
    def _somatic_log_odds_ratio(curr: SampleSummary, supports, samples) -> float:
        """SOLOR = ln(((case_alt+1)(ctrl_ref+1)) / ((case_ref+1)(ctrl_alt+1)))
        averaged over control samples (reference: variant_call.cpp:289-345)."""
        if curr.tag != LABEL_CASE:
            return 0.0
        case_ev = supports.get(curr.name)
        case_alt = (case_ev.total_alt_cov() + 1.0) if case_ev else 1.0
        case_ref = (case_ev.total_ref_cov() + 1.0) if case_ev else 1.0
        sum_alt = sum_ref = count = 0.0
        for sinfo in samples:
            ev = supports.get(sinfo.name)
            if sinfo.tag != LABEL_CTRL or ev is None:
                continue
            sum_alt += ev.total_alt_cov()
            sum_ref += ev.total_ref_cov()
            count += 1.0
        n = max(count, 1.0)
        ctrl_alt = sum_alt / n + 1.0
        ctrl_ref = sum_ref / n + 1.0
        return math.log((case_alt * ctrl_ref) / (case_ref * ctrl_alt))

    def _compute_state(self, supports, samples, case_ctrl_mode) -> None:
        if not case_ctrl_mode:
            self.state = STATE_UNKNOWN
            return
        def has_alt(role):
            for sinfo in samples:
                ev = supports.get(sinfo.name)
                if sinfo.tag == role and ev is not None and ev.total_alt_cov() > 0:
                    return True
            return False

        in_ctrl = has_alt(LABEL_CTRL)
        in_case = has_alt(LABEL_CASE)
        self.state = [STATE_NONE, STATE_CTRL, STATE_CASE, STATE_SHARED][
            (in_case << 1) | in_ctrl
        ]

    def _build_info(self, case_ctrl_mode) -> None:
        parts = []
        if case_ctrl_mode:
            parts.append(STATE_NAMES[self.state])
        if len(self.alt_alleles) > 1:
            parts.append("MULTIALLELIC")
        type_str = ",".join(TYPE_NAMES[c] for c in self.categories)
        len_str = ",".join(str(l) for l in self.variant_lengths)
        parts.append(f"TYPE={type_str}")
        parts.append(f"LENGTH={len_str}")
        parts.append(f"GRAPH_CX={self.variant.graph_metrics.format_vcf_value()}")
        if self.variant.seq_cx is not None:
            parts.append(f"SEQ_CX={self.variant.seq_cx.format_vcf_value()}")
        self.info_field = ";".join(parts)

    def as_vcf_record(self) -> str:
        alt_field = ",".join(self.alt_alleles)
        cols = [
            self.chrom_name,
            str(self.pos1),
            ".",
            self.ref_allele,
            alt_field,
            f"{self.site_quality:.2f}",
            ".",
            self.info_field,
            FORMAT_HEADER,
        ] + self.sample_columns
        return "\t".join(cols)
