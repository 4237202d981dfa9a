"""Raw variant model: multi-allelic records with per-haplotype coordinates.

Reference: src/lancet/caller/raw_variant.{h,cpp}, alt_allele.h, variant_bubble.cpp.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# AlleleType (reference enum values)
TYPE_REF, TYPE_SNV, TYPE_INS, TYPE_DEL, TYPE_MNP, TYPE_CPX = -1, 0, 1, 2, 3, 4
TYPE_NAMES = {TYPE_REF: "REF", TYPE_SNV: "SNV", TYPE_INS: "INS", TYPE_DEL: "DEL",
              TYPE_MNP: "MNP", TYPE_CPX: "CPX"}

# AlleleState
STATE_NONE, STATE_SHARED, STATE_CTRL, STATE_CASE, STATE_UNKNOWN = -1, 0, 1, 2, 3
STATE_NAMES = {STATE_NONE: "NONE", STATE_SHARED: "SHARED", STATE_CTRL: "CTRL",
               STATE_CASE: "CASE", STATE_UNKNOWN: "UNKNOWN"}


def classify_variant(ref_seq: str, alt_seq: str) -> int:
    """Strict sequence-core classification: squeeze matching 5' prefix and 3'
    suffix, then classify the core (reference: RawVariant::ClassifyVariant)."""
    start = 0
    while start < len(ref_seq) and start < len(alt_seq) and ref_seq[start] == alt_seq[start]:
        start += 1
    if start == len(ref_seq) and start == len(alt_seq):
        return TYPE_REF
    end = 0
    while (
        end < len(ref_seq) - start
        and end < len(alt_seq) - start
        and ref_seq[len(ref_seq) - 1 - end] == alt_seq[len(alt_seq) - 1 - end]
    ):
        end += 1
    ref_core = len(ref_seq) - start - end
    alt_core = len(alt_seq) - start - end
    if ref_core == 0 and alt_core > 0:
        return TYPE_INS
    if ref_core > 0 and alt_core == 0:
        return TYPE_DEL
    if ref_core == 0 or alt_core == 0:
        return TYPE_REF
    if ref_core != alt_core:
        return TYPE_CPX
    return TYPE_SNV if ref_core == 1 else TYPE_MNP


def calculate_variant_length(ref_allele: str, alt_allele: str, vtype: int) -> int:
    """Reference: caller/variant_bubble.cpp CalculateVariantLength."""
    if vtype == TYPE_SNV:
        return 1
    diff = len(alt_allele) - len(ref_allele)
    if vtype in (TYPE_INS, TYPE_DEL, TYPE_CPX):
        return diff
    # MNP: biological length = sequence core after squeezing both ends
    start = 0
    while (
        start < len(ref_allele)
        and start < len(alt_allele)
        and ref_allele[start] == alt_allele[start]
    ):
        start += 1
    end = 0
    while (
        end < len(ref_allele) - start
        and end < len(alt_allele) - start
        and ref_allele[len(ref_allele) - 1 - end] == alt_allele[len(alt_allele) - 1 - end]
    ):
        end += 1
    return len(alt_allele) - start - end


@dataclass
class AltAllele:
    sequence: str
    vtype: int = TYPE_REF
    length: int = -1
    # haplotype index -> variant's 0-based local start on that haplotype string
    local_hap_starts: dict[int, int] = field(default_factory=dict)

    def sort_key(self):
        return self.sequence


@dataclass
class GraphMetricsAnnotation:
    """GRAPH_CX INFO payload (GEI, tip/path cov ratio, max degree)."""

    gei: float = 0.0
    tip_to_path_cov_ratio: float = 0.0
    max_single_dir_degree: int = 0

    def format_vcf_value(self) -> str:
        from lancet2_tpu_torch.base.sequence_complexity import format_complexity_score as fs

        return f"{fs(self.gei)},{fs(self.tip_to_path_cov_ratio)},{self.max_single_dir_degree}"


@dataclass
class RawVariant:
    chrom_index: int
    chrom_name: str
    genome_pos1: int  # 1-based genomic position (anchored)
    local_ref_start0: int  # 0-based start on the REF haplotype (anchor) string
    ref_allele: str
    alts: list[AltAllele] = field(default_factory=list)
    # annotations (populated post-discovery)
    graph_metrics: GraphMetricsAnnotation = field(default_factory=GraphMetricsAnnotation)
    seq_cx: object | None = None  # base.sequence_complexity.SequenceComplexity
    num_total_haps: int = 0
    max_path_cv: float | None = None

    def sort_key(self):
        return (
            self.chrom_index,
            self.genome_pos1,
            self.ref_allele,
            tuple(a.sequence for a in self.alts),
        )

    @property
    def is_multiallelic(self) -> bool:
        return len(self.alts) > 1

    def identity(self) -> tuple:
        """Locus-level identity CHROM+POS+REF (reference: HashRawVariant)."""
        return (self.chrom_index, self.genome_pos1, self.ref_allele)
