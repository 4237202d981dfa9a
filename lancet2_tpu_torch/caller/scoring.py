"""Read-at-variant local/combined scoring (allele assignment math).

Reference: src/lancet/caller/local_scorer.{h,cpp}, combined_scorer.{h,cpp},
scoring_constants.h. The combined score of one read-haplotype alignment at a
variant site is

  combined = (global_score - sc_penalty - local_raw_score)
             + local_pbq_score * local_identity

where local_raw_score is the substitution-matrix score of M ops inside the
variant region (gaps excluded to avoid the penalty-refund bug documented in
the reference), local_pbq is the Phred-confidence-weighted region score (gap
extends included, gated by identity), and identity is the exact-match
fraction inside the region.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lancet2_tpu_torch.base.phred import PHRED_TO_CONFIDENCE
from lancet2_tpu_torch.ops.affine_dp import OP_D, OP_I, OP_M

SCORING_MATCH = 1
SCORING_MISMATCH = 4
SCORING_GAP_OPEN = 12
SCORING_GAP_EXTEND = 3

# 5x5 substitution matrix (target x query); N row/col scores 0.
SCORING_MATRIX = np.array(
    [
        [1, -4, -4, -4, 0],
        [-4, 1, -4, -4, 0],
        [-4, -4, 1, -4, 0],
        [-4, -4, -4, 1, 0],
        [0, 0, 0, 0, 0],
    ],
    dtype=np.int32,
)


@dataclass
class LocalScoreResult:
    pbq_score: float = 0.0
    raw_score: float = 0.0
    identity: float = 0.0
    base_qual: int = 0  # min Phred in region (weakest link)


@dataclass
class ReadAlleleAssignment:
    local_score: float = 0.0
    local_identity: float = 0.0
    folded_read_pos: float = 0.0
    global_score: int = 0
    ref_nm: int = 0
    own_hap_nm: int = 0
    assigned_haplotype_id: int = 0
    allele: int = 0  # 0 = REF
    base_qual_at_var: int = 0

    @property
    def combined_score(self) -> float:
        return float(self.global_score) + self.local_score * self.local_identity


def compute_local_score(
    cigar: list[tuple[int, int]],
    qry_codes: np.ndarray,
    hap_codes: np.ndarray,  # slice of haplotype starting at alignment start
    qry_quals: np.ndarray,
    aln_start_on_hap: int,
    var_start_on_hap: int,
    var_len_on_hap: int,
) -> LocalScoreResult:
    """CIGAR walk over the variant's physical region on the haplotype
    (reference: ComputeLocalScore). tpos is relative to alignment start."""
    if not cigar or var_len_on_hap == 0:
        return LocalScoreResult()

    var_end = var_start_on_hap + var_len_on_hap
    pbq = 0.0
    raw = 0.0
    matches = 0
    aligned = 0
    min_bq = 255

    tpos = 0
    qpos = 0
    for op, length in cigar:
        if aln_start_on_hap + tpos >= var_end and op in (OP_M, OP_D):
            break
        if op == OP_M:
            for _ in range(length):
                abs_pos = aln_start_on_hap + tpos
                if var_start_on_hap <= abs_pos < var_end:
                    aligned += 1
                    if qpos < len(qry_codes) and tpos < len(hap_codes):
                        s = int(SCORING_MATRIX[min(int(hap_codes[tpos]), 4), min(int(qry_codes[qpos]), 4)])
                        raw += s
                        w = (
                            float(PHRED_TO_CONFIDENCE[min(int(qry_quals[qpos]), 255)])
                            if qpos < len(qry_quals)
                            else 1.0
                        )
                        pbq += s * w
                        if qry_codes[qpos] == hap_codes[tpos]:
                            matches += 1
                    if qpos < len(qry_quals):
                        min_bq = min(min_bq, int(qry_quals[qpos]))
                tpos += 1
                qpos += 1
        elif op == OP_I:
            in_region = var_start_on_hap <= aln_start_on_hap + tpos < var_end
            for _ in range(length):
                if in_region:
                    aligned += 1
                    if qpos < len(qry_quals):
                        min_bq = min(min_bq, int(qry_quals[qpos]))
                    pbq += SCORING_GAP_EXTEND
                qpos += 1
        elif op == OP_D:
            for _ in range(length):
                if var_start_on_hap <= aln_start_on_hap + tpos < var_end:
                    aligned += 1
                    pbq += SCORING_GAP_EXTEND
                tpos += 1
            # deletion confidence borrows from flanking bases
            if qpos > 0 and qpos - 1 < len(qry_quals):
                min_bq = min(min_bq, int(qry_quals[qpos - 1]))
            if qpos < len(qry_quals):
                min_bq = min(min_bq, int(qry_quals[qpos]))
        # soft clips don't occur in glocal CIGARs; N/other ops unused

    return LocalScoreResult(
        pbq_score=pbq,
        raw_score=raw,
        identity=matches / aligned if aligned > 0 else 0.0,
        base_qual=0 if min_bq == 255 else min_bq,
    )


def compute_edit_distance_cigar(
    cigar: list[tuple[int, int]], qry_codes: np.ndarray, hap_slice: np.ndarray
) -> int:
    """SAM NM over the alignment (M mismatches + I bases + D bases)."""
    nm = 0
    qpos = tpos = 0
    for op, length in cigar:
        if op == OP_M:
            span = min(length, len(qry_codes) - qpos, len(hap_slice) - tpos)
            if span > 0:
                nm += int(
                    np.count_nonzero(qry_codes[qpos : qpos + span] != hap_slice[tpos : tpos + span])
                )
            qpos += length
            tpos += length
        elif op == OP_I:
            nm += length
            qpos += length
        elif op == OP_D:
            nm += length
            tpos += length
    return nm


def ref_pos_to_query_pos(cigar: list[tuple[int, int]], target_rel: int) -> int:
    qpos = tpos = 0
    for op, length in cigar:
        if op == OP_M:
            if tpos + length > target_rel:
                return qpos + (target_rel - tpos)
            tpos += length
            qpos += length
        elif op == OP_I:
            qpos += length
        elif op == OP_D:
            if tpos + length > target_rel:
                return qpos
            tpos += length
    return qpos


def score_read_at_variant(
    aln: dict,  # {score, t_start, t_end, cigar, hap_idx}
    hap_codes: np.ndarray,  # full haplotype codes
    qry_codes: np.ndarray,
    qry_quals: np.ndarray,
    read_length: int,
    var_start: int,
    var_len: int,
    allele_idx: int,
) -> ReadAlleleAssignment:
    """Reference: caller/combined_scorer.cpp ScoreReadAtVariant."""
    t_start = aln["t_start"]
    hap_slice = hap_codes[t_start : aln["t_end"]]
    local = compute_local_score(
        aln["cigar"], qry_codes, hap_slice, qry_quals, t_start, var_start, var_len
    )
    # glocal alignment never soft-clips; penalty retained for API parity
    sc_penalty = 0.0
    out = ReadAlleleAssignment()
    out.allele = allele_idx
    out.global_score = int(float(aln["score"]) - sc_penalty - local.raw_score)
    out.local_score = local.pbq_score
    out.local_identity = local.identity
    out.base_qual_at_var = local.base_qual
    out.assigned_haplotype_id = aln["hap_idx"]
    out.own_hap_nm = compute_edit_distance_cigar(aln["cigar"], qry_codes, hap_slice)

    var_start_in_aln = max(0, var_start - t_start)
    qpos_at_var = ref_pos_to_query_pos(aln["cigar"], var_start_in_aln)
    rel = qpos_at_var / read_length if read_length > 0 else 0.5
    out.folded_read_pos = min(rel, 1.0 - rel)
    return out
