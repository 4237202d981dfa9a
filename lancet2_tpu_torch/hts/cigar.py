"""CIGAR model and coordinate/edit-distance utilities.

Reference: src/lancet/hts/cigar_unit.h, cigar_utils.{h,cpp}. Ops are stored as
(op_code, length) pairs with the BAM integer op order "MIDNSHP=X".
"""

from __future__ import annotations

import numpy as np

CIGAR_OPS = "MIDNSHP=X"
M, I, D, N, S, H, P, EQ, X = range(9)

CONSUMES_QUERY = frozenset((M, I, S, EQ, X))
CONSUMES_REF = frozenset((M, D, N, EQ, X))
ALN_MATCH_OPS = frozenset((M, EQ, X))

Cigar = list[tuple[int, int]]  # [(op, length), ...]


def cigar_to_str(cigar: Cigar) -> str:
    return "".join(f"{length}{CIGAR_OPS[op]}" for op, length in cigar) or "*"


def cigar_from_str(text: str) -> Cigar:
    if text == "*" or not text:
        return []
    out: Cigar = []
    num = 0
    for ch in text:
        if ch.isdigit():
            num = num * 10 + int(ch)
        else:
            out.append((CIGAR_OPS.index(ch), num))
            num = 0
    return out


def query_length(cigar: Cigar) -> int:
    return sum(length for op, length in cigar if op in CONSUMES_QUERY)


def reference_span(cigar: Cigar) -> int:
    return sum(length for op, length in cigar if op in CONSUMES_REF)


def soft_clip_lengths(cigar: Cigar) -> tuple[int, int]:
    """(leading, trailing) soft-clip lengths."""
    lead = cigar[0][1] if cigar and cigar[0][0] == S else 0
    trail = cigar[-1][1] if len(cigar) > 1 and cigar[-1][0] == S else 0
    return lead, trail


def compute_edit_distance(
    cigar: Cigar, query_codes: np.ndarray, target_codes: np.ndarray
) -> int:
    """SAM-spec NM over an alignment: mismatches under M/=/X + I bases + D bases.

    `target_codes` is the aligned slice of the target (starting at the
    alignment's target start). Soft/hard clips and N skips are excluded
    (reference: hts::ComputeEditDistance via caller/combined_scorer.cpp).
    """
    nm = 0
    qpos = 0
    tpos = 0
    for op, length in cigar:
        if op in ALN_MATCH_OPS:
            qs = query_codes[qpos : qpos + length]
            ts = target_codes[tpos : tpos + length]
            span = min(len(qs), len(ts))
            nm += int(np.count_nonzero(qs[:span] != ts[:span]))
            qpos += length
            tpos += length
        elif op == I:
            nm += length
            qpos += length
        elif op == D:
            nm += length
            tpos += length
        elif op == S:
            qpos += length
        elif op == N:
            tpos += length
    return nm


def ref_pos_to_query_pos(cigar: Cigar, target_rel_pos: int) -> int:
    """Query position at a target-relative position (0 = alignment start).

    Mirrors hts::CigarRefPosToQueryPos: walks ops and returns the query
    offset when the target cursor reaches `target_rel_pos`. If the position
    falls inside a deletion, returns the query offset at the deletion.
    Returns the final query offset if the position is beyond the alignment.
    """
    qpos = 0
    tpos = 0
    for op, length in cigar:
        cq = op in CONSUMES_QUERY
        ct = op in CONSUMES_REF
        if ct:
            if tpos + length > target_rel_pos:
                return qpos + (target_rel_pos - tpos if cq else 0)
            tpos += length
        if cq:
            qpos += length
    return qpos
