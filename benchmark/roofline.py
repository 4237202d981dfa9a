"""The least time the card needs for the evidence work a job hands the
genotyper: a frozen copy of `chip_smoke.py`'s phase-10 arithmetic.

The int32 rate is 64 lanes per SM x 2 operations per lane and clock
(sm_90a's three-input VIADDMNMX and IADD3 do two per instruction) x SMs x the
SM clock; HBM moves 3.35 TB/s, each input byte read once and each output
byte written once. Operations per DP cell of the minimal recurrence:
pass 1 (K1, span) 20; pass 2 (K2, evidence) 20 + 36 per active region slot.
Cells: a pair's read length times its band (pass 1), or times its cropped
span (pass 2). The work is counted from what the evidence calls are given
and what they keep, never from a kernel's launch arguments, so the count
stays the same whatever implements the kernels.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
INT32_OPS_PER_LANE_CLOCK = 2
SPAN_OPS_PER_CELL = 20
EVIDENCE_OPS_PER_CELL = 20
EVIDENCE_OPS_PER_SLOT = 36
MIN_SCORE_FRAC = 0.25  # the two-pass gate: score >= 25% of the read length


def min_seconds(ops: float, nbytes: float, clock_hz: float, sms: int) -> float:
    """The larger of the operations over the int32 rate and the bytes over
    HBM's rate."""
    t_ops = ops / (INT32_LANES_PER_SM * INT32_OPS_PER_LANE_CLOCK * sms * clock_hz)
    return max(t_ops, nbytes / HBM_BYTES_PER_S)


def span_work(read_lens: np.ndarray, read_ix: np.ndarray, tlens: np.ndarray,
              lt: int) -> int:
    """Pass-1 operations: every pair, read length x min(band, lt) cells."""
    rows = np.asarray(read_lens, np.int64)[np.asarray(read_ix, np.int64)]
    cols = np.clip(np.asarray(tlens, np.int64), 0, lt)
    return int((rows * cols).sum()) * SPAN_OPS_PER_CELL


def gate(score, t_start, t_end, regions, read_len):
    """The pairs the two-pass gate keeps: a span that scores at least
    MIN_SCORE_FRAC of the read length, is not empty and overlaps an active
    region slot; returns their indices and active-slot counts."""
    regions = np.asarray(regions)
    active = regions[:, :, 1] > regions[:, :, 0]
    overlap = ((regions[:, :, 1] > t_start[:, None])
               & (regions[:, :, 0] < t_end[:, None]) & active).any(axis=1)
    min_score = (MIN_SCORE_FRAC * read_len.astype(np.int64)).astype(np.int64)
    kept = np.flatnonzero((score >= min_score) & (t_end > t_start) & overlap)
    return kept, active[kept].sum(axis=1)


def evidence_work(read_len: np.ndarray, t_start: np.ndarray, t_end: np.ndarray,
                  slots: np.ndarray) -> int:
    """Pass-2 operations of the kept pairs at their cropped span."""
    cells = read_len.astype(np.int64) * (t_end - t_start).astype(np.int64)
    return int((cells * (EVIDENCE_OPS_PER_CELL
                         + EVIDENCE_OPS_PER_SLOT * slots.astype(np.int64))).sum())
