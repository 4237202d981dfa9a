"""Phred quality <-> error probability conversion tables.

Reference: src/lancet/hts/phred_quality.{h,cpp} — precomputed lookup tables so
per-base conversions are O(1) on hot paths (expected-error k-mer filter,
PBQ weighting, DM genotyping).
"""

from __future__ import annotations

import numpy as np

MAX_PHRED = 255

# error_prob[q] = 10^(-q/10)
PHRED_TO_ERROR_PROB = np.power(10.0, -np.arange(MAX_PHRED + 1, dtype=np.float64) / 10.0)
# confidence[q] = 1 - 10^(-q/10)
PHRED_TO_CONFIDENCE = 1.0 - PHRED_TO_ERROR_PROB


def phred_to_error_prob(qual) -> np.ndarray | float:
    """Vectorized Phred -> error probability."""
    q = np.asarray(qual, dtype=np.int64)
    out = PHRED_TO_ERROR_PROB[np.clip(q, 0, MAX_PHRED)]
    return float(out) if out.ndim == 0 else out


def error_prob_to_phred(prob: float) -> float:
    """Error probability -> Phred scale."""
    return -10.0 * np.log10(max(prob, 1e-300))
