"""Streaming statistics, medians, Mann-Whitney effect size, polar features.

Mirrors the behavior of the reference's base-layer statistics:
  * OnlineStats           — Welford recurrence (reference: src/lancet/base/compute_stats.h:75-128)
  * median_u32            — integer median, even-size averages the two middles
                            with integer division (reference: compute_stats.h:146-159)
  * mann_whitney_effect_size — Z/sqrt(N) coverage-invariant effect size with
                            mid-rank ties + Lehmann tie-corrected variance
                            (reference: src/lancet/base/mann_whitney.h)
  * polar_radius / polar_angle — depth/identity-decoupled ML features
                            (reference: src/lancet/base/polar_coords.h)
"""

from __future__ import annotations

import math

import numpy as np


class OnlineStats:
    """Welford single-pass mean/variance accumulator (mergeable)."""

    __slots__ = ("n", "m1", "m2")

    def __init__(self) -> None:
        self.n = 0
        self.m1 = 0.0
        self.m2 = 0.0

    def add(self, value: float) -> None:
        old_n = self.n
        self.n += 1
        delta = float(value) - self.m1
        norm = delta / self.n
        self.m1 += norm
        self.m2 += delta * norm * old_n

    def add_many(self, values) -> None:
        for v in values:
            self.add(v)

    def merge(self, other: "OnlineStats") -> None:
        if other.n == 0:
            return
        if self.n == 0:
            self.n, self.m1, self.m2 = other.n, other.m1, other.m2
            return
        new_n = self.n + other.n
        delta = other.m1 - self.m1
        self.m1 = (self.n * self.m1 + other.n * other.m1) / new_n
        self.m2 = self.m2 + other.m2 + delta * delta * self.n * other.n / new_n
        self.n = new_n

    @property
    def is_empty(self) -> bool:
        return self.n == 0

    @property
    def mean(self) -> float:
        return self.m1

    @property
    def variance(self) -> float:
        return 0.0 if self.n < 2 else self.m2 / (self.n - 1)

    @property
    def stddev(self) -> float:
        return math.sqrt(self.variance)


def median_u32(data) -> int:
    """Integer median; even-length input averages the two middles via // 2."""
    arr = np.asarray(list(data) if not isinstance(data, np.ndarray) else data)
    if arr.size == 0:
        return 0
    if arr.size == 1:
        return int(arr[0])
    s = np.sort(arr)
    half = arr.size // 2
    if arr.size % 2 == 1:
        return int(s[half])
    return int((int(s[half]) + int(s[half - 1])) // 2)


def mann_whitney_effect_size(ref_vals, alt_vals) -> float | None:
    """Mann-Whitney U effect size Z/sqrt(N), or None when either group is empty.

    Positive when alt_vals tend higher than ref_vals. 0.0 on zero variance.
    """
    ref = np.asarray(ref_vals, dtype=np.float64)
    alt = np.asarray(alt_vals, dtype=np.float64)
    if ref.size == 0 or alt.size == 0:
        return None

    n_ref = float(ref.size)
    n_alt = float(alt.size)
    total = ref.size + alt.size

    pooled = np.concatenate([ref, alt])
    is_alt = np.concatenate(
        [np.zeros(ref.size, dtype=bool), np.ones(alt.size, dtype=bool)]
    )
    order = np.argsort(pooled, kind="stable")
    pooled = pooled[order]
    is_alt = is_alt[order]

    # Mid-rank assignment + tie-correction accumulation per tie group.
    ranks = np.empty(total, dtype=np.float64)
    tie_correction = 0.0
    i = 0
    while i < total:
        j = i
        while j < total and pooled[j] == pooled[i]:
            j += 1
        mid = (i + 1 + j) / 2.0  # mean of 1-indexed ranks i+1..j
        ranks[i:j] = mid
        t = j - i
        if t > 1:
            tie_correction += t * t * t - t
        i = j

    alt_rank_sum = float(ranks[is_alt].sum())
    u_alt = alt_rank_sum - n_alt * (n_alt + 1.0) / 2.0
    mean_u = n_ref * n_alt / 2.0

    n_total = float(total)
    var_u = (n_ref * n_alt / 12.0) * (
        (n_total + 1.0) - tie_correction / (n_total * (n_total - 1.0))
    )
    if var_u <= 0.0:
        return 0.0

    z = (u_alt - mean_u) / math.sqrt(var_u)
    return z / math.sqrt(n_total)


def polar_radius(ad_ref: float, ad_alt: float) -> float:
    """PRAD = log10(1 + sqrt(AD_ref^2 + AD_alt^2))."""
    return math.log10(1.0 + math.hypot(ad_ref, ad_alt))


def polar_angle(ad_alt: float, ad_ref: float) -> float:
    """PANG = atan2(AD_alt, AD_ref) in radians (0 = pure REF, pi/2 = pure ALT)."""
    return math.atan2(ad_alt, ad_ref)
