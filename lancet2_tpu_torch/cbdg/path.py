"""Assembled haplotype paths and per-component results.

Reference: src/lancet/cbdg/path.{h,cpp}, component_result.{h,cpp}.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from lancet2_tpu_torch.base.stats import OnlineStats, median_u32


@dataclass
class Path:
    """Haplotype sequence + per-node weights (run-length) + coverage stats."""

    sequence: str = ""
    node_coverages: list[int] = field(default_factory=list)
    node_weights: list[tuple[int, int]] = field(default_factory=list)  # (weight, num_bases)
    mean_cov: float = 0.0
    median_cov: float = 0.0
    stddev_cov: float = 0.0
    cv_cov: float = 0.0
    qcv_cov: float = 0.0
    total_cov: float = 0.0

    def append_sequence(self, seq: str) -> None:
        self.sequence += seq

    def add_node_coverage(self, cov: int) -> None:
        self.node_coverages.append(int(cov))

    def add_node_weight(self, weight: int, num_bases: int) -> None:
        self.node_weights.append((int(weight), int(num_bases)))

    def per_base_weights(self) -> np.ndarray:
        out = np.empty(sum(n for _, n in self.node_weights), dtype=np.uint32)
        off = 0
        for w, n in self.node_weights:
            out[off : off + n] = w
            off += n
        return out

    def min_weight(self) -> int:
        return min((w for w, _ in self.node_weights), default=0)

    def finalize(self) -> None:
        """Coverage summary stats (reference: Path::Finalize).

        Q1/Q3 use the reference's index convention: sorted[n/4] and
        sorted[3n/4] (only when n >= 4).
        """
        if not self.node_coverages:
            return
        stats = OnlineStats()
        stats.add_many(self.node_coverages)
        self.mean_cov = stats.mean
        self.stddev_cov = stats.stddev
        self.total_cov = stats.mean * stats.n
        if self.mean_cov > 0.0:
            self.cv_cov = self.stddev_cov / self.mean_cov
        self.median_cov = float(median_u32(self.node_coverages))
        n = len(self.node_coverages)
        if n >= 4:
            sorted_cov = sorted(self.node_coverages)
            q1 = float(sorted_cov[n // 4])
            q3 = float(sorted_cov[(n * 3) // 4])
            if q3 + q1 > 0.0:
                self.qcv_cov = (q3 - q1) / (q3 + q1)


@dataclass
class EnumeratedHaplotype:
    path: Path
    walk: list  # list[Edge]; empty for the reference haplotype


class ComponentResult:
    """Per-component bundle: REF-first haplotype paths + complexity + anchor.

    Reference: src/lancet/cbdg/component_result.h — first path is always the
    reference anchor; ALT paths are sorted by descending MinWeight.
    """

    def __init__(self, haplotypes: list[EnumeratedHaplotype], metrics, anchor_start_offset: int):
        self.paths = [h.path for h in haplotypes]
        self.walks = [h.walk for h in haplotypes]
        self.metrics = metrics
        self.anchor_start_offset = int(anchor_start_offset)

    @property
    def num_paths(self) -> int:
        return len(self.paths)

    @property
    def num_alt_haplotypes(self) -> int:
        return len(self.paths) - 1

    def haplotype_sequences(self) -> list[str]:
        return [p.sequence for p in self.paths]

    def haplotype_weights(self) -> list[np.ndarray]:
        return [p.per_base_weights() for p in self.paths]

    def max_alt_path_cv(self) -> float | None:
        """Max depth CV across ALT paths with >= 2 nodes (PDCV feature)."""
        best = None
        for p in self.paths[1:]:
            if len(p.node_coverages) >= 2:
                best = p.cv_cov if best is None else max(best, p.cv_cov)
        return best
