"""Per-component graph-topology metrics + the complexity guard.

Reference: src/lancet/cbdg/graph_complexity.{h,cpp}. The CC>=50 AND BP>=50
guard retries at a larger k, removing the measured ~14x pathological-window
tail (thresholds derived from chr4 profiling, see reference header).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from lancet2_tpu_torch.base.stats import OnlineStats

MAX_CYCLOMATIC_COMPLEXITY = 50
MAX_BRANCH_POINTS = 50


@dataclass
class GraphComplexity:
    cyclomatic_complexity: int = 0  # E - V + 1
    num_branch_points: int = 0
    max_single_dir_degree: int = 0
    unitig_ratio: float = 0.0
    coverage_cv: float = 0.0
    tip_to_path_cov_ratio: float = 0.0

    @property
    def is_complex(self) -> bool:
        return (
            self.cyclomatic_complexity >= MAX_CYCLOMATIC_COMPLEXITY
            and self.num_branch_points >= MAX_BRANCH_POINTS
        )

    def graph_entanglement_index(self) -> float:
        """GEI = log10(1 + CC*BP*CovCV / (UnitigRatio + eps))."""
        eps = 1e-6
        raw = (
            self.cyclomatic_complexity
            * self.num_branch_points
            * self.coverage_cv
            / (self.unitig_ratio + eps)
        )
        return math.log10(1.0 + raw)


def compute_component_complexity(nodes: dict, comp_id: int) -> GraphComplexity:
    """O(V+E) metrics for a single component (reference: ComputeGraphComplexity)."""
    cplx = GraphComplexity()
    num_nodes = 0
    num_edges = 0
    unitig_nodes = 0
    cov_stats = OnlineStats()
    tip_stats = OnlineStats()
    unitig_stats = OnlineStats()

    for node in nodes.values():
        if node.comp_id != comp_id:
            continue
        num_nodes += 1
        dflt_sign = node.sign_for(True)
        dflt = sum(1 for e in node.edges if e.src_sign == dflt_sign)
        oppo = len(node.edges) - dflt
        num_edges += dflt + oppo
        cplx.max_single_dir_degree = max(cplx.max_single_dir_degree, max(dflt, oppo))
        if dflt >= 2 or oppo >= 2:
            cplx.num_branch_points += 1
        if dflt == 1 and oppo == 1:
            unitig_nodes += 1
        cov = float(node.total_support())
        cov_stats.add(cov)
        if dflt == 0 or oppo == 0:
            tip_stats.add(cov)
        elif dflt == 1 and oppo == 1:
            unitig_stats.add(cov)

    num_edges //= 2  # each edge stored at both endpoints (forward + mirror)
    cplx.cyclomatic_complexity = num_edges - num_nodes + 1 if num_edges >= num_nodes else 0
    cplx.unitig_ratio = unitig_nodes / num_nodes if num_nodes else 0.0
    if not cov_stats.is_empty and cov_stats.mean > 0.0:
        cplx.coverage_cv = cov_stats.stddev / cov_stats.mean
    if not tip_stats.is_empty and not unitig_stats.is_empty and unitig_stats.mean > 0.0:
        cplx.tip_to_path_cov_ratio = tip_stats.mean / unitig_stats.mean
    return cplx
