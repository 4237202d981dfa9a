from lancet2_tpu_torch.cbdg.graph import Edge, Graph, GraphParams, Node
from lancet2_tpu_torch.cbdg.path import ComponentResult, EnumeratedHaplotype, Path
from lancet2_tpu_torch.cbdg.read import LABEL_CASE, LABEL_CTRL, LABEL_REFERENCE, Read
from lancet2_tpu_torch.cbdg.complexity import GraphComplexity, compute_component_complexity

__all__ = [
    "Edge",
    "Graph",
    "GraphParams",
    "Node",
    "ComponentResult",
    "EnumeratedHaplotype",
    "Path",
    "Read",
    "LABEL_CASE",
    "LABEL_CTRL",
    "LABEL_REFERENCE",
    "GraphComplexity",
    "compute_component_complexity",
]
