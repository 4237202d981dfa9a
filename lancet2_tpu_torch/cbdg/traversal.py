"""Frozen-graph CSR traversal index + three-color cycle detection.

Reference: src/lancet/cbdg/traversal_index.{h,cpp}, cycle_finder.cpp.

Traversal state = node_flat_idx * 2 + sign_offset (0 for PLUS, 1 for MINUS):
a node reached via '+' and via '-' are distinct states, which is how the
BCALM2 sign-continuity rule (edge_i.DstSign == edge_{i+1}.SrcSign) falls out
of plain adjacency iteration.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NO_PARENT = 0xFFFFFFFF


@dataclass
class TraversalIndex:
    adj_ranges: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int64))
    adj_dst_state: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    adj_ordinal: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    orig_edges: list = field(default_factory=list)
    node_ids: list = field(default_factory=list)
    nodes: list = field(default_factory=list)
    src_state: int = 0
    snk_node_idx: int = 0

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_states(self) -> int:
        return len(self.adj_ranges)

    def is_sink_state(self, state: int) -> bool:
        return state // 2 == self.snk_node_idx

    @staticmethod
    def make_state(node_idx: int, sign: int) -> int:
        return node_idx * 2 + sign

    def out_edges(self, state: int):
        start, count = self.adj_ranges[state]
        return [
            (int(self.adj_dst_state[i]), int(self.adj_ordinal[i]))
            for i in range(start, start + count)
        ]


def build_traversal_index(nodes: dict, source_sink: tuple[int, int], comp_id: int) -> TraversalIndex:
    """Flatten one component into contiguous CSR adjacency (deterministic order)."""
    idx = TraversalIndex()
    nid_to_flat: dict[int, int] = {}
    for nid, node in nodes.items():
        if node.comp_id != comp_id:
            continue
        nid_to_flat[nid] = len(idx.nodes)
        idx.nodes.append(node)
        idx.node_ids.append(nid)

    num_states = 2 * len(idx.nodes)
    counts = np.zeros(num_states, dtype=np.int64)
    for flat, node in enumerate(idx.nodes):
        for edge in node.edges:
            if edge.dst not in nid_to_flat:
                continue
            counts[TraversalIndex.make_state(flat, edge.src_sign)] += 1

    starts = np.zeros(num_states, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    idx.adj_ranges = np.stack([starts, np.zeros_like(counts)], axis=1)
    total = int(counts.sum())
    idx.adj_dst_state = np.zeros(total, dtype=np.int64)
    idx.adj_ordinal = np.zeros(total, dtype=np.int64)

    edge_to_ordinal: dict = {}
    for flat, node in enumerate(idx.nodes):
        for edge in node.edges:
            dst_flat = nid_to_flat.get(edge.dst)
            if dst_flat is None:
                continue
            src_state = TraversalIndex.make_state(flat, edge.src_sign)
            dst_state = TraversalIndex.make_state(dst_flat, edge.dst_sign)
            ordinal = edge_to_ordinal.get(edge)
            if ordinal is None:
                ordinal = len(idx.orig_edges)
                edge_to_ordinal[edge] = ordinal
                idx.orig_edges.append(edge)
            start, cnt = idx.adj_ranges[src_state]
            idx.adj_dst_state[start + cnt] = dst_state
            idx.adj_ordinal[start + cnt] = ordinal
            idx.adj_ranges[src_state, 1] += 1

    source_id, sink_id = source_sink
    src_flat = nid_to_flat[source_id]
    snk_flat = nid_to_flat[sink_id]
    idx.src_state = TraversalIndex.make_state(src_flat, idx.nodes[src_flat].sign_for(True))
    idx.snk_node_idx = snk_flat
    return idx


def has_cycle(idx: TraversalIndex) -> bool:
    """Iterative three-color DFS from the source state; True on any back edge."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = np.zeros(idx.num_states, dtype=np.uint8)
    color[idx.src_state] = GRAY
    stack: list[list[int]] = [[idx.src_state, 0]]
    while stack:
        frame = stack[-1]
        state = frame[0]
        start, count = idx.adj_ranges[state]
        if frame[1] >= count:
            color[state] = BLACK
            stack.pop()
            continue
        dst = int(idx.adj_dst_state[start + frame[1]])
        frame[1] += 1
        if color[dst] == GRAY:
            return True
        if color[dst] != WHITE:
            continue
        color[dst] = GRAY
        stack.append([dst, 0])
    return False
