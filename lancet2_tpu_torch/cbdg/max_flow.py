"""Sequential source->sink walk enumeration over the pruned graph.

Reference: src/lancet/cbdg/max_flow.{h,cpp}. Each next_path() call runs a BFS
over traversal states, building a parent-linked walk-tree arena; a walk is
accepted when it reaches the sink carrying at least one not-yet-traversed
edge ordinal. Branches are expanded in descending destination-node Confidence
order (untraversed edges first), so the first accepted walk follows the most
biologically prevalent topology. Bounded at 2^20 BFS visits.
"""

from __future__ import annotations

from collections import deque

from lancet2_tpu_torch.base.dna import decode
from lancet2_tpu_torch.cbdg.path import EnumeratedHaplotype, Path
from lancet2_tpu_torch.cbdg.traversal import NO_PARENT, TraversalIndex

DEFAULT_GRAPH_TRAVERSAL_LIMIT = 1 << 20


class MaxFlow:
    def __init__(self, nodes: dict, curr_k: int, trav_idx: TraversalIndex, num_samples: int):
        self.nodes = nodes
        self.curr_k = curr_k
        self.idx = trav_idx
        self.num_samples = num_samples
        self.traversed: set[int] = set()
        self.hit_traversal_limit = False
        # Cache per-node confidence: walk enumeration queries it per expansion.
        self._conf = [node.confidence(num_samples) for node in trav_idx.nodes]

    def next_path(self) -> EnumeratedHaplotype | None:
        idx = self.idx
        # arena columns: edge_ordinal, dst_state, parent, score
        arena: list[tuple[int, int, int, int]] = []
        frontier: deque[int] = deque()
        self._enqueue(idx.src_state, NO_PARENT, 0, arena, frontier)

        nvisits = 0
        best_leaf = None
        while frontier:
            nvisits += 1
            if nvisits > DEFAULT_GRAPH_TRAVERSAL_LIMIT:
                self.hit_traversal_limit = True
                break
            ai = frontier.popleft()
            ordinal, dst_state, parent, score = arena[ai]
            if idx.is_sink_state(dst_state):
                if score == 0:
                    continue
                best_leaf = ai
                break
            self._enqueue(dst_state, ai, score, arena, frontier)

        if best_leaf is None:
            return None

        # Reconstruct walk leaf->root; mark ordinals traversed.
        edges = []
        ai = best_leaf
        while ai != NO_PARENT:
            ordinal, _dst, parent, _score = arena[ai]
            edges.append(idx.orig_edges[ordinal])
            self.traversed.add(ordinal)
            ai = parent
        edges.reverse()
        return self._build_sequence(edges)

    def _enqueue(self, state: int, parent_ai: int, parent_score: int, arena, frontier) -> None:
        outs = self.idx.out_edges(state)
        if not outs:
            return
        # Descending destination Confidence (stable -> deterministic).
        outs.sort(key=lambda e: -self._conf[e[0] // 2])
        for dst_state, ordinal in outs:
            if ordinal in self.traversed:
                continue
            arena.append((ordinal, dst_state, parent_ai, parent_score + 1))
            frontier.append(len(arena) - 1)
        for dst_state, ordinal in outs:
            if ordinal not in self.traversed:
                continue
            arena.append((ordinal, dst_state, parent_ai, parent_score))
            frontier.append(len(arena) - 1)

    def _build_sequence(self, walk) -> EnumeratedHaplotype | None:
        """Concatenate k-1-overlap node sequences along the walk
        (reference: MaxFlow::BuildSequence)."""
        if not walk:
            return None
        path = Path()
        k = self.curr_k
        pieces: list[str] = []
        first = walk[0]
        src_node = self.nodes[first.src]
        # PLUS endpoint sign selects the canonical (DEFAULT) orientation.
        seq = src_node.sequence_for(first.src_sign == 0)
        pieces.append(decode(seq))
        path.add_node_coverage(src_node.total_support())
        path.add_node_weight(src_node.confidence(self.num_samples), len(seq))
        for conn in walk:
            dst_node = self.nodes[conn.dst]
            dseq = dst_node.sequence_for(conn.dst_sign == 0)
            uniq = dseq[k - 1 :]
            pieces.append(decode(uniq))
            path.add_node_coverage(dst_node.total_support())
            path.add_node_weight(dst_node.confidence(self.num_samples), len(uniq))
        path.append_sequence("".join(pieces))
        path.finalize()
        return EnumeratedHaplotype(path=path, walk=list(walk))
