"""Graphviz DOT rendering of de Bruijn graph components + snapshot buffering.

Reference: src/lancet/cbdg/dot_renderer.cpp, dot_plan.h, dot_layers.h,
dot_snapshot_buffer.{h,cpp} and graph.cpp BufferFinalSnapshot /
BufferStageSnapshot. Nodes are colored by role (REF / CTRL / CASE / shared),
source/sink anchors outlined, and enumerated walks overlaid as colored edge
layers. Snapshots buffer in memory per window and only commit to the
per-worker shard when a k-attempt succeeds, so abandoned attempts leave no
artifacts.
"""

from __future__ import annotations

from lancet2_tpu_torch.cbdg.read import LABEL_CASE, LABEL_CTRL, LABEL_REFERENCE

_WALK_PALETTE = [
    "#1b9e77", "#d95f02", "#7570b3", "#e7298a", "#66a61e",
    "#e6ab02", "#a6761d", "#666666",
]


def _node_color(node) -> str:
    has_ref = node.has_tag(LABEL_REFERENCE)
    has_ctrl = node.has_tag(LABEL_CTRL)
    has_case = node.has_tag(LABEL_CASE)
    if has_ref:
        return "lightblue"
    if has_ctrl and has_case:
        return "khaki"
    if has_case:
        return "salmon"
    if has_ctrl:
        return "palegreen"
    return "white"


def render_component_dot(
    graph, comp_id: int, name: str, walks=None, probe_node_ids=None
) -> str:
    """Serialize one component to a DOT string with anchor/walk overlays."""
    source_id, sink_id = graph.source_sink
    lines = [f'digraph "{name}" {{', "  rankdir=LR;", "  node [shape=box, style=filled];"]
    seen_edges = set()
    for nid, node in graph.nodes.items():
        if node.comp_id != comp_id:
            continue
        label = f"{node.seq_len}bp\\ncov={node.total_support()}"
        attrs = [f'fillcolor="{_node_color(node)}"', f'label="{label}"']
        if nid == source_id:
            attrs.append('color="blue" penwidth=3 xlabel="SOURCE"')
        elif nid == sink_id:
            attrs.append('color="red" penwidth=3 xlabel="SINK"')
        if probe_node_ids and nid in probe_node_ids:
            attrs.append('peripheries=2 color="magenta"')
        lines.append(f'  n{nid:x} [{" ".join(attrs)}];')
        for edge in node.edges:
            key = (min(edge.src, edge.dst), max(edge.src, edge.dst), edge.kind)
            mirror_key = (key[0], key[1], edge.mirror().kind)
            if key in seen_edges or mirror_key in seen_edges:
                continue
            seen_edges.add(key)
            sign = "+-"[edge.src_sign] + "+-"[edge.dst_sign]
            lines.append(f'  n{edge.src:x} -> n{edge.dst:x} [label="{sign}"];')

    for widx, walk in enumerate(walks or []):
        color = _WALK_PALETTE[widx % len(_WALK_PALETTE)]
        for edge in walk:
            lines.append(
                f'  n{edge.src:x} -> n{edge.dst:x} '
                f'[color="{color}" penwidth=2 style=dashed];'
            )
    lines.append("}")
    return "\n".join(lines) + "\n"


class DotSnapshotBuffer:
    """Buffer DOT snapshots in memory; commit only on a successful k-attempt."""

    def __init__(self):
        self._pending: list[tuple[str, str]] = []
        self.window_subdir = ""

    def set_window_subdir(self, subdir: str) -> None:
        self.window_subdir = subdir

    def buffer(self, filename: str, contents: str) -> None:
        self._pending.append((filename, contents))

    def discard(self) -> None:
        self._pending.clear()

    def commit(self, shard_writer, top_dir: str = "dbg_graph") -> None:
        for filename, contents in self._pending:
            path = f"{top_dir}/{self.window_subdir}/{filename}"
            shard_writer.add_file(path, contents.encode())
        self._pending.clear()
