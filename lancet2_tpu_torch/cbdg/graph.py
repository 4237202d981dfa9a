"""Colored bidirected de Bruijn graph: construction, pruning, k-retry loop.

Re-implements the semantics of the reference assembly core
(reference: src/lancet/cbdg/graph.{h,cpp}) with a TPU-first split:

  * k-mer counting / canonicalization / expected-error filtering / mate-mer
    dedup run fully vectorized over numpy arrays (one batch per window); the
    same formulation maps 1:1 onto a device pipeline (sort + segment-sum
    over padded batches), which this package does not port yet.
  * the *pruned* graph (typically 10^2..10^3 nodes) is materialized as Python
    node objects for compression / tip removal / walk enumeration, whose
    observable output is the haplotype sequence set.

Pipeline per window (reference: graph.cpp:106-235):
  for k in min_k..max_k step k_step:
    skip k if reference window has an exact/approx (<=2 mismatch) k-mer repeat
    build graph from ref + reads (k+1-mers -> nodes + bidirected edges)
    remove low-coverage nodes; mark connected components (desc. by size)
    per component: source/sink ref anchors (>=150bp apart), prune
      (compress -> lowcov -> compress -> tips), CSR traversal index,
      cycle check -> retry k, complexity guard (CC>=50 & BP>=50) -> retry k,
      confidence-ordered walk enumeration -> haplotypes
    stop at first k that yields results
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from lancet2_tpu_torch.base.dna import decode, revcomp_codes
from lancet2_tpu_torch.base.phred import PHRED_TO_ERROR_PROB
from lancet2_tpu_torch.base.repeat import has_approx_repeat
from lancet2_tpu_torch.base.stats import median_u32
from lancet2_tpu_torch.cbdg.complexity import GraphComplexity, compute_component_complexity
from lancet2_tpu_torch.cbdg.kmer import (
    MINUS,
    PLUS,
    canonicalize_batch,
    dst_sign,
    flip_sign,
    kmer_ids,
    make_kind,
    merge_codes,
    rev_kind,
    src_sign,
)
from lancet2_tpu_torch.cbdg.max_flow import MaxFlow
from lancet2_tpu_torch.cbdg.path import ComponentResult, EnumeratedHaplotype, Path
from lancet2_tpu_torch.cbdg.read import LABEL_CASE, LABEL_CTRL, LABEL_REFERENCE, Read
from lancet2_tpu_torch.cbdg.traversal import build_traversal_index, has_cycle

DEFAULT_MIN_KMER_LEN = 13
DEFAULT_MAX_KMER_LEN = 127
DEFAULT_KMER_STEP_LEN = 6
DEFAULT_MIN_NODE_COV = 2
DEFAULT_MIN_ANCHOR_COV = 5
DEFAULT_MIN_ANCHOR_LENGTH = 150


_REV_KIND = (3, 1, 2, 0)


class Edge(NamedTuple):
    src: int
    dst: int
    kind: int

    def mirror(self) -> "Edge":
        return Edge(self.dst, self.src, _REV_KIND[self.kind])

    @property
    def is_self_loop(self) -> bool:
        return self.src == self.dst

    @property
    def src_sign(self) -> int:
        return self.kind >> 1

    @property
    def dst_sign(self) -> int:
        return self.kind & 1


class Node:
    """Graph node: canonical (possibly unitig-merged) sequence + colors."""

    __slots__ = ("nid", "codes", "sign", "label", "comp_id", "counts", "role_counts", "edges")

    def __init__(self, nid: int, codes: np.ndarray, sign: int, label: int, num_samples: int):
        self.nid = nid
        self.codes = codes
        self.sign = sign  # sign labeling the canonical (DEFAULT) orientation
        self.label = label
        self.comp_id = 0
        self.counts = np.zeros(num_samples, dtype=np.int64)
        self.role_counts = [0, 0]  # [CTRL, CASE]
        self.edges: list[Edge] = []

    # -- sequence ---------------------------------------------------------
    @property
    def seq_len(self) -> int:
        return len(self.codes)

    def sequence_for(self, ordering_default: bool) -> np.ndarray:
        return self.codes if ordering_default else revcomp_codes(self.codes)

    def sign_for(self, ordering_default: bool) -> int:
        return self.sign if ordering_default else flip_sign(self.sign)

    # -- colors / support -------------------------------------------------
    def has_tag(self, tag: int) -> bool:
        return bool(self.label & tag)

    def total_support(self) -> int:
        return int(self.counts.sum())

    def support_for_role(self, tag: int) -> int:
        return self.role_counts[1 if tag == LABEL_CASE else 0]

    def is_all_singletons(self) -> bool:
        return bool((self.counts > 0).any()) and bool((self.counts <= 1).all())

    def confidence(self, num_samples: int) -> int:
        """floor(total * concordance) + ref_bonus (reference: Node::Confidence)."""
        if self.is_all_singletons():
            return 1
        total = self.total_support()
        if total == 0:
            return 0
        confirming = int((self.counts > 0).sum())
        concordance = confirming / max(num_samples, 1)
        ref_bonus = 1 if self.has_tag(LABEL_REFERENCE) else 0
        return int(total * concordance) + ref_bonus

    # -- edges ------------------------------------------------------------
    def emplace_edge(self, edge: Edge) -> None:
        if edge not in self.edges:
            self.edges.append(edge)

    def erase_edge(self, edge: Edge) -> None:
        try:
            self.edges.remove(edge)
        except ValueError:
            pass

    @property
    def num_out_edges(self) -> int:
        return len(self.edges)

    def has_self_loop(self) -> bool:
        return any(e.is_self_loop for e in self.edges)

    def edges_in_direction(self, ordering_default: bool) -> list[Edge]:
        want = self.sign_for(ordering_default)
        return [e for e in self.edges if e.src_sign == want]

    # -- merging (unitig compaction) --------------------------------------
    def merge(self, other: "Node", kind: int, k: int) -> None:
        """Absorb `other` along a connecting edge (reference: Node::Merge).

        Sequence merge follows the BCALM2 MergeCords rules; per-sample counts
        and role counts become length-weighted averages of the two nodes.
        """
        this_len = self.seq_len
        other_len = other.seq_len
        self.codes = merge_codes(self.codes, other.codes, kind, k)
        self.label |= other.label
        total_len = this_len + other_len
        self.counts = (
            (self.counts.astype(np.int64) * this_len + other.counts.astype(np.int64) * other_len)
            // total_len
        )
        self.role_counts = [
            (self.role_counts[i] * this_len + other.role_counts[i] * other_len) // total_len
            for i in range(2)
        ]


@dataclass
class GraphParams:
    min_kmer_len: int = DEFAULT_MIN_KMER_LEN
    max_kmer_len: int = DEFAULT_MAX_KMER_LEN
    kmer_step_len: int = DEFAULT_KMER_STEP_LEN
    min_node_cov: int = DEFAULT_MIN_NODE_COV
    min_anchor_cov: int = DEFAULT_MIN_ANCHOR_COV
    num_samples: int = 0
    # 'final' = one DOT per component per window; 'verbose' additionally
    # snapshots every pruning boundary (reference GraphSnapshotMode)
    snapshot_mode: str = "final"
    # construction backend: 'auto' (native C++ then numpy), 'native',
    # 'numpy', 'device' (the tape-packed torch pass, ops/graph_tape.py, on
    # build_device; never chosen by 'auto')
    build_backend: str = "auto"
    # torch device of the 'device' backend, by name (phase A imports torch
    # only when that backend runs); the batch executor's forked prep
    # workers keep "cpu"
    build_device: str = "cpu"


class _RefAnchor(NamedTuple):
    anchor_id: int
    ref_offset: int
    found: bool


@dataclass
class _ComponentInfo:
    comp_id: int
    num_nodes: int = 0


class Graph:
    """Per-window colored bidirected de Bruijn graph (one per worker)."""

    def __init__(self, params: GraphParams, probe_tracker=None, shard_writer=None):
        self.params = params
        self.nodes: dict[int, Node] = {}
        self.ref_node_ids: list[int] = []
        self.source_sink = (0, 0)
        self.curr_k = 0
        self.probe_tracker = probe_tracker
        # graph-snapshot observability (reference: --out-graphs-tgz): DOT
        # renders buffer per k-attempt and commit only on success
        self.shard_writer = shard_writer
        from lancet2_tpu_torch.cbdg.dot import DotSnapshotBuffer

        self.dot_buffer = DotSnapshotBuffer()

    # ------------------------------------------------------------------
    # Entry point: k-retry cascade (reference: Graph::BuildComponentResults)
    # ------------------------------------------------------------------
    def build_component_results(
        self, ref_codes: np.ndarray, reads: list[Read], window_name: str = ""
    ) -> list[ComponentResult]:
        params = self.params
        results: list[ComponentResult] = []
        k = params.min_kmer_len - params.kmer_step_len
        probe = self.probe_tracker
        self.dot_buffer.set_window_subdir(window_name or "window")

        while not results and (k + params.kmer_step_len) <= params.max_kmer_len:
            k += params.kmer_step_len
            self.curr_k = k
            self.source_sink = (0, 0)
            self.dot_buffer.discard()

            # de Bruijn graph over a repeat-bearing reference would contain a
            # cycle by construction — skip this k outright.
            if has_approx_repeat(ref_codes, k, max_mismatch=2):
                continue

            # fast path: fused native build+lowcov+components+anchors+prune
            # (one C++ call, GIL released; Python materializes only the
            # pruned nodes). Instrumented runs (probe / graph snapshots)
            # take the stepwise path below.
            if (probe is None and self.shard_writer is None
                    and params.build_backend in ("auto", "native")):
                handled, retry_k = self._assemble_native_k(
                    ref_codes, reads, k, results
                )
                if handled:
                    if retry_k:
                        results.clear()
                        continue
                    continue

            self._build_graph(ref_codes, reads, k)
            if probe is not None:
                probe.on_graph_built(self, k)
            self._remove_low_cov_nodes(0)
            if probe is not None:
                probe.log_stage("lowcov1", self, k)
            components = self._mark_connected_components()

            retry_k = False
            for cinfo in components:
                comp_id = cinfo.comp_id
                source = self._find_source(comp_id)
                sink = self._find_sink(comp_id)
                if not source.found or not sink.found or source.anchor_id == sink.anchor_id:
                    if probe is not None:
                        probe.set_status(comp_id, "no_anchor")
                    continue
                anchor_len = sink.ref_offset - source.ref_offset + k
                if anchor_len < DEFAULT_MIN_ANCHOR_LENGTH:
                    if probe is not None:
                        probe.set_status(comp_id, "short_anchor")
                    continue

                self.source_sink = (source.anchor_id, sink.anchor_id)
                ref_anchor_codes = ref_codes[source.ref_offset : source.ref_offset + anchor_len]
                self._prune_component(comp_id, probe, k)

                trav = build_traversal_index(self.nodes, self.source_sink, comp_id)
                if has_cycle(trav):
                    if probe is not None:
                        probe.set_status(comp_id, "cycle")
                    retry_k = True
                    break

                gcplx = compute_component_complexity(self.nodes, comp_id)
                if gcplx.is_complex:
                    if probe is not None:
                        probe.set_status(comp_id, "complex")
                    retry_k = True
                    break

                haps = self._build_haplotypes(comp_id, trav, ref_anchor_codes, probe)
                if probe is not None:
                    probe.check_paths(haps, comp_id, k)
                self._buffer_final_snapshot(comp_id, haps, k)
                if not haps:
                    continue
                results.append(ComponentResult(haps, gcplx, source.ref_offset))

            if retry_k:
                results.clear()
                self.dot_buffer.discard()
                continue

        if self.shard_writer is not None:
            self.dot_buffer.commit(self.shard_writer)
        return results

    def _assemble_native_k(self, ref_codes, reads, k: int, results) -> tuple:
        """One fused native (build+lowcov+components+anchors+prune) attempt.

        Returns (handled, retry_k). handled=False => native unavailable,
        caller runs the stepwise Python/numpy path. On success the node
        table holds ONLY the pruned passing components and `results` is
        extended with their enumerated haplotypes (bit-identical to the
        stepwise path — tested in tests/test_native_prune.py)."""
        from lancet2_tpu_torch.base import native_core

        if not native_core.available():
            return False, False
        # guard against a stale/default num_samples=0: the native pass sizes
        # per-sample count arrays from it, and an out-of-range sample_index
        # would write past the buffer (segfault, not an exception)
        num_samples = max(
            self.params.num_samples,
            max((r.sample_index + 1 for r in reads), default=0),
        )
        seqs: list[np.ndarray] = []
        quals: list[np.ndarray | None] = []
        meta: list[tuple[int, int, int, int]] = []
        if len(ref_codes) >= k + 1:
            seqs.append(np.asarray(ref_codes, dtype=np.uint8))
            quals.append(None)
            meta.append((LABEL_REFERENCE, -1, 0, 0))
        for read in reads:
            if not read.passes_aln_filters or len(read.codes) < k + 1:
                continue
            seqs.append(read.codes)
            quals.append(read.qual)
            meta.append((read.tag, read.sample_index, read.tag, read.qname_hash))
        self.nodes = {}
        self.ref_node_ids = []
        if not seqs:
            return True, False

        n_seqs = len(seqs)
        offsets = np.zeros(n_seqs + 1, dtype=np.int64)
        np.cumsum([len(c) for c in seqs], out=offsets[1:])
        codes_buf = np.concatenate(seqs).astype(np.uint8, copy=False)
        quals_buf = np.concatenate([
            q if q is not None and q.dtype == np.uint8
            else (np.clip(q, 0, 255).astype(np.uint8) if q is not None
                  else np.zeros(len(s), np.uint8))
            for q, s in zip(quals, seqs)
        ]) if n_seqs else np.zeros(0, np.uint8)
        labels = np.zeros(n_seqs, dtype=np.uint8)
        is_read = np.zeros(n_seqs, dtype=np.uint8)
        sample_idx = np.zeros(n_seqs, dtype=np.int32)
        tags = np.zeros(n_seqs, dtype=np.uint8)
        qhashes = np.zeros(n_seqs, dtype=np.uint64)
        for si, (label, sidx, tag, qh) in enumerate(meta):
            labels[si] = label
            tags[si] = tag
            qhashes[si] = np.uint64(qh)
            if label != LABEL_REFERENCE:
                is_read[si] = 1
                sample_idx[si] = sidx

        # fully-native post-prune path: traversal/cycle/complexity/walks run
        # in C++ and no Python node objects are ever materialized (bit-exact
        # vs the stepwise path, tests/test_native_walks.py); falls back to
        # assemble_pass + Python walks on capacity overflow
        full = native_core.assemble_full(
            codes_buf, offsets, quals_buf, labels, is_read, sample_idx, tags,
            qhashes, PHRED_TO_ERROR_PROB, k, num_samples,
            self.params.min_node_cov, LABEL_CASE, LABEL_REFERENCE,
            self.params.min_anchor_cov, DEFAULT_MIN_ANCHOR_LENGTH,
        )
        if full is not None:
            if full["retry"]:
                return True, True
            if full["n_comps"] == 0:
                return True, False
            self._materialize_full_results(full, ref_codes, results)
            return True, False

        out = native_core.assemble_pass(
            codes_buf, offsets, quals_buf, labels, is_read, sample_idx, tags,
            qhashes, PHRED_TO_ERROR_PROB, k, num_samples,
            self.params.min_node_cov, LABEL_CASE, LABEL_REFERENCE,
            self.params.min_anchor_cov, DEFAULT_MIN_ANCHOR_LENGTH,
        )
        if out is None:
            return False, False
        if out["n_comps"] == 0:
            return True, False

        # materialize pruned survivors (comp-grouped, within-comp original
        # table order — traversal/walk determinism depends on it)
        n_nodes = out["n_nodes"]
        for i in range(n_nodes):
            nid = int(out["nid"][i])
            node = Node(
                nid,
                np.ascontiguousarray(
                    out["seq"][out["seq_off"][i] : out["seq_off"][i + 1]]
                ),
                int(out["sign"][i]),
                int(out["label"][i]),
                num_samples,
            )
            node.counts = out["counts"][i].copy()
            node.role_counts = [int(out["roles"][i, 0]), int(out["roles"][i, 1])]
            node.comp_id = int(out["comp"][i])
            node.edges = [
                Edge(nid, int(out["e_dst"][e]), int(out["e_kind"][e]))
                for e in range(int(out["e_off"][i]), int(out["e_off"][i + 1]))
            ]
            self.nodes[nid] = node

        for c in range(out["n_comps"]):
            comp_id = int(out["c_id"][c])
            src_off = int(out["c_src_off"][c])
            anchor_len = int(out["c_anchor_len"][c])
            self.source_sink = (int(out["c_source"][c]), int(out["c_sink"][c]))
            ref_anchor_codes = ref_codes[src_off : src_off + anchor_len]

            trav = build_traversal_index(self.nodes, self.source_sink, comp_id)
            if has_cycle(trav):
                return True, True
            gcplx = compute_component_complexity(self.nodes, comp_id)
            if gcplx.is_complex:
                return True, True
            haps = self._build_haplotypes(comp_id, trav, ref_anchor_codes, None)
            if not haps:
                continue
            results.append(ComponentResult(haps, gcplx, src_off))
        return True, False

    def _materialize_full_results(self, full: dict, ref_codes, results) -> None:
        """Build ComponentResults from l2t_assemble_full's flat hap arrays.

        Path objects (float stats incl. finalize()) are reconstructed in
        Python from the raw coverage/weight arrays, so every downstream
        value is computed by the same code as the stepwise path. Walks are
        not carried (the fast path runs only with snapshots/probe off, the
        sole walk consumers)."""
        h_comp = full["h_comp"]
        h_seq, h_seq_off = full["h_seq"], full["h_seq_off"]
        h_cov, h_cov_off = full["h_cov"], full["h_cov_off"]
        h_wt_w, h_wt_n = full["h_wt_w"], full["h_wt_n"]
        n_haps = full["n_haps"]
        haps_by_comp: dict[int, list[EnumeratedHaplotype]] = {}
        for hi in range(n_haps):
            path = Path()
            path.sequence = decode(h_seq[h_seq_off[hi] : h_seq_off[hi + 1]])
            lo, hi2 = int(h_cov_off[hi]), int(h_cov_off[hi + 1])
            path.node_coverages = [int(x) for x in h_cov[lo:hi2]]
            path.node_weights = [
                (int(w), int(n)) for w, n in zip(h_wt_w[lo:hi2], h_wt_n[lo:hi2])
            ]
            path.finalize()
            haps_by_comp.setdefault(int(h_comp[hi]), []).append(
                EnumeratedHaplotype(path=path, walk=[])
            )
        for c in range(full["n_comps"]):
            haps = haps_by_comp.get(c, [])
            if not haps:
                continue
            src_off = int(full["c_src_off"][c])
            anchor_len = int(full["c_anchor_len"][c])
            m = full["c_metrics"][c]
            gcplx = GraphComplexity(
                cyclomatic_complexity=int(m[0]),
                num_branch_points=int(m[1]),
                max_single_dir_degree=int(m[2]),
                unitig_ratio=float(m[3]),
                coverage_cv=float(m[4]),
                tip_to_path_cov_ratio=float(m[5]),
            )
            ref_anchor_seq = decode(ref_codes[src_off : src_off + anchor_len])
            haps = self._finalize_haplotypes(
                haps, ref_anchor_seq, int(full["c_ref_weight"][c])
            )
            results.append(ComponentResult(haps, gcplx, src_off))

    def _buffer_final_snapshot(self, comp_id: int, haps, k: int) -> None:
        if self.shard_writer is None:
            return
        from lancet2_tpu_torch.cbdg.dot import render_component_dot

        stage = "enumerated_walks" if haps else "fully_pruned"
        fname = f"dbg__{self.dot_buffer.window_subdir}__{stage}__k{k}__comp{comp_id}.dot"
        walks = [h.walk for h in haps if h.walk]
        contents = render_component_dot(self, comp_id, fname[:-4], walks=walks)
        self.dot_buffer.buffer(fname, contents)

    # ------------------------------------------------------------------
    # Phase 1: vectorized construction
    # ------------------------------------------------------------------
    def _build_graph(self, ref_codes: np.ndarray, reads: list[Read], k: int) -> None:
        self.nodes = {}
        self.ref_node_ids = []
        # same oob guard as _assemble_native_k: sample_index must fit the
        # per-sample count arrays even when params.num_samples is unset
        num_samples = max(
            self.params.num_samples,
            max((r.sample_index + 1 for r in reads), default=0),
        )

        seqs: list[np.ndarray] = []
        seq_quals: list[np.ndarray | None] = []
        seq_meta: list[tuple[int, int, int, int]] = []  # (label, sample_idx, tag, qhash)
        if len(ref_codes) >= k + 1:
            seqs.append(np.asarray(ref_codes, dtype=np.uint8))
            seq_quals.append(None)
            seq_meta.append((LABEL_REFERENCE, -1, 0, 0))
        for read in reads:
            if not read.passes_aln_filters or len(read.codes) < k + 1:
                continue
            seqs.append(read.codes)
            seq_quals.append(read.qual)
            seq_meta.append((read.tag, read.sample_index, read.tag, read.qname_hash))
        if not seqs:
            return

        backend = getattr(self.params, "build_backend", "auto")
        if backend == "device":
            self._build_graph_tape(seqs, seq_quals, seq_meta, k, num_samples)
            return
        if backend != "numpy":
            if self._build_graph_native(seqs, seq_quals, seq_meta, k, num_samples):
                return

        # K-merize every sequence; collect global occurrence arrays.
        kmer_blocks = []
        occ_seq_idx = []
        occ_ee_ok = []
        kept_reads = iter([r for r in reads if r.passes_aln_filters and len(r.codes) >= k + 1])
        for si, codes in enumerate(seqs):
            m = len(codes) - k + 1
            kmer_blocks.append(np.lib.stride_tricks.sliding_window_view(codes, k))
            occ_seq_idx.append(np.full(m, si, dtype=np.int64))
            if seq_meta[si][0] == LABEL_REFERENCE:
                occ_ee_ok.append(np.zeros(m, dtype=bool))  # ref adds nodes, no support
            else:
                # Expected-error k-mer filter: floor(sum of error probs) > 0
                # excludes the k-mer from read support (reference:
                # graph.cpp:296-304). Prefix sums give O(1) range queries.
                read = next(kept_reads)
                errs = PHRED_TO_ERROR_PROB[np.clip(read.qual, 0, 255)]
                prefix = np.concatenate([[0.0], np.cumsum(errs)])
                window_err = prefix[k:] - prefix[:-k]
                occ_ee_ok.append(np.floor(window_err[:m]) <= 0)

        all_kmers = np.concatenate(kmer_blocks, axis=0)
        seq_idx = np.concatenate(occ_seq_idx)
        ee_ok = np.concatenate(occ_ee_ok)

        canonical, occ_signs = canonicalize_batch(all_kmers)
        ids = kmer_ids(canonical)

        uniq_ids, first_idx, inverse = np.unique(ids, return_index=True, return_inverse=True)
        labels = np.array([seq_meta[si][0] for si in range(len(seqs))], dtype=np.int64)

        # --- ref path node ids (in ref kmer order) ------------------------
        if seq_meta and seq_meta[0][0] == LABEL_REFERENCE:
            ref_m = len(seqs[0]) - k + 1
            self.ref_node_ids = [int(i) for i in ids[:ref_m]]

        # --- read support: expected-error filter + mate-mer dedup --------
        # (fully vectorized; per-(node, sample) counts via bincount)
        n_uniq = uniq_ids.size
        count_matrix = np.zeros((n_uniq, num_samples), dtype=np.int64)
        role_matrix = np.zeros((n_uniq, 2), dtype=np.int64)
        read_occ = np.nonzero(ee_ok)[0]
        if read_occ.size:
            qhashes = np.array([seq_meta[si][3] for si in range(len(seqs))], dtype=np.uint64)
            tags = np.array([seq_meta[si][2] for si in range(len(seqs))], dtype=np.uint8)
            sample_idxs = np.array([seq_meta[si][1] for si in range(len(seqs))], dtype=np.int64)
            occ_q = qhashes[seq_idx[read_occ]]
            occ_tag = tags[seq_idx[read_occ]]
            occ_uidx = inverse[read_occ]
            occ_sample = sample_idxs[seq_idx[read_occ]]
            # MateMer dedup: one support increment per (qname, kmer, tag)
            # (reference: graph.cpp:290-307) — both mates of a pair count once.
            key = np.empty(read_occ.size, dtype=[("q", "u8"), ("i", "u8"), ("t", "u1")])
            key["q"] = occ_q
            key["i"] = ids[read_occ]
            key["t"] = occ_tag
            _, keep = np.unique(key, return_index=True)
            flat = occ_uidx[keep] * num_samples + occ_sample[keep]
            count_matrix = np.bincount(flat, minlength=n_uniq * num_samples).reshape(
                n_uniq, num_samples
            )
            role_flat = occ_uidx[keep] * 2 + (occ_tag[keep] == LABEL_CASE).astype(np.int64)
            role_matrix = np.bincount(role_flat, minlength=n_uniq * 2).reshape(n_uniq, 2)

        # --- vectorized pre-prune (equivalent to RemoveLowCovNodes(0)) ----
        # At this point source/sink are unset, so the low-cov pass removes
        # every all-singleton or below-threshold node; filtering before
        # materializing Python node objects skips the error-kmer bulk.
        totals = count_matrix.sum(axis=1)
        all_singleton = (count_matrix > 0).any(axis=1) & (count_matrix <= 1).all(axis=1)
        survives = (~all_singleton) & (totals >= self.params.min_node_cov)
        self.all_built_ids = set(int(i) for i in uniq_ids)  # probe 'build' stage

        # materialize survivors in first-occurrence order (deterministic)
        order = np.argsort(first_idx, kind="stable")
        for ui in order:
            if not survives[ui]:
                continue
            nid = int(uniq_ids[ui])
            fi = int(first_idx[ui])
            node = Node(
                nid,
                np.ascontiguousarray(canonical[fi]),
                int(occ_signs[fi]),
                int(labels[seq_idx[fi]]),
                num_samples,
            )
            node.counts = count_matrix[ui].copy()
            node.role_counts = [int(role_matrix[ui, 0]), int(role_matrix[ui, 1])]
            self.nodes[nid] = node

        # --- edges: unique ordered consecutive pairs among survivors ------
        pair_src_list = []
        pair_dst_list = []
        off = 0
        for si, codes in enumerate(seqs):
            m = len(codes) - k + 1
            if m >= 2:
                pair_src_list.append(ids[off : off + m - 1])
                pair_dst_list.append(ids[off + 1 : off + m])
            off += m
        if pair_src_list:
            pair_src = np.concatenate(pair_src_list)
            pair_dst = np.concatenate(pair_dst_list)
            pk = np.empty(pair_src.size, dtype=[("s", "u8"), ("d", "u8")])
            pk["s"] = pair_src
            pk["d"] = pair_dst
            uniq_pairs = np.unique(pk)
            for s_id, d_id in zip(uniq_pairs["s"], uniq_pairs["d"]):
                s_node = self.nodes.get(int(s_id))
                d_node = self.nodes.get(int(d_id))
                if s_node is None or d_node is None:
                    continue  # endpoint pre-pruned
                # Edge kind derives from the *stored* node signs — the sign each
                # node was first created with (reference: graph.cpp:333-336).
                kind = make_kind(s_node.sign, d_node.sign)
                fwd = Edge(int(s_id), int(d_id), kind)
                s_node.emplace_edge(fwd)
                d_node.emplace_edge(fwd.mirror())

    def _build_graph_tape(self, seqs, seq_quals, seq_meta, k: int,
                          num_samples: int) -> None:
        """Tape-packed device pass (ops/graph_tape.py) on
        params.build_device: the 'device' backend. A failure raises."""
        from lancet2_tpu_torch.ops.graph_tape import build_graphs_tape

        outs = build_graphs_tape([(seqs, seq_quals, seq_meta)], k,
                                 num_samples, self.params.build_device)
        self._materialize_tape_window(outs[0], seqs, seq_meta, k, num_samples)

    def _materialize_tape_window(self, out, seqs, seq_meta, k, num_samples):
        """Host materialization of one window's compact tape-pass output."""
        self.nodes = {}
        self.ref_node_ids = []
        if out is None:
            self.all_built_ids = set()
            return

        ids = out["ids"]
        counts = out["counts"]
        roles = out["roles"]
        signs = out["signs"]
        labels = out["labels"]

        if seq_meta and seq_meta[0][0] == LABEL_REFERENCE:
            self.ref_node_ids = [
                int(ids[r]) if r >= 0 else 0 for r in out["ref_rows"]
            ]
        self.all_built_ids = set(int(i) for i in ids)

        totals = counts.sum(axis=1)
        all_singleton = (counts > 0).any(axis=1) & (counts <= 1).all(axis=1)
        survives = (~all_singleton) & (totals >= self.params.min_node_cov)

        order = np.argsort(out["first_ord"], kind="stable")
        for ui in order:
            if not survives[ui]:
                continue
            nid = int(ids[ui])
            node = Node(
                nid,
                np.ascontiguousarray(out["codes"][ui]),
                int(signs[ui]),
                int(labels[ui]),
                num_samples,
            )
            node.counts = counts[ui].astype(np.int64)
            node.role_counts = [int(roles[ui, 0]), int(roles[ui, 1])]
            self.nodes[nid] = node

        self._add_edges(ids[out["edges"][:, 0]], ids[out["edges"][:, 1]])

    def _add_edges(self, src_ids, dst_ids) -> None:
        """Emplace each distinct (src, dst) id pair between surviving nodes,
        its kind from the nodes' stored signs, in id-pair order."""
        if not len(src_ids):
            return
        pk = np.empty(len(src_ids), dtype=[("s", "u8"), ("d", "u8")])
        pk["s"] = src_ids
        pk["d"] = dst_ids
        for s_id, d_id in np.unique(pk):
            s_node = self.nodes.get(int(s_id))
            d_node = self.nodes.get(int(d_id))
            if s_node is None or d_node is None:
                continue
            kind = make_kind(s_node.sign, d_node.sign)
            fwd = Edge(int(s_id), int(d_id), kind)
            s_node.emplace_edge(fwd)
            d_node.emplace_edge(fwd.mirror())

    def _build_graph_xla(self, seqs, seq_quals, seq_meta, k: int,
                         num_samples: int) -> None:
        """One-window device pass (ops/graph_tpu.py) on params.build_device,
        the twin of _build_graph_tape (the JAX package's first device pass;
        the 'device' backend takes the tape). A failure raises."""
        from lancet2_tpu_torch.ops.graph_tpu import build_graph_device

        out = build_graph_device(seqs, seq_quals, seq_meta, k, num_samples,
                                 self.params.build_device)
        if out is None:
            return  # no sequences: empty graph

        ids = out["ids"]
        counts = out["counts"]
        roles = out["roles"]
        first_idx = out["first_idx"]
        inverse = out["inverse"]
        occ_sign = out["occ_sign"]
        M = out["grid_m"]

        if seq_meta and seq_meta[0][0] == LABEL_REFERENCE:
            ref_m = len(seqs[0]) - k + 1
            self.ref_node_ids = [int(ids[u]) for u in inverse[0, :ref_m]]
        else:
            self.ref_node_ids = []
        self.all_built_ids = set(int(i) for i in ids)

        totals = counts.sum(axis=1)
        all_singleton = (counts > 0).any(axis=1) & (counts <= 1).all(axis=1)
        survives = (~all_singleton) & (totals >= self.params.min_node_cov)

        order = np.argsort(first_idx, kind="stable")
        for ui in order:
            if not survives[ui]:
                continue
            fi = int(first_idx[ui])
            si, pos = fi // M, fi % M
            nid = int(ids[ui])
            node = Node(
                nid,
                np.ascontiguousarray(out["codes"][ui]),
                int(occ_sign[si, pos]),
                int(seq_meta[si][0]),
                num_samples,
            )
            node.counts = counts[ui].astype(np.int64)
            node.role_counts = [int(roles[ui, 0]), int(roles[ui, 1])]
            self.nodes[nid] = node

        # edges from consecutive occurrence pairs (uniq-index space -> ids)
        src_list, dst_list = [], []
        for si, codes in enumerate(seqs):
            m = len(codes) - k + 1
            if m >= 2:
                src_list.append(inverse[si, : m - 1])
                dst_list.append(inverse[si, 1:m])
        if src_list:
            self._add_edges(ids[np.concatenate(src_list)],
                            ids[np.concatenate(dst_list)])

    def _build_graph_native(self, seqs, seq_quals, seq_meta, k: int,
                            num_samples: int) -> bool:
        """Native C++ construction pass (native/assembly_core.cpp) — bit-exact
        twin of the numpy path below (parity-tested in tests/test_native_core.py).
        Returns False when the native library is unavailable."""
        from lancet2_tpu_torch.base import native_core

        if not native_core.available():
            return False
        from lancet2_tpu_torch.base.dna import revcomp_codes
        from lancet2_tpu_torch.base.phred import PHRED_TO_ERROR_PROB

        n_seqs = len(seqs)
        offsets = np.zeros(n_seqs + 1, dtype=np.int64)
        for si, codes in enumerate(seqs):
            offsets[si + 1] = offsets[si] + len(codes)
        codes_buf = np.concatenate(seqs).astype(np.uint8, copy=False)
        quals_buf = np.zeros(offsets[-1], dtype=np.uint8)
        labels = np.zeros(n_seqs, dtype=np.uint8)
        is_read = np.zeros(n_seqs, dtype=np.uint8)
        sample_idx = np.zeros(n_seqs, dtype=np.int32)
        tags = np.zeros(n_seqs, dtype=np.uint8)
        qhashes = np.zeros(n_seqs, dtype=np.uint64)
        for si, (label, sidx, tag, qhash) in enumerate(seq_meta):
            labels[si] = label
            tags[si] = tag
            qhashes[si] = np.uint64(qhash)
            if label != LABEL_REFERENCE:
                is_read[si] = 1
                sample_idx[si] = sidx
                quals_buf[offsets[si] : offsets[si + 1]] = np.clip(
                    seq_quals[si], 0, 255
                )

        out = native_core.kmer_pass(
            codes_buf, offsets, quals_buf, labels, is_read, sample_idx, tags,
            qhashes, PHRED_TO_ERROR_PROB, k, num_samples,
            self.params.min_node_cov, LABEL_CASE,
        )
        if out is None:
            return False

        occ_ids = out["occ_ids"]
        # per-seq occurrence bases to map a global occ index back to (si, pos)
        ms = np.maximum(np.diff(offsets) - k + 1, 0)
        occ_base = np.concatenate([[0], np.cumsum(ms)])

        if seq_meta and seq_meta[0][0] == LABEL_REFERENCE:
            ref_m = int(ms[0])
            self.ref_node_ids = [int(i) for i in occ_ids[:ref_m]]
        else:
            self.ref_node_ids = []

        uniq_first = out["uniq_first"]
        uniq_ids = occ_ids[uniq_first]
        self.all_built_ids = set(int(i) for i in uniq_ids)

        survives = out["survives"]
        counts = out["counts"]
        role = out["role"]
        signs = out["uniq_sign"]
        ulabels = out["uniq_label"]
        for ui in np.nonzero(survives)[0]:
            fi = int(uniq_first[ui])
            si = int(np.searchsorted(occ_base, fi, side="right")) - 1
            pos = fi - int(occ_base[si])
            fwd = seqs[si][pos : pos + k]
            canon = fwd if signs[ui] == 0 else revcomp_codes(fwd)
            nid = int(uniq_ids[ui])
            node = Node(nid, np.ascontiguousarray(canon), int(signs[ui]),
                        int(ulabels[ui]), num_samples)
            node.counts = counts[ui].copy()
            node.role_counts = [int(role[ui, 0]), int(role[ui, 1])]
            self.nodes[nid] = node

        for s_id, d_id in zip(out["edge_src"], out["edge_dst"]):
            s_node = self.nodes.get(int(s_id))
            d_node = self.nodes.get(int(d_id))
            if s_node is None or d_node is None:
                continue
            kind = make_kind(s_node.sign, d_node.sign)
            fwd = Edge(int(s_id), int(d_id), kind)
            s_node.emplace_edge(fwd)
            d_node.emplace_edge(fwd.mirror())
        return True

    # ------------------------------------------------------------------
    # Phase 2: pruning primitives
    # ------------------------------------------------------------------
    def _remove_node(self, nid: int) -> None:
        node = self.nodes.get(nid)
        if node is None:
            return
        for edge in node.edges:
            if edge.is_self_loop:
                continue
            nb = self.nodes.get(edge.dst)
            if nb is not None:
                nb.erase_edge(edge.mirror())
        if self.probe_tracker is not None:
            self.probe_tracker.on_node_remove(nid)
        del self.nodes[nid]

    def _remove_low_cov_nodes(self, comp_id: int) -> None:
        source_id, sink_id = self.source_sink
        min_cov = self.params.min_node_cov
        to_remove = [
            nid
            for nid, node in self.nodes.items()
            if node.comp_id == comp_id
            and nid not in (source_id, sink_id)
            and (node.is_all_singletons() or node.total_support() < min_cov)
        ]
        for nid in to_remove:
            self._remove_node(nid)

    def _mark_connected_components(self) -> list[_ComponentInfo]:
        current = 0
        infos: list[_ComponentInfo] = []
        for nid, node in self.nodes.items():
            if node.comp_id != 0:
                continue
            current += 1
            info = _ComponentInfo(comp_id=current)
            stack = [node]
            while stack:
                cur = stack.pop()
                if cur.comp_id != 0:
                    continue
                cur.comp_id = current
                info.num_nodes += 1
                for edge in cur.edges:
                    nb = self.nodes.get(edge.dst)
                    if nb is not None and nb.comp_id == 0:
                        stack.append(nb)
            infos.append(info)
        infos.sort(key=lambda i: -i.num_nodes)
        return infos

    # ------------------------------------------------------------------
    # Phase 3: anchors
    # ------------------------------------------------------------------
    def _find_source(self, comp_id: int) -> _RefAnchor:
        min_cov = self.params.min_anchor_cov
        for ref_idx, nid in enumerate(self.ref_node_ids):
            node = self.nodes.get(nid)
            if node is None or node.comp_id != comp_id or node.total_support() < min_cov:
                continue
            return _RefAnchor(nid, ref_idx, True)
        return _RefAnchor(0, 0, False)

    def _find_sink(self, comp_id: int) -> _RefAnchor:
        min_cov = self.params.min_anchor_cov
        for ref_idx in range(len(self.ref_node_ids) - 1, -1, -1):
            nid = self.ref_node_ids[ref_idx]
            node = self.nodes.get(nid)
            if node is None or node.comp_id != comp_id or node.total_support() < min_cov:
                continue
            return _RefAnchor(nid, ref_idx, True)
        return _RefAnchor(0, 0, False)

    # ------------------------------------------------------------------
    # Phase 4: compression + tips (reference: graph.cpp:515-840)
    # ------------------------------------------------------------------
    def _prune_component(self, comp_id: int, probe, k: int) -> None:
        # fast path: the native C++ cascade (bit-exact twin, GIL released so
        # prep worker threads actually run in parallel); the Python cascade
        # below stays as the instrumented path (probe hooks + per-stage DOT
        # snapshots fire per sub-stage) and the correctness baseline
        if (probe is None and (self.shard_writer is None
                               or self.params.snapshot_mode != "verbose")
                and self._prune_component_native(comp_id, k)):
            return
        self._compress_graph(comp_id)
        if probe is not None:
            probe.log_stage("compress1", self, k)
        self._buffer_stage_snapshot("compression1", comp_id, k)
        self._remove_low_cov_nodes(comp_id)
        if probe is not None:
            probe.log_stage("lowcov2", self, k)
        self._buffer_stage_snapshot("low_cov_removal2", comp_id, k)
        self._compress_graph(comp_id)
        if probe is not None:
            probe.log_stage("compress2", self, k)
        self._buffer_stage_snapshot("compression2", comp_id, k)
        self._remove_tips(comp_id)
        if probe is not None:
            probe.log_stage("tips", self, k)
        self._buffer_stage_snapshot("short_tip_removal", comp_id, k)

    def _prune_component_native(self, comp_id: int, k: int) -> bool:
        """Native prune cascade (native/assembly_core.cpp::l2t_prune_component).

        Flattens the component's nodes in table order, runs compress ->
        lowcov -> compress -> tips in C++, and rebuilds the node table with
        survivors in their original relative positions (downstream traversal
        indexing and walk enumeration are order-sensitive). Returns False
        when the native library is unavailable (Python path runs instead).
        """
        from lancet2_tpu_torch.base import native_core

        if not native_core.available():
            return False
        comp_nids = [nid for nid, n in self.nodes.items() if n.comp_id == comp_id]
        if not comp_nids:
            return True
        n = len(comp_nids)
        num_samples = self.params.num_samples
        nids = np.array(comp_nids, dtype=np.uint64)
        seq_off = np.zeros(n + 1, np.int64)
        signs = np.zeros(n, np.uint8)
        labels = np.zeros(n, np.uint8)
        counts = np.zeros((n, num_samples), np.int64)
        roles = np.zeros((n, 2), np.int64)
        e_off = np.zeros(n + 1, np.int64)
        seqs = []
        e_dst, e_kind = [], []
        for i, nid in enumerate(comp_nids):
            node = self.nodes[nid]
            seqs.append(node.codes)
            seq_off[i + 1] = seq_off[i] + len(node.codes)
            signs[i] = node.sign
            labels[i] = node.label
            counts[i] = node.counts
            roles[i] = node.role_counts
            for e in node.edges:
                e_dst.append(e.dst)
                e_kind.append(e.kind)
            e_off[i + 1] = len(e_dst)
        out = native_core.prune_component(
            nids, np.concatenate(seqs) if seqs else np.zeros(0, np.uint8),
            seq_off, signs, labels, counts, roles,
            np.array(e_dst, dtype=np.uint64), np.array(e_kind, dtype=np.uint8),
            e_off, k, num_samples, self.params.min_node_cov,
            self.source_sink[0], self.source_sink[1],
        )
        if out is None:
            return False

        alive = out["alive"]
        survivors: dict[int, Node] = {}
        oi = 0
        for i, nid in enumerate(comp_nids):
            if not alive[i]:
                continue
            node = self.nodes[nid]
            node.codes = np.ascontiguousarray(
                out["seq"][out["seq_off"][oi] : out["seq_off"][oi + 1]]
            )
            node.label = int(out["label"][oi])
            node.counts = out["counts"][oi].copy()
            node.role_counts = [int(out["roles"][oi, 0]), int(out["roles"][oi, 1])]
            node.edges = [
                Edge(nid, int(out["e_dst"][e]), int(out["e_kind"][e]))
                for e in range(int(out["e_off"][oi]), int(out["e_off"][oi + 1]))
            ]
            survivors[nid] = node
            oi += 1
        # rebuild the table preserving original relative order (removed
        # entries drop out in place, exactly like dict `del`)
        new_nodes: dict[int, Node] = {}
        for nid, node in self.nodes.items():
            if node.comp_id != comp_id:
                new_nodes[nid] = node
            elif nid in survivors:
                new_nodes[nid] = survivors[nid]
        self.nodes = new_nodes
        return True

    def _buffer_stage_snapshot(self, stage_label: str, comp_id: int, k: int) -> None:
        """Per-prune-stage DOT snapshot (reference: BufferStageSnapshot;
        only under --graph-snapshots=verbose with a shard writer wired)."""
        if self.shard_writer is None or self.params.snapshot_mode != "verbose":
            return
        from lancet2_tpu_torch.cbdg.dot import render_component_dot

        fname = f"dbg__{self.dot_buffer.window_subdir}__{stage_label}__k{k}__comp{comp_id}.dot"
        contents = render_component_dot(self, comp_id, fname[:-4])
        self.dot_buffer.buffer(fname, contents)

    def _compress_graph(self, comp_id: int) -> None:
        removed: set[int] = set()
        for nid in list(self.nodes.keys()):
            node = self.nodes.get(nid)
            if node is None or node.comp_id != comp_id or nid in removed:
                continue
            self._compress_node(nid, True, removed)
            self._compress_node(nid, False, removed)
        for nid in removed:
            self._remove_node(nid)

    def _compress_node(self, nid: int, ordering_default: bool, removed: set[int]) -> None:
        node = self.nodes[nid]
        k = self.curr_k
        edge = self._find_compressible_edge(node, ordering_default)
        while edge is not None:
            buddy = self.nodes[edge.dst]
            if self.probe_tracker is not None:
                self.probe_tracker.on_node_merge(edge.dst, nid)
            node.merge(buddy, edge.kind, k)
            node.erase_edge(edge)

            # Rewire buddy's remaining edges to the surviving node, flipping the
            # propagated source sign when the buddy's internal sign-continuity
            # flips (reference: graph.cpp:600-645, BCALM2 walk rule).
            rev_src_sign = flip_sign(edge.src_sign)
            for b2n in buddy.edges:
                if b2n == edge.mirror():
                    continue
                nb = self.nodes[b2n.dst]
                ne_src_sign = rev_src_sign if edge.dst_sign != b2n.src_sign else edge.src_sign
                new_edge = Edge(nid, b2n.dst, make_kind(ne_src_sign, b2n.dst_sign))
                node.emplace_edge(new_edge)
                nb.emplace_edge(new_edge.mirror())
                nb.erase_edge(b2n.mirror())

            removed.add(edge.dst)
            # buddy stays in the table until the batch delete; clear its edges
            # so it cannot be picked as someone else's buddy again
            buddy.edges = []
            edge = self._find_compressible_edge(node, ordering_default)

    def _find_compressible_edge(self, node: Node, ordering_default: bool) -> Edge | None:
        if node.num_out_edges > 2 or node.num_out_edges == 0 or node.has_self_loop():
            return None
        source_id, sink_id = self.source_sink
        if node.nid in (source_id, sink_id):
            return None
        mergeable = node.edges_in_direction(ordering_default)
        if len(mergeable) != 1:
            return None
        cand = mergeable[0]
        if cand.dst in (source_id, sink_id):
            return None
        if cand.dst not in self.nodes:
            return None
        if not self._is_potential_buddy_edge(node, cand):
            return None
        opp = node.edges_in_direction(not ordering_default)
        if not opp:
            return cand
        if len(opp) > 1:
            return None
        if opp[0].dst not in self.nodes or not self._is_potential_buddy_edge(node, opp[0]):
            return None
        return cand

    def _is_potential_buddy_edge(self, src: Node, conn: Edge) -> bool:
        nbour = self.nodes[conn.dst]
        # Degenerate mutual degree-1 pair would merge into a zero-edge node.
        if src.num_out_edges == 1 and nbour.num_out_edges == 1:
            if src.edges[0].dst == nbour.nid and nbour.edges[0].dst == src.nid:
                return False
        if nbour.num_out_edges > 2 or nbour.num_out_edges == 0 or nbour.has_self_loop():
            return False

        expected = conn.mirror()
        dir_default = expected.src_sign == nbour.sign_for(True)
        nb_edges = nbour.edges_in_direction(dir_default)
        if len(nb_edges) != 1 or nb_edges[0] != expected:
            return False

        opp_edges = nbour.edges_in_direction(not dir_default)
        if len(opp_edges) != 1 or opp_edges[0].dst == conn.src:
            return False
        nnb = self.nodes.get(opp_edges[0].dst)
        return nnb is not None and nnb.num_out_edges <= 2

    def _remove_tips(self, comp_id: int) -> None:
        current_tips = 1
        while current_tips > 0:
            source_id, sink_id = self.source_sink
            k = self.curr_k
            to_remove = []
            for nid, node in self.nodes.items():
                if (
                    node.comp_id != comp_id
                    or nid in (source_id, sink_id)
                    or node.num_out_edges > 1
                ):
                    continue
                uniq_len = node.seq_len - k + 1
                if uniq_len >= k:
                    continue
                to_remove.append(nid)
            if to_remove:
                for nid in to_remove:
                    self._remove_node(nid)
                self._compress_graph(comp_id)
            current_tips = len(to_remove)

    # ------------------------------------------------------------------
    # Phase 5: haplotype enumeration
    # ------------------------------------------------------------------
    def _build_haplotypes(
        self, comp_id: int, trav, ref_anchor_codes: np.ndarray, probe
    ) -> list[EnumeratedHaplotype]:
        max_flow = MaxFlow(self.nodes, self.curr_k, trav, self.params.num_samples)
        haps: list[EnumeratedHaplotype] = []
        hap = max_flow.next_path()
        while hap is not None:
            haps.append(hap)
            hap = max_flow.next_path()
        if max_flow.hit_traversal_limit and probe is not None:
            probe.set_status(comp_id, "traversal_limit")
        if not haps:
            return haps
        num_samples = self.params.num_samples
        confidences = [
            node.confidence(num_samples)
            for node in self.nodes.values()
            if node.comp_id == comp_id and node.has_tag(LABEL_REFERENCE)
        ]
        ref_weight = median_u32(confidences) if confidences else 1
        return self._finalize_haplotypes(haps, decode(ref_anchor_codes),
                                         ref_weight)

    def _finalize_haplotypes(self, haps, ref_anchor_seq: str,
                             ref_weight: int) -> list[EnumeratedHaplotype]:
        """Sort/dedup enumerated walks + prepend the REF haplotype.

        ALTs sorted by descending weakest-link confidence; duplicates keep
        the highest-MinWeight copy; paths identical to the ref anchor drop.
        The REF path is weighted by the median surviving REF-node confidence
        (reference: graph.cpp:902-924)."""
        haps.sort(key=lambda h: -h.path.min_weight())
        seen: set[str] = set()
        deduped = []
        for hap in haps:
            seq = hap.path.sequence
            if seq in seen or seq == ref_anchor_seq:
                continue
            seen.add(seq)
            deduped.append(hap)
        haps = deduped

        ref_path = Path()
        ref_path.append_sequence(ref_anchor_seq)
        ref_path.add_node_weight(ref_weight, len(ref_anchor_seq))
        ref_path.finalize()
        haps.insert(0, EnumeratedHaplotype(path=ref_path, walk=[]))
        return haps
