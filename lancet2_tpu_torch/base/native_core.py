"""ctypes bindings for the native assembly core (native/assembly_core.cpp).

Two entry points, both bit-exact ports of their Python twins (tested in
tests/test_native_core.py):

  kmer_pass(...)     the vectorized middle of cbdg.graph.Graph._build_graph
                     (canonicalize + hash + unique + MateMer dedup counts +
                     expected-error filter + survivor edges)
  align_batch(...)   ops.affine_dp.align_batch_numpy + traceback_batch in one
                     call (dual-affine DP with CIGAR traceback)

The library is built from the repo's native/assembly_core.cpp into this
package's own build directory (utils/native_build.py). Falls back silently
(returns None / available() False) when the toolchain is missing — callers keep their numpy paths as the correctness baseline.
"""

from __future__ import annotations

import ctypes

import numpy as np

from lancet2_tpu_torch.utils.native_build import build_library


_lib = None
_load_failed = False

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _ensure_lib():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(build_library("assembly_core.cpp"))
        lib.l2t_kmer_pass.restype = ctypes.c_int64
        lib.l2t_kmer_pass.argtypes = [
            _u8p, _i64p, _u8p,                    # codes, offsets, quals
            _u8p, _u8p, _i32p, _u8p, _u64p,       # labels, is_read, sample_idx, tags, qhash
            _f64p,                                 # err_table
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint8,
            _u64p, _i64p, _u8p, _u8p,             # occ_ids, u_first, u_sign, u_label
            _i64p, _i64p, _u8p,                   # u_counts, u_role, u_survives
            _u64p, _u64p, _i64p,                  # e_src, e_dst, out_n_edges
        ]
        lib.l2t_align_batch.restype = ctypes.c_int64
        lib.l2t_align_batch.argtypes = [
            _u8p, _i64p, ctypes.c_int64, ctypes.c_int64,
            _u8p, _i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            _i64p, _i64p, _i64p,
            _i32p, _i32p, ctypes.c_int64, _i64p,
        ]
        lib.l2t_assemble_pass.restype = ctypes.c_int64
        lib.l2t_assemble_pass.argtypes = [
            _u8p, _i64p, _u8p,                    # codes, offsets, quals
            _u8p, _u8p, _i32p, _u8p, _u64p,       # labels, is_read, sample_idx, tags, qhash
            _f64p,                                 # err_table
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint8, ctypes.c_uint8,       # label_case, label_ref
            ctypes.c_int64, ctypes.c_int64,       # min_anchor_cov, min_anchor_len
            _u64p, _u8p, _i64p, _u8p, _u8p,       # nid, seq, seq_off, sign, label
            _i64p, _i64p, _i32p,                  # counts, roles, comp
            _u64p, _u8p, _i64p,                   # e_dst, e_kind, e_off
            _u64p, _u64p, _i64p, _i64p, _i32p,    # c_source, c_sink, c_src_off, c_anchor_len, c_id
            _i64p,                                 # n_comps
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.l2t_assemble_full.restype = ctypes.c_int64
        lib.l2t_assemble_full.argtypes = (
            list(lib.l2t_assemble_pass.argtypes)
            + [_f64p, _i64p, _u8p,                 # c_metrics, c_ref_weight, c_limit
               _i32p, _u8p, _i64p,                 # h_comp, h_seq, h_seq_off
               _i64p, _i64p, _i64p, _i64p,         # h_cov, h_wt_w, h_wt_n, h_cov_off
               _i64p, _i64p,                       # n_haps, retry
               ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        )
        lib.l2t_prune_component.restype = ctypes.c_int64
        lib.l2t_prune_component.argtypes = [
            ctypes.c_int64, _u64p, _u8p, _i64p, _u8p, _u8p,  # n, nids, seq, off, sign, label
            _i64p, _i64p, _u64p, _u8p, _i64p,                # counts, roles, e_dst, e_kind, e_off
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # k, num_samples, min_node_cov
            ctypes.c_uint64, ctypes.c_uint64,                # source_id, sink_id
            _u8p, _u8p, _i64p, _u8p, _u8p,                   # alive, seq, seq_off, sign, label
            _i64p, _i64p, _u64p, _u8p, _i64p,                # counts, roles, e_dst, e_kind, e_off
            ctypes.c_int64, ctypes.c_int64,                  # cap_seq, cap_edges
        ]
        lib.l2t_tandem_repeats.restype = ctypes.c_int64
        lib.l2t_tandem_repeats.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
            _i32p, _i32p, _i32p, _i32p, _u8p,
        ]
        lib.l2t_has_approx_repeat.restype = ctypes.c_int32
        lib.l2t_has_approx_repeat.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.l2t_longdust_counts.restype = ctypes.c_int64
        lib.l2t_longdust_counts.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            _i32p, ctypes.c_int64, _i64p,
        ]
        _lib = lib
    except Exception:
        _load_failed = True
        _lib = None
    return _lib


def available() -> bool:
    return _ensure_lib() is not None


def kmer_pass(codes, offsets, quals, labels, is_read, sample_idx, tags, qhash,
              err_table, k: int, num_samples: int, min_node_cov: int,
              label_case: int):
    """Run the native k-mer pass. Returns None when native is unavailable,
    else a dict of numpy arrays (see assembly_core.cpp for field docs)."""
    lib = _ensure_lib()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, np.int64)
    n_seqs = len(offsets) - 1
    lens = np.diff(offsets)
    n_occ = int(np.maximum(lens - k + 1, 0).sum())
    if n_occ == 0:
        return None

    occ_ids = np.empty(n_occ, np.uint64)
    u_first = np.empty(n_occ, np.int64)
    u_sign = np.empty(n_occ, np.uint8)
    u_label = np.empty(n_occ, np.uint8)
    u_counts = np.empty(n_occ * num_samples, np.int64)
    u_role = np.empty(n_occ * 2, np.int64)
    u_survives = np.empty(n_occ, np.uint8)
    e_src = np.empty(n_occ, np.uint64)
    e_dst = np.empty(n_occ, np.uint64)
    n_edges = np.zeros(1, np.int64)

    n_uniq = lib.l2t_kmer_pass(
        np.ascontiguousarray(codes, np.uint8), offsets,
        np.ascontiguousarray(quals, np.uint8),
        np.ascontiguousarray(labels, np.uint8),
        np.ascontiguousarray(is_read, np.uint8),
        np.ascontiguousarray(sample_idx, np.int32),
        np.ascontiguousarray(tags, np.uint8),
        np.ascontiguousarray(qhash, np.uint64),
        np.ascontiguousarray(err_table, np.float64),
        n_seqs, k, num_samples, min_node_cov, label_case,
        occ_ids, u_first, u_sign, u_label, u_counts, u_role, u_survives,
        e_src, e_dst, n_edges,
    )
    if n_uniq < 0:
        return None
    ne = int(n_edges[0])
    return {
        "occ_ids": occ_ids,
        "uniq_first": u_first[:n_uniq],
        "uniq_sign": u_sign[:n_uniq],
        "uniq_label": u_label[:n_uniq],
        "counts": u_counts[: n_uniq * num_samples].reshape(n_uniq, num_samples),
        "role": u_role[: n_uniq * 2].reshape(n_uniq, 2),
        "survives": u_survives[:n_uniq].astype(bool),
        "edge_src": e_src[:ne],
        "edge_dst": e_dst[:ne],
    }


def assemble_pass(codes, offsets, quals, labels, is_read, sample_idx, tags,
                  qhash, err_table, k: int, num_samples: int,
                  min_node_cov: int, label_case: int, label_ref: int,
                  min_anchor_cov: int, min_anchor_len: int):
    """Fused build + lowcov + components + anchors + prune for one (window,
    k) attempt. Returns None when native is unavailable, else a dict of
    compacted survivor arrays grouped by passing component (size-desc) plus
    per-component anchor metadata."""
    lib = _ensure_lib()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, np.int64)
    lens = np.diff(offsets)
    n_occ = int(np.maximum(lens - k + 1, 0).sum())
    if n_occ == 0:
        return {"n_nodes": 0, "n_comps": 0}
    cap_nodes = n_occ
    cap_seq = n_occ * k
    cap_edges = n_occ + 8
    cap_comps = 256

    out_nid = np.empty(cap_nodes, np.uint64)
    out_seq = np.empty(cap_seq, np.uint8)
    out_seq_off = np.zeros(cap_nodes + 1, np.int64)
    out_sign = np.empty(cap_nodes, np.uint8)
    out_label = np.empty(cap_nodes, np.uint8)
    out_counts = np.empty(cap_nodes * num_samples, np.int64)
    out_roles = np.empty(cap_nodes * 2, np.int64)
    out_comp = np.empty(cap_nodes, np.int32)
    out_e_dst = np.empty(cap_edges, np.uint64)
    out_e_kind = np.empty(cap_edges, np.uint8)
    out_e_off = np.zeros(cap_nodes + 1, np.int64)
    c_source = np.empty(cap_comps, np.uint64)
    c_sink = np.empty(cap_comps, np.uint64)
    c_src_off = np.empty(cap_comps, np.int64)
    c_anchor_len = np.empty(cap_comps, np.int64)
    c_id = np.empty(cap_comps, np.int32)
    n_comps = np.zeros(1, np.int64)

    n_nodes = lib.l2t_assemble_pass(
        np.ascontiguousarray(codes, np.uint8), offsets,
        np.ascontiguousarray(quals, np.uint8),
        np.ascontiguousarray(labels, np.uint8),
        np.ascontiguousarray(is_read, np.uint8),
        np.ascontiguousarray(sample_idx, np.int32),
        np.ascontiguousarray(tags, np.uint8),
        np.ascontiguousarray(qhash, np.uint64),
        np.ascontiguousarray(err_table, np.float64),
        len(offsets) - 1, k, num_samples, min_node_cov,
        label_case, label_ref, min_anchor_cov, min_anchor_len,
        out_nid, out_seq, out_seq_off, out_sign, out_label,
        out_counts, out_roles, out_comp,
        out_e_dst, out_e_kind, out_e_off,
        c_source, c_sink, c_src_off, c_anchor_len, c_id, n_comps,
        cap_nodes, cap_seq, cap_edges, cap_comps,
    )
    if n_nodes < 0:
        return None
    nc = int(n_comps[0])
    return {
        "n_nodes": int(n_nodes),
        "n_comps": nc,
        "nid": out_nid[:n_nodes],
        "seq": out_seq,
        "seq_off": out_seq_off[: n_nodes + 1],
        "sign": out_sign[:n_nodes],
        "label": out_label[:n_nodes],
        "counts": out_counts[: n_nodes * num_samples].reshape(int(n_nodes), num_samples),
        "roles": out_roles[: n_nodes * 2].reshape(int(n_nodes), 2),
        "comp": out_comp[:n_nodes],
        "e_dst": out_e_dst,
        "e_kind": out_e_kind,
        "e_off": out_e_off[: n_nodes + 1],
        "c_source": c_source[:nc],
        "c_sink": c_sink[:nc],
        "c_src_off": c_src_off[:nc],
        "c_anchor_len": c_anchor_len[:nc],
        "c_id": c_id[:nc],
    }


def assemble_full(codes, offsets, quals, labels, is_read, sample_idx, tags,
                  qhash, err_table, k: int, num_samples: int,
                  min_node_cov: int, label_case: int, label_ref: int,
                  min_anchor_cov: int, min_anchor_len: int):
    """Fused assemble + native haplotype enumeration for one (window, k)
    attempt: everything assemble_pass does PLUS per-component complexity
    metrics, cycle/complexity retry detection, and the confidence-ordered
    walk enumeration — the fast path never materializes Python node objects
    (cbdg/{traversal,max_flow,complexity}.py parity, tested in
    tests/test_native_walks.py).

    Returns None when native is unavailable or an output capacity was
    exceeded (callers fall back to assemble_pass + Python walks), else a
    dict: retry flag, per-comp anchors/metrics/ref-weights, and flat per-hap
    arrays (seq codes, node coverages, run-length weights)."""
    lib = _ensure_lib()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, np.int64)
    lens = np.diff(offsets)
    n_occ = int(np.maximum(lens - k + 1, 0).sum())
    if n_occ == 0:
        return {"n_nodes": 0, "n_comps": 0, "n_haps": 0, "retry": False}
    cap_nodes = n_occ
    cap_seq = n_occ * k
    cap_edges = n_occ + 8
    cap_comps = 256
    cap_haps = 1024
    cap_hseq = cap_haps * 8192
    cap_hcov = cap_haps * 1024

    out_nid = np.empty(cap_nodes, np.uint64)
    out_seq = np.empty(cap_seq, np.uint8)
    out_seq_off = np.zeros(cap_nodes + 1, np.int64)
    out_sign = np.empty(cap_nodes, np.uint8)
    out_label = np.empty(cap_nodes, np.uint8)
    out_counts = np.empty(cap_nodes * num_samples, np.int64)
    out_roles = np.empty(cap_nodes * 2, np.int64)
    out_comp = np.empty(cap_nodes, np.int32)
    out_e_dst = np.empty(cap_edges, np.uint64)
    out_e_kind = np.empty(cap_edges, np.uint8)
    out_e_off = np.zeros(cap_nodes + 1, np.int64)
    c_source = np.empty(cap_comps, np.uint64)
    c_sink = np.empty(cap_comps, np.uint64)
    c_src_off = np.empty(cap_comps, np.int64)
    c_anchor_len = np.empty(cap_comps, np.int64)
    c_id = np.empty(cap_comps, np.int32)
    n_comps = np.zeros(1, np.int64)
    c_metrics = np.zeros(cap_comps * 6, np.float64)
    c_ref_weight = np.zeros(cap_comps, np.int64)
    c_limit = np.zeros(cap_comps, np.uint8)
    h_comp = np.empty(cap_haps, np.int32)
    h_seq = np.empty(cap_hseq, np.uint8)
    h_seq_off = np.zeros(cap_haps + 1, np.int64)
    h_cov = np.empty(cap_hcov, np.int64)
    h_wt_w = np.empty(cap_hcov, np.int64)
    h_wt_n = np.empty(cap_hcov, np.int64)
    h_cov_off = np.zeros(cap_haps + 1, np.int64)
    n_haps = np.zeros(1, np.int64)
    retry = np.zeros(1, np.int64)

    n_nodes = lib.l2t_assemble_full(
        np.ascontiguousarray(codes, np.uint8), offsets,
        np.ascontiguousarray(quals, np.uint8),
        np.ascontiguousarray(labels, np.uint8),
        np.ascontiguousarray(is_read, np.uint8),
        np.ascontiguousarray(sample_idx, np.int32),
        np.ascontiguousarray(tags, np.uint8),
        np.ascontiguousarray(qhash, np.uint64),
        np.ascontiguousarray(err_table, np.float64),
        len(offsets) - 1, k, num_samples, min_node_cov,
        label_case, label_ref, min_anchor_cov, min_anchor_len,
        out_nid, out_seq, out_seq_off, out_sign, out_label,
        out_counts, out_roles, out_comp,
        out_e_dst, out_e_kind, out_e_off,
        c_source, c_sink, c_src_off, c_anchor_len, c_id, n_comps,
        cap_nodes, cap_seq, cap_edges, cap_comps,
        c_metrics, c_ref_weight, c_limit,
        h_comp, h_seq, h_seq_off, h_cov, h_wt_w, h_wt_n, h_cov_off,
        n_haps, retry, cap_haps, cap_hseq, cap_hcov,
    )
    if n_nodes < 0:
        return None
    nc = int(n_comps[0])
    nh = int(n_haps[0])
    return {
        "n_nodes": int(n_nodes),
        "n_comps": nc,
        "retry": bool(retry[0]),
        "n_haps": nh,
        "c_source": c_source[:nc],
        "c_sink": c_sink[:nc],
        "c_src_off": c_src_off[:nc],
        "c_anchor_len": c_anchor_len[:nc],
        "c_id": c_id[:nc],
        "c_metrics": c_metrics[: nc * 6].reshape(nc, 6),
        "c_ref_weight": c_ref_weight[:nc],
        "c_limit": c_limit[:nc].astype(bool),
        "h_comp": h_comp[:nh],
        "h_seq": h_seq,
        "h_seq_off": h_seq_off[: nh + 1],
        "h_cov": h_cov,
        "h_wt_w": h_wt_w,
        "h_wt_n": h_wt_n,
        "h_cov_off": h_cov_off[: nh + 1],
    }


def prune_component(nids, seq_codes, seq_off, signs, labels, counts, roles,
                    e_dst, e_kind, e_off, k: int, num_samples: int,
                    min_node_cov: int, source_id: int, sink_id: int):
    """Native twin of cbdg.graph.Graph._prune_component (compress -> lowcov
    -> compress -> tips) over one component's flat node/edge arrays.

    Returns None when native is unavailable, else a dict with `alive` flags
    (per input node, table order) and compacted survivor arrays."""
    lib = _ensure_lib()
    if lib is None:
        return None
    nids = np.ascontiguousarray(nids, np.uint64)
    seq_codes = np.ascontiguousarray(seq_codes, np.uint8)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    e_off = np.ascontiguousarray(e_off, np.int64)
    n_nodes = len(nids)
    n_edges = int(e_off[-1])
    cap_seq = int(seq_off[-1])
    cap_edges = max(n_edges, 1)

    out_alive = np.zeros(n_nodes, np.uint8)
    out_seq = np.empty(max(cap_seq, 1), np.uint8)
    out_seq_off = np.zeros(n_nodes + 1, np.int64)
    out_sign = np.empty(max(n_nodes, 1), np.uint8)
    out_label = np.empty(max(n_nodes, 1), np.uint8)
    out_counts = np.empty(max(n_nodes * num_samples, 1), np.int64)
    out_roles = np.empty(max(n_nodes * 2, 1), np.int64)
    out_e_dst = np.empty(cap_edges, np.uint64)
    out_e_kind = np.empty(cap_edges, np.uint8)
    out_e_off = np.zeros(n_nodes + 1, np.int64)

    n_out = lib.l2t_prune_component(
        n_nodes, nids, seq_codes, seq_off,
        np.ascontiguousarray(signs, np.uint8),
        np.ascontiguousarray(labels, np.uint8),
        np.ascontiguousarray(counts, np.int64),
        np.ascontiguousarray(roles, np.int64),
        np.ascontiguousarray(e_dst, np.uint64),
        np.ascontiguousarray(e_kind, np.uint8),
        e_off, k, num_samples, min_node_cov, source_id, sink_id,
        out_alive, out_seq, out_seq_off, out_sign, out_label,
        out_counts, out_roles, out_e_dst, out_e_kind, out_e_off,
        int(cap_seq), int(cap_edges),
    )
    if n_out < 0:
        return None
    return {
        "alive": out_alive.astype(bool),
        "seq": out_seq,
        "seq_off": out_seq_off[: n_out + 1],
        "sign": out_sign[:n_out],
        "label": out_label[:n_out],
        "counts": out_counts[: n_out * num_samples].reshape(n_out, num_samples),
        "roles": out_roles[: n_out * 2].reshape(n_out, 2),
        "e_dst": out_e_dst,
        "e_kind": out_e_kind,
        "e_off": out_e_off[: n_out + 1],
    }


def align_batch(queries, q_lens, targets, t_lens, p) -> list[dict] | None:
    """Native twin of ops.affine_dp.align_and_traceback. Returns None when
    native is unavailable."""
    lib = _ensure_lib()
    if lib is None:
        return None
    queries = np.ascontiguousarray(queries, np.uint8)
    targets = np.ascontiguousarray(targets, np.uint8)
    q_lens = np.ascontiguousarray(q_lens, np.int64)
    t_lens = np.ascontiguousarray(t_lens, np.int64)
    B, Lq = queries.shape
    Lt = targets.shape[1]
    max_cigar = Lq + Lt + 2
    scores = np.empty(B, np.int64)
    tstarts = np.empty(B, np.int64)
    tends = np.empty(B, np.int64)
    cigar_ops = np.empty((B, max_cigar), np.int32)
    cigar_lens = np.empty((B, max_cigar), np.int32)
    n_cigars = np.empty(B, np.int64)
    rc = lib.l2t_align_batch(
        queries, q_lens, B, Lq, targets, t_lens, Lt,
        p.match, p.mismatch, p.gap_open1, p.gap_extend1,
        p.gap_open2, p.gap_extend2, int(p.dual), int(p.free_target_ends),
        scores, tstarts, tends, cigar_ops, cigar_lens, max_cigar, n_cigars,
    )
    if rc != 0:
        return None
    results = []
    for b in range(B):
        nc = int(n_cigars[b])
        cigar = [(int(cigar_ops[b, c]), int(cigar_lens[b, c])) for c in range(nc)]
        results.append(
            {
                "score": int(scores[b]),
                "t_end": int(tends[b]),
                "t_start": int(tstarts[b]),
                "cigar": cigar,
            }
        )
    return results


def tandem_repeats(seq: str, max_period: int = 6):
    """Native exact+approx tandem-repeat scan over an ASCII sequence.

    Returns [(period, start, span, errors, is_exact), ...] in the same order
    as find_exact_repeats(seq) + find_approx_repeats(seq), or None when the
    native library is unavailable."""
    lib = _ensure_lib()
    if lib is None:
        return None
    buf = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    cap = 64
    while True:
        period = np.empty(cap, np.int32)
        start = np.empty(cap, np.int32)
        span = np.empty(cap, np.int32)
        errors = np.empty(cap, np.int32)
        exact = np.empty(cap, np.uint8)
        cnt = int(lib.l2t_tandem_repeats(
            np.ascontiguousarray(buf), len(buf), max_period, cap,
            period, start, span, errors, exact,
        ))
        if cnt <= cap:
            return [
                (int(period[i]), int(start[i]), int(span[i]),
                 int(errors[i]), bool(exact[i]))
                for i in range(cnt)
            ]
        cap = cnt


def has_approx_repeat_native(codes, k: int, max_mismatch: int = 2):
    """Native pairwise-Hamming repeat gate; None when unavailable."""
    lib = _ensure_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    return bool(lib.l2t_has_approx_repeat(codes, codes.size, k, max_mismatch))


def longdust_counts(seq: str, k: int, rc: bool = False):
    """Rolling k-mer multi-counts of one strand (ascending k-mer order) +
    total k-mer count, for the longdust scorer; None when unavailable."""
    lib = _ensure_lib()
    if lib is None:
        return None
    buf = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    cap = 256
    while True:
        multi = np.empty(cap, np.int32)
        n_multi = np.zeros(1, np.int64)
        ell = int(lib.l2t_longdust_counts(
            np.ascontiguousarray(buf), len(buf), k, int(rc),
            multi, cap, n_multi,
        ))
        nm = int(n_multi[0])
        if nm <= cap:
            return ell, multi[:nm]
        cap = nm
