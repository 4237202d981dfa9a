"""Tape-packed device graph construction over many windows at once.

Ports `lancet2_tpu/ops/graph_tape.py` (`build_graphs_tape`, `_dispatch`,
`_materialize`) with the steps of ops/graph_tpu.py:

  * every sequence of a window batch is packed into overlapping tape rows of
    TW = 160 bases; rows overlap by k-1 bases, so row r owns occurrences
    [r*B, r*B + M) with stride B = M - 1 and every adjacent k-mer pair of a
    sequence lies inside one row (edges need consecutive occurrences); the
    overlap's duplicated occurrence collapses in the MateMer dedup exactly
    like a k-mer repeated inside one read, so counts stay exact;
  * one lexsort keyed (window, canonical words, qname hash, tag, ordinal)
    groups all windows at once; per-(node, sample) counts, role counts, the
    first occurrence's sign and label (packed into the ordinal), edge dedup
    and the reference-path node map are segment ops;
  * per-window results are bit-identical to Graph._build_graph's numpy path.

The JAX pass sizes its outputs by capacity buckets (node, edge and
reference-map capacities, row buckets) to reuse compiled executables, and
retries with larger ones when they overflow. Eager torch sizes every output
exactly, so none of that is carried over; the outputs do not depend on it.
"""

from __future__ import annotations

import numpy as np
import torch

from lancet2_tpu_torch.ops.graph_tpu import (
    INVALID_WORD,
    LABEL_REFERENCE,
    boundaries,
    canonical_words,
    expected_error_ok,
    lexsort,
    matemer_contrib,
    support_counts,
    unpack_words,
)

TW = 160  # tape row width (bases)

# occurrence-ordinal packing: (seq_ord << 12 | offset) << 4 | sign<<3 | label
_OFF_BITS = 12
_ORD_SHIFT = 4
_ORD_INVALID = 0x7FFFFFFF


def _tape_rows(batch, k: int):
    """Cut every sequence of every window into tape rows. Returns (rows,
    ref_bases, ref_lens, rcap): rows of (window, codes, quals, meta,
    occurrences, pairs, seq ordinal, base offset, ref-map base or -1)."""
    M = TW - k + 1
    B = M - 1  # row stride in occurrences: every adjacent pair lives in a row
    rows = []
    ref_bases, ref_lens = [], []
    rcap = 0
    for wi, (seqs, quals, meta) in enumerate(batch):
        ref_len = 0
        if meta and meta[0][0] == LABEL_REFERENCE:
            ref_len = len(seqs[0]) - k + 1
        ref_bases.append(rcap)
        ref_lens.append(ref_len)
        for si, codes in enumerate(seqs):
            n_occ_seq = len(codes) - k + 1
            if n_occ_seq <= 0:
                continue
            q = quals[si]
            is_ref_seq = meta[si][0] == LABEL_REFERENCE
            r = 0
            while r * B < n_occ_seq or (r == 0 and n_occ_seq > 0):
                base = r * B
                rows.append((
                    wi, codes[base:base + TW],
                    None if q is None else q[base:base + TW],
                    meta[si], min(M, n_occ_seq - base),
                    max(0, min(B, n_occ_seq - 1 - base)), si, base,
                    (rcap + base) if is_ref_seq else -1,
                ))
                r += 1
                if base + M >= n_occ_seq:
                    break
        rcap += ref_len
    return rows, ref_bases, ref_lens, rcap


def build_graphs_tape(batch, k: int, num_samples: int,
                      device: torch.device | str):
    """Batched device construction over many windows on `device`.

    batch: list of (seqs, quals, meta) per window, the per-window inputs of
    ops.graph_tpu.build_graph_device (ref first; sequences shorter than k+1
    pre-filtered by the caller). Returns a list of per-window dicts with
    keys {ids, codes, counts, roles, first_ord, signs, labels, edges
    (window-local uniq-row pairs), ref_rows}, or None for empty windows.
    """
    rows, ref_bases, ref_lens, rcap = _tape_rows(batch, k)
    if not rows:
        return [None for _ in batch]
    out = _dispatch(rows, k, num_samples, max(rcap, 1), torch.device(device))
    return _materialize(out, batch, ref_bases, ref_lens, k)


def _dispatch(rows, k: int, num_samples: int, rcap: int, dev: torch.device):
    """The device pass over the packed rows; returns compact host arrays."""
    NR = len(rows)
    M = TW - k + 1
    n_occ = NR * M
    tape = np.zeros((NR, TW), np.uint8)
    quals = np.zeros((NR, TW), np.uint8)
    # window, sample, tag, qlo, qhi, is_ref, occ_cnt, pair_cnt, seq_ord,
    # base_off, ref_base
    meta = np.zeros((NR, 11), np.int64)
    for i, (wi, codes, q, m, occ, pair, so, bo, rb) in enumerate(rows):
        L = len(codes)
        tape[i, :L] = codes
        lab, smp, tg, qh = m
        if lab == LABEL_REFERENCE:
            quals[i, :L] = 255  # ref never passes the EE gate anyway
        elif q is not None:
            quals[i, :L] = q
        # no-qual reads keep qual 0 (error prob ~1 -> EE fails), as the
        # one-window pass and the numpy path
        meta[i] = (wi, max(smp, 0), tg, qh & 0xFFFFFFFF,
                   (qh >> 32) & 0xFFFFFFFF, lab == LABEL_REFERENCE, occ,
                   pair, so, bo, rb)

    t_meta = torch.from_numpy(meta).to(dev)
    (win, sample, tag, qlo, qhi, is_ref, occ_cnt, pair_cnt, seq_ord,
     base_off, ref_base) = t_meta.unbind(1)
    is_ref = is_ref.bool()
    offs = torch.arange(M, device=dev)
    occ_valid = offs[None, :] < occ_cnt[:, None]  # [NR, M]
    ovalid = occ_valid.reshape(-1)

    # ---- k-mers, canonicalization, expected-error filter --------------
    kmers = torch.from_numpy(tape).to(dev).to(torch.int64).unfold(
        1, k, 1).reshape(n_occ, k)
    canon, signs = canonical_words(kmers, k)
    canon = torch.where(ovalid[:, None], canon,
                        torch.full_like(canon, INVALID_WORD))
    ee = (expected_error_ok(torch.from_numpy(quals).to(dev), k)
          & ~is_ref[:, None] & occ_valid).reshape(-1)

    # ---- per-occurrence metadata + global lexsort ----------------------
    occ_row = torch.arange(NR, device=dev).repeat_interleave(M)
    o_win = win[occ_row]
    offs_t = offs.repeat(NR)
    grid_ord = (seq_ord[occ_row] << _OFF_BITS) + base_off[occ_row] + offs_t
    label_occ = torch.where(is_ref[occ_row], 1, tag[occ_row])
    ordl = (grid_ord << _ORD_SHIFT) | (signs << 3) | label_occ
    ordl = torch.where(ovalid, ordl, _ORD_INVALID)
    keys = [ordl, tag[occ_row], qlo[occ_row], qhi[occ_row]]
    keys += [canon[:, w] for w in range(canon.shape[1] - 1, -1, -1)]
    keys.append(torch.where(ovalid, o_win, _ORD_INVALID))
    order = lexsort(keys)
    nv = int(ovalid.sum())
    order = order[:nv]  # invalid lanes sort last
    s_w = canon[order]
    s_win = o_win[order]
    s_row = occ_row[order]
    s_ordl = ordl[order]

    new_kmer = boundaries(s_w, s_win)
    node = torch.cumsum(new_kmer.to(torch.int64), 0) - 1
    n_uniq = int(node[-1]) + 1
    contrib = matemer_contrib(new_kmer, qlo[s_row], qhi[s_row], tag[s_row],
                              ee[order])
    counts, roles = support_counts(contrib, sample[s_row], tag[s_row], node,
                                   n_uniq, num_samples)
    first_ordl = torch.full((n_uniq,), _ORD_INVALID, dtype=torch.int64,
                            device=dev)
    first_ordl.scatter_reduce_(0, node, s_ordl, reduce="amin")

    # ---- edges: consecutive owned occurrence pairs ---------------------
    inv = torch.zeros(n_occ, dtype=torch.int64, device=dev)
    inv[order] = node
    inv2 = inv.reshape(NR, M)
    pair_valid = offs[None, :-1] < pair_cnt[:, None]  # [NR, M-1]
    src = inv2[:, :-1][pair_valid]
    dst = inv2[:, 1:][pair_valid]
    key = torch.unique(src * n_uniq + dst)  # sorted by (src, dst)
    edges = torch.stack([key // n_uniq, key % n_uniq], dim=1)

    # ---- ref-path node map ---------------------------------------------
    rb = ref_base[occ_row]
    ref_mask = is_ref[occ_row] & ovalid & (rb >= 0)
    ref_map = torch.full((rcap,), -1, dtype=torch.int64, device=dev)
    ref_map[(rb + offs_t)[ref_mask]] = inv[ref_mask]

    return {
        "node_words": s_w[new_kmer].cpu().numpy(),
        "node_win": s_win[new_kmer].cpu().numpy(),
        "counts": counts.cpu().numpy(),
        "roles": roles.cpu().numpy(),
        "first_ordl": first_ordl.cpu().numpy(),
        "edges": edges.cpu().numpy(),
        "ref_map": ref_map.cpu().numpy(),
    }


def _materialize(out, batch, ref_bases, ref_lens, k):
    """Split the compact outputs into per-window dicts (the JAX package's
    `_materialize`): nodes are window-major, edges follow their source."""
    from lancet2_tpu_torch.base.hashing import hash_kmer_matrix

    node_win = out["node_win"]
    counts, roles = out["counts"], out["roles"]
    first_ordl = out["first_ordl"]
    edges = out["edges"]
    ref_map = out["ref_map"]
    codes = unpack_words(out["node_words"], k)
    ids = hash_kmer_matrix(codes)

    wins = np.arange(len(batch))
    starts = np.searchsorted(node_win, wins)
    stops = np.searchsorted(node_win, wins + 1)
    e_src_win = node_win[edges[:, 0]] if len(edges) else np.empty(0, np.int64)
    e_starts = np.searchsorted(e_src_win, wins)
    e_stops = np.searchsorted(e_src_win, wins + 1)

    results = []
    for wi in range(len(batch)):
        lo, hi = int(starts[wi]), int(stops[wi])
        if hi <= lo:
            results.append(None)
            continue
        fo = first_ordl[lo:hi]
        e = edges[int(e_starts[wi]):int(e_stops[wi])]
        rr = ref_map[ref_bases[wi]:ref_bases[wi] + ref_lens[wi]]
        results.append({
            "ids": ids[lo:hi],
            "codes": codes[lo:hi],
            "counts": counts[lo:hi],
            "roles": roles[lo:hi],
            "first_ord": fo >> _ORD_SHIFT,      # seq_ord<<12 | offset
            "signs": (fo >> 3) & 1,
            "labels": fo & 7,
            "edges": e - lo,                    # window-local uniq rows
            "ref_rows": np.where(rr >= 0, rr - lo, -1),
        })
    return results
