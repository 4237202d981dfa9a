"""Sharded evidence dispatch: K1 and K2 over the entries of a mesh.

Ports `lancet2_tpu/parallel/evidence_spmd.py`. The JAX package shard_maps
the span kernel (and the evidence kernel) over a 1-D device mesh: pair
arrays are padded to a multiple of the mesh, sharded on their leading axis,
and every device runs the same kernel on its shard; pools are replicated.
Here each mesh entry (parallel/mesh.py) takes an equal, contiguous shard of
the padded pair-index arrays and launches the port's wrappers
(ops/evidence_cuda.py) on its device and stream; the shards' outputs come
back in device order. Pairs are independent, so per-pair results equal the
one-device dispatch's, whatever the shard boundaries.

Padding rows point at read 0 and haplotype 0 with lengths 1 and no active
region; their outputs are dropped before anything reads them (the gate, the
pass-2 counters, the records).

`SPMD_STATS` counts sharded dispatches, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from lancet2_tpu_torch.ops.evidence_cuda import (
    evidence_pairs_finalize,
    evidence_pairs_submit,
    span_pairs_finalize,
    span_pairs_submit,
)
from lancet2_tpu_torch.ops.evidence_fused import DevicePools, _gather_qt
from lancet2_tpu_torch.ops.evidence_layout import R_MAX
from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS, KernelParams
from lancet2_tpu_torch.parallel.mesh import Mesh, split_rows

# sharded-dispatch counters (the multi-device dry run asserts that every
# device phase went through them when a mesh is attached)
SPMD_STATS = {"span_sharded": 0, "evidence_sharded": 0}


def replicate_pools(mesh: Mesh, reads_q, reads_qu, read_lens,
                    haps) -> list[DevicePools]:
    """A group's pools on every distinct device of the mesh (uploaded on the
    device's current stream; `Mesh.on` orders each entry after it). Returns
    one DevicePools per entry; entries on one device share it."""
    by_dev: dict = {}
    out = []
    for dev in mesh.devices:
        if dev not in by_dev:
            by_dev[dev] = DevicePools(reads_q, reads_qu, read_lens, haps, dev)
        out.append(by_dev[dev])
    return out


def _padded_rows(n: int, size: int) -> int:
    return size * max(1, -(-n // size))


def _pad(a, rows: int, fill=0) -> np.ndarray:
    out = np.full(rows, fill, np.int64)
    out[:len(a)] = a
    return out


def _to(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)


def _launch_shards(mesh: Mesh, pools: list[DevicePools], rows: int,
                   max_rows: int | None, launch):
    """Call launch(i, pools[i], lo, hi) for every piece of every entry's
    shard (pieces of at most max_rows rows) inside the entry's `on`
    context; returns [(i, handle, lo, hi)]."""
    out = []
    for i, (lo, hi) in enumerate(split_rows(rows, mesh.size)):
        step = max_rows or (hi - lo)
        with mesh.on(i):
            p = pools[i]
            mesh.keep(i, p.reads_q, p.reads_qu, p.read_lens, p.haps)
            for a in range(lo, hi, step):
                b = min(a + step, hi)
                out.append((i, launch(i, p, a, b), a, b))
    return out


def span_indexed_sharded_submit(mesh: Mesh, pools: list[DevicePools],
                                read_ix, hap_ix, band_start, tlens, Lt: int,
                                kp: KernelParams = READ_TO_HAP_PARAMS,
                                max_rows: int | None = None):
    """Pass-1 span over every pair of a group, sharded over the mesh; pools
    as `replicate_pools` gives them. Launches without waiting and returns
    the handle `span_sharded_finalize` reads (pieces of at most max_rows
    pairs per launch; None = one launch per entry)."""
    n = len(read_ix)
    rows = _padded_rows(n, mesh.size)
    rix = _pad(read_ix, rows)
    hix = _pad(hap_ix, rows)
    bst = _pad(band_start, rows)
    tl = _pad(tlens, rows, fill=1)
    ql = pools[0].read_lens_host[rix].astype(np.int64)
    ql[n:] = 1

    def launch(i, p, a, b):
        dev = p.device
        q, t = _gather_qt(p, _to(rix[a:b], np.int64, dev),
                          _to(hix[a:b], np.int64, dev),
                          _to(bst[a:b], np.int64, dev), Lt)
        return span_pairs_submit(q, _to(ql[a:b], np.int32, dev), t,
                                 _to(tl[a:b], np.int32, dev), kp.to(dev))

    SPMD_STATS["span_sharded"] += 1
    return dict(mesh=mesh, n=n,
                shards=_launch_shards(mesh, pools, rows, max_rows, launch))


def span_sharded_finalize(handle) -> dict:
    """Host copy of a sharded span dispatch: the dict of span_pairs_finalize
    for the n real pairs, in pair order."""
    mesh, parts = handle["mesh"], []
    for i, iout, _lo, _hi in handle["shards"]:
        with mesh.on(i):
            parts.append(span_pairs_finalize(iout))
    n = handle["n"]
    return {k: np.concatenate([p[k] for p in parts])[:n] for k in parts[0]}


def span_indexed_sharded(mesh: Mesh, pools: list[DevicePools], read_ix,
                         hap_ix, band_start, tlens, Lt: int,
                         kp: KernelParams = READ_TO_HAP_PARAMS,
                         max_rows: int | None = None) -> dict:
    """One sharded span dispatch over all pairs of a group, read back."""
    return span_sharded_finalize(span_indexed_sharded_submit(
        mesh, pools, read_ix, hap_ix, band_start, tlens, Lt, kp, max_rows))


def evidence_indexed_sharded(mesh: Mesh, pools: list[DevicePools], read_ix,
                             hap_ix, band_start, tlens, regions, Lt: int,
                             R: int, kp: KernelParams = READ_TO_HAP_PARAMS,
                             max_rows: int | None = None) -> dict:
    """Pass-2 evidence over the selected pairs (regions [n, R_MAX, 2] int32
    in band coordinates, slots >= R inactive), sharded over the mesh and
    read back: the dict of evidence_pairs_finalize for the n pairs."""
    n = len(read_ix)
    rows = _padded_rows(n, mesh.size)
    rix = _pad(read_ix, rows)
    hix = _pad(hap_ix, rows)
    bst = _pad(band_start, rows)
    tl = _pad(tlens, rows, fill=1)
    ql = pools[0].read_lens_host[rix].astype(np.int64)
    ql[n:] = 1
    reg = np.zeros((rows, R_MAX, 2), np.int32)
    reg[:n] = regions

    def launch(i, p, a, b):
        dev = p.device
        ix = _to(rix[a:b], np.int64, dev)
        q, t = _gather_qt(p, ix, _to(hix[a:b], np.int64, dev),
                          _to(bst[a:b], np.int64, dev), Lt)
        return evidence_pairs_submit(
            q, p.reads_qu[ix], _to(ql[a:b], np.int32, dev), t,
            _to(tl[a:b], np.int32, dev), _to(reg[a:b], np.int32, dev), R,
            kp.to(dev))

    SPMD_STATS["evidence_sharded"] += 1
    parts = []
    for i, (iout, fout), _a, _b in _launch_shards(mesh, pools, rows,
                                                  max_rows, launch):
        with mesh.on(i):
            parts.append(evidence_pairs_finalize(iout, fout, R))
    return {k: np.concatenate([p[k] for p in parts])[:n] for k in parts[0]}


def span_arrays_sharded(mesh: Mesh, qs, qus, qlens, ts, tlens,
                        kp: KernelParams = READ_TO_HAP_PARAMS) -> dict:
    """K1 over every row of the given pair arrays (qs [n, Lq] u8, ts [n, Lt]
    u8, lens [n]), one launch per mesh entry. Rows are padded to a multiple
    of the mesh with inert rows (all-pad bases, lengths 1) whose outputs are
    dropped. Returns the span dict of the n real rows."""
    del qus  # quals are dead for the span kernel
    n = qs.shape[0]
    rows = _padded_rows(n, mesh.size)
    pad = rows - n
    qs = np.pad(qs, ((0, pad), (0, 0)), constant_values=5)
    ts = np.pad(ts, ((0, pad), (0, 0)), constant_values=5)
    qlens = np.pad(np.asarray(qlens), (0, pad), constant_values=1)
    tlens = np.pad(np.asarray(tlens), (0, pad), constant_values=1)
    parts = []
    handles = []
    for i, (lo, hi) in enumerate(split_rows(rows, mesh.size)):
        with mesh.on(i) as dev:
            handles.append((i, span_pairs_submit(
                _to(qs[lo:hi], np.uint8, dev), _to(qlens[lo:hi], np.int32, dev),
                _to(ts[lo:hi], np.uint8, dev), _to(tlens[lo:hi], np.int32, dev),
                kp.to(dev))))
    for i, iout in handles:
        with mesh.on(i):
            parts.append(span_pairs_finalize(iout))
    return {k: np.concatenate([p[k] for p in parts])[:n] for k in parts[0]}
