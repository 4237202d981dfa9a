"""Indexed evidence dispatch: read/haplotype pools on the device.

Ports `lancet2_tpu/ops/evidence_fused.py` (`DevicePools`, `_gather_qt`,
`span_indexed_submit`, `evidence_indexed_submit`). A window batch's unique
reads and haplotypes are uploaded once; each pair is four int32 indices
(read, haplotype, band start, band length), and the q/t rows a kernel
launch needs are gathered on the device by plain tensor indexing.

A gathered t row equals the reference's expanded row on every column
< t_len (columns past the pool edge are clamped, as the reference's gather
clamps them); the DP never reads a column >= t_len, so outputs do not depend
on what lies beyond it.

Left out, as measures for the TPU's host link: 4-bit read packing, keeping
quals on the host, pool-shape buckets and super-chunk sizing.
"""

from __future__ import annotations

import numpy as np
import torch

from lancet2_tpu_torch.ops.evidence_cuda import (
    evidence_pairs_submit,
    span_pairs_submit,
)
from lancet2_tpu_torch.ops.params import KernelParams


class DevicePools:
    """Read and haplotype pools of one window-batch group on one device."""

    def __init__(self, reads_q, reads_qu, read_lens, haps,
                 device: torch.device):
        self.device = device
        self.read_lens_host = np.asarray(read_lens, np.int32)
        self.reads_q = _to(reads_q, np.uint8, device)
        self.reads_qu = _to(reads_qu, np.uint8, device)
        self.read_lens = _to(self.read_lens_host, np.int32, device)
        self.haps = _to(haps, np.uint8, device)
        self.lh = self.haps.shape[1]


def _to(arr, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(device)


def _gather_qt(pools: DevicePools, read_ix, hap_ix, band_start, Lt: int):
    """q [B, Lq] by row gather; t [B, Lt] by banded gather, columns clamped
    to the pool edge."""
    q = pools.reads_q[read_ix]
    cols = band_start[:, None] + torch.arange(Lt, device=pools.device)[None, :]
    cols = cols.clamp_(0, pools.lh - 1)
    t = pools.haps[hap_ix[:, None], cols]
    return q, t


def _ix(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr, np.int64)).to(device)


def span_indexed_submit(pools: DevicePools, read_ix, hap_ix, band_start,
                        tlens, Lt: int, kp: KernelParams) -> torch.Tensor:
    """Pass-1 span over one pair chunk; returns the device iout [n, 4]."""
    dev = pools.device
    rix = _ix(read_ix, dev)
    q, t = _gather_qt(pools, rix, _ix(hap_ix, dev), _ix(band_start, dev), Lt)
    return span_pairs_submit(q, pools.read_lens[rix], t,
                             _to(tlens, np.int32, dev), kp)


def evidence_indexed_submit(pools: DevicePools, read_ix, hap_ix, band_start,
                            tlens, regions, Lt: int, R: int,
                            kp: KernelParams):
    """Pass-2 evidence over one pair chunk; regions [n, R_MAX, 2] int32 in
    band coordinates. Returns the device (iout, fout)."""
    dev = pools.device
    rix = _ix(read_ix, dev)
    q, t = _gather_qt(pools, rix, _ix(hap_ix, dev), _ix(band_start, dev), Lt)
    return evidence_pairs_submit(
        q, pools.reads_qu[rix], pools.read_lens[rix], t,
        _to(tlens, np.int32, dev), _to(regions, np.int32, dev), R, kp)
