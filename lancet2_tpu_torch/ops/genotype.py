"""Batched Dirichlet-Multinomial genotyping on a torch device.

Ports `lancet2_tpu/ops/genotype_tpu.py` (the batched twin of
caller/likelihood.py): counts [B, K] -> PLs [B, G] with G = K(K+1)/2, plus
GQ and the best genotype.

  * `batched_genotype_pls` runs in float32, as the window step's does, with
    `ops/lgamma_f32.lgamma_f32`, XLA's CPU lgamma op for op: its PLs, GQs
    and best genotypes equal the JAX package's on the CPU.
  * `batched_genotype_pls_exact` runs in float64 for the batch executor's
    phase C (`torch.lgamma`: the float64 PLs equal the host engine's). Sums
    over alleles run left to right, as the host engine's do. With `mesh=`
    the rows are split over the mesh's devices (`_sharded_pls_fn`), after
    the JAX package's bucketing and padding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lancet2_tpu_torch.caller.likelihood import (
    DM_ALPHA_FLOOR,
    DM_BACKGROUND_ERROR,
    DM_OVERDISPERSION,
)
from lancet2_tpu_torch.ops.lgamma_f32 import lgamma_f32, lgamma_folded

MAX_GQ = 99
# XLA folds the float32 PLs' -10 * x / ln(10) into one multiply by this
_MINUS_10_OVER_LN10_F32 = float(np.float32(-4.34294462))


def genotype_alpha_matrix(num_alleles: int) -> np.ndarray:
    """[G, K] Dirichlet alphas in VCF genotype order (static per K)."""
    precision = (1.0 - DM_OVERDISPERSION) / DM_OVERDISPERSION
    rows = []
    for b in range(num_alleles):
        for a in range(b + 1):
            mu = np.full(num_alleles, DM_BACKGROUND_ERROR / num_alleles)
            main = 1.0 - DM_BACKGROUND_ERROR
            if a == b:
                mu[a] += main
            else:
                mu[a] += main / 2.0
                mu[b] += main / 2.0
            rows.append(np.maximum(DM_ALPHA_FLOOR, mu * precision))
    return np.stack(rows)


def _sum_alleles(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (allele) axis, left to right."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _raw_pls_f64(counts: torch.Tensor, num_alleles: int) -> torch.Tensor:
    """-10 log10 of each genotype's likelihood ratio to the best, [B, G], in
    float64:
    ln P(c|a) = lnG(sum a) - lnG(N + sum a) + sum[lnG(c_i+a_i) - lnG(a_i)]."""
    dtype = torch.float64
    alphas = torch.from_numpy(genotype_alpha_matrix(num_alleles)).to(
        device=counts.device, dtype=dtype)  # [G, K]
    c = counts.to(dtype)[:, None, :]  # [B, 1, K]
    a = alphas[None, :, :]  # [1, G, K]
    lg = torch.lgamma
    ll = _sum_alleles(lg(c + a) - lg(a))
    ll = ll + lg(_sum_alleles(a)) - lg(_sum_alleles(c + a))  # [B, G]
    best_ll = ll.max(dim=-1, keepdim=True).values
    ln10 = torch.log(torch.tensor(10.0, dtype=dtype, device=counts.device))
    return -10.0 * (ll - best_ll) / ln10


@functools.cache
def _folded_alpha_terms(num_alleles: int):
    """The alphas [G, K] in float32, lnG(a) [G, K] and lnG(sum a) [G]: XLA
    folds the last two at compile time (`lgamma_folded`)."""
    a = genotype_alpha_matrix(num_alleles).astype(np.float32)
    sum_a = a[:, 0].copy()
    for k in range(1, num_alleles):
        sum_a = sum_a + a[:, k]
    lg = np.vectorize(lgamma_folded, otypes=[np.float32])
    return a, lg(a), lg(sum_a)


_ALPHA_TENSORS: dict = {}


def _alpha_tensors(num_alleles: int, device: torch.device):
    """`_folded_alpha_terms` as float32 tensors on `device`, made once (a
    CUDA graph capture may not copy from the host)."""
    key = (num_alleles, device)
    if key not in _ALPHA_TENSORS:
        _ALPHA_TENSORS[key] = tuple(
            torch.from_numpy(x).to(device)[None]
            for x in _folded_alpha_terms(num_alleles))
    return _ALPHA_TENSORS[key]


def _raw_pls_f32(counts: torch.Tensor, num_alleles: int) -> torch.Tensor:
    """The float32 PLs in the operations of the JAX package's compiled
    `batched_genotype_pls` on the CPU: `lgamma_f32` where the argument
    depends on the counts (one call for both such terms), the folded
    constants of `_folded_alpha_terms` elsewhere, and -10 * x / ln(10)
    folded into one multiply."""
    a, lg_a, lg_sum_a = _alpha_tensors(num_alleles, counts.device)
    c = counts.to(torch.float32)[:, None, :]  # [B, 1, K]
    ca = c + a  # [B, G, K]
    sum_ca = _sum_alleles(ca)  # [B, G]
    lg = lgamma_f32(torch.cat([ca.reshape(-1), sum_ca.reshape(-1)]))
    ll = _sum_alleles(lg[:ca.numel()].reshape(ca.shape) - lg_a)
    ll = ll + lg_sum_a - lg[ca.numel():].reshape(sum_ca.shape)
    best_ll = ll.max(dim=-1, keepdim=True).values
    return (ll - best_ll) * _MINUS_10_OVER_LN10_F32


def _pls_f32(counts: torch.Tensor, num_alleles: int):
    pls = torch.round(_raw_pls_f32(counts, num_alleles)).to(torch.int32)
    best = torch.argmin(pls, dim=-1).to(torch.int32)
    # GQ = second smallest PL (min is 0 after normalization), capped at 99
    top2 = torch.sort(pls, dim=-1).values[:, :2]
    gq = torch.clamp(top2[:, 1] - top2[:, 0], max=MAX_GQ).to(torch.int32)
    return pls, gq, best


# CUDA graphs of `_pls_f32`, one per (device, stream, counts shape and
# type, K): a few hundred small elementwise launches replayed as one.
_PL_GRAPHS: dict = {}


def _pls_f32_graphed(counts: torch.Tensor, num_alleles: int):
    dev = counts.device
    stream = torch.cuda.current_stream(dev)
    key = (dev, stream.cuda_stream, counts.dtype, tuple(counts.shape),
           num_alleles)
    entry = _PL_GRAPHS.get(key)
    if entry is None:
        _alpha_tensors(num_alleles, dev)
        static = counts.clone()
        warm = torch.cuda.Stream(dev)  # capture wants a warmed-up side stream
        warm.wait_stream(stream)
        with torch.cuda.stream(warm):
            _pls_f32(static, num_alleles)
        stream.wait_stream(warm)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = _pls_f32(static, num_alleles)
        entry = _PL_GRAPHS[key] = (graph, static, out)
    graph, static, out = entry
    static.copy_(counts)
    graph.replay()
    return tuple(o.clone() for o in out)


def batched_genotype_pls(counts: torch.Tensor, num_alleles: int):
    """counts [B, K] (any number type) -> (pls [B, G] int32, gq [B] int32,
    best [B] int32), in float32 on the counts' device (on a CUDA device
    through a CUDA graph per shape: the same kernels, launched as one)."""
    if counts.device.type == "cuda":
        return _pls_f32_graphed(counts, num_alleles)
    return _pls_f32(counts, num_alleles)


def pls_f64(counts: torch.Tensor, num_alleles: int) -> torch.Tensor:
    """counts [B, K] -> PLs [B, G] int64, in float64 on the counts' device."""
    return torch.round(_raw_pls_f64(counts, num_alleles)).to(
        torch.int64)


_PL_BUCKETS = (64, 256, 1024, 4096, 16384)


def _sharded_pls_fn(mesh, num_alleles: int):
    """The float64 PLs with the rows split over the mesh: rows are
    independent (per-(call, sample) counts), so entry i computes the i-th
    equal shard on its device and stream, and the shards come back in
    device order. Takes int64 counts [B, K] (B a multiple of the mesh
    size), returns int64 numpy [B, G]."""
    from lancet2_tpu_torch.parallel.mesh import split_rows

    def fn(counts: np.ndarray) -> np.ndarray:
        parts = []
        for i, (lo, hi) in enumerate(split_rows(len(counts), mesh.size)):
            with mesh.on(i) as dev:
                c = torch.from_numpy(counts[lo:hi]).to(dev)
                parts.append(pls_f64(c, num_alleles).cpu().numpy())
        return np.concatenate(parts)

    return fn


def batched_genotype_pls_exact(counts, num_alleles: int,
                               device: torch.device | None = None,
                               mesh=None) -> np.ndarray:
    """DM PLs of int counts [B, K] in float64, on `device` or, with `mesh`,
    split over its devices; returns pls [B, G] int64 numpy (the caller
    derives GQ from the ints).

    With a mesh the rows are bucketed and padded as the JAX package's
    `batched_genotype_pls_exact` does (B up to 64/256/1024/4096/16384, then
    to a multiple of the mesh size) with zero-count rows, which are dropped
    again."""
    counts = np.asarray(counts, np.int64)
    if mesh is None:
        return pls_f64(torch.from_numpy(counts).to(device),
                       num_alleles).cpu().numpy()
    B = counts.shape[0]
    Bb = next((b for b in _PL_BUCKETS if B <= b), B)
    d = mesh.size
    Bb = max(Bb, d) + (-max(Bb, d)) % d
    if Bb != B:
        counts = np.pad(counts, ((0, Bb - B), (0, 0)))
    return _sharded_pls_fn(mesh, num_alleles)(counts)[:B]
