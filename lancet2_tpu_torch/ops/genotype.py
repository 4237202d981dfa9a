"""Batched Dirichlet-Multinomial genotyping on a torch device.

Ports `lancet2_tpu/ops/genotype_tpu.py` (the batched twin of
caller/likelihood.py): counts [B, K] -> PLs [B, G] with G = K(K+1)/2, plus
GQ and the best genotype.

  * `batched_genotype_pls` runs in float32, as the window step's does. Its
    PLs can differ by 1 from the JAX package's where the two lgamma
    implementations differ in the last bit.
  * `batched_genotype_pls_exact` runs in float64 for the batch executor's
    phase C. Sums over alleles run left to right, as the host engine's do.

The JAX package's sharded variant (`_sharded_pls_fn`) is not ported: it
belongs to the multi-GPU path.
"""

from __future__ import annotations

import numpy as np
import torch

from lancet2_tpu_torch.caller.likelihood import (
    DM_ALPHA_FLOOR,
    DM_BACKGROUND_ERROR,
    DM_OVERDISPERSION,
)

MAX_GQ = 99


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


def _raw_pls(counts: torch.Tensor, num_alleles: int,
             dtype: torch.dtype) -> torch.Tensor:
    """-10 log10 of each genotype's likelihood ratio to the best, [B, G]:
    ln P(c|a) = lnG(sum a) - lnG(N + sum a) + sum[lnG(c_i+a_i) - lnG(a_i)]."""
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


def batched_genotype_pls(counts: torch.Tensor, num_alleles: int):
    """counts [B, K] (any number type) -> (pls [B, G] int32, gq [B] int32,
    best [B] int32), in float32 on the counts' device."""
    pls = torch.round(_raw_pls(counts, num_alleles, torch.float32)).to(
        torch.int32)
    best = torch.argmin(pls, dim=-1).to(torch.int32)
    # GQ = second smallest PL (min is 0 after normalization), capped at 99
    top2 = torch.sort(pls, dim=-1).values[:, :2]
    gq = torch.clamp(top2[:, 1] - top2[:, 0], max=MAX_GQ).to(torch.int32)
    return pls, gq, best


def pls_f64(counts: torch.Tensor, num_alleles: int) -> torch.Tensor:
    """counts [B, K] -> PLs [B, G] int64, in float64 on the counts' device."""
    return torch.round(_raw_pls(counts, num_alleles, torch.float64)).to(
        torch.int64)


def batched_genotype_pls_exact(counts, num_alleles: int,
                               device: torch.device) -> np.ndarray:
    """DM PLs of int counts [B, K] computed on `device` in float64; returns
    pls [B, G] int64 numpy (the caller derives GQ from the ints)."""
    counts = torch.from_numpy(np.asarray(counts, np.int64)).to(device)
    return pls_f64(counts, num_alleles).cpu().numpy()
