"""Plain PyTorch version of K3, the score-only fitting DP.

The score-only path of `lancet2_tpu/ops/affine_dp_jax.py` (`_make_align`
with `with_dirs=False`) in the fitting single-affine mode of READ_TO_HAP,
with the outputs of the Pallas kernel it replaces
(`lancet2_tpu/ops/sw_pallas.py`, `_make_kernel`): per pair the best score
of the query's last row over the valid target columns, and t_end, the FIRST
column holding it, 1-based. It is the contract the CUDA kernel
(csrc/sw_fitting.cu) is held to, and the CPU engine of the window step.

Per query row i (1-based), columns j = 1..Lt:
  diag   = H[i-1][j-1] + s(q_i, t_j)        s = 0 where either base is N
  V      = max(H[i-1][j] - (go+ge), V[i-1][j] - ge)
  H_tmp  = max(diag, V)
  F[j]   = cummax_{k<=j}(H_tmp[k-1] + ge*k) - (go+ge) - ge*(j-1) - ge
  H      = max(H_tmp, F)
with H[0][*] = 0 (free leading target gap) and H[i][0] = -(go + ge*i).
Codes: 0-3 ACGT, 4 N, 5 padding (scores 0 like N). Columns at or past a
pair's t_len never feed a valid column, so they are not masked per row;
the final row is masked. Degenerate pairs follow the Pallas kernel: with
q_len outside [1, Lq] the final row is row 0 (all zeros), and with no valid
column the score is NEG_INF and t_end is 1.
"""

from __future__ import annotations

import torch

from lancet2_tpu_torch.ops.affine_dp import NEG_INF
from lancet2_tpu_torch.ops.params import KernelParams


def fitting_scores_torch(queries, q_lens, targets, t_lens, kp: KernelParams):
    """queries [B, Lq] uint8, q_lens [B] int32, targets [B, Lt] uint8,
    t_lens [B] int32, all on one device -> (score int32 [B], t_end int32
    [B], 1-based)."""
    dev = queries.device
    B, Lq = queries.shape
    Lt = targets.shape[1]
    go, ge = kp.gap_open, kp.gap_extend
    i32 = torch.int32
    neg = int(NEG_INF)

    if Lt == 0:
        return (torch.full((B,), neg, dtype=i32, device=dev),
                torch.ones((B,), dtype=i32, device=dev))
    q = queries.to(i32)
    t = targets.to(i32)
    q_lens = q_lens.to(i32)
    jcols = torch.arange(1, Lt + 1, dtype=i32, device=dev)
    t_is_n = t >= 4
    sub_m = torch.where(t_is_n, 0, kp.match).to(i32)
    sub_x = torch.where(t_is_n, 0, -kp.mismatch).to(i32)
    f_off = (go + ge) + ge * (jcols - 1) + ge

    H = torch.zeros((B, Lt), dtype=i32, device=dev)  # columns 1..Lt, row 0
    V = torch.full((B, Lt), neg, dtype=i32, device=dev)
    final_H = H
    for i in range(1, Lq + 1):
        qi = q[:, i - 1:i]
        sub = torch.where(qi >= 4, 0, torch.where(qi == t, sub_m, sub_x))
        col0_prev = 0 if i == 1 else -(go + ge * (i - 1))
        h_left = torch.cat(
            [torch.full((B, 1), col0_prev, dtype=i32, device=dev),
             H[:, :-1]], dim=1)
        diag = h_left + sub
        V = torch.maximum(H - (go + ge), V - ge)
        H_tmp = torch.maximum(diag, V)
        ht_left = torch.cat(
            [torch.full((B, 1), -(go + ge * i), dtype=i32, device=dev),
             H_tmp[:, :-1]], dim=1)
        F = torch.cummax(ht_left + ge * jcols, dim=1).values - f_off
        H = torch.maximum(H_tmp, F)
        final_H = torch.where((q_lens == i)[:, None], H, final_H)

    valid = jcols[None, :] <= t_lens.to(i32)[:, None]
    masked = torch.where(valid, final_H, neg)
    score = masked.max(dim=1).values
    is_max = masked == score[:, None]
    first = torch.where(is_max, jcols[None, :] - 1, Lt).min(dim=1).values
    return score.to(i32), (first + 1).to(i32)
