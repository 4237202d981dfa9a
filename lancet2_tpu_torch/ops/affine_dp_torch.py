"""Batched dual-affine alignment DP in plain PyTorch: the dirs engine.

Ports `lancet2_tpu/ops/affine_dp_jax.py` (`_row_step`, `_make_align`,
`align_scores_jax`, `align_dirs_jax`): the same recurrences as the numpy
baseline in ops/affine_dp.py, as a loop over query rows, each row vectorized
over [pairs, target columns]; vertical gaps elementwise, horizontal gaps
through the exact max-plus identity with `torch.cummax`. The JAX engine is
jitted XLA (no Pallas kernel), so this is plain PyTorch on the CPU and on a
CUDA device alike.

Every op matches the JAX engine's, so the outputs are bit-equal: int32
throughout, the winner order (diag, V1, V2, F1, F2), the extension bits,
the q_active / final_H masks and the first maximum for `free_target_ends`.

Two entry points, numpy in and out, on an explicit torch device:

  * align_scores_torch: score and t_end only (`align_scores` is the same on
    tensors, for the window step's scan route);
  * align_dirs_torch:   also the packed per-cell direction bytes [B, Lq, Lt]
    that ops/affine_dp.traceback_batch walks on the host.

Scores are int32; bases are uint8 codes (0..3 ACGT, 4=N, >=5 pad).
"""

from __future__ import annotations

import numpy as np
import torch

from lancet2_tpu_torch.ops.affine_dp import NEG_INF, AlignParams

_NEG = int(NEG_INF)
_I32 = torch.int32


def _subs(qi: torch.Tensor, targets: torch.Tensor, p: AlignParams):
    """[B, Lt] int32: +match / -mismatch; any N (4) or pad (>4) scores 0."""
    eq = qi[:, None] == targets
    any_n = (qi[:, None] >= 4) | (targets >= 4)
    sub = eq.to(_I32) * (p.match + p.mismatch) - p.mismatch
    return sub.masked_fill_(any_n, 0)


def _align(queries, q_lens, targets, t_lens, p: AlignParams, with_dirs: bool):
    """Tensors on one device: queries [B, Lq] u8, q_lens [B] i32, targets
    [B, Lt] u8, t_lens [B] i32. Returns (score [B] i32, t_end [B] i32,
    dirs [B, Lq, Lt] u8 or None)."""
    dev = queries.device
    B, Lq = queries.shape
    Lt = targets.shape[1]
    q1, e1 = p.gap_open1, p.gap_extend1
    dual = p.dual
    q2, e2 = (p.gap_open2, p.gap_extend2) if dual else (q1, e1)

    jcols = torch.arange(1, Lt + 1, dtype=_I32, device=dev)
    t_valid = jcols[None, :] <= t_lens[:, None]
    # F's max-plus identity: F[j] = cummax_k<j(Htmp[k] + e*(k+1)) - off[j]
    gain1 = e1 * jcols
    off1 = (q1 + e1) + e1 * (jcols - 1) + e1
    gain2 = e2 * jcols
    off2 = (q2 + e2) + e2 * (jcols - 1) + e2

    if p.free_target_ends:
        H = torch.zeros((B, Lt + 1), dtype=_I32, device=dev)
    else:
        row0 = -(q1 + e1 * jcols)
        if dual:
            row0 = torch.maximum(row0, -(q2 + e2 * jcols))
        row0 = torch.where(t_valid, row0[None, :], _NEG)
        H = torch.cat([torch.zeros((B, 1), dtype=_I32, device=dev), row0], 1)
    V1 = torch.full((B, Lt + 1), _NEG, dtype=_I32, device=dev)
    V2 = V1
    final_H = H
    neg_col = torch.full((B, 1), _NEG, dtype=_I32, device=dev)
    neg_row = torch.full((B, Lt), _NEG, dtype=_I32, device=dev)
    no_ext = torch.zeros((B, Lt), dtype=torch.bool, device=dev)
    first_col = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    dirs = (torch.empty((B, Lq, Lt), dtype=torch.uint8, device=dev)
            if with_dirs else None)

    for i in range(1, Lq + 1):
        sub = _subs(queries[:, i - 1], targets, p)
        diag = H[:, :-1] + sub

        v1_open = H[:, 1:] - (q1 + e1)
        v1_ext = V1[:, 1:] - e1
        V1_row = torch.maximum(v1_open, v1_ext)
        v1_is_ext = v1_ext >= v1_open
        if dual:
            v2_open = H[:, 1:] - (q2 + e2)
            v2_ext = V2[:, 1:] - e2
            V2_row = torch.maximum(v2_open, v2_ext)
            v2_is_ext = v2_ext >= v2_open
        else:
            V2_row = neg_row
            v2_is_ext = no_ext

        H_tmp = torch.maximum(diag, torch.maximum(V1_row, V2_row))

        col0 = -(q1 + e1 * i)
        if dual:
            col0 = max(col0, -(q2 + e2 * i))
        h_col0 = torch.full((B, 1), col0, dtype=_I32, device=dev)

        shifted = torch.cat([h_col0, H_tmp[:, :-1]], 1)  # Htmp_full[:, :-1]
        F1_row = torch.cummax(shifted + gain1, dim=1).values - off1
        if dual:
            F2_row = torch.cummax(shifted + gain2, dim=1).values - off2
        else:
            F2_row = neg_row

        H_row = torch.maximum(H_tmp, torch.maximum(F1_row, F2_row))

        if with_dirs:
            f1_is_ext = torch.cat(
                [first_col, F1_row[:, 1:] == F1_row[:, :-1] - e1], 1)
            if dual:
                f2_is_ext = torch.cat(
                    [first_col, F2_row[:, 1:] == F2_row[:, :-1] - e2], 1)
            else:
                f2_is_ext = no_ext
            winner = torch.full((B, Lt), 4, dtype=torch.uint8, device=dev)
            winner.masked_fill_(F1_row >= H_row, 3)
            winner.masked_fill_(V2_row >= H_row, 2)
            winner.masked_fill_(V1_row >= H_row, 1)
            winner.masked_fill_(diag >= H_row, 0)
            dirs[:, i - 1, :] = (
                winner
                | (v1_is_ext.to(torch.uint8) << 3)
                | (v2_is_ext.to(torch.uint8) << 4)
                | (f1_is_ext.to(torch.uint8) << 5)
                | (f2_is_ext.to(torch.uint8) << 6)
            )

        H_row = torch.where(t_valid, H_row, _NEG)
        H_full = torch.cat([h_col0, H_row], 1)
        V1_full = torch.cat([neg_col, torch.where(t_valid, V1_row, _NEG)], 1)
        V2_full = torch.cat([neg_col, torch.where(t_valid, V2_row, _NEG)], 1)

        q_active = (i <= q_lens)[:, None]
        H = torch.where(q_active, H_full, H)
        V1 = torch.where(q_active, V1_full, V1)
        V2 = torch.where(q_active, V2_full, V2)
        final_H = torch.where((i == q_lens)[:, None], H, final_H)

    if p.free_target_ends:
        valid0 = torch.cat([first_col, t_valid], 1)
        masked = torch.where(valid0, final_H, _NEG)
        score = masked.max(dim=1).values
        # the first maximum, as jnp.argmax
        cols = torch.arange(Lt + 1, dtype=_I32, device=dev)
        t_end = torch.where(masked == score[:, None], cols, Lt + 1
                            ).min(dim=1).values
    else:
        t_end = t_lens.to(_I32)
        score = final_H.gather(1, t_end[:, None].long())[:, 0]
    return score, t_end, dirs


def _inputs(queries, q_lens, targets, t_lens, device):
    dev = torch.device(device)

    def put(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)

    return (put(queries, np.uint8), put(q_lens, np.int32),
            put(targets, np.uint8), put(t_lens, np.int32))


@torch.inference_mode()
def align_scores(queries, q_lens, targets, t_lens, p: AlignParams):
    """Scores + end positions of tensors on one device (queries/targets
    uint8, lens int32); returns int32 tensors there."""
    score, t_end, _ = _align(queries, q_lens.to(_I32), targets,
                             t_lens.to(_I32), p, with_dirs=False)
    return score, t_end


def align_scores_torch(queries, q_lens, targets, t_lens, p: AlignParams,
                       device="cuda"):
    """Scores + end positions only. Returns numpy int32 arrays."""
    score, t_end = align_scores(*_inputs(queries, q_lens, targets, t_lens,
                                         device), p)
    return score.cpu().numpy(), t_end.cpu().numpy()


@torch.inference_mode()
def align_dirs_torch(queries, q_lens, targets, t_lens, p: AlignParams,
                     device="cuda"):
    """Scores, end positions, and the packed direction matrix [B, Lq, Lt]
    (for traceback). Returns numpy arrays (int32, int32, uint8)."""
    score, t_end, dirs = _align(*_inputs(queries, q_lens, targets, t_lens,
                                         device), p, with_dirs=True)
    return score.cpu().numpy(), t_end.cpu().numpy(), dirs.cpu().numpy()
