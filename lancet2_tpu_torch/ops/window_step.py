"""Batched window step on a torch device.

Ports `lancet2_tpu/ops/window_step.py`: one call processes a fixed-shape
batch of windows end to end:

  inputs  reads [W, R, L]   uint8 base codes (5 = pad), read lens [W, R]
          haps  [W, H, LH]  haplotype codes,              hap lens [W, H]
          hap_allele [W, H] allele index per haplotype (0 = REF hap)
          read_sample [W, R] sample index per read, read_valid [W, R]

  compute 1. DP scores of every (read, hap) pair: through K3
             (ops/sw_cuda.fitting_scores: the CUDA kernel on a CUDA device,
             its plain version on the CPU) or through the dirs engine's
             score pass (ops/affine_dp_torch.py), per `dp_backend`
          2. allele assignment = argmax over haplotype scores
          3. per-(window, sample, allele) depth counts, a one-hot einsum
          4. Dirichlet-Multinomial PLs + GQ per (window, sample), float32

Outputs keep the JAX step's dict keys and layouts. `dp_backend` keeps the
JAX step's choice of engine under the port's names: 'kernel' (the JAX
package's 'pallas') is K3, which covers the fitting single-affine mode;
'scan' (the XLA lax.scan engine there) is `align_scores` of the dirs
engine, any AlignParams; 'auto' takes the kernel when the params fit its
mode and the scan otherwise, on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from lancet2_tpu_torch.ops.affine_dp import READ_TO_HAP, AlignParams
from lancet2_tpu_torch.ops.affine_dp_torch import align_scores
from lancet2_tpu_torch.ops.genotype import batched_genotype_pls
from lancet2_tpu_torch.ops.params import from_jax, kernel_fits
from lancet2_tpu_torch.ops.sw_cuda import fitting_scores

_BAND_Q = 64  # band-start quantization, as the JAX step's lane blocks
DP_BACKENDS = ("auto", "kernel", "scan")


def _extract_band(t, tl, ro, L: int, margin: int):
    """Banded target extraction: per pair, the window of the haplotype
    around the read's expected diagonal (its mapped offset into the window),
    starting on a multiple of 64 columns.

    t [B, LH] u8, tl [B] i32, ro [B] i32 (expected target start of the read)
    -> (t_band [B, Lb], tl_band [B], used) with Lb = roundup(L+2*margin, 128).
    The JAX step selects the band with a chain of lane-block selects; this
    is the same function as one gather.
    """
    B, LH = t.shape
    Lb = -(-(L + 2 * margin) // 128) * 128
    if LH <= Lb:
        return t, tl, False
    max_blk = (LH - Lb) // _BAND_Q
    sblk = torch.clamp(torch.div(ro - margin, _BAND_Q, rounding_mode="floor"),
                       0, max_blk)
    cols = (sblk * _BAND_Q)[:, None] + torch.arange(Lb, device=t.device)
    out = torch.gather(t, 1, cols.to(torch.int64))
    tl_band = torch.clamp(tl - sblk * _BAND_Q, 0, Lb).to(torch.int32)
    return out, tl_band, True


def window_pairs(reads, read_lens, haps, hap_lens, read_offset=None,
                 band_margin: int | None = None):
    """The DP batch of a window batch: every (window, read, hap) pair,
    window-major, as K3's contiguous inputs (q [B, L] u8, q_lens [B] i32,
    t [B, Lt] u8, t_lens [B] i32) with B = W*R*H. With band_margin and
    read_offset, t is each pair's band (`_extract_band`), else the whole
    haplotype."""
    W, R, L = reads.shape
    H, LH = haps.shape[1], haps.shape[2]
    q = reads[:, :, None, :].expand(W, R, H, L).reshape(-1, L)
    ql = read_lens[:, :, None].expand(W, R, H).reshape(-1)
    t = haps[:, None, :, :].expand(W, R, H, LH).reshape(-1, LH)
    tl = hap_lens[:, None, :].expand(W, R, H).reshape(-1)
    if band_margin is not None and read_offset is not None:
        ro = read_offset[:, :, None].expand(W, R, H).reshape(-1)
        t, tl, _ = _extract_band(t, tl, ro, L, band_margin)
    return q.contiguous(), ql.contiguous(), t.contiguous(), tl.contiguous()


def make_window_step(num_samples: int, num_alleles: int,
                     params: AlignParams = READ_TO_HAP,
                     device: torch.device | str = "cuda",
                     band_margin: int | None = None,
                     dp_backend: str = "auto"):
    """Build the window-batch step function for `device` (a CUDA device
    unless the caller asks for the CPU). Its inputs may be numpy arrays or
    tensors; they are moved to the device, and the outputs stay there.

    band_margin: when set, the step takes an extra read_offset [W, R] input
    (each read's expected start inside the window) and runs the DP over a
    banded target window of roundup(L+2*margin, 128) columns instead of the
    full haplotype — exact whenever the optimal path stays inside the band.

    dp_backend: 'kernel' (K3; params outside its mode raise
    NotImplementedError), 'scan' (the dirs engine's score pass, any params)
    or 'auto' (the kernel when `kernel_fits(params)`, else the scan).
    """
    if dp_backend not in DP_BACKENDS:
        raise ValueError(f"dp_backend must be one of {DP_BACKENDS}, "
                         f"got {dp_backend!r}")
    device = torch.device(device)
    use_kernel = dp_backend == "kernel" or (
        dp_backend == "auto" and kernel_fits(params))
    kp = from_jax(params).to(device) if use_kernel else None

    def scores_of(q, ql, t, tl):
        if use_kernel:
            return fitting_scores(q, ql, t, tl, kp)[0]
        return align_scores(q, ql, t, tl, params)[0]

    def as_dev(x, dtype):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    def step(reads, read_lens, read_sample, read_valid, haps, hap_lens,
             hap_allele, read_offset=None):
        reads = as_dev(reads, torch.uint8)
        read_lens = as_dev(read_lens, torch.int32)
        read_sample = as_dev(read_sample, torch.int64)
        read_valid = as_dev(read_valid, torch.bool)
        haps = as_dev(haps, torch.uint8)
        hap_lens = as_dev(hap_lens, torch.int32)
        hap_allele = as_dev(hap_allele, torch.int64)
        W, R, _L = reads.shape
        H = haps.shape[1]
        if read_offset is not None:
            read_offset = as_dev(read_offset, torch.int32)
        scores = scores_of(*window_pairs(reads, read_lens, haps, hap_lens,
                                         read_offset, band_margin))
        scores = scores.reshape(W, R, H)

        # allele assignment: best haplotype per read (mask invalid reads)
        best_hap = torch.argmax(scores, dim=-1)  # the first best
        best_score = scores.max(dim=-1).values
        assigned_allele = torch.gather(hap_allele, 1, best_hap)  # [W, R]

        # minimum-score gate stands in for mapability filtering
        ok = read_valid & (best_score >= read_lens // 4)

        # per-(window, sample, allele) depth counts: one-hot contraction
        f32 = torch.float32
        sample_oh = torch.nn.functional.one_hot(read_sample,
                                                num_samples).to(f32)
        allele_oh = torch.nn.functional.one_hot(assigned_allele,
                                                num_alleles).to(f32)
        allele_oh = allele_oh * ok[:, :, None].to(f32)
        counts = torch.einsum("wrs,wra->wsa", sample_oh, allele_oh)

        pls, gq, best_gt = batched_genotype_pls(
            counts.reshape(-1, num_alleles), num_alleles)
        G = num_alleles * (num_alleles + 1) // 2
        return {
            "scores": scores,
            "allele_counts": counts,
            "pls": pls.reshape(W, num_samples, G),
            "gq": gq.reshape(W, num_samples),
            "best_gt": best_gt.reshape(W, num_samples),
        }

    return step


def synth_window_batch(
    rng: np.random.Generator,
    num_windows: int = 8,
    reads_per_window: int = 64,
    read_len: int = 128,
    num_haps: int = 4,
    hap_len: int = 512,
    num_samples: int = 2,
):
    """Synthetic fixed-shape window batch for benches and checks: the JAX
    package's generator, draw for draw, as CPU tensors (the same seed gives
    the same arrays)."""
    W, R, L, H, LH = num_windows, reads_per_window, read_len, num_haps, hap_len
    haps = rng.integers(0, 4, (W, H, LH)).astype(np.uint8)
    # ALT haps = ref hap with one SNV
    haps[:, 1:, :] = haps[:, :1, :]
    for h in range(1, H):
        pos = LH // 2 + h
        haps[:, h, pos] = (haps[:, h, pos] + 1) % 4
    reads = np.zeros((W, R, L), dtype=np.uint8)
    read_offset = np.zeros((W, R), dtype=np.int32)
    read_sample = rng.integers(0, num_samples, (W, R)).astype(np.int32)
    src_hap = rng.integers(0, 2, (W, R)).astype(np.int32)  # REF or first ALT
    for w in range(W):
        for r in range(R):
            start = int(rng.integers(0, LH - L))
            reads[w, r] = haps[w, src_hap[w, r], start : start + L]
            read_offset[w, r] = start
    read_lens = np.full((W, R), L, dtype=np.int32)
    hap_lens = np.full((W, H), LH, dtype=np.int32)
    hap_allele = np.minimum(np.arange(H), 1)[None, :].repeat(W, axis=0).astype(np.int32)
    read_valid = np.ones((W, R), dtype=bool)
    return {k: torch.from_numpy(v) for k, v in dict(
        reads=reads,
        read_lens=read_lens,
        read_sample=read_sample,
        read_valid=read_valid,
        haps=haps,
        hap_lens=hap_lens,
        hap_allele=hap_allele,
        read_offset=read_offset,
    ).items()}
