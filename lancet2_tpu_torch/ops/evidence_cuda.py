"""Wrappers of K1 (span) and K2 (evidence): csrc/evidence_dp.cu.

Ports `lancet2_tpu/ops/evidence_pallas.py` `span_pairs_submit/finalize` and
`evidence_pairs_submit/finalize`. A submit takes tensors that all lie on one
device:

  * on the CPU it runs the plain version (ops/evidence_dp.py);
  * on a CUDA device it launches the kernel on the current stream, without
    synchronizing, and counts the launch in LAUNCHES;
  * on any other device it raises.

A finalize copies the outputs to the host (this is where a caller waits for
the device) and returns the dict of `lancet2_tpu.ops.evidence_dp`. Launch
counts live in ops/_build.py (`LAUNCHES`, re-exported here).

The TPU's padding (Lq % 8, Lt % 128, 128-pair tiles), bit-packed output
columns and descent taint are not carried over: the kernel takes any shape
and is exact at any deletion distance. A launch allocates one boundary row
per resident warp (2 * (3 + 6R) * Lt ints each) and a pair counter.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from lancet2_tpu_torch.ops._build import (
    LAUNCHES,
    count_launch,
    library,
    reset_launches,
)
from lancet2_tpu_torch.ops.evidence_dp import (
    MAX_LEN,
    R_MAX,
    REGION_FILL,
    REGION_FLOAT_KEYS,
    REGION_INT_KEYS,
    SPAN_KEYS,
    evidence_dp_torch,
)
from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS, KernelParams

KERNEL_R = (0, 1, 2, 4)  # instantiated region-slot counts (0 = span)

__all__ = ["LAUNCHES", "reset_launches", "span_pairs_submit",
           "span_pairs_finalize", "evidence_pairs_submit",
           "evidence_pairs_finalize"]


def _check(q, qu, q_lens, t, t_lens, regions, R):
    if R not in KERNEL_R:
        raise ValueError(f"R must be one of {KERNEL_R}, got {R}")
    tensors = {"q": q, "q_lens": q_lens, "t": t, "t_lens": t_lens}
    if R:
        tensors.update(qu=qu, regions=regions)
    dev = q.device
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q is on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, Lq = q.shape
    Lt = t.shape[1]
    if Lq > MAX_LEN or Lt > MAX_LEN:
        raise ValueError(f"Lq={Lq}, Lt={Lt}: both must be <= {MAX_LEN}")
    want = {"q": ((B, Lq), torch.uint8), "t": ((B, Lt), torch.uint8),
            "q_lens": ((B,), torch.int32), "t_lens": ((B,), torch.int32)}
    if R:
        want.update(qu=((B, Lq), torch.uint8),
                    regions=((B, R_MAX, 2), torch.int32))
    for name, (shape, dtype) in want.items():
        x = tensors[name]
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    return dev, B, Lq, Lt


@functools.cache
def _kernel(R: int):
    """The C entry points of csrc/evidence_dp.cu for R: `slots(B, &n)` gives
    the warps of a launch over B pairs (each needs a boundary row of
    2 * (3 + 6R) * Lt ints of scratch), and the launch returns
    cudaGetLastError()."""
    lib = library()
    slots = getattr(lib, f"l2t_evidence_dp_slots_r{R}")
    slots.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    slots.restype = ctypes.c_int
    fn = getattr(lib, f"l2t_evidence_dp_r{R}")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 7 + [ci] * 8 + [vp] * 5
    fn.restype = ci
    return slots, fn


def _pack(out: dict, R: int):
    """Plain-version dict -> (iout [B, 4+3R] int32, fout [B, 3R] float32),
    the kernel's output layout."""
    cols = [out[k][:, None].to(torch.int32) for k in SPAN_KEYS]
    cols += [out[k].to(torch.int32) for k in REGION_INT_KEYS if R]
    iout = torch.cat(cols, dim=1)
    fout = (torch.cat([out[k] for k in REGION_FLOAT_KEYS], dim=1) if R
            else torch.empty((iout.shape[0], 0), dtype=torch.float32))
    return iout, fout


def _run(q, qu, q_lens, t, t_lens, regions, R: int, kp: KernelParams):
    dev, B, Lq, Lt = _check(q, qu, q_lens, t, t_lens, regions, R)
    if dev.type == "cpu":
        return _pack(evidence_dp_torch(q, qu, q_lens, t, t_lens, regions, kp,
                                       r_max=R), R)
    if dev.type != "cuda":
        raise ValueError(f"no evidence DP for device {dev}")
    iout = torch.empty((B, 4 + 3 * R), dtype=torch.int32, device=dev)
    fout = torch.empty((B, 3 * R), dtype=torch.float32, device=dev)
    if B == 0:
        return iout, fout
    slots_fn, fn = _kernel(R)
    with torch.cuda.device(dev):
        slots = ctypes.c_int(0)
        err = slots_fn(B, ctypes.byref(slots))
        if err != 0:
            raise RuntimeError(f"evidence DP kernel (R={R}): occupancy query "
                               f"failed: CUDA error {err}")
        # boundary rows, one per warp of the launch, and the pair counter;
        # they and the inputs may be freed while the kernel runs: the caching
        # allocator hands their memory out again only in this stream's order
        scratch = torch.empty(slots.value * 2 * (3 + 6 * R) * Lt,
                              dtype=torch.int32, device=dev)
        next_pair = torch.zeros(1, dtype=torch.int32, device=dev)
        conf = kp.to(dev).conf
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), qu.data_ptr() if R else None,
                 q_lens.data_ptr(), t.data_ptr(), t_lens.data_ptr(),
                 regions.data_ptr() if R else None, conf.data_ptr(),
                 B, Lq, Lt, kp.match, kp.mismatch, kp.gap_open,
                 kp.gap_extend, slots.value, scratch.data_ptr(),
                 next_pair.data_ptr(), iout.data_ptr(),
                 fout.data_ptr() if R else None, stream)
    if err != 0:
        raise RuntimeError(f"evidence DP kernel (R={R}) launch failed: "
                           f"CUDA error {err}")
    count_launch("span" if R == 0 else "evidence")
    return iout, fout


def span_pairs_submit(q, q_lens, t, t_lens,
                      kp: KernelParams = READ_TO_HAP_PARAMS) -> torch.Tensor:
    """K1 over one chunk: returns iout [B, 4] int32 (score, t_end, t_start,
    nm) on the inputs' device, without waiting for it."""
    return _run(q, None, q_lens, t, t_lens, None, 0, kp)[0]


def span_pairs_finalize(iout: torch.Tensor) -> dict:
    iout = iout.cpu().numpy()
    return {k: iout[:, n] for n, k in enumerate(SPAN_KEYS)}


def evidence_pairs_submit(q, qu, q_lens, t, t_lens, regions, R: int,
                          kp: KernelParams = READ_TO_HAP_PARAMS):
    """K2 over one chunk with region slots [0, R) (slots >= R must be
    inactive). Returns (iout [B, 4+3R] int32, fout [B, 3R] float32) on the
    inputs' device, without waiting for them."""
    if R == 0:
        raise ValueError("the evidence kernel needs R >= 1; use span_pairs_submit")
    return _run(q, qu, q_lens, t, t_lens, regions, R, kp)


def evidence_pairs_finalize(iout: torch.Tensor, fout: torch.Tensor,
                            R: int) -> dict:
    """Host unpack into the [B] / [B, R_MAX] arrays of the reference engine
    (slots >= R carry the inactive-slot values)."""
    iout = iout.cpu().numpy()
    fout = fout.cpu().numpy()
    B = iout.shape[0]
    out = {k: iout[:, n] for n, k in enumerate(SPAN_KEYS)}
    for n, k in enumerate(REGION_INT_KEYS):
        a = np.full((B, R_MAX), REGION_FILL[k], np.int32)
        a[:, :R] = iout[:, 4 + n * R: 4 + (n + 1) * R]
        out[k] = a
    for n, k in enumerate(REGION_FLOAT_KEYS):
        a = np.full((B, R_MAX), REGION_FILL[k], np.float32)
        a[:, :R] = fout[:, n * R:(n + 1) * R]
        out[k] = a
    return out
