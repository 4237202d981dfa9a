"""Wrapper of K3, the score-only fitting DP: csrc/sw_fitting.cu.

Ports `lancet2_tpu/ops/sw_pallas.py` (`fitting_scores_device`,
`sw_fitting_scores_pallas`). `fitting_scores` takes tensors that all lie on
one device:

  * on the CPU it runs the plain version (ops/sw_dp.py);
  * on a CUDA device it launches the kernel on the current stream, without
    synchronizing, and counts the launch in LAUNCHES["sw_fitting"];
  * on any other device it raises.

The Pallas kernel's shape contract (256-pair tiles, Lq % 8, Lt % 128,
queries transposed to [Lq, B]) is not carried over: the kernel takes any
shape. It holds the substitution scores as signed bytes and refuses others
(the launch returns an error, and the wrapper raises).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lancet2_tpu_torch.ops._build import count_launch, library
from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS, KernelParams
from lancet2_tpu_torch.ops.sw_dp import fitting_scores_torch


@functools.cache
def _kernel():
    """The C entry points: the launch `l2t_sw_fitting` (it returns
    cudaGetLastError() of the launch) and the bytes of scratch it needs,
    `l2t_sw_fitting_scratch_bytes(B, Lq, Lt)`."""
    lib = library()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.l2t_sw_fitting
    fn.argtypes = [vp] * 4 + [ci] * 7 + [vp] * 4
    fn.restype = ci
    scratch = lib.l2t_sw_fitting_scratch_bytes
    scratch.argtypes = [ci] * 3
    scratch.restype = ctypes.c_longlong
    return fn, scratch


def warps_per_sm(rpl: int, multi: bool) -> int:
    """Resident warps (pairs in flight) per SM of the kernel at `rpl` query
    rows per lane, single- or multi-stripe: the occupancy query."""
    fn = library().l2t_sw_fitting_warps_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(rpl, int(multi), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"occupancy query failed for rpl={rpl}: CUDA "
                           f"error {err}")
    return out.value


def rows_per_lane(Lq: int) -> int:
    """The kernel's query rows per lane for a launch at Lq."""
    fn = library().l2t_sw_fitting_rpl_for
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(Lq)


def _check(q, q_lens, t, t_lens):
    tensors = {"q": q, "q_lens": q_lens, "t": t, "t_lens": t_lens}
    dev = q.device
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q is on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 2 or t.dim() != 2:
        raise ValueError("q and t must be [B, L] matrices")
    B, Lq = q.shape
    Lt = t.shape[1]
    want = {"q": ((B, Lq), torch.uint8), "t": ((B, Lt), torch.uint8),
            "q_lens": ((B,), torch.int32), "t_lens": ((B,), torch.int32)}
    for name, (shape, dtype) in want.items():
        x = tensors[name]
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    return dev, B, Lq, Lt


def fitting_scores(q, q_lens, t, t_lens,
                   kp: KernelParams = READ_TO_HAP_PARAMS):
    """q [B, Lq] uint8, q_lens [B] int32, t [B, Lt] uint8, t_lens [B]
    int32 -> (score int32 [B], t_end int32 [B], 1-based) on the inputs'
    device, without waiting for them."""
    dev, B, Lq, Lt = _check(q, q_lens, t, t_lens)
    if dev.type == "cpu":
        return fitting_scores_torch(q, q_lens, t, t_lens, kp)
    if dev.type != "cuda":
        raise ValueError(f"no fitting DP for device {dev}")
    score = torch.empty(B, dtype=torch.int32, device=dev)
    t_end = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return score, t_end
    launch, scratch_bytes = _kernel()
    # boundary rows, only for queries of more than one stripe; scratch and
    # the inputs may be freed while the kernel runs: the caching allocator
    # hands their memory out again only in this stream's order
    nbytes = scratch_bytes(B, Lq, Lt)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(q.data_ptr(), q_lens.data_ptr(), t.data_ptr(),
                     t_lens.data_ptr(), B, Lq, Lt, kp.match, kp.mismatch,
                     kp.gap_open, kp.gap_extend,
                     None if scratch is None else scratch.data_ptr(),
                     score.data_ptr(), t_end.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fitting DP kernel launch failed: CUDA error {err}")
    count_launch("sw_fitting")
    return score, t_end
