"""K3's schedule, rehearsed on the CPU.

csrc/sw_fitting.cuh holds the per-lane step `l2t_sw::lane_step<RPL>` that
the CUDA kernel (csrc/sw_fitting.cu) runs, and `fitting_pair_lockstep<RPL>`,
which runs the kernel's schedule on the host: 32 lanes in lockstep over the
anti-diagonals, each reading the cell above from its neighbour's last step,
stripes of 32 * RPL rows meeting at boundary rows. This test compiles the
header with g++ behind a small `extern "C"` wrapper, loads it with ctypes
and holds the schedule, score and t_end, against the plain version
`fitting_scores_torch` on the edge batch of ops/sw_cases.py, at several
rows per lane and at a shape where pairs take several stripes. It skips
only when no g++ is on PATH.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS
from lancet2_tpu_torch.ops.sw_cases import edge_pairs
from lancet2_tpu_torch.ops.sw_dp import fitting_scores_torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "lancet2_tpu_torch", "csrc")

_WRAPPER = r"""
#include <vector>
#include "sw_fitting.cuh"
#define L2T_HOST(R)                                                          \
  extern "C" void l2t_sw_host_rpl##R(                                        \
      const uint8_t* q, const int* q_lens, const uint8_t* t,                 \
      const int* t_lens, int B, int Lq, int Lt, int match, int mismatch,     \
      int go, int ge, int* score, int* t_end) {                              \
    const l2t_sw::Params p{match, mismatch, go, ge};                         \
    std::vector<int32_t> G(4 * (Lt > 0 ? Lt : 1));                           \
    for (int b = 0; b < B; ++b)                                              \
      l2t_sw::fitting_pair_lockstep<R>(q + (long)b * Lq, q_lens[b], Lq,      \
                                       t + (long)b * Lt, t_lens[b], Lt, p,   \
                                       G.data(), score + b, t_end + b);      \
  }
L2T_HOST(1)
L2T_HOST(2)
L2T_HOST(3)
L2T_HOST(4)
L2T_HOST(5)
L2T_HOST(8)
extern "C" void l2t_sw_host_plan(int Lq, int* rpl, int* stripes) {
  const l2t_sw::Plan p = l2t_sw::plan(Lq);
  *rpl = p.rpl;
  *stripes = p.stripes;
}
"""

# (B, Lq, Lt): pairs of up to 200 rows, several stripes at RPL <= 4 (four
# at RPL 1); and a band of 1-3 stripes at RPL 1-2, one at RPL >= 3
SHAPES = [(200, 200, 150), (150, 80, 96)]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: cannot compile csrc/sw_fitting.cuh")
    out = tmp_path_factory.mktemp("sw_cell")
    src, so = out / "wrapper.cpp", out / "libsw_host.so"
    src.write_text(_WRAPPER)
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


@pytest.fixture
def one_torch_thread():
    """The plain version runs hundreds of small torch ops; with the suite's
    workers sharing the host's cores, one intra-op thread each keeps them
    from contending. One thread is enough at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _host(lib, arrays, rpl, kp):
    q, q_lens, t, t_lens = (np.ascontiguousarray(a) for a in arrays)
    B, Lq = q.shape
    Lt = t.shape[1]
    score = np.zeros(B, np.int32)
    t_end = np.zeros(B, np.int32)
    fn = getattr(lib, f"l2t_sw_host_rpl{rpl}")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 4 + [ci] * 7 + [vp] * 2
    fn(q.ctypes.data, q_lens.ctypes.data, t.ctypes.data, t_lens.ctypes.data,
       B, Lq, Lt, kp.match, kp.mismatch, kp.gap_open, kp.gap_extend,
       score.ctypes.data, t_end.ctypes.data)
    return score, t_end


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("rpl", [1, 2, 3, 4, 5, 8])
def test_lockstep_schedule_matches_plain(host_lib, one_torch_thread, rpl,
                                         shape):
    B, Lq, Lt = shape
    kp = READ_TO_HAP_PARAMS
    arrays = edge_pairs(300 + 10 * rpl + Lq, B, Lq, Lt, rpls=(rpl, 4, 5))
    want_s, want_e = fitting_scores_torch(
        *(torch.from_numpy(a) for a in arrays), kp)
    got_s, got_e = _host(host_lib, arrays, rpl, kp)
    bad = np.flatnonzero((got_s != want_s.numpy()) | (got_e != want_e.numpy()))
    assert bad.size == 0, (
        f"pairs {bad[:5].tolist()} (q_len {arrays[1][bad[:5]].tolist()}, "
        f"t_len {arrays[3][bad[:5]].tolist()}): score "
        f"{got_s[bad[:5]].tolist()} vs {want_s.numpy()[bad[:5]].tolist()}, "
        f"t_end {got_e[bad[:5]].tolist()} vs {want_e.numpy()[bad[:5]].tolist()}")
    # the batch reaches several stripes wherever Lq allows them
    assert Lq <= 32 * rpl or int((arrays[1] > 32 * rpl).sum()) > 0


def test_plan_rows_per_lane(host_lib):
    """One stripe of ceil(Lq / 32) rows per lane up to 256 rows (4 at the
    window step's Lq 128, 5 at bench.py's 152), then the fewest stripes of
    at most 8 rows per lane."""
    fn = host_lib.l2t_sw_host_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    got = {}
    for Lq in (1, 32, 33, 128, 152, 256, 257, 400, 512, 513, 2000):
        rpl, st = ctypes.c_int(0), ctypes.c_int(0)
        fn(Lq, ctypes.byref(rpl), ctypes.byref(st))
        got[Lq] = (rpl.value, st.value)
    assert got == {1: (1, 1), 32: (1, 1), 33: (2, 1), 128: (4, 1),
                   152: (5, 1), 256: (8, 1), 257: (5, 2), 400: (7, 2),
                   512: (8, 2), 513: (6, 3), 2000: (8, 8)}
