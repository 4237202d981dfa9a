"""The CUDA kernel's arithmetic, checked on the CPU.

csrc/evidence_dp.cuh holds the cell update `l2t::cell<R>` that the K1/K2
kernel (csrc/evidence_dp.cu) runs in anti-diagonal order, and a host
reference `l2t::dp_pair_host<R>` that runs the same cell update row by row.
This test compiles the header with g++ behind a small `extern "C"` wrapper,
loads it with ctypes and holds the host reference bit for bit against the
plain version `evidence_dp_torch` at R 0, 1, 2 and 4, on the edge batch of
ops/evidence_cases.py (the batch the kernel meets on the card). It skips
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

from lancet2_tpu_torch.ops import evidence_cuda as ec
from lancet2_tpu_torch.ops.evidence_cases import edge_pairs
from lancet2_tpu_torch.ops.evidence_dp import evidence_dp_torch
from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "lancet2_tpu_torch", "csrc")

_WRAPPER = r"""
#include "evidence_dp.cuh"
#define L2T_HOST(R)                                                          \
  extern "C" void l2t_host_r##R(                                             \
      const uint8_t* q, const uint8_t* qu, const int* q_lens,                \
      const uint8_t* t, const int* t_lens, const int* regions,               \
      const float* conf, int B, int Lq, int Lt, int match, int mismatch,     \
      int go, int ge, int* iout, float* fout) {                              \
    const l2t::Scoring sc{match, mismatch, go, ge};                          \
    for (int b = 0; b < B; ++b)                                              \
      l2t::dp_pair_host<R>(b, q, qu, q_lens, t, t_lens, regions, conf, Lq,   \
                           Lt, sc, iout, fout);                              \
  }
L2T_HOST(0)
L2T_HOST(1)
L2T_HOST(2)
L2T_HOST(4)
"""

# (B, Lq, Lt): the edge batch at a width with three stripe boundaries and
# five column chunks, and a narrower one with a single full-width stripe
# boundary
SHAPES = [(176, 100, 160), (120, 70, 90)]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: cannot compile csrc/evidence_dp.cuh")
    out = tmp_path_factory.mktemp("evidence_cell")
    src, so = out / "wrapper.cpp", out / "libevidence_host.so"
    src.write_text(_WRAPPER)
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(so), str(src)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


@pytest.fixture
def one_torch_thread():
    """The plain version runs thousands of small torch ops; with the suite's
    workers sharing the host's cores, every worker's intra-op thread pool
    competing for them slowed this test a hundredfold. One thread is
    enough at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _host_dp(lib, arrays, R, kp):
    q, qu, q_lens, t, t_lens, regions = (np.ascontiguousarray(a) for a in arrays)
    B, Lq = q.shape
    Lt = t.shape[1]
    iout = np.zeros((B, 4 + 3 * R), np.int32)
    fout = np.zeros((B, 3 * R), np.float32)
    conf = np.ascontiguousarray(kp.conf.numpy(), np.float32)
    fn = getattr(lib, f"l2t_host_r{R}")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 7 + [ci] * 7 + [vp] * 2
    fn(q.ctypes.data, qu.ctypes.data, q_lens.ctypes.data, t.ctypes.data,
       t_lens.ctypes.data, regions.ctypes.data, conf.ctypes.data, B, Lq, Lt,
       kp.match, kp.mismatch, kp.gap_open, kp.gap_extend, iout.ctypes.data,
       fout.ctypes.data)
    return iout, fout


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("R", [0, 1, 2, 4])
def test_host_cell_matches_plain(host_lib, one_torch_thread, R, shape):
    B, Lq, Lt = shape
    kp = READ_TO_HAP_PARAMS
    arrays = edge_pairs(700 + 10 * R + Lq, B, Lq, Lt, R)
    want_i, want_f = ec._pack(evidence_dp_torch(
        *(torch.from_numpy(a) for a in arrays), kp, r_max=R), R)
    got_i, got_f = _host_dp(host_lib, arrays, R, kp)
    bad = np.argwhere(got_i != want_i.numpy())
    assert bad.size == 0, f"iout differs at (pair, column) {bad[:5].tolist()}"
    # float32 bit patterns, so that -0.0 and 0.0 differ too
    bad = np.argwhere(got_f.view(np.int32) != want_f.numpy().view(np.int32))
    assert bad.size == 0, f"fout differs at (pair, column) {bad[:5].tolist()}"
    # the batch reaches what it is meant to: long deletions and indels won
    assert int((want_i[:, 3] >= 33).sum()) > 0
