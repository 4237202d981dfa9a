"""Parity: K3's plain version and wrapper against the JAX package.

`lancet2_tpu_torch.ops.sw_dp.fitting_scores_torch` must equal, score and
t_end exactly,
  * the Pallas K3 (`lancet2_tpu/ops/sw_pallas.py`) run in interpret mode,
    patched as tests/test_aux.py::TestPallasInterpret patches it, with N
    bases, padding, short and degenerate lengths;
  * `lancet2_tpu.ops.affine_dp_jax.align_scores_jax` at an Lq that is not a
    multiple of 8 and an Lt that is not a multiple of 128.
The CUDA kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py). Inputs are made with numpy.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import lancet2_tpu.ops.sw_pallas as swp
from lancet2_tpu.ops.affine_dp import READ_TO_HAP
from lancet2_tpu.ops.affine_dp_jax import align_scores_jax
from lancet2_tpu_torch.ops import sw_cuda
from lancet2_tpu_torch.ops._build import LAUNCHES
from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS
from lancet2_tpu_torch.ops.sw_dp import fitting_scores_torch


def sw_case(seed: int, B: int, Lq: int, Lt: int, min_len: int = 1):
    """Reads cut from their targets with 10% noise (N included), the rest
    padded with 5; targets padded past t_len and sprinkled with N."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    q = np.full((B, Lq), 5, np.uint8)
    ql = rng.integers(min_len, Lq + 1, B).astype(np.int32)
    tl = rng.integers(min_len, Lt + 1, B).astype(np.int32)
    for b in range(B):
        n = int(ql[b])
        off = int(rng.integers(0, max(1, Lt - n)))
        read = np.concatenate([t[b, off:off + n], rng.integers(0, 4, n)])[:n]
        noisy = rng.random(n) < 0.1
        q[b, :n] = np.where(noisy, rng.integers(0, 5, n), read)
        t[b, tl[b]:] = 5
    t[rng.random((B, Lt)) < 0.02] = 4
    return q, ql, t, tl


def _plain(q, ql, t, tl):
    s, e = fitting_scores_torch(*(torch.from_numpy(a) for a in (q, ql, t, tl)),
                                READ_TO_HAP_PARAMS)
    assert s.dtype == e.dtype == torch.int32
    return s.numpy(), e.numpy()


def test_plain_matches_pallas_interpret():
    q, ql, t, tl = sw_case(64, swp.B_TILE, 32, 128)
    # degenerate pairs: no query row, a query longer than Lq, no target
    ql[:3] = (0, 33, 5)
    tl[2] = 0
    orig = pl.pallas_call
    swp.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        want_s, want_e = swp.sw_fitting_scores_pallas(q, ql, t, tl)
    finally:
        swp.pl.pallas_call = orig
    got_s, got_e = _plain(q, ql, t, tl)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_e, want_e)
    assert (got_e[3:] > 1).any() and (np.diff(got_s) != 0).any()


def test_plain_matches_align_scores_jax():
    q, ql, t, tl = sw_case(65, 96, 37, 101)
    want_s, want_e = align_scores_jax(q, ql, t, tl, READ_TO_HAP)
    got_s, got_e = _plain(q, ql, t, tl)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_e, want_e)


def test_wrapper_cpu_runs_the_plain_version_and_checks_inputs():
    q, ql, t, tl = (torch.from_numpy(a) for a in sw_case(66, 12, 9, 20))
    before = dict(LAUNCHES)
    s, e = sw_cuda.fitting_scores(q, ql, t, tl)
    assert LAUNCHES == before  # the plain version is not a launch
    want = fitting_scores_torch(q, ql, t, tl, READ_TO_HAP_PARAMS)
    assert torch.equal(s, want[0]) and torch.equal(e, want[1])
    with pytest.raises(ValueError, match="q_lens"):
        sw_cuda.fitting_scores(q, ql.long(), t, tl)
    with pytest.raises(ValueError, match="contiguous"):
        sw_cuda.fitting_scores(q, ql, t.t().contiguous().t(), tl)
    meta = [x.to("meta") for x in (q, ql, t, tl)]
    with pytest.raises(ValueError, match="no fitting DP for device"):
        sw_cuda.fitting_scores(*meta)
