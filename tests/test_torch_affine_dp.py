"""The port's dirs engine (ops/affine_dp_torch.py) against the JAX engine.

`align_dirs_torch` and `align_scores_torch` on the CPU must equal
`lancet2_tpu.ops.affine_dp_jax.align_dirs_jax` / `align_scores_jax` bit for
bit (tolerance 0): score, t_end and every direction byte, for the fitting
(READ_TO_HAP) and the global dual-affine (HAP_TO_REF) parameters, on seeded
pairs at B 8, Lq 40, Lt 64 (as tests/test_affine_dp.py::TestJaxParity) and
on an edge batch (N bases, q_len 1 and Lq, t_len 1 and Lt, pad code 5
inside and past the lengths). The CIGARs that the port's traceback_batch
walks from the port's dirs must equal the JAX package's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lancet2_tpu.ops.affine_dp import HAP_TO_REF as JAX_HAP_TO_REF
from lancet2_tpu.ops.affine_dp import READ_TO_HAP as JAX_READ_TO_HAP
from lancet2_tpu.ops.affine_dp import traceback_batch as jax_traceback
from lancet2_tpu.ops.affine_dp_jax import align_dirs_jax, align_scores_jax
from lancet2_tpu_torch.ops.affine_dp import HAP_TO_REF, READ_TO_HAP, traceback_batch
from lancet2_tpu_torch.ops.affine_dp_torch import align_dirs_torch, align_scores_torch

B, LQ, LT = 8, 40, 64
PARAMS = {"fitting": (READ_TO_HAP, JAX_READ_TO_HAP),
          "global": (HAP_TO_REF, JAX_HAP_TO_REF)}


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The suite runs several workers at once: keep torch's pool small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seeded_pairs():
    rng = np.random.default_rng(77)
    qs = rng.integers(0, 4, (B, LQ)).astype(np.uint8)
    ts = rng.integers(0, 4, (B, LT)).astype(np.uint8)
    qlens = rng.integers(5, LQ + 1, B).astype(np.int64)
    tlens = rng.integers(10, LT + 1, B).astype(np.int64)
    for b in range(B):
        qs[b, qlens[b]:] = 5
        ts[b, tlens[b]:] = 5
    return qs, qlens, ts, tlens


def edge_pairs():
    """Reads cut from their targets with noise, then the edges: q_len 1 and
    Lq, t_len 1 and Lt, N bases, pad code 5 inside the valid range."""
    rng = np.random.default_rng(5)
    ts = rng.integers(0, 4, (B, LT)).astype(np.uint8)
    qs = np.full((B, LQ), 5, np.uint8)
    qlens = np.array([1, LQ, LQ, 1, 17, LQ, 23, 9], np.int64)
    tlens = np.array([LT, 1, LT, 1, 40, 50, LT, 31], np.int64)
    for b in range(B):
        n, tl = int(qlens[b]), int(tlens[b])
        off = int(rng.integers(0, max(1, tl - n)))
        read = np.concatenate([ts[b, off:off + n], rng.integers(0, 4, n)])[:n]
        qs[b, :n] = np.where(rng.random(n) < 0.15, rng.integers(0, 4, n), read)
        ts[b, tl:] = 5
    qs[4, 3:6] = 4                       # N bases in the read
    ts[5, 10:14] = 4                     # N bases in the target
    qs[6, 7] = 5                         # pad code inside q_len
    ts[7, 2] = 5                         # pad code inside t_len
    return qs, qlens, ts, tlens


@pytest.mark.parametrize("inputs", [seeded_pairs, edge_pairs],
                         ids=["seeded", "edge"])
@pytest.mark.parametrize("pname", sorted(PARAMS))
def test_dirs_engine_bit_equal_to_jax(pname, inputs):
    p, jp = PARAMS[pname]
    qs, qlens, ts, tlens = inputs()
    want = align_dirs_jax(qs, qlens, ts, tlens, jp)
    got = align_dirs_torch(qs, qlens, ts, tlens, p, device="cpu")
    for name, w, g in zip(("score", "t_end", "dirs"), want, got):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    c_jax = jax_traceback(want[2], qlens, want[1].astype(np.int64), jp)
    c_port = traceback_batch(got[2], qlens, got[1].astype(np.int64), p)
    assert c_port == c_jax


@pytest.mark.parametrize("inputs", [seeded_pairs, edge_pairs],
                         ids=["seeded", "edge"])
@pytest.mark.parametrize("pname", sorted(PARAMS))
def test_scores_engine_bit_equal_to_jax(pname, inputs):
    p, jp = PARAMS[pname]
    qs, qlens, ts, tlens = inputs()
    want = align_scores_jax(qs, qlens, ts, tlens, jp)
    got = align_scores_torch(qs, qlens, ts, tlens, p, device="cpu")
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
