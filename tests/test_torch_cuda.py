"""The port's CUDA kernels against their plain PyTorch versions, on the card:
K1/K2 (ops/evidence_cuda.py) and K3 (ops/sw_cuda.py).

Marked `cuda`: without a CUDA device every test skips. This file imports no
jax, so on a machine with the card and without jax it runs on its own:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(tests/conftest.py imports jax). Inputs are made from seeds with numpy.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lancet2_tpu_torch.ops import evidence_cuda as ec
from lancet2_tpu_torch.ops import sw_cuda
from lancet2_tpu_torch.ops.evidence_cases import edge_pairs
from lancet2_tpu_torch.ops.evidence_dp import R_MAX, evidence_dp_torch
from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS
from lancet2_tpu_torch.ops.sw_dp import fitting_scores_torch


def _pairs(seed: int, B: int, Lq: int, Lt: int, R: int):
    """Reads cut from their targets with 3% substitutions; every third pair
    skips a 40-column run (a deletion longer than the TPU kernel's 31-column
    descent); R region slots, some inactive, some with negative starts."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    q = np.full((B, Lq), 5, np.uint8)
    q_lens = rng.integers(Lq // 2, Lq + 1, B).astype(np.int32)
    for b in range(B):
        ql = int(q_lens[b])
        gap = 40 if b % 3 == 0 else 0
        off = int(rng.integers(0, Lt - ql - gap))
        seg = t[b, off:off + ql + gap]
        read = np.concatenate([seg[:ql // 2], seg[ql // 2 + gap:]])[:ql]
        noisy = rng.random(ql) < 0.03
        q[b, :ql] = np.where(noisy, rng.integers(0, 5, ql), read)
    regions = np.zeros((B, R_MAX, 2), np.int32)
    for r in range(R):
        s = rng.integers(-8, Lt - 2, B)
        e = np.where(rng.random(B) < 0.15, s, s + rng.integers(1, 12, B))
        regions[:, r] = np.stack([s, np.minimum(e, Lt)], axis=1)
    qu = rng.integers(2, 42, (B, Lq)).astype(np.uint8)
    t_lens = rng.integers(Lt - 20, Lt + 1, B).astype(np.int32)
    return q, qu, q_lens, t, t_lens, regions


@pytest.mark.cuda
@pytest.mark.parametrize("R", [0, 1, 2, 4])
def test_kernel_matches_plain_on_card(R):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    kp = READ_TO_HAP_PARAMS.to(dev)
    args = [torch.from_numpy(a).to(dev)
            for a in _pairs(400 + R, 192, 96, 200, R)]
    plain_i, plain_f = ec._pack(evidence_dp_torch(*args, kp, r_max=R), R)
    assert int((plain_i[:, 3] >= 40).sum()) > 0  # long deletions won
    before = dict(ec.LAUNCHES)
    if R == 0:
        got_i = ec.span_pairs_submit(args[0], args[2], args[3], args[4], kp)
        assert torch.equal(got_i, plain_i)
    else:
        got_i, got_f = ec.evidence_pairs_submit(*args, R, kp)
        assert torch.equal(got_i, plain_i) and torch.equal(got_f, plain_f)
    key = "span" if R == 0 else "evidence"
    assert ec.LAUNCHES[key] == before[key] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(400, 100, 160), (64, 160, 2048)],
                         ids=["edge", "long_band"])
@pytest.mark.parametrize("R", [0, 1, 2, 4])
def test_kernel_matches_plain_on_edge_batch(R, shape):
    """K1/K2 on the edge batch of ops/evidence_cases.py: q_len and t_len at
    the kernel's stripe (32-row) and chunk (32-column) boundaries, zero and
    out of range; N bases; regions at column 0, negative, ending at t_len
    and inactive; insertions across row 32; deletions of 33-45 columns;
    tandem-repeat targets. Bit for bit, float32 bit patterns included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    kp = READ_TO_HAP_PARAMS.to(dev)
    B, Lq, Lt = shape
    args = [torch.from_numpy(a).to(dev)
            for a in edge_pairs(900 + R + Lt, B, Lq, Lt, R)]
    plain_i, plain_f = ec._pack(evidence_dp_torch(*args, kp, r_max=R), R)
    if R == 0:
        got_i = ec.span_pairs_submit(args[0], args[2], args[3], args[4], kp)
        assert torch.equal(got_i, plain_i)
    else:
        got_i, got_f = ec.evidence_pairs_submit(*args, R, kp)
        assert torch.equal(got_i, plain_i)
        assert torch.equal(got_f.view(torch.int32), plain_f.view(torch.int32))


@pytest.mark.cuda
def test_sw_fitting_kernel_matches_plain_on_card():
    """K3 at an odd shape, with N bases, padding and degenerate lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    kp = READ_TO_HAP_PARAMS.to(dev)
    rng = np.random.default_rng(500)
    B, Lq, Lt = 300, 77, 203
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    q = np.full((B, Lq), 5, np.uint8)
    q_lens = rng.integers(1, Lq + 1, B).astype(np.int32)
    t_lens = rng.integers(1, Lt + 1, B).astype(np.int32)
    for b in range(B):
        n = int(q_lens[b])
        off = int(rng.integers(0, max(1, Lt - n)))
        read = np.concatenate([t[b, off:off + n], rng.integers(0, 4, n)])[:n]
        q[b, :n] = np.where(rng.random(n) < 0.1, rng.integers(0, 5, n), read)
        t[b, t_lens[b]:] = 5
    t[rng.random((B, Lt)) < 0.02] = 4
    q_lens[:4] = (0, Lq + 1, -1, 3)
    t_lens[3:5] = (0, Lt + 9)
    args = [torch.from_numpy(a).to(dev) for a in (q, q_lens, t, t_lens)]
    want = fitting_scores_torch(*args, kp)
    before = ec.LAUNCHES["sw_fitting"]
    got = sw_cuda.fitting_scores(*args, kp)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ec.LAUNCHES["sw_fitting"] == before + 1
