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
from lancet2_tpu_torch.ops.sw_cases import edge_pairs as sw_edge_pairs
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(600, 152, 256), (300, 520, 300),
                                   (128, 128, 2048)],
                         ids=["edge", "long_query", "long_band"])
def test_sw_fitting_kernel_matches_plain_on_edge_batch(shape):
    """K3 on the edge batch of ops/sw_cases.py: q_len at the kernel's lane
    and stripe boundaries (one stripe of 5 rows per lane at Lq 152, three
    stripes at Lq 520), zero and out of range; t_len 0, 1, 31-33, Lt and
    Lt+9; N bases, padding, tandem-repeat targets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    kp = READ_TO_HAP_PARAMS.to(dev)
    B, Lq, Lt = shape
    rpl = sw_cuda.rows_per_lane(Lq)
    args = [torch.from_numpy(a).to(dev)
            for a in sw_edge_pairs(800 + Lq, B, Lq, Lt, rpls=(4, 5, rpl))]
    want = fitting_scores_torch(*args, kp)
    before = ec.LAUNCHES["sw_fitting"]
    got = sw_cuda.fitting_scores(*args, kp)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ec.LAUNCHES["sw_fitting"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("pname", ["fitting", "global"])
def test_dirs_engine_on_card_matches_cpu(pname):
    """The dirs engine (plain PyTorch, ops/affine_dp_torch.py) on the card
    equals its CPU run: score, t_end and every direction byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lancet2_tpu_torch.ops.affine_dp import HAP_TO_REF, READ_TO_HAP
    from lancet2_tpu_torch.ops.affine_dp_torch import align_dirs_torch

    p = READ_TO_HAP if pname == "fitting" else HAP_TO_REF
    q, _qu, q_lens, t, t_lens, _reg = _pairs(700, 96, 160, 384, 0)
    q[3, 10:14] = 4
    got = align_dirs_torch(q, q_lens, t, t_lens, p, device="cuda")
    want = align_dirs_torch(q, q_lens, t, t_lens, p, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_tuple_form_two_pass_on_card_matches_cpu_one_pass():
    """`Genotyper.run_evidence_pairs` on the card (K1 over every pair, the
    gate, K2 over the survivors) against the one-pass plain run on the CPU:
    equal span outputs for every pair and equal region outputs wherever a
    pair passes the gate and overlaps the slot; both kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lancet2_tpu_torch.caller.genotyper import Genotyper
    from lancet2_tpu_torch.ops.evidence_layout import REGION_FILL, SPAN_KEYS

    q, qu, q_lens, t, t_lens, regions = _pairs(710, 600, 150, 700, 4)
    regions[:, :, 0] = np.maximum(regions[:, :, 0], 0)
    pairs = ([q[b, :q_lens[b]] for b in range(len(q))],
             [qu[b, :q_lens[b]] for b in range(len(q))],
             [t[b, :t_lens[b]] for b in range(len(q))],
             [(b, 0, regions[b], []) for b in range(len(q))])
    before = dict(ec.LAUNCHES)
    card = Genotyper(backend="evidence", device="cuda")
    got = card.run_evidence_pairs(*pairs)
    want = Genotyper(backend="evidence", device="cpu").run_evidence_pairs(*pairs)
    assert ec.LAUNCHES["span"] > before["span"]
    assert ec.LAUNCHES["evidence"] > before["evidence"]
    for k in SPAN_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    live = ((want["score"] >= (0.25 * q_lens).astype(np.int64))
            & (want["t_end"] > want["t_start"]))
    ov = ((regions[:, :, 1] > want["t_start"][:, None])
          & (regions[:, :, 0] < want["t_end"][:, None])
          & (regions[:, :, 1] > regions[:, :, 0]) & live[:, None])
    assert ov.any() and card.pass2_stats["pass2"] > 0
    for k in REGION_FILL:
        np.testing.assert_array_equal(got[k][ov], want[k][ov], err_msg=k)


@pytest.mark.cuda
def test_sharded_dispatch_on_card_matches_one_device():
    """The sharded span and evidence dispatches (parallel/evidence_spmd.py)
    over [cuda:0] * 2, two streams on one card, equal one launch each on
    the card; 301 pairs, so the shards are padded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lancet2_tpu_torch.ops.evidence_fused import (
        DevicePools,
        evidence_indexed_submit,
        span_indexed_submit,
    )
    from lancet2_tpu_torch.parallel import evidence_spmd as spmd
    from lancet2_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0)
    kp = READ_TO_HAP_PARAMS.to(dev)
    n, Lt = 301, 256
    q, qu, q_lens, t, t_lens, regions = _pairs(720, n, 150, Lt, 2)
    pools = (q, qu, q_lens, t)  # pair b: read b against haplotype b
    ix = np.arange(n)
    bst = np.zeros(n, np.int64)
    one = DevicePools(*pools, dev)
    mesh = make_mesh([dev, dev])
    reps = spmd.replicate_pools(mesh, *pools)
    want = ec.span_pairs_finalize(span_indexed_submit(one, ix, ix, bst,
                                                      t_lens, Lt, kp))
    got = spmd.span_indexed_sharded(mesh, reps, ix, ix, bst, t_lens, Lt, kp)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want = ec.evidence_pairs_finalize(*evidence_indexed_submit(
        one, ix, ix, bst, t_lens, regions, Lt, 2, kp), 2)
    got = spmd.evidence_indexed_sharded(mesh, reps, ix, ix, bst, t_lens,
                                        regions, Lt, 2, kp)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.cuda
def test_float32_pls_on_card_match_cpu():
    """The window step's float32 DM PLs (ops/lgamma_f32.py) on the card equal
    the CPU's bit for bit: PLs, GQ and best genotype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lancet2_tpu_torch.ops.genotype import batched_genotype_pls
    from lancet2_tpu_torch.ops.lgamma_f32 import lgamma_f32

    rng = np.random.default_rng(730)
    for K in (2, 3, 4):
        counts = torch.from_numpy(np.concatenate([
            rng.integers(0, 60, (500, K)), rng.integers(0, 3000, (500, K)),
            np.zeros((4, K), np.int64)]))
        got = batched_genotype_pls(counts.cuda(), K)
        want = batched_genotype_pls(counts, K)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    grid = torch.arange(0, 50, 2.5e-4, dtype=torch.float32)
    assert torch.equal(lgamma_f32(grid.cuda()).cpu().view(torch.int32),
                       lgamma_f32(grid).view(torch.int32))


@pytest.mark.cuda
def test_device_graph_build_on_card_matches_cpu():
    """The tape and one-window graph passes on the card equal their CPU runs
    array for array, on a simulated 1.2 kb window at k 13 and 25."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lancet2_tpu_torch.base.dna import encode
    from lancet2_tpu_torch.cbdg.read import Read
    from lancet2_tpu_torch.ops.graph_tape import build_graphs_tape
    from lancet2_tpu_torch.ops.graph_tpu import build_graph_device
    from lancet2_tpu_torch.utils.simulate import (
        ReadSimulator,
        Variant,
        random_reference,
    )

    ref = random_reference(1200, seed=31)
    sim = ReadSimulator(ref, "chrT", seed=32)

    class _W:
        def __init__(self):
            self.records = []

        def add(self, rec):
            self.records.append(rec)

    w = _W()
    alt = "A" if ref[600] != "A" else "C"
    sim.simulate([Variant(600, ref[600], alt, vaf=0.4)], 40.0, w)
    reads = [Read.from_bam(r, "TUMOR", 4, 1) for r in w.records]
    for k in (13, 25):
        seqs, quals, meta = [encode(ref)], [None], [(1, -1, 0, 0)]
        for r in reads:
            if r.passes_aln_filters and len(r.codes) >= k + 1:
                seqs.append(r.codes)
                quals.append(r.qual)
                meta.append((r.tag, r.sample_index, r.tag, r.qname_hash))
        got = build_graphs_tape([(seqs, quals, meta)], k, 2, "cuda")[0]
        want = build_graphs_tape([(seqs, quals, meta)], k, 2, "cpu")[0]
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        got = build_graph_device(seqs, quals, meta, k, 2, "cuda")
        want = build_graph_device(seqs, quals, meta, k, 2, "cpu")
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
