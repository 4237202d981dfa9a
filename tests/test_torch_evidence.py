"""Parity: the port's evidence DP against the JAX package's engine.

The plain PyTorch version (lancet2_tpu_torch/ops/evidence_dp.py) must equal
`lancet2_tpu.ops.evidence_dp.evidence_dp` exactly, every key, on the
fixtures the Pallas kernel is held to (tests/test_evidence_pallas.py). The
kernel wrappers take it for CPU tensors, so the port's CPU path and the
indexed two-pass genotyper are held to the JAX package here as well. The
CUDA kernel itself is compared with the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lancet2_tpu.base.phred import PHRED_TO_CONFIDENCE
from lancet2_tpu.caller import genotyper as gmod
from lancet2_tpu.ops.affine_dp import HAP_TO_REF, READ_TO_HAP
from lancet2_tpu.ops.evidence_dp import R_MAX as JAX_R_MAX
from lancet2_tpu.ops.evidence_dp import evidence_dp as jax_evidence_dp
from lancet2_tpu.ops.evidence_pallas import D_MAX
from lancet2_tpu_torch.caller.genotyper import TorchGenotyper
from lancet2_tpu_torch.ops import evidence_cuda as ec
from lancet2_tpu_torch.ops.evidence_dp import R_MAX, SPAN_KEYS, evidence_dp
from lancet2_tpu_torch.base.phred import PHRED_TO_CONFIDENCE as PORT_CONF
from lancet2_tpu_torch.ops.affine_dp import HAP_TO_REF as PORT_HAP_TO_REF
from lancet2_tpu_torch.ops.affine_dp import READ_TO_HAP as PORT_READ_TO_HAP
from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS, from_jax
from test_evidence_fused import _pools_and_pairs, component  # noqa: F401
from test_evidence_pallas import KEYS, _rand_case

SPAN = list(SPAN_KEYS)


def _assert_equal(ref, got, tag, keys=KEYS):
    for k in keys:
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.shape == b.shape, f"{tag}: {k} shape {a.shape} vs {b.shape}"
        assert np.array_equal(a, b), (
            f"{tag}: {k} mismatch at {np.argwhere(a != b)[:5].tolist()}")


def _long_deletion_case():
    """tests/test_evidence_pallas.py::test_overflow_fallback_long_deletion."""
    rng = np.random.default_rng(3)
    Lq, gap = 120, D_MAX + 2
    Lt = Lq + gap + 16
    half = 60
    t_row = rng.integers(0, 4, Lt).astype(np.uint8)
    q_row = np.concatenate([t_row[:half],
                            t_row[half + gap: half + gap + (Lq - half)]])
    B = 8
    q = np.tile(q_row, (B, 1)).astype(np.uint8)
    qu = np.full((B, Lq), 35, np.uint8)
    t = np.tile(t_row, (B, 1))
    regions = np.zeros((B, R_MAX, 2), np.int32)
    regions[:, 0] = (half + 2, half + 6)
    return (q, qu, np.full(B, Lq, np.int32), t, np.full(B, Lt, np.int32),
            regions)


def _short_indel_case():
    """tests/test_evidence_pallas.py::test_parity_winning_short_indels."""
    rng = np.random.default_rng(42)
    pairs = []
    for gap in (1, 2, 3, 4, 6, 8):
        anchor = rng.integers(0, 4, 48).astype(np.uint8)
        a1, a2 = anchor[:24], anchor[24:]
        mid = rng.integers(0, 4, gap).astype(np.uint8)
        pairs.append((np.concatenate([a1, a2]), np.concatenate([a1, mid, a2])))
        pairs.append((np.concatenate([a1, mid, a2]), np.concatenate([a1, a2])))
    Lq = max(len(q) for q, _ in pairs)
    Lt = max(len(t) for _, t in pairs)
    B = len(pairs)
    q = np.full((B, Lq), 4, np.uint8)
    t = np.full((B, Lt), 4, np.uint8)
    q_lens = np.zeros(B, np.int32)
    t_lens = np.zeros(B, np.int32)
    for b, (qq, tt) in enumerate(pairs):
        q[b, : len(qq)] = qq
        t[b, : len(tt)] = tt
        q_lens[b], t_lens[b] = len(qq), len(tt)
    regions = np.zeros((B, R_MAX, 2), np.int32)
    regions[:, 0] = (22, 28)
    return q, np.full((B, Lq), 35, np.uint8), q_lens, t, t_lens, regions


CASES = {
    "random_1": lambda: _rand_case(np.random.default_rng(101), 24, 24, 48, 1),
    "random_2": lambda: _rand_case(np.random.default_rng(102), 24, 24, 48, 2),
    "random_3": lambda: _rand_case(np.random.default_rng(103), 24, 24, 48, 3),
    "dissimilar": lambda: _rand_case(np.random.default_rng(7), 16, 16, 32, 2,
                                     similar=False),
    "short_indels": _short_indel_case,
    "long_deletion": _long_deletion_case,
    "padding": lambda: _rand_case(np.random.default_rng(5), 3, 17, 33, 1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_engine(name):
    case = CASES[name]()
    ref = jax_evidence_dp(*case)
    _assert_equal(ref, evidence_dp(*case), name)
    if name == "long_deletion":
        assert int(np.asarray(ref["nm"]).max()) > D_MAX  # the run must win


@pytest.mark.parametrize("name", sorted(CASES))
def test_span_mode_matches_jax_scalars(name):
    case = CASES[name]()
    ref = jax_evidence_dp(*case)
    got = evidence_dp(*case, r_max=0)
    assert sorted(got) == sorted(SPAN)
    _assert_equal(ref, got, name, SPAN)


def test_plain_negative_region_starts_and_edge_lengths():
    """Crop-shifted regions (negative starts, as pass 2 makes them) and
    query/target lengths at and past the array edges."""
    rng = np.random.default_rng(9)
    q, qu, q_lens, t, t_lens, regions = _rand_case(rng, 16, 20, 40, 3)
    regions = regions - rng.integers(0, 10, (16, R_MAX))[:, :, None].astype(np.int32)
    q_lens = np.array([0, 20, 21, -1, 1, 5, 20, 3, 0, 7, 9, 11, 13, 15, 20, 2],
                      np.int32)
    t_lens = np.array([0, 0, 40, 41, -3, 1, 2, 40, 5, 6, 7, 8, 9, 10, 39, 40],
                      np.int32)
    case = (q, qu, q_lens, t, t_lens, regions)
    _assert_equal(jax_evidence_dp(*case), evidence_dp(*case), "edges")


def test_plain_padding_invariance():
    """A pair's outputs do not depend on the array widths around it or on
    the other pairs of its launch: the kernel takes chunks of any shape, and
    the genotyper cuts pass 2 to the widest crop of each chunk."""
    rng = np.random.default_rng(5)
    case = _rand_case(rng, 3, 17, 33, 1)
    q, qu, q_lens, t, t_lens, regions = _rand_case(rng, 9, 29, 71, 2)
    q[:3, :17], qu[:3, :17], t[:3, :33] = case[0], case[1], case[3]
    q_lens[:3], t_lens[:3], regions[:3] = case[2], case[4], case[5]
    ref = evidence_dp(*case)
    got = evidence_dp(q, qu, q_lens, t, t_lens, regions)
    _assert_equal(ref, {k: v[:3] for k, v in got.items()}, "padded")


@pytest.mark.parametrize("R", [1, 2, 4])
def test_evidence_wrapper_cpu_matches_jax(R):
    """evidence_pairs_submit/finalize on CPU tensors: slots < R as the
    engine computes them, slots >= R at their inactive values."""
    q, qu, q_lens, t, t_lens, regions = _rand_case(
        np.random.default_rng(200 + R), 20, 24, 48, R)
    ref = jax_evidence_dp(q, qu, q_lens, t, t_lens, regions)
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (q, qu, q_lens, t, t_lens, regions)]
    iout, fout = ec.evidence_pairs_submit(*args, R)
    assert iout.shape == (20, 4 + 3 * R) and fout.shape == (20, 3 * R)
    _assert_equal(ref, ec.evidence_pairs_finalize(iout, fout, R), f"R={R}")
    span = ec.span_pairs_finalize(ec.span_pairs_submit(
        args[0], args[2], args[3], args[4]))
    _assert_equal(ref, span, f"span R={R}", SPAN)


def test_wrapper_checks_inputs_and_device():
    q, qu, q_lens, t, t_lens, regions = (
        torch.from_numpy(np.ascontiguousarray(a))
        for a in _rand_case(np.random.default_rng(1), 4, 8, 16, 1))
    with pytest.raises(ValueError, match="R must be"):
        ec.evidence_pairs_submit(q, qu, q_lens, t, t_lens, regions, 3)
    with pytest.raises(ValueError, match="q_lens"):
        ec.span_pairs_submit(q, q_lens.long(), t, t_lens)
    with pytest.raises(ValueError, match="contiguous"):
        ec.span_pairs_submit(q, q_lens, t.t().contiguous().t(), t_lens)
    meta = [x.to("meta") for x in (q, q_lens, t, t_lens)]
    with pytest.raises(ValueError, match="no evidence DP for device"):
        ec.span_pairs_submit(*meta)
    before = dict(ec.LAUNCHES)
    ec.span_pairs_submit(q, q_lens, t, t_lens)
    assert ec.LAUNCHES == before  # the plain version is not a launch


def test_from_jax_round_trips_parameters():
    kp = from_jax(READ_TO_HAP, PHRED_TO_CONFIDENCE)
    assert (kp.match, kp.mismatch, kp.gap_open, kp.gap_extend) == (
        READ_TO_HAP.match, READ_TO_HAP.mismatch, READ_TO_HAP.gap_open1,
        READ_TO_HAP.gap_extend1)
    assert kp.conf.dtype == torch.float32 and kp.conf.shape == (256,)
    assert np.array_equal(kp.conf.numpy(),
                          np.asarray(PHRED_TO_CONFIDENCE, np.float32))
    assert kp.conf.equal(READ_TO_HAP_PARAMS.conf)
    assert kp.gap_open == READ_TO_HAP_PARAMS.gap_open
    with pytest.raises(NotImplementedError):
        from_jax(HAP_TO_REF)
    assert R_MAX == JAX_R_MAX
    # the port's own copies of the scoring and the confidence table
    assert vars(PORT_READ_TO_HAP) == vars(READ_TO_HAP)
    assert vars(PORT_HAP_TO_REF) == vars(HAP_TO_REF)
    assert np.array_equal(np.asarray(PORT_CONF), np.asarray(PHRED_TO_CONFIDENCE))
    assert np.asarray(PORT_CONF).dtype == np.asarray(PHRED_TO_CONFIDENCE).dtype


def test_indexed_genotyper_matches_jax(component):  # noqa: F811
    """TorchGenotyper's two-pass span -> gate -> crop -> evidence protocol
    on CPU equals the JAX package's host engine on every span output and on
    every region slot assemble_evidence reads
    (tests/test_evidence_fused.py::test_indexed_device_path_matches_host)."""
    pools, pairs = _pools_and_pairs(component)
    got = TorchGenotyper(torch.device("cpu")).run_evidence_indexed(
        pools, pairs, pair_chunk=64)
    want = gmod.Genotyper(backend="evidence").run_evidence_indexed(
        pools, pairs, pair_chunk=256)

    t_s = np.asarray(want["t_start"])
    t_e = np.asarray(want["t_end"])
    ql = pools["read_lens"][pairs["read_ix"]]
    gate = (np.asarray(want["score"]) >= (0.25 * ql).astype(int)) & (t_e > t_s)
    regions = pairs["regions"]
    active = regions[:, :, 1] > regions[:, :, 0]
    slot_read = (gate[:, None]
                 & (regions[:, :, 1] > t_s[:, None])
                 & (regions[:, :, 0] < t_e[:, None]) & active)
    for k in SPAN:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    for k in ("qv", "aligned", "min_bq", "raw", "pbq", "matches"):
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert np.array_equal(a[slot_read], b[slot_read]), k
    assert gate.sum() > 0 and (~gate).sum() > 0
