"""Parity: the port's window step, graft entry and DM PLs against the JAX
package, on the CPU.

The JAX step runs its XLA-scan engine here; the port's runs K3's plain
version, or with dp_backend="scan" the dirs engine's score pass. Every
output is held exact: `scores`, `allele_counts`, `_extract_band`,
`synth_window_batch`, the float64 PLs, and the float32 `pls`, `gq` and
`best_gt` (ops/lgamma_f32.py reproduces XLA's CPU lgamma bit for bit).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
import lancet2_tpu.ops.window_step as jws
from lancet2_tpu.caller.likelihood import compute_genotype_pls
from jax.scipy.special import gammaln

from lancet2_tpu.ops.affine_dp import HAP_TO_REF, READ_TO_HAP, AlignParams
from lancet2_tpu.ops.genotype_tpu import batched_genotype_pls as jax_pls_f32
from lancet2_tpu.ops.genotype_tpu import batched_genotype_pls_exact as jax_pls_f64
from lancet2_tpu_torch import graft_entry
from lancet2_tpu_torch.ops import genotype as tg
from lancet2_tpu_torch.ops.lgamma_f32 import lgamma_f32
from lancet2_tpu_torch.ops import window_step as tws

STEP_KEYS = ("reads", "read_lens", "read_sample", "read_valid", "haps",
             "hap_lens", "hap_allele")


def assert_step_matches(want: dict, got: dict) -> None:
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.cpu().numpy() for k, v in got.items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _batches(seed: int):
    kw = dict(num_windows=2, reads_per_window=16, read_len=64, num_haps=2,
              hap_len=384, num_samples=2)
    return (jws.synth_window_batch(np.random.default_rng(seed), **kw),
            tws.synth_window_batch(np.random.default_rng(seed), **kw))


def test_synth_window_batch_draws_as_jax():
    jb, tb = _batches(11)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), k)


def test_extract_band_matches_jax():
    rng = np.random.default_rng(12)
    B, LH, L, margin = 40, 512, 64, 64
    t = rng.integers(0, 6, (B, LH)).astype(np.uint8)
    tl = rng.integers(200, LH + 1, B).astype(np.int32)
    ro = rng.integers(-80, LH + 40, B).astype(np.int32)
    want = jws._extract_band(t, tl, ro, L, margin)
    got = tws._extract_band(*(torch.from_numpy(a) for a in (t, tl, ro)),
                            L, margin)
    assert got[2] is want[2] is True
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # a haplotype no wider than the band is used whole
    narrow = tws._extract_band(torch.from_numpy(t[:, :256]),
                               torch.from_numpy(tl), torch.from_numpy(ro),
                               L, margin)
    assert narrow[2] is False and narrow[0].shape == (B, 256)


@pytest.mark.parametrize("band_margin", [64, None])
def test_window_step_matches_jax(band_margin):
    jb, tb = _batches(13)
    extra_j = {"read_offset": jb["read_offset"]} if band_margin else {}
    extra_t = {"read_offset": tb["read_offset"]} if band_margin else {}
    want = jws.make_window_step(2, 2, band_margin=band_margin)(
        *(jb[k] for k in STEP_KEYS), **extra_j)
    got = tws.make_window_step(2, 2, device="cpu", band_margin=band_margin)(
        *(tb[k] for k in STEP_KEYS), **extra_t)
    assert_step_matches(want, got)
    assert got["allele_counts"].sum() > 0


def test_entry_cpu_matches_jax_entry():
    jstep, jargs = jax_graft.entry()
    step, args = graft_entry.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert_step_matches(jstep(*jargs), step(*args))


def test_window_step_rejects_unported_modes():
    # K3 runs the fitting single-affine mode only; other params take the
    # scan route (below), or raise when the kernel is asked for by name
    with pytest.raises(NotImplementedError):
        tws.make_window_step(2, 2, params=HAP_TO_REF, device="cpu",
                             dp_backend="kernel")
    with pytest.raises(ValueError):
        tws.make_window_step(2, 2, device="cpu", dp_backend="pallas")


# dual and global (HAP_TO_REF), dual fitting, single-affine global
SCAN_PARAMS = {
    "hap_to_ref": HAP_TO_REF,
    "dual_fitting": AlignParams(match=1, mismatch=4, gap_open1=12,
                                gap_extend1=3, gap_open2=30, gap_extend2=1,
                                free_target_ends=True),
    "single_global": AlignParams(match=1, mismatch=4, gap_open1=12,
                                 gap_extend1=3, free_target_ends=False),
}


@pytest.mark.parametrize("name,band_margin", [
    ("hap_to_ref", 64), ("hap_to_ref", None), ("dual_fitting", 64),
    ("single_global", None)])
def test_window_step_scan_matches_jax(name, band_margin):
    params = SCAN_PARAMS[name]
    jb, tb = _batches(14)
    extra_j = {"read_offset": jb["read_offset"]} if band_margin else {}
    extra_t = {"read_offset": tb["read_offset"]} if band_margin else {}
    want = jws.make_window_step(2, 2, params=params, dp_backend="scan",
                                band_margin=band_margin)(
        *(jb[k] for k in STEP_KEYS), **extra_j)
    for backend in ("scan", "auto"):
        got = tws.make_window_step(2, 2, params=params, device="cpu",
                                   band_margin=band_margin,
                                   dp_backend=backend)(
            *(tb[k] for k in STEP_KEYS), **extra_t)
        assert_step_matches(want, got)


def test_window_step_kernel_and_scan_agree_on_read_to_hap():
    _jb, tb = _batches(15)
    outs = [tws.make_window_step(2, 2, params=READ_TO_HAP, device="cpu",
                                 dp_backend=b)(*(tb[k] for k in STEP_KEYS))
            for b in ("kernel", "scan")]
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k].numpy(), outs[1][k].numpy())


def test_lgamma_f32_matches_jax_gammaln_on_grid():
    grid = np.concatenate([np.arange(0, 50, 2.5e-4),
                           np.arange(1.5, 3000, 1.0)]).astype(np.float32)
    want = np.asarray(gammaln(grid))
    got = lgamma_f32(torch.from_numpy(grid)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _pl_sweep(K: int) -> np.ndarray:
    """tests/test_graft_and_parallel.py::TestDevicePlsExact's counts."""
    rng = np.random.default_rng(7)
    for k in (2, 3, 4):
        counts = np.concatenate([
            rng.integers(0, 60, (120, k)),
            rng.integers(0, 3000, (60, k)),
            np.zeros((4, k), np.int64),
        ]).astype(np.int64)
        if k == K:
            return counts
    raise ValueError(K)


@pytest.mark.parametrize("K", [2, 3, 4])
def test_pls_exact_matches_jax_and_host(K):
    counts = _pl_sweep(K)
    got = tg.batched_genotype_pls_exact(counts, K, torch.device("cpu"))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jax_pls_f64(counts, K))
    host = np.stack([np.asarray(compute_genotype_pls(list(c)), np.int64)
                     for c in counts])
    np.testing.assert_array_equal(got, host)


def test_pls_f32_matches_jax_within_one():
    for K in (2, 3, 4):
        counts = _pl_sweep(K)
        want = [np.asarray(x) for x in jax_pls_f32(counts, K)]
        got = [x.numpy() for x in tg.batched_genotype_pls(
            torch.from_numpy(counts), K)]
        assert [g.dtype for g in got] == [w.dtype for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
