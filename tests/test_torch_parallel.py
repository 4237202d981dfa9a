"""The port's multi-device path on the CPU, held against the JAX package and
against the port's one-device results.

  * parallel/mesh.py: the sharded window step over `[cpu] * 4` equals
    `lancet2_tpu.parallel.mesh.make_sharded_window_step` on 4 of the
    conftest's virtual CPU devices (every output, both scalar totals);
  * ops/genotype.py: `batched_genotype_pls_exact(mesh=)` equals the JAX
    function with `mesh=` (4 devices), and the one-device PLs on 3;
  * parallel/evidence_spmd.py: the sharded span and evidence dispatches over
    `[cpu] * 3` (an odd count, so rows are padded) equal one device's;
  * core/batch_pipeline.py: the batch executor over `devices=[cpu, cpu]`
    writes the records of its one-device run, at the production sharding
    threshold (small pass-2 classes fall back and are counted in
    MESH_FALLBACK_STATS) and with every dispatch sharded;
  * multi-host sharding: `--host-index i --num-hosts 2` for i = 0, 1, merged
    with `parallel/manifest.merge_vcf_shards`, gives the record lines of the
    JAX package's merged shards and of the port's unsharded run.

Fixture: 3 kb, somatic SNV at 1500, germline 5 bp deletion at 750, 14x/20x,
seed 5, 600 bp windows (tests/test_torch_threads.py's). torch is held to
two intra-op threads.
"""

from __future__ import annotations

import gzip
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import lancet2_tpu.ops.window_step as jws
from lancet2_tpu.cli.main import main as jax_cli_main
from lancet2_tpu.ops.genotype_tpu import batched_genotype_pls_exact as jax_pls
from lancet2_tpu.parallel.manifest import merge_vcf_shards as jax_merge
from lancet2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lancet2_tpu.parallel.mesh import make_sharded_window_step as jax_sharded
from lancet2_tpu.utils.simulate import Variant, make_tumor_normal_fixture, random_reference
from lancet2_tpu_torch.caller import genotyper as tgmod
from lancet2_tpu_torch.ops import genotype as tg
from lancet2_tpu_torch.ops import window_step as tws
from lancet2_tpu_torch.ops.evidence_cuda import (
    evidence_pairs_finalize,
    span_pairs_finalize,
    span_pairs_submit,
)
from lancet2_tpu_torch.ops.evidence_fused import DevicePools, evidence_indexed_submit, span_indexed_submit
from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS as KP
from lancet2_tpu_torch.parallel import evidence_spmd as spmd
from lancet2_tpu_torch.parallel.manifest import merge_vcf_shards
from lancet2_tpu_torch.parallel.mesh import make_mesh, make_sharded_window_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
WINDOW = ["-w", "600"]
REF_LEN, SNV, DEL = 3000, 1500, 750

_RUN_PORT = """
import json, sys
from lancet2_tpu_torch.cli.main import main
codes = [main(argv) for argv in json.loads(sys.argv[1])]
print(json.dumps({"exit": codes, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "lancet2_tpu"))}))
"""


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The suite runs several workers at once: keep torch's pool small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sharded_window_step_matches_jax_mesh():
    kw = dict(num_windows=8, reads_per_window=16, read_len=64, num_haps=2,
              hap_len=384, num_samples=2)
    jb = jws.synth_window_batch(np.random.default_rng(21), **kw)
    tb = tws.synth_window_batch(np.random.default_rng(21), **kw)
    jfn, jshard = jax_sharded(jax_make_mesh(jax.devices()[:4]), 2, 2,
                              band_margin=64)
    want = {k: np.asarray(v) for k, v in jfn(*jshard(jb)).items()}
    fn, shard = make_sharded_window_step(make_mesh([CPU] * 4), 2, 2,
                                         band_margin=64)
    got = {k: v.numpy() for k, v in fn(*shard(tb)).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert float(got["total_alt_depth"]) > 0
    with pytest.raises(ValueError):  # W must split evenly, as in JAX
        fn(*shard({k: v[:6] for k, v in tb.items()}))


@pytest.mark.parametrize("K", [2, 3])
def test_sharded_pls_match_jax_mesh(K):
    rng = np.random.default_rng(7 + K)
    counts = np.concatenate([rng.integers(0, 60, (150, K)),
                             rng.integers(0, 3000, (50, K)),
                             np.zeros((3, K), np.int64)]).astype(np.int64)
    want = jax_pls(counts, K, mesh=jax_make_mesh(jax.devices()[:4]))
    for size in (4, 3):
        got = tg.batched_genotype_pls_exact(counts, K,
                                            mesh=make_mesh([CPU] * size))
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tg.batched_genotype_pls_exact(counts, K, CPU), want)


def _pairs(seed: int, n: int, Lt: int):
    """A read pool, a haplotype pool and n (read, hap, band) pairs with
    regions in band coordinates."""
    rng = np.random.default_rng(seed)
    nr, nh, Lq, LH = 40, 6, 96, 400
    haps = rng.integers(0, 4, (nh, LH)).astype(np.uint8)
    reads_q = np.full((nr, Lq), 5, np.uint8)
    read_lens = rng.integers(60, Lq + 1, nr).astype(np.int32)
    for r in range(nr):
        h, off = int(rng.integers(nh)), int(rng.integers(0, LH - Lq))
        seq = haps[h, off:off + read_lens[r]].copy()
        noise = rng.random(seq.size) < 0.03
        seq[noise] = rng.integers(0, 4, int(noise.sum()))
        reads_q[r, :read_lens[r]] = seq
    reads_qu = rng.integers(5, 41, (nr, Lq)).astype(np.uint8)
    read_ix = rng.integers(0, nr, n)
    hap_ix = rng.integers(0, nh, n)
    band_start = rng.integers(0, LH - Lt // 2, n)
    tlens = np.minimum(rng.integers(Lt // 2, Lt + 1, n), LH - band_start)
    regions = np.zeros((n, 4, 2), np.int32)
    regions[:, 0, 0] = rng.integers(-5, Lt // 2, n)
    regions[:, 0, 1] = regions[:, 0, 0] + rng.integers(1, 6, n)
    regions[::3, 1, 0] = 20
    regions[::3, 1, 1] = 24
    return (reads_q, reads_qu, read_lens, haps), (read_ix, hap_ix,
                                                  band_start, tlens, regions)


@pytest.mark.parametrize("max_rows", [None, 16])
def test_sharded_evidence_dispatch_matches_one_device(max_rows):
    Lt = 192
    pools, (rix, hix, bst, tl, reg) = _pairs(31, 101, Lt)
    one = DevicePools(*pools, CPU)
    mesh = make_mesh([CPU] * 3)
    reps = spmd.replicate_pools(mesh, *pools)
    assert all(p is reps[0] for p in reps)  # one device: one replica
    before = dict(spmd.SPMD_STATS)

    want = span_pairs_finalize(span_indexed_submit(one, rix, hix, bst, tl,
                                                   Lt, KP))
    got = spmd.span_indexed_sharded(mesh, reps, rix, hix, bst, tl, Lt,
                                    max_rows=max_rows)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    for R in (1, 2):
        sel = np.flatnonzero((reg[:, 1, 1] > reg[:, 1, 0]) == (R == 2))
        want = evidence_pairs_finalize(*evidence_indexed_submit(
            one, rix[sel], hix[sel], bst[sel], tl[sel], reg[sel], Lt, R, KP),
            R)
        got = spmd.evidence_indexed_sharded(
            mesh, reps, rix[sel], hix[sel], bst[sel], tl[sel], reg[sel], Lt,
            R, max_rows=max_rows)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{R} {k}")

    # the tuple-form pair arrays (inert padding rows, dropped)
    q, t = np.full((50, 80), 5, np.uint8), np.full((50, 160), 5, np.uint8)
    rng = np.random.default_rng(3)
    ql, tll = rng.integers(30, 81, 50), rng.integers(60, 161, 50)
    for b in range(50):
        t[b, :tll[b]] = rng.integers(0, 4, tll[b])
        q[b, :ql[b]] = t[b, 5:5 + ql[b]] if ql[b] + 5 <= tll[b] else \
            rng.integers(0, 4, ql[b])
    got = spmd.span_arrays_sharded(mesh, q, None, ql, t, tll)
    want = span_pairs_finalize(span_pairs_submit(
        torch.from_numpy(q), torch.from_numpy(ql.astype(np.int32)),
        torch.from_numpy(t), torch.from_numpy(tll.astype(np.int32))))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert spmd.SPMD_STATS["span_sharded"] > before["span_sharded"]
    assert spmd.SPMD_STATS["evidence_sharded"] == before[
        "evidence_sharded"] + 2


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_parallel")
    ref = random_reference(REF_LEN, seed=5)
    alt = "C" if ref[SNV] != "C" else "G"
    fx = make_tumor_normal_fixture(
        str(tmp), ref_len=REF_LEN,
        somatic=[Variant(pos0=SNV, ref=ref[SNV], alt=alt, vaf=0.45)],
        germline=[Variant(pos0=DEL, ref=ref[DEL:DEL + 6], alt=ref[DEL],
                          vaf=0.5)],
        normal_cov=14, tumor_cov=20, seed=5)
    return tmp, fx


def _records(path) -> list[str]:
    with gzip.open(path, "rt") as fh:
        return [l for l in fh.read().splitlines() if l and not l.startswith("#")]


def test_batch_executor_device_list_matches_one_device(fixture, monkeypatch):
    from lancet2_tpu_torch.cbdg.graph import GraphParams
    from lancet2_tpu_torch.core.batch_pipeline import TorchBatchPipelineExecutor
    from lancet2_tpu_torch.core.read_collector import CollectorParams
    from lancet2_tpu_torch.core.sample_info import make_sample_list
    from lancet2_tpu_torch.core.variant_builder import BuilderParams
    from lancet2_tpu_torch.core.window_builder import WindowBuilder, WindowParams
    from lancet2_tpu_torch.hts.fasta import Reference

    _tmp, fx = fixture
    ref = Reference(fx["fasta"])
    samples = make_sample_list([fx["normal"]], [fx["tumor"]], [])
    wb = WindowBuilder(ref, WindowParams(window_length=600))
    wb.add_whole_reference()
    wb.sort_input_regions()
    windows = wb.build_windows()
    params = BuilderParams(
        graph=GraphParams(num_samples=len(samples)),
        collector=CollectorParams(), aligner_backend="evidence",
        device="cpu")

    def run(devices):
        ex = TorchBatchPipelineExecutor(
            params, ref, samples, list(windows), num_workers=2,
            window_batch=3, prep_mode="threads", device=CPU,
            devices=devices)
        out = io.StringIO()
        stats = ex.execute(out)
        return [l for l in out.getvalue().splitlines() if l], stats

    want, one = run(None)
    assert one["devices"] == ["cpu"] and want

    def run_mesh():
        for k in tgmod.MESH_FALLBACK_STATS:
            tgmod.MESH_FALLBACK_STATS[k] = 0
        before = dict(spmd.SPMD_STATS)
        got, stats = run([CPU, CPU])
        assert stats["devices"] == ["cpu", "cpu"]
        assert got == want and stats["pass2"] == one["pass2"]
        return ({k: spmd.SPMD_STATS[k] - before[k] for k in before},
                dict(tgmod.MESH_FALLBACK_STATS))

    # production threshold: the fixture's pass-2 classes are too small to
    # shard, so they run on the first entry and are counted
    sharded, fallback = run_mesh()
    assert sharded["span_sharded"] > 0
    assert fallback["plain_ev_with_mesh"] > 0
    # every dispatch sharded, as the multi-device dry run forces it
    monkeypatch.setattr(tgmod, "SPMD_MIN_ROWS_PER_DEVICE", 1)
    sharded, fallback = run_mesh()
    assert sharded["span_sharded"] > 0 and sharded["evidence_sharded"] > 0
    assert fallback == {"plain_span_with_mesh": 0, "plain_ev_with_mesh": 0}


def test_host_shards_merge_to_jax_and_unsharded_records(fixture):
    tmp, fx = fixture
    common = ["pipeline", "-n", fx["normal"], "-t", fx["tumor"],
              "-r", fx["fasta"], "-T", "2", *WINDOW, "--executor", "batch",
              "--prep-mode", "threads"]

    def shard(tag, i):
        return common + ["-o", str(tmp / f"{tag}{i}.vcf.gz"),
                         "--host-index", str(i), "--num-hosts", "2"]

    port_argvs = [shard("port", 0) + ["--device", "cpu"],
                  shard("port", 1) + ["--device", "cpu"],
                  common + ["-o", str(tmp / "port_all.vcf.gz"),
                            "--device", "cpu"]]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-c", _RUN_PORT, json.dumps(port_argvs)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp))
    try:
        for i in (0, 1):
            assert jax_cli_main(shard("jax", i)) == 0
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    assert json.loads(stdout.strip().splitlines()[-1]) == {
        "exit": [0, 0, 0], "loaded": []}, stderr[-3000:]

    merged = {}
    for tag, merge in (("port", merge_vcf_shards), ("jax", jax_merge)):
        path = str(tmp / f"{tag}_merged.vcf.gz")
        n = merge([str(tmp / f"{tag}{i}.vcf.gz") for i in (0, 1)], path,
                  ["chrS"])
        merged[tag] = _records(path)
        assert n == len(merged[tag])
    assert merged["port"] and merged["port"] == merged["jax"]
    assert merged["port"] == _records(str(tmp / "port_all.vcf.gz"))


def test_device_list_checks_every_entry():
    from lancet2_tpu_torch.core.batch_pipeline import resolve_devices

    assert resolve_devices(CPU) == [CPU]
    assert resolve_devices("cuda", [CPU, "cpu"]) == [CPU, CPU]
    with pytest.raises(ValueError):
        resolve_devices(CPU, [])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_devices(CPU, [CPU, "cuda:0"])
