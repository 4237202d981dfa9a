"""The port's threads executor and the per-window genotyper engines.

On a small seeded tumor/normal fixture (3 kb, somatic SNV at 1500, germline
5 bp deletion at 750, 14x/20x, seed 5, 600 bp windows):

  * genotyper level: on the windows' prepared components (every sixth
    read), the port's `Genotyper(backend=b, device="cpu")` for b in numpy,
    jax and evidence returns VariantSupport evidence equal field by field to
    `lancet2_tpu.caller.genotyper.Genotyper`'s; `build_evidence_pairs` and
    `run_evidence_pairs` return equal arrays; and the two-pass protocol that
    the card runs, driven on CPU tensors (where each kernel wrapper runs its
    plain version), equals the one-pass run on every field that
    `assemble_evidence` reads;
  * end to end: `python -m lancet2_tpu_torch pipeline --device cpu -T 2`
    with `--executor threads` and `--aligner-backend evidence` or `jax`, and
    the batch executor with `--prep-mode threads`, write VCF records
    byte-identical to ONE JAX batch-executor run on the fixture, and load
    neither jax nor the JAX package;
  * `--out-graphs-tgz` and `--probe-variants/--probe-results` on a
    one-window region with `--aligner-backend numpy` on both packages: the
    same archive members (names and bytes) and the same probe TSV.

tests/conftest.py imports jax, so the end-to-end port runs go to one
subprocess, which overlaps the in-process JAX reference run.
"""

from __future__ import annotations

import copy
import gzip
import json
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch

from lancet2_tpu.caller.genotyper import Genotyper as JaxGenotyper
from lancet2_tpu.cli.main import main as jax_cli_main
from lancet2_tpu.utils.simulate import Variant, make_tumor_normal_fixture, random_reference
from lancet2_tpu_torch.caller.genotyper import Genotyper
from lancet2_tpu_torch.caller.support import VariantSupport
from lancet2_tpu_torch.cbdg.graph import GraphParams
from lancet2_tpu_torch.cli.main import main as port_cli_main
from lancet2_tpu_torch.core.read_collector import CollectorParams
from lancet2_tpu_torch.core.sample_info import make_sample_list
from lancet2_tpu_torch.core.variant_builder import (
    BuilderParams,
    PreparedWindow,
    VariantBuilder,
)
from lancet2_tpu_torch.core.window_builder import WindowBuilder, WindowParams
from lancet2_tpu_torch.hts.fasta import Reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_threads")
    ref = random_reference(REF_LEN, seed=5)
    alt = "C" if ref[SNV] != "C" else "G"
    fx = make_tumor_normal_fixture(
        str(tmp), ref_len=REF_LEN,
        somatic=[Variant(pos0=SNV, ref=ref[SNV], alt=alt, vaf=0.4)],
        germline=[Variant(pos0=DEL, ref=ref[DEL:DEL + 6], alt=ref[DEL],
                          vaf=0.5)],
        normal_cov=14, tumor_cov=20, seed=5)
    return tmp, fx


def _records(path) -> list[str]:
    with gzip.open(path, "rt") as fh:
        return [l for l in fh.read().splitlines() if l and not l.startswith("#")]


# ---------------------------------------------------------------------------
# genotyper level
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def components(fixture):
    """(hap_seqs, reads, variants) of every component of the fixture's
    windows, prepared by the port's builder, with every sixth read."""
    _tmp, fx = fixture
    ref = Reference(fx["fasta"])
    samples = make_sample_list([fx["normal"]], [fx["tumor"]], [])
    wb = WindowBuilder(ref, WindowParams(window_length=600))
    wb.add_whole_reference()
    wb.sort_input_regions()
    params = BuilderParams(graph=GraphParams(num_samples=len(samples)),
                           collector=CollectorParams(ref_path=fx["fasta"]),
                           device="cpu")
    builder = VariantBuilder(params, ref, [copy.copy(s) for s in samples])
    comps = []
    for window in wb.build_windows():
        prepared = builder.prepare_window(window)
        if isinstance(prepared, PreparedWindow):
            for pc in prepared.components:
                comps.append((pc.hap_seqs, prepared.reads[::6], pc.variants))
    assert len(comps) >= 2, "the fixture must give components to genotype"
    return comps


def _support_fields(result: dict) -> dict:
    """{variant: {sample: [{field: value} per allele]}}"""
    return {vi: {name: [{f: getattr(a, f) for f in a.__slots__}
                        for a in sup.allele_data]
                 for name, sup in per.items()}
            for vi, per in result.items()}


@pytest.mark.parametrize("backend", ["numpy", "jax", "evidence"])
def test_genotyper_matches_jax_package(components, backend):
    port = Genotyper(backend=backend, device="cpu")
    ref = JaxGenotyper(backend=backend)
    n_evidence = 0
    for hap_seqs, reads, variants in components:
        got = port.genotype(hap_seqs, reads, variants)
        want = ref.genotype(hap_seqs, reads, variants)
        assert all(isinstance(s, VariantSupport)
                   for per in got.values() for s in per.values())
        assert _support_fields(got) == _support_fields(want)
        n_evidence += sum(len(a["aln_scores"]) for per in
                          _support_fields(got).values()
                          for alleles in per.values() for a in alleles)
    assert n_evidence > 0


def _evidence_pairs(genotyper, hap_seqs, reads, variants):
    from lancet2_tpu_torch.base.dna import encode

    return genotyper.build_evidence_pairs([encode(h) for h in hap_seqs],
                                          reads, variants)


def test_evidence_pairs_and_outputs_match_jax_package(components):
    port, ref = Genotyper(backend="evidence", device="cpu"), JaxGenotyper(
        backend="evidence")
    hap_seqs, reads, variants = components[0]
    got = _evidence_pairs(port, hap_seqs, reads, variants)
    want = _evidence_pairs(ref, hap_seqs, reads, variants)
    assert len(got[0]) == len(want[0]) > 0
    for g_list, w_list in zip(got[:3], want[:3]):
        for g, w in zip(g_list, w_list):
            np.testing.assert_array_equal(g, w)
    for (gr, gh, greg, gvis), (wr, wh, wreg, wvis) in zip(got[3], want[3]):
        assert (gr, gh, gvis) == (wr, wh, wvis)
        np.testing.assert_array_equal(greg, wreg)
    outs = port.run_evidence_pairs(*got)
    ref_outs = ref.run_evidence_pairs(*want)
    assert sorted(outs) == sorted(ref_outs)
    for k in outs:
        np.testing.assert_array_equal(outs[k], ref_outs[k], err_msg=k)


def test_two_pass_protocol_on_cpu_tensors_matches_one_pass(components):
    """The protocol `run_evidence_pairs` runs on a CUDA device, driven here
    on CPU tensors: span over every pair, the shared gate, evidence over the
    survivors by launch class. Every field assembly reads must equal the
    one-pass run, and so must the assembled evidence."""
    from lancet2_tpu_torch.ops.evidence_layout import REGION_FILL, SPAN_KEYS

    port = Genotyper(backend="evidence", device="cpu")
    hap_seqs, reads, variants = components[0]
    pairs = _evidence_pairs(port, hap_seqs, reads, variants)
    one = port.run_evidence_pairs(*pairs)
    two = port._run_evidence_pairs_two_pass(*pairs, torch.device("cpu"))
    n = len(pairs[0])
    assert 0 < port.pass2_stats["pass2"] < port.pass2_stats["total"] == n
    for k in SPAN_KEYS:
        np.testing.assert_array_equal(two[k], one[k], err_msg=k)
    regions = np.stack([m[2] for m in pairs[3]])
    read = np.array([m[0] for m in pairs[3]])
    min_score = (0.25 * np.array([reads[r].length for r in read])).astype(int)
    live = ((one["score"] >= min_score) & (one["t_end"] > one["t_start"]))
    ov = ((regions[:, :, 1] > one["t_start"][:, None])
          & (regions[:, :, 0] < one["t_end"][:, None])
          & (regions[:, :, 1] > regions[:, :, 0]) & live[:, None])
    assert ov.any()
    for k in REGION_FILL:
        np.testing.assert_array_equal(two[k][ov], one[k][ov], err_msg=k)
    assert _support_fields(port.assemble_evidence(reads, variants, pairs[3],
                                                  two)) == \
        _support_fields(port.assemble_evidence(reads, variants, pairs[3], one))


def _stress(work, n_threads: int = 16) -> None:
    """Run work(k) for k < n_threads in threads at once, the interpreter
    switching threads as often as it can; every thread must finish."""
    import threading

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)


def test_reference_fetch_is_thread_safe(fixture):
    """The threads executor's workers share one Reference: fetches from
    many threads at once must return what one thread reads. The file handle
    yields the interpreter after each seek, so that another thread's seek
    lands between a seek and its read whenever nothing keeps it out."""
    import random
    import time

    class YieldAfterSeek:
        def __init__(self, fh):
            self.fh = fh

        def seek(self, pos):
            self.fh.seek(pos)
            time.sleep(1e-5)

        def read(self, n):
            return self.fh.read(n)

    _tmp, fx = fixture
    ref = Reference(fx["fasta"])
    rng = random.Random(3)
    regions = [(a, a + rng.randint(1, 900))
               for a in (rng.randint(1, REF_LEN) for _ in range(1600))]
    want = [ref.fetch(fx["chrom"], a, b) for a, b in regions]
    ref._fh = YieldAfterSeek(ref._fh)
    bad = []

    def work(k):
        for i in range(k, len(regions), 16):
            if ref.fetch(fx["chrom"], *regions[i]) != want[i]:
                bad.append(regions[i])

    _stress(work)
    assert not bad, bad[:5]


def test_launch_counts_exact_under_threads(monkeypatch):
    """The threads executor's workers launch K1/K2 at once: no count may be
    lost. The counts yield the interpreter between a read and its write."""
    import time

    from lancet2_tpu_torch.ops import _build

    class YieldOnRead(dict):
        def __getitem__(self, key):
            value = super().__getitem__(key)
            time.sleep(1e-6)
            return value

    counts = YieldOnRead(span=0)
    monkeypatch.setattr(_build, "LAUNCHES", counts)

    def work(k):
        for _ in range(200):
            _build.count_launch("span")

    _stress(work)
    assert counts["span"] == 16 * 200


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

PORT_RUNS = {
    "threads_evidence": ["--executor", "threads", "--aligner-backend",
                         "evidence"],
    "threads_jax": ["--executor", "threads", "--aligner-backend", "jax"],
    "batch_prep_threads": ["--prep-mode", "threads"],
}


@pytest.fixture(scope="module")
def pipeline_runs(fixture):
    """The port's three runs in one subprocess (two intra-op threads each),
    overlapping ONE JAX batch-executor run here."""
    tmp, fx = fixture
    common = ["pipeline", "-n", fx["normal"], "-t", fx["tumor"],
              "-r", fx["fasta"], "-T", "2", *WINDOW]
    argvs = [common + ["-o", str(tmp / f"{name}.vcf.gz"), "--device", "cpu",
                       *extra] for name, extra in PORT_RUNS.items()]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-c", _RUN_PORT, json.dumps(argvs)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp))
    try:
        jax_vcf = str(tmp / "jax_batch.vcf.gz")
        assert jax_cli_main(common + ["-o", jax_vcf, "--executor", "batch"]) == 0
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    status = json.loads(stdout.strip().splitlines()[-1])
    assert status == {"exit": [0] * len(PORT_RUNS), "loaded": []}, \
        stderr[-3000:]
    want = _records(jax_vcf)
    assert want, "fixture must produce records"
    called = {(int(r.split("\t")[1]), r.split("\t")[3], r.split("\t")[4])
              for r in want}
    for v in fx["somatic"] + fx["germline"]:
        assert (v.pos0 + 1, v.ref, v.alt) in called, v
    return want, {name: _records(tmp / f"{name}.vcf.gz") for name in PORT_RUNS}


@pytest.mark.parametrize("name", sorted(PORT_RUNS))
def test_port_run_matches_jax_batch_executor(pipeline_runs, name):
    want, got = pipeline_runs
    assert got[name] == want


def test_graphs_tgz_and_probes_match_jax_package(fixture, monkeypatch):
    """One window, numpy backend, one worker, in both packages: the same
    graph archive members and the same probe TSV. `--append-history` hands
    the port's run stats to profiling.append_history."""
    from lancet2_tpu_torch.utils import profiling

    tmp, fx = fixture
    probes = tmp / "probes.tsv"
    alt = fx["somatic"][0]
    probes.write_text(f"{fx['chrom']}\t{alt.pos0 + 1}\t{alt.ref}\t{alt.alt}\n")
    common = ["pipeline", "-n", fx["normal"], "-t", fx["tumor"],
              "-r", fx["fasta"], "-T", "1", *WINDOW,
              "-R", f"{fx['chrom']}:{SNV - 50}-{SNV + 50}", "-P", "0",
              "--executor", "threads", "--aligner-backend", "numpy",
              "--probe-variants", str(probes)]
    history = []
    monkeypatch.setattr(profiling, "append_history", history.append)
    out = {}
    for tag, main, extra in (("jax", jax_cli_main, []),
                             ("port", port_cli_main,
                              ["--device", "cpu", "--append-history"])):
        assert main(common + ["-o", str(tmp / f"g_{tag}.vcf.gz"),
                              "--out-graphs-tgz", str(tmp / f"g_{tag}.tgz"),
                              "--probe-results", str(tmp / f"p_{tag}.tsv"),
                              *extra]) == 0
        with tarfile.open(tmp / f"g_{tag}.tgz") as tar:
            members = {m.name: tar.extractfile(m).read()
                       for m in tar.getmembers() if m.isfile()}
        out[tag] = (members, (tmp / f"p_{tag}.tsv").read_text(),
                    _records(tmp / f"g_{tag}.vcf.gz"))
    members, tsv, recs = out["port"]
    assert members and len(tsv.splitlines()) > 1
    assert sorted(members) == sorted(out["jax"][0])
    assert members == out["jax"][0]
    assert tsv == out["jax"][1]
    assert recs == out["jax"][2]
    assert len(history) == 1
    assert (history[0]["kind"], history[0]["executor"], history[0]["windows"]
            ) == ("pipeline", "threads", 1)
