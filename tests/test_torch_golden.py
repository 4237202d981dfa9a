"""The port's records against the JAX package's frozen golden VCF, and
tests/test_e2e_breadth.py's cases against the JAX package's CLI, on the CPU:

  * tests/test_truth_harness.py's golden fixture (3.6 kb: a somatic SNV, a
    homopolymer insertion and a 2 bp deletion, 42x/60x, seeds 61-63), built
    with the port's simulator: the port's CLI on --device cpu writes the
    record lines of tests/data/golden_somatic.vcf, the JAX package's frozen
    output (which TestGoldenVcf holds in the same suite), byte for byte;
  * a germline insertion, a somatic MNP and a somatic SNV at a window edge
    (one record despite two overlapping windows), on tests/test_e2e_breadth.py's
    fixtures: the port's records equal, byte for byte, the JAX package's
    default command on the same fixture and region, and pass the JAX
    tests' assertions. The regions are cut to the windows that hold each
    variant, with -P 0 so that they are windows of the whole-reference run:
    one window for the insertion and the MNP, the two that overlap at the
    edge for the SNV.

The port's CLI runs go through tests/torch_cloud_jobs.py in two processes
with two intra-op threads each (neither may load jax or lancet2_tpu),
started before the JAX runs and awaited after.
"""

from __future__ import annotations

import gzip

import pytest

from lancet2_tpu.cli.main import main as jax_cli_main
from lancet2_tpu_torch.utils.simulate import (
    Variant,
    make_tumor_normal_fixture,
    random_reference,
)
from torch_cloud_jobs import PortProcess, golden_fixture, golden_records

EDGE = 2405  # default windows (step 800) start at 1: edge at 2401
# each case's region, with -P 0: the windows of the whole-reference run
# that hold its variant
REGIONS = {"ins": "chrS:1601-2601", "mnp": "chrS:801-1801",
           "edge": "chrS:1601-3401"}


def _records(path):
    with gzip.open(path, "rt") as fh:
        return [l.rstrip("\n").split("\t") for l in fh if not l.startswith("#")]


def _breadth_fixtures(tmp) -> dict:
    """tests/test_e2e_breadth.py's three fixtures, in directories of their
    own: {name: fixture}."""
    out = {}
    ref = random_reference(3500, seed=601)
    out["ins"] = dict(ref_len=3500, seed=601, normal_cov=38, tumor_cov=38,
                      germline=[Variant(1700, ref[1700], ref[1700] + "TGCA",
                                        vaf=0.5)])
    ref = random_reference(3500, seed=602)
    ref2 = ref[1600:1602]
    alt2 = "".join("ACGT"[("ACGT".index(b) + 1) % 4] for b in ref2)
    out["mnp"] = dict(ref_len=3500, seed=602, normal_cov=38, tumor_cov=50,
                      somatic=[Variant(1600, ref2, alt2, vaf=0.5)])
    ref = random_reference(4600, seed=603)
    alt = "C" if ref[EDGE] != "C" else "G"
    out["edge"] = dict(ref_len=4600, seed=603, normal_cov=34, tumor_cov=46,
                       somatic=[Variant(EDGE, ref[EDGE], alt, vaf=0.5)])
    fixtures = {}
    for name, kw in out.items():
        (tmp / name).mkdir()
        fixtures[name] = make_tumor_normal_fixture(str(tmp / name), **kw)
    return fixtures


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's CLI runs (the golden fixture in one process, the three
    breadth fixtures in another) beside the JAX package's default command
    on the breadth fixtures (this process). Returns ({name: PortProcess},
    {name: the port's output VCF}, {name: the JAX package's output VCF})."""
    tmp = tmp_path_factory.mktemp("torch_golden")
    (tmp / "golden").mkdir()
    fasta, normal, tumor = golden_fixture(str(tmp / "golden"))
    outs = {"golden": str(tmp / "golden.vcf.gz")}
    golden = [{"kind": "cli", "argv": [
        "pipeline", "-n", normal, "-t", tumor, "-r", fasta, "-o",
        outs["golden"], "-T", "2", "--device", "cpu"]}]
    breadth, jax_argv, jax_outs = [], {}, {}
    for name, fx in _breadth_fixtures(tmp).items():
        outs[name] = str(tmp / f"{name}.vcf.gz")
        jax_outs[name] = str(tmp / f"{name}_jax.vcf.gz")
        argv = ["pipeline", "-n", fx["normal"], "-t", fx["tumor"], "-r",
                fx["fasta"], "-R", REGIONS[name], "-P", "0", "-T", "2"]
        breadth.append({"kind": "cli", "argv": argv + [
            "-o", outs[name], "--device", "cpu"]})
        jax_argv[name] = argv + ["-o", jax_outs[name]]
    procs = {"golden": PortProcess(golden, ["golden"], tmp),
             "breadth": PortProcess(breadth, ["ins", "mnp", "edge"], tmp)}
    try:
        for argv in jax_argv.values():
            assert jax_cli_main(argv) == 0
        for p in procs.values():
            p.results()
    finally:
        for p in procs.values():
            p.stop()
    return procs, outs, jax_outs


def _port_records(runs, group, name):
    procs, outs, _jax = runs
    assert procs[group].results()[name]["exit"] == 0
    return _records(outs[name])


def _breadth_records(runs, name):
    """The port's records for breadth case `name`, after holding them equal
    to the JAX package's."""
    recs = _port_records(runs, "breadth", name)
    assert recs == _records(runs[2][name])
    return recs


# ---------------------------------------------------------------------------
# tests/test_e2e_breadth.py and the golden VCF
# ---------------------------------------------------------------------------

def test_germline_insertion_called(runs):
    recs = _breadth_records(runs, "ins")
    hits = [r for r in recs
            if abs(int(r[1]) - 1701) <= 4 and len(r[4]) > len(r[3])]
    assert hits, f"insertion not called: {[(r[1], r[3], r[4]) for r in recs]}"
    assert "TYPE=INS" in hits[0][7]
    assert "LENGTH=4" in hits[0][7]
    assert "SHARED" in hits[0][7]


def test_somatic_mnp_called(runs):
    recs = _breadth_records(runs, "mnp")
    hits = [r for r in recs if abs(int(r[1]) - 1601) <= 2]
    assert hits
    info = hits[0][7]
    assert "TYPE=MNP" in info or "TYPE=SNV" in info  # may split or keep
    assert "CASE" in info


def test_variant_near_window_edge_called_via_overlap(runs):
    recs = _breadth_records(runs, "edge")
    hits = [r for r in recs if int(r[1]) == EDGE + 1]
    assert hits, f"boundary variant lost: {[(r[1], r[3], r[4]) for r in recs]}"
    assert len(hits) == 1


def test_records_match_frozen_golden(runs):
    recs = _port_records(runs, "golden", "golden")
    assert recs, "golden fixture produced no records"
    assert ["\t".join(r) for r in recs] == golden_records()
