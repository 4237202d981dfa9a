"""The port's device graph build against the JAX package and the numpy path.

  * `ops/graph_tpu.build_graph_device` (one window) and
    `ops/graph_tape.build_graphs_tape` (a batch of windows) on the CPU equal
    the JAX functions array for array (the one-window pass's occurrence grid
    is compared by sequence and offset: the port drops the JAX pass's shape
    buckets), on the fixtures of tests/test_graph_tpu.py (k 13, 25) and
    tests/test_graph_tape.py (k 13, 25, the 3 kb multi-row reference, an
    empty window);
  * the port's Graph with `build_backend="device"` builds node tables (ids,
    codes, signs, labels, counts, roles, edges), the reference path and the
    node order bit-identical to the numpy path, through the tape
    (`_build_graph_tape`) and the one-window pass (`_build_graph_xla`);
  * `--graph-backend device` end to end under each executor (threads: on
    --device; batch: on the CPU, in the prep workers): the records of the
    same run with the native graph build.
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lancet2_tpu.base.dna import encode
from lancet2_tpu.ops.graph_tape import build_graphs_tape as jax_tape
from lancet2_tpu.ops.graph_tpu import build_graph_device as jax_device
from lancet2_tpu.utils.simulate import (
    Variant,
    make_tumor_normal_fixture,
    random_reference,
    structured_reference,
)
from lancet2_tpu_torch.cbdg.graph import Graph, GraphParams
from lancet2_tpu_torch.ops.graph_tape import build_graphs_tape
from lancet2_tpu_torch.ops.graph_tpu import build_graph_device
from test_graph_tape import _make_reads, _numpy_table, _window_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def window_fixture():
    """tests/test_graph_tpu.py's window: 1 kb, a homopolymer, an SNV and an
    insertion, 35x normal + 50x tumor."""
    ref_seq = structured_reference(1000, [(420, "homopolymer", "A", 9)], seed=5)
    alt = "G" if ref_seq[500] != "G" else "C"
    somatic = [Variant(500, ref_seq[500], alt, vaf=0.45),
               Variant(700, ref_seq[700], ref_seq[700] + "TAC", vaf=0.45)]
    normal = _make_reads(ref_seq, [], 35.0, 21, 0, "NORMAL", 2)
    tumor = _make_reads(ref_seq, somatic, 50.0, 22, 1, "TUMOR", 4)
    return encode(ref_seq), normal + tumor


@pytest.fixture(scope="module")
def batch_fixture():
    """tests/test_graph_tape.py's three windows of different sizes."""
    windows = []
    for wi, (n, seed) in enumerate([(900, 5), (1400, 6), (600, 7)]):
        ref_seq = structured_reference(
            n, [(n // 3, "homopolymer", "A", 8)], seed=seed)
        alt = "G" if ref_seq[n // 2] != "G" else "C"
        som = [Variant(n // 2, ref_seq[n // 2], alt, vaf=0.45)]
        normal = _make_reads(ref_seq, [], 30.0, 40 + wi, 0, "NORMAL", 2)
        tumor = _make_reads(ref_seq, som, 40.0, 50 + wi, 1, "TUMOR", 4)
        windows.append((encode(ref_seq), normal + tumor))
    return windows


def _port_table(build, seqs, quals, meta, k):
    """Node table, ref path, built ids and node order of the port's Graph
    after one of its device builds ('tape' or 'xla') on the CPU."""
    g = Graph(GraphParams(num_samples=2, build_backend="device",
                          build_device="cpu"))
    g.curr_k = k
    g.nodes, g.ref_node_ids = {}, []
    getattr(g, f"_build_graph_{build}")(seqs, quals, meta, k, 2)
    table = {nid: (tuple(n.codes.tolist()), n.sign, n.label,
                   tuple(n.counts.tolist()), tuple(n.role_counts),
                   tuple(sorted(n.edges)))
             for nid, n in g.nodes.items()}
    return table, list(g.ref_node_ids), set(g.all_built_ids), list(g.nodes)


def _assert_tables_equal(got, want):
    assert got[1] == want[1], "ref path ids differ"
    assert got[2] == want[2], "built id sets differ"
    assert got[0] == want[0], "node tables differ"
    assert got[3] == want[3], "node order differs"


@pytest.mark.parametrize("k", [13, 25])
def test_build_graph_device_matches_jax_and_numpy(window_fixture, k):
    ref_codes, reads = window_fixture
    seqs, quals, meta = _window_inputs(ref_codes, reads, k)
    want = jax_device(seqs, quals, meta, k, 2)
    got = build_graph_device(seqs, quals, meta, k, 2, CPU)
    for key in ("ids", "codes", "counts", "roles"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    # grid positions as (sequence, offset): the JAX grid is bucketed
    np.testing.assert_array_equal(
        np.divmod(got["first_idx"], got["grid_m"]),
        np.divmod(np.asarray(want["first_idx"]), want["grid_m"]))
    S, M = got["occ_valid"].shape
    valid = got["occ_valid"]
    np.testing.assert_array_equal(np.asarray(want["occ_valid"])[:S, :M],
                                  valid)
    for key in ("inverse", "occ_sign"):
        np.testing.assert_array_equal(
            got[key][valid], np.asarray(want[key])[:S, :M][valid],
            err_msg=key)
    numpy_table = _numpy_table(ref_codes, reads, k)
    for build in ("xla", "tape"):
        _assert_tables_equal(_port_table(build, seqs, quals, meta, k),
                             numpy_table)


@pytest.mark.parametrize("k", [13, 25])
def test_build_graphs_tape_matches_jax_and_numpy(batch_fixture, k):
    inputs = [_window_inputs(ref_codes, reads, k)
              for ref_codes, reads in batch_fixture]
    want = jax_tape(inputs, k, 2)
    got = build_graphs_tape(inputs, k, 2, CPU)
    assert len(got) == len(want) == len(inputs)
    for (ref_codes, reads), g, w, (seqs, quals, meta) in zip(
            batch_fixture, got, want, inputs):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], np.asarray(w[key]),
                                          err_msg=key)
        graph = Graph(GraphParams(num_samples=2, build_backend="device"))
        graph.curr_k = k
        graph._materialize_tape_window(g, seqs, meta, k, 2)
        table = {nid: (tuple(n.codes.tolist()), n.sign, n.label,
                       tuple(n.counts.tolist()), tuple(n.role_counts),
                       tuple(sorted(n.edges)))
                 for nid, n in graph.nodes.items()}
        _assert_tables_equal(
            (table, list(graph.ref_node_ids), set(graph.all_built_ids),
             list(graph.nodes)), _numpy_table(ref_codes, reads, k))


def test_tape_long_reference_and_empty_window():
    """A 3 kb reference spans ~20 tape rows: overlap occurrences must not
    double-count and every adjacent pair must give its edge; an empty
    window gives None, as in the JAX pass."""
    k = 13
    ref_seq = structured_reference(3000, [(1500, "str", "AT", 10)], seed=9)
    reads = _make_reads(ref_seq, [], 12.0, 77, 0, "NORMAL", 2)
    ref_codes = encode(ref_seq)
    inputs = [_window_inputs(ref_codes, reads, k), ([], [], [])]
    got = build_graphs_tape(inputs, k, 2, CPU)
    want = jax_tape(inputs, k, 2)
    assert got[1] is None and want[1] is None
    for key in want[0]:
        np.testing.assert_array_equal(got[0][key], np.asarray(want[0][key]),
                                      err_msg=key)
    seqs, quals, meta = inputs[0]
    _assert_tables_equal(_port_table("tape", seqs, quals, meta, k),
                         _numpy_table(ref_codes, reads, k))
    assert build_graphs_tape([([], [], [])], k, 2, CPU) == [None]
    assert build_graph_device([], [], [], k, 2, CPU) is None


_RUN_PORT = """
import json, sys
from lancet2_tpu_torch.cli.main import main
codes = [main(argv) for argv in json.loads(sys.argv[1])]
print(json.dumps({"exit": codes}))
"""


def _records(path) -> list[str]:
    with gzip.open(path, "rt") as fh:
        return [l for l in fh.read().splitlines() if l and not l.startswith("#")]


def test_cli_graph_backend_device_under_each_executor(tmp_path):
    ref = random_reference(2400, seed=8)
    alt = "C" if ref[1200] != "C" else "G"
    fx = make_tumor_normal_fixture(
        str(tmp_path), ref_len=2400,
        somatic=[Variant(pos0=1200, ref=ref[1200], alt=alt, vaf=0.45)],
        normal_cov=14, tumor_cov=20, seed=8)
    common = ["pipeline", "-n", fx["normal"], "-t", fx["tumor"],
              "-r", fx["fasta"], "-T", "2", "-w", "600", "--device", "cpu",
              "-R", "chrS:900-1500"]
    runs = {}
    argvs = []
    for executor, extra in (("threads", ["--aligner-backend", "numpy"]),
                            ("batch", ["--prep-mode", "threads"])):
        for backend in ("device", "native"):
            out = str(tmp_path / f"{executor}_{backend}.vcf.gz")
            runs[(executor, backend)] = out
            argvs.append(common + ["-o", out, "--executor", executor,
                                   "--graph-backend", backend] + extra)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_PORT, json.dumps(argvs)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "exit": [0, 0, 0, 0]}
    assert "graph build: the tape-packed torch pass on cpu" in proc.stderr
    for executor in ("threads", "batch"):
        got = _records(runs[(executor, "device")])
        assert got and got == _records(runs[(executor, "native")]), executor
