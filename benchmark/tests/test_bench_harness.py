"""The harness's arithmetic and its files: the rate, the roofline count,
the device's idle share, the readers found by name, the module checks."""

import ast
import json
import os
import re
import sys
import types

import numpy as np
import pytest

import bench_helpers as H
import devtrace
import roofline
import run as R

with open(os.path.join(H.ROOT, "BENCHMARK.json")) as fh:
    BENCH = json.load(fh)
CELLS = [w["name"] for w in BENCH["workloads"]]


def fake_run(**kw):
    run = R.Run(kw.pop("stats", {}), kw.pop("windows", 100),
                kw.pop("job_s", 4.0))
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def reader(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "m_" + name, os.path.join(H.BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_rate_is_all_windows_over_all_the_jobs_wall():
    assert reader("windows_per_s")(fake_run(windows=1275, job_s=51.0)) == 25.0
    assert reader("setup_s")(fake_run(setup_s=17.5)) == 17.5


def test_phase_readers_divide_the_executors_wall_by_windows():
    stats = {"wall_profile": {"prep_wait": {"seconds": 30.0},
                              "device": {"seconds": 4.0},
                              "phase_c": {"seconds": 8.0}},
             "pass2": {"total": 200000, "pass2": 70000}}
    run = fake_run(stats=stats, windows=1000)
    assert reader("prep_wait_ms_per_win")(run) == 30.0
    assert reader("device_phase_ms_per_win")(run) == 4.0
    assert reader("phase_c_ms_per_win")(run) == 8.0
    assert reader("pairs_per_win")(run) == 200.0
    assert reader("prep_wait_ms_per_win")(fake_run(stats={})) is None


def test_roofline_count_by_hand():
    # pass 1: 100 x 200 + 150 x min(500, 384) + 150 x 300 cells, 20 ops each
    assert roofline.span_work(np.array([100, 150]), np.array([0, 1, 1]),
                              np.array([200, 500, 300]), 384) == 122600 * 20
    # the gate: pair 0 scores 30 >= 25% of 100 and overlaps slot 0; pair 1
    # scores under 25% of 150; pair 2 has an empty span; pair 3 overlaps
    # only an inactive slot
    score = np.array([30, 20, 90, 90])
    ts = np.array([10, 0, 50, 0])
    te = np.array([130, 150, 50, 150])
    reg = np.zeros((4, 4, 2), np.int64)
    reg[0, 0] = (40, 45)
    reg[0, 2] = (100, 104)
    reg[1, 0] = (5, 9)
    reg[2, 0] = (40, 60)
    reg[3, 0] = (7, 7)
    rl = np.array([100, 150, 150, 150])
    kept, slots = roofline.gate(score, ts, te, reg, rl)
    assert kept.tolist() == [0] and slots.tolist() == [2]
    # pass 2: 100 x 120 cells at 20 + 36 x 2 ops
    assert roofline.evidence_work(rl[kept], ts[kept], te[kept], slots) == \
        100 * 120 * (20 + 72)
    # 64 lanes x 2 ops x 132 SMs x 1.98 GHz; bytes at 3.35 TB/s
    rate = 64 * 2 * 132 * 1.98e9
    assert roofline.min_seconds(rate, 0, 1.98e9, 132) == pytest.approx(1.0)
    assert roofline.min_seconds(1, 3.35e12, 1.98e9, 132) == pytest.approx(1.0)


def synthetic_trace():
    s = 1_000_000_000
    # job window 0-10 s; a kernel 1-2 s and a copy 1.5-3 s overlap; a
    # kernel 9-11 s runs past the window's end
    device = [(1 * s, 2 * s, "k_ev", True, 7, 0),
              (int(1.5 * s), 3 * s, "Memcpy HtoD", False, 8, 0),
              (9 * s, 11 * s, "k_other", True, 9, 0)]
    ranges = [(0, 4 * s, "prep_wait", 1), (int(0.5 * s), int(1.2 * s),
                                            "evidence_begin", 1),
              (5 * s, 8 * s, "assemble_evidence", 1)]
    runtime = {7: (int(0.6 * s), 1), 9: (int(8.5 * s), 1)}
    return devtrace.Trace((0, 10 * s), device, ranges, {}, runtime)


def test_device_idle_from_a_synthetic_event_list():
    tr = synthetic_trace()
    assert devtrace.busy_seconds(tr) == pytest.approx(3.0)
    assert devtrace.window_seconds(tr) == pytest.approx(10.0)
    run = fake_run(trace=tr)
    assert reader("device_idle_pct")(run) == pytest.approx(70.0)
    gaps = dict(devtrace.idle_by_host_call(tr))
    # 0-1 s mid 0.5 -> evidence_begin opens at 0.5; 3-9 s mid 6 ->
    # assemble_evidence
    assert gaps == pytest.approx({"evidence_begin": 1.0,
                                  "assemble_evidence": 6.0})
    ops = dict(devtrace.device_ops(tr))
    assert ops["k_other"] == pytest.approx(1.0)
    assert reader("device_idle_pct")(fake_run()) is None


def test_short_kernel_names():
    assert devtrace.short_name(
        "void (anonymous namespace)::evidence_dp_kernel<2>(unsigned char "
        "const*, int, l2t::Scoring, int*)") == \
        "(anonymous namespace)::evidence_dp_kernel<2>"
    assert devtrace.short_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD"


def test_kernels_in_calls_follow_their_launch():
    tr = synthetic_trace()
    secs, n = devtrace.kernel_seconds_in(tr, {"evidence_begin"})
    assert (secs, n) == (pytest.approx(1.0), 1)
    secs, n = devtrace.kernel_seconds_in(tr, {"prep_wait"})
    assert n == 1 and secs == pytest.approx(1.0)


def test_evidence_roofline_reads_least_time_over_kernel_time():
    tr = synthetic_trace()
    work = types.SimpleNamespace(ops=64 * 2 * 132 * 1.98e9 * 0.25, bytes=0)
    run = fake_run(trace=tr, work=work, clock_hz=1.98e9, sms=132)
    assert reader("evidence_roofline_pct")(run) == pytest.approx(25.0)
    assert reader("evidence_roofline_pct")(fake_run()) is None


def test_every_file_found_by_name_loads_and_is_used():
    used = {"configs": set(), "traffic": set(), "cells": set(),
            "metrics": set()}
    for name in CELLS:
        cell = R.load_cell(name)
        w = next(w for w in BENCH["workloads"] if w["name"] == name)
        used["traffic"].add(w["traffic"] + ".json")
        used["cells"].add(name + ".json")
        assert cell["cell"]["sizing_windows_per_s"] > 0
        assert set(cell["cell"]["limits"]) == {"missed_share", "extra_share",
                                               "likelihood_mismatches"}
        assert R.pipeline_argv(cell, {"fasta": "f", "inputs": {
            s["role"]: "b" for s in cell["cfg"]["samples"]}}, "o", "cuda", 8)
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    for c in BENCH["configs"]:
        used["configs"].add(os.path.basename(c["file"]))
        with open(os.path.join(H.ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        used["metrics"].add(m["name"] + ".py")
        assert callable(reader(m["name"]))
    for sub, names in used.items():
        on_disk = {f for f in os.listdir(os.path.join(H.BENCH, sub))
                   if not f.startswith((".", "__"))}
        assert names <= on_disk, sub
        if sub in ("cells", "metrics"):
            assert on_disk == names, sub


def load_config(f):
    with open(os.path.join(H.BENCH, "configs", f)) as fh:
        return json.load(fh)


CONFIGS = sorted(os.listdir(os.path.join(H.BENCH, "configs")))
TRAFFIC = sorted(f[:-5] for f in os.listdir(os.path.join(H.BENCH, "traffic")))


@pytest.mark.parametrize("config,traffic", [(c, "wgs") for c in CONFIGS] + [
    ("somatic_hcc1395.json", t) for t in TRAFFIC if t != "wgs"])
def test_every_config_and_traffic_on_disk_make_a_job(config, traffic,
                                                     tmp_path):
    """Files kept for cells that later changes add (see PERF.md) load, and
    the generator makes a small job from each: every configuration under
    the plain traffic, every traffic mix on the somatic configuration."""
    import simulate as S

    cfg = load_config(config)
    assert cfg["name"] + ".json" == config
    assert {"source", "cli", "samples", "reads", "germline", "reduced",
            "assumed"} <= set(cfg)
    run = R.apply_traffic(cfg, R.load_traffic(traffic))
    assert set(run["depths"]) == {s["role"] for s in cfg["samples"]}
    fx = S.make_job_inputs(str(tmp_path), run["cfg"], {
        k: 2.0 for k in run["depths"]}, 6, 5, 2)
    assert set(fx["bams"]) == set(run["depths"]) and fx["truth"]


def test_a_traffic_file_lays_settings_over_the_configuration(tmp_path):
    cfg = load_config("somatic_hcc1395.json")
    run = R.apply_traffic(cfg, {
        "config": {"somatic": {"spacing_bp": [250, 350]},
                   "cli": {"window": 600}},
        "depth": {"tumor": 200},
        "pipeline_args": ["--executor", "threads"], "inputs": "cram"})
    assert run["cfg"]["somatic"] == {**cfg["somatic"],
                                     "spacing_bp": [250, 350]}
    assert run["cfg"]["cli"] == {**cfg["cli"], "window": 600}
    assert run["depths"] == {"normal": 40.0, "tumor": 200.0}
    assert run["inputs"] == "cram"
    assert cfg["somatic"]["spacing_bp"] == [1700, 2100]  # not changed
    argv = R.pipeline_argv(run, {"fasta": "ref.fa", "inputs": {
        "normal": "n.cram", "tumor": "t.cram"}}, "o.vcf.gz", "cpu", 2)
    assert argv[-2:] == ["--executor", "threads"]
    assert argv[argv.index("-w") + 1] == "600"
    from lancet2_tpu_torch.cli.main import build_parser

    args = build_parser().parse_args(argv)
    assert args.executor == "threads" and args.tumor == ["t.cram"]
    with pytest.raises(SystemExit):
        R.apply_traffic(cfg, {"depth": {"germline": 30}})
    # a traffic file names only known keys and formats
    os.mkdir(tmp_path / "traffic")
    for bad in ({"layout": "prose"}, {"inputs": "sam"}):
        with open(tmp_path / "traffic" / "bad.json", "w") as fh:
            json.dump(bad, fh)
        with pytest.raises(SystemExit):
            R.load_traffic("bad", str(tmp_path))


def test_benchmark_json_shape():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for m in BENCH["end_to_end"]:
        assert name.match(m["name"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert name.match(m["name"]) and m["moves"] in {
            e["name"] for e in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert name.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for mod in ("lancet2_tpu_torch", "lancet2_tpu_torch.ops", "jaxtyping",
                "flaxen"):
        monkeypatch.setitem(sys.modules, mod, types.ModuleType(mod))
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lancet2_tpu.ops",
                        types.ModuleType("lancet2_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert R.forbidden_modules() == ["jax", "lancet2_tpu"]


def imports_of(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for root, _dirs, files in os.walk(H.BENCH):
        for f in files:
            if f.endswith(".py"):
                bad = imports_of(os.path.join(root, f)) & R.FORBIDDEN
                assert not bad, (f, bad)


@pytest.mark.parametrize("module", ["reference.py", "simulate.py",
                                    "roofline.py", "devtrace.py"])
def test_the_yardstick_imports_nothing_of_the_program(module):
    assert "lancet2_tpu_torch" not in imports_of(os.path.join(H.BENCH, module))
