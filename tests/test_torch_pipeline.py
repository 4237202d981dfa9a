"""The port's slice as a whole: `python -m lancet2_tpu_torch pipeline`.

On a seeded 6 kb tumor/normal fixture (somatic SNV at 3000, germline 5 bp
deletion at 1200, seed 9), the port's pipeline
with --device cpu must write VCF record lines byte-identical to the JAX
package's batch executor on CPU, call both planted variants, and load
neither jax nor the JAX package. tests/conftest.py imports jax, so the port
runs in a subprocess.
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys

import pytest
import torch

from lancet2_tpu.cli.main import main as jax_cli_main
from lancet2_tpu.utils.simulate import Variant, make_tumor_normal_fixture, random_reference
from lancet2_tpu_torch.cli.main import build_parser
from lancet2_tpu_torch.core.batch_pipeline import check_device
from lancet2_tpu_torch.hts.bam import BamReader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# modules of the multi-device path and the device graph build, held by the
# import checks below by name
NEW_MODULES = ("lancet2_tpu_torch.parallel.mesh",
               "lancet2_tpu_torch.parallel.evidence_spmd",
               "lancet2_tpu_torch.ops.graph_tpu",
               "lancet2_tpu_torch.ops.graph_tape",
               "lancet2_tpu_torch.ops.lgamma_f32",
               "lancet2_tpu_torch.graft_entry")

# the port's job, once through `python -m lancet2_tpu_torch` untraced, then
# through run_pipeline under torch.profiler (CPU activity): the modules it
# loaded, both runs' stats, the traced run's wall on the profiler's clock,
# and the profiler's ranges named like the spans
_RUN_PORT = """
import json, runpy, sys, time
from lancet2_tpu_torch.cli import main as cli

argv, plain_vcf, traced_vcf, out = json.loads(sys.argv[1]), *sys.argv[2:]
runs, run_pipeline = [], cli.run_pipeline


def keep_stats(*args, **kwargs):
    runs.append(run_pipeline(*args, **kwargs))
    return runs[-1]


cli.run_pipeline = keep_stats
sys.argv = ["lancet2_tpu_torch"] + argv + ["-o", plain_vcf]
try:
    runpy.run_module("lancet2_tpu_torch", run_name="__main__")
except SystemExit as exc:
    code = exc.code
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "lancet2_tpu"))
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU]) as prof:
    t0 = time.time_ns()
    traced = run_pipeline(cli.build_parser().parse_args(argv + ["-o", traced_vcf]),
                          "t")
    t1 = time.time_ns()
names = set(traced["trace"]["spans"])
ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events() if e.name() in names]
keep = ("trace", "wall_profile", "pass2")
with open(out, "w") as fh:
    json.dump({"exit": code, "loaded": loaded,
               "plain": {k: runs[0][k] for k in keep},
               "traced": {k: traced[k] for k in keep},
               "wall": [t0, t1], "ranges": ranges}, fh)
"""
NAME, PARENT, REQUEST, PID, TID, T0, T1 = range(7)  # fields of an event


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_slice")
    ref = random_reference(6000, seed=9)
    alt = "C" if ref[3000] != "C" else "G"
    fx = make_tumor_normal_fixture(
        str(tmp), ref_len=6000,
        somatic=[Variant(pos0=3000, ref=ref[3000], alt=alt, vaf=0.4)],
        germline=[Variant(pos0=1200, ref=ref[1200:1206], alt=ref[1200],
                          vaf=0.5)],
        normal_cov=35, tumor_cov=50, seed=9)
    return tmp, fx


class _PortJob:
    """The _RUN_PORT job, started in a subprocess when the module's first
    test asks for it (the parity test, whose JAX run it overlaps) and read
    once it ends."""

    def __init__(self, tmp, fx):
        self.tmp = tmp
        argv = ["pipeline", "-n", fx["normal"], "-t", fx["tumor"],
                "-r", fx["fasta"], "-T", "2", "--device", "cpu"]
        # two intra-op threads: the plain DP needs no more, and the test
        # shares the host's cores with the other test workers
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _RUN_PORT, json.dumps(argv),
             str(tmp / "port.vcf.gz"), str(tmp / "traced.vcf.gz"),
             str(tmp / "port.json")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(tmp))
        self._out = None

    def get(self) -> dict:
        if self._out is None:
            try:
                _stdout, stderr = self.proc.communicate(timeout=600)
            finally:
                if self.proc.poll() is None:
                    self.proc.kill()
                    self.proc.communicate()
            assert self.proc.returncode == 0, stderr[-3000:]
            with open(self.tmp / "port.json") as fh:
                self._out = json.load(fh)
        return self._out


@pytest.fixture(scope="module")
def traced(fixture):
    job = _PortJob(*fixture)
    yield job
    if job.proc.poll() is None:
        job.proc.kill()
        job.proc.communicate()


def _records(path) -> list[str]:
    with gzip.open(path, "rt") as fh:
        return [l for l in fh.read().splitlines() if l and not l.startswith("#")]


def test_port_pipeline_matches_jax_batch_executor(fixture, traced):
    tmp, fx = fixture
    common = ["pipeline", "-n", fx["normal"], "-t", fx["tumor"],
              "-r", fx["fasta"], "-T", "2"]
    port_vcf = str(tmp / "port.vcf.gz")
    # the port runs in the fixture's subprocess while the JAX reference
    # runs here
    jax_vcf = str(tmp / "jax.vcf.gz")
    assert jax_cli_main(common + ["-o", jax_vcf, "--executor", "batch"]) == 0
    out = traced.get()
    assert (out["exit"], out["loaded"]) == (0, [])

    want, got = _records(jax_vcf), _records(port_vcf)
    assert want, "fixture must produce records"
    assert got == want
    called = {(int(r.split("\t")[1]), r.split("\t")[3], r.split("\t")[4])
              for r in got}
    for v in fx["somatic"] + fx["germline"]:
        assert (v.pos0 + 1, v.ref, v.alt) in called, v


def test_traced_job_writes_the_untraced_records(fixture, traced):
    tmp, _fx = fixture
    traced.get()
    want = _records(tmp / "port.vcf.gz")
    assert want and _records(tmp / "traced.vcf.gz") == want


def test_traced_job_keeps_events_only_under_the_profiler(traced):
    out = traced.get()
    plain, tr = out["plain"]["trace"], out["traced"]["trace"]
    assert "events" not in plain and tr["events"]
    assert set(plain["spans"]) == set(tr["spans"])
    assert plain["counters"] == tr["counters"]
    assert tr["counters"]["prep.workers"] == 2
    assert out["traced"]["pass2"] == {"total": tr["counters"]["phase_b.pairs"],
                                      "pass2": tr["counters"]["phase_b.pass2_pairs"]}


def test_traced_job_decodes_every_record_natively(fixture, traced):
    _tmp, fx = fixture
    counters = traced.get()["traced"]["trace"]["counters"]
    n_records = sum(len(BamReader(fx[s], use_native=False).all_records())
                    for s in ("tumor", "normal"))
    assert counters["prep.records_native"] == n_records
    assert counters["prep.records_python"] == 0


def test_traced_job_decode_and_windows_arrive_from_the_prep_processes(traced):
    tr = traced.get()["traced"]["trace"]
    main_pid = tr["main"][0]
    decode = [e for e in tr["events"] if e[NAME] == "prep.decode"]
    windows = [e for e in tr["events"] if e[NAME] == "prep.window"]
    assert len(decode) == 1 and decode[0][PID] != main_pid
    workers = {e[PID] for e in windows}
    # every worker prepared windows; none is the executor or the coordinator
    assert len(workers) == tr["counters"]["prep.workers"]
    assert not workers & {main_pid, decode[0][PID]}
    assert len(windows) == tr["spans"]["prep.window"]["count"] == 7
    assert sorted(e[REQUEST] for e in windows) == list(range(7))
    stages = [e for e in tr["events"] if e[PARENT] == "prep.window"]
    assert {e[NAME] for e in stages} >= {"gate", "collect", "assemble",
                                         "build_pairs"}


def test_traced_job_main_thread_spans_cover_its_wall(traced):
    out = traced.get()
    tr = out["traced"]["trace"]
    t0, t1 = out["wall"]
    mine = sorted((e[T0], e[T1]) for e in tr["events"]
                  if [e[PID], e[TID]] == list(tr["main"]))
    covered, cur = 0, t0
    for s, e in mine:  # the main thread's spans do not nest
        assert s >= cur - 1, "main-thread spans overlap"
        covered += e - s
        cur = e
    assert covered >= 0.95 * (t1 - t0), covered / (t1 - t0)


def test_traced_job_wall_profile_is_its_spans(traced):
    out = traced.get()
    for run in ("plain", "traced"):
        spans = out[run]["trace"]["spans"]
        wall = out[run]["wall_profile"]
        for phase, prefix in (("prep_wait", "prep.wait"),
                              ("device", "phase_b."),
                              ("phase_c", "phase_c."), ("flush", "output.")):
            secs = sum(v["seconds"] for k, v in spans.items()
                       if k.startswith(prefix))
            assert wall[phase]["seconds"] == pytest.approx(secs, abs=1e-3)
        assert set(wall) == {"prep_wait", "device", "phase_c", "flush",
                             "other"}


def test_traced_job_spans_on_the_profilers_clock(traced):
    out = traced.get()
    tr = out["traced"]["trace"]
    ranges: dict = {}
    for name, s, e in out["ranges"]:
        ranges.setdefault(name, []).append((s, e))
    mine: dict = {}
    for e in tr["events"]:
        if [e[PID], e[TID]] == list(tr["main"]):
            mine.setdefault(e[NAME], []).append((e[T0], e[T1]))
    assert set(ranges) == set(mine)
    for name, spans in mine.items():
        assert len(spans) == len(ranges[name]), name
        for (a, b), (s, e) in zip(sorted(spans), sorted(ranges[name])):
            assert abs(a - s) < 200_000 and abs(b - e) < 200_000, (
                name, a - s, b - e)


def test_cli_rejects_unsupported_options(fixture):
    from lancet2_tpu_torch.cli.main import graph_build_device

    tmp, fx = fixture
    base = ["pipeline", "-n", fx["normal"], "-r", fx["fasta"],
            "-o", str(tmp / "x.vcf.gz"), "--device", "cpu"]
    # --graph-backend device is supported: it builds on the run's device
    # under the threads executor, and on the CPU under the batch executor,
    # whose forked prep workers must never touch CUDA
    for extra, want in (([], "cpu"), (["--executor", "threads"], "cuda")):
        args = build_parser().parse_args(
            base[:-2] + extra + ["--graph-backend", "device"])
        assert graph_build_device(args) == want
    with pytest.raises(SystemExit):  # argparse: tpu is not a port device
        build_parser().parse_args(base + ["--device", "tpu"])
    args = build_parser().parse_args(base[:-2])
    assert (args.device, args.executor, args.aligner_backend) == (
        "cuda", "batch", "evidence")


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_device(torch.device("cuda"))
    assert check_device(torch.device("cpu")) == torch.device("cpu")


def test_threads_executor_cuda_without_a_card_raises(fixture):
    from lancet2_tpu_torch.cli.main import run_pipeline

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmp, fx = fixture
    for backend in ("evidence", "jax"):
        args = build_parser().parse_args(
            ["pipeline", "-n", fx["normal"], "-r", fx["fasta"],
             "-o", str(tmp / "t.vcf.gz"), "--executor", "threads",
             "--aligner-backend", backend, "--device", "cuda"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_pipeline(args, "test")


def test_port_modules_import_without_jax():
    """Every module of the port imports without jax and without the JAX
    package; the CLI and the prep module import without torch (the spawned
    prep coordinator re-imports the CLI); and importing them all starts no
    CUDA context (the coordinator forks its workers)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lancet2_tpu_torch.cli.main, lancet2_tpu_torch.core.prep_worker\n"
        "assert 'torch' not in sys.modules, 'cli/prep import torch eagerly'\n"
        "import lancet2_tpu_torch\n"
        "walked = set()\n"
        "for m in pkgutil.walk_packages(lancet2_tpu_torch.__path__,\n"
        "                               'lancet2_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    walked.add(m.name)\n"
        f"missing = set({NEW_MODULES!r}) - walked\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'lancet2_tpu')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_port_sources_import_no_jax():
    """Static check: no module of the port, not chip_smoke.py and not the
    port's test helpers (tests/torch_*.py, which run the port's side of its
    tests and of chip_smoke.py) import jax or the JAX package
    (lancet2_tpu_torch itself aside)."""
    import ast
    import pathlib

    files = sorted(pathlib.Path(ROOT, "lancet2_tpu_torch").rglob("*.py"))
    files.append(pathlib.Path(ROOT, "chip_smoke.py"))
    helpers = sorted(pathlib.Path(ROOT, "tests").glob("torch_*.py"))
    assert {p.name for p in helpers} >= {"torch_options_jobs.py",
                                         "torch_cloud_jobs.py"}
    files += helpers
    rel = {str(p.relative_to(ROOT)) for p in files}
    for name in NEW_MODULES:
        assert name.replace(".", "/") + ".py" in rel, name
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if not node.level else []
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in ("jax", "lancet2_tpu")]
    assert len(files) > 60 and not bad, bad
