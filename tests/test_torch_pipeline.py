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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# modules of the multi-device path and the device graph build, held by the
# import checks below by name
NEW_MODULES = ("lancet2_tpu_torch.parallel.mesh",
               "lancet2_tpu_torch.parallel.evidence_spmd",
               "lancet2_tpu_torch.ops.graph_tpu",
               "lancet2_tpu_torch.ops.graph_tape",
               "lancet2_tpu_torch.ops.lgamma_f32",
               "lancet2_tpu_torch.graft_entry")

_RUN_PORT = """
import json, runpy, sys
sys.argv = ["lancet2_tpu_torch"] + json.loads(sys.argv[1])
try:
    runpy.run_module("lancet2_tpu_torch", run_name="__main__")
except SystemExit as exc:
    code = exc.code
print(json.dumps({"exit": code, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "lancet2_tpu"))}))
"""


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


def _records(path) -> list[str]:
    with gzip.open(path, "rt") as fh:
        return [l for l in fh.read().splitlines() if l and not l.startswith("#")]


def test_port_pipeline_matches_jax_batch_executor(fixture):
    tmp, fx = fixture
    common = ["pipeline", "-n", fx["normal"], "-t", fx["tumor"],
              "-r", fx["fasta"], "-T", "2"]
    port_vcf = str(tmp / "port.vcf.gz")
    # the port runs in a subprocess while the JAX reference runs here; two
    # intra-op threads: the plain DP needs no more, and the test shares the
    # host's cores with the other test workers
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-c", _RUN_PORT,
         json.dumps(common + ["-o", port_vcf, "--device", "cpu"])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp))
    try:
        jax_vcf = str(tmp / "jax.vcf.gz")
        assert jax_cli_main(common + ["-o", jax_vcf, "--executor", "batch"]) == 0
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    status = json.loads(stdout.strip().splitlines()[-1])
    assert status == {"exit": 0, "loaded": []}, stderr[-3000:]

    want, got = _records(jax_vcf), _records(port_vcf)
    assert want, "fixture must produce records"
    assert got == want
    called = {(int(r.split("\t")[1]), r.split("\t")[3], r.split("\t")[4])
              for r in got}
    for v in fx["somatic"] + fx["germline"]:
        assert (v.pos0 + 1, v.ref, v.alt) in called, v


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
