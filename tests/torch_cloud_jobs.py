"""The port's side of tests/test_torch_cloud.py, test_torch_prep_faults.py
and test_torch_golden.py, and the steps chip_smoke.py's phase 14 shares
with them. Imports nothing of jax or lancet2_tpu.

    python tests/torch_cloud_jobs.py JOBS_JSON

JOBS_JSON is a list of jobs, run in order; each is {"kind": ..., ...}:

  cli   {"argv": [...]}: the port's CLI (torch_options_jobs.run_cli)
  s3    {"argv": [...], "objects": {uri: local path}, "vcf": path}: a
        MemTransport registered for s3:// in this process holds each local
        file under its URI; the CLI runs `argv`, and its output object
        (argv's -o) is written to `vcf`. Returns the run's result with
        "objects", the URIs the transport holds after the run; an exception
        of the run is returned as "error" (its repr)
  http  {"argv": [...], "files": {name: local path}}: a RangeServer on
        loopback serves the files; "{base}" in argv becomes its URL

Prints one JSON line last: {"results": [...], "loaded": [...]}, where
"loaded" lists the modules of jax or lancet2_tpu that were imported (none
may be).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_options_jobs import run_cli  # noqa: E402

# the log line of TorchBatchPipelineExecutor._use_processes when inputs over
# a transport registered in this process send `auto` to prep threads
THREADS_FOR_LOCAL_TRANSPORT = "prep: threads, not processes: the s3://"


class RangeServer:
    """A stdlib ThreadingHTTPServer on loopback serving `blobs` (name ->
    bytes) at /name, with HEAD and single-range GETs, as an object store
    or a web server does. Use as a context manager; `base` is its URL."""

    def __init__(self, blobs: dict[str, bytes]):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _blob(self):
                data = blobs.get(self.path.lstrip("/"))
                if data is None:
                    self.send_error(404)
                return data

            def do_HEAD(self):
                data = self._blob()
                if data is not None:
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(data)))
                    self.send_header("Accept-Ranges", "bytes")
                    self.end_headers()

            def do_GET(self):
                data = self._blob()
                if data is None:
                    return
                rng = self.headers.get("Range")
                if rng and rng.startswith("bytes="):
                    lo, _, hi = rng[6:].partition("-")
                    lo = int(lo)
                    hi = int(hi) if hi else len(data) - 1
                    chunk = data[lo:hi + 1]
                    self.send_response(206)
                    self.send_header(
                        "Content-Range",
                        f"bytes {lo}-{lo + len(chunk) - 1}/{len(data)}")
                else:
                    chunk = data
                    self.send_response(200)
                self.send_header("Content-Length", str(len(chunk)))
                self.end_headers()
                self.wfile.write(chunk)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.base = f"http://127.0.0.1:{self._httpd.server_address[1]}"

    def __enter__(self) -> RangeServer:
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return self

    def __exit__(self, *exc) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def run_s3(argv: list[str], objects: dict[str, str], vcf: str) -> dict:
    from lancet2_tpu_torch.hts import uri

    transport = uri.MemTransport()
    for key, path in objects.items():
        with open(path, "rb") as fh:
            transport.blobs[key] = fh.read()
    uri.register_transport("s3", transport)
    try:
        out = run_cli(argv)
    except Exception as exc:
        return {"error": repr(exc)}
    finally:
        uri.unregister_transport("s3")
    out["objects"] = sorted(transport.blobs)
    key = argv[argv.index("-o") + 1]
    if key in transport.blobs:
        with open(vcf, "wb") as fh:
            fh.write(transport.blobs[key])
    return out


def run_http(argv: list[str], files: dict[str, str]) -> dict:
    blobs = {}
    for name, path in files.items():
        with open(path, "rb") as fh:
            blobs[name] = fh.read()
    with RangeServer(blobs) as server:
        return run_cli([a.replace("{base}", server.base) for a in argv])


CLOUD_SNV = 2000


def cloud_fixture(workdir: str) -> dict:
    """tests/test_cloud_transport.py's fixture with the port's simulator:
    4 kb, a somatic SNV at CLOUD_SNV, 25x/35x, seed 5."""
    from lancet2_tpu_torch.utils.simulate import (
        Variant,
        make_tumor_normal_fixture,
        random_reference,
    )

    ref = random_reference(4000, seed=5)
    alt = "C" if ref[CLOUD_SNV] != "C" else "G"
    return make_tumor_normal_fixture(
        workdir, ref_len=4000,
        somatic=[Variant(pos0=CLOUD_SNV, ref=ref[CLOUD_SNV], alt=alt,
                         vaf=0.4)],
        germline=[], normal_cov=25, tumor_cov=35, seed=5)


# ---------------------------------------------------------------------------
# prep-process faults
# ---------------------------------------------------------------------------

def child_pids(pid: int) -> list[int]:
    """The pids whose parent is `pid`, from every process's /proc/N/stat.
    /proc/PID/task/PID/children is no substitute: on gVisor it also lists
    tasks that are not child processes (five for a coordinator's two
    workers on an H100 host)."""
    kids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        # field 2, the command, is in parentheses and may hold anything
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            kids.append(int(name))
    return sorted(kids)


def listed_children(pid: int) -> list[int] | None:
    """/proc/PID/task/PID/children, or None where the file is missing."""
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as fh:
            return [int(p) for p in fh.read().split()]
    except OSError:
        return None


def shm_segments(coordinator: int) -> set[str] | None:
    """The shared-memory segments in /dev/shm of the run whose prep
    coordinator has pid `coordinator` (core/prep_worker.py names them after
    it), or None where /dev/shm cannot be listed."""
    from lancet2_tpu_torch.core.prep_worker import SHM_PREFIX

    prefix = f"{SHM_PREFIX}{coordinator}_"
    try:
        return {e for e in os.listdir("/dev/shm") if e.startswith(prefix)}
    except OSError:
        return None


def run_with_deadline(ex, deadline_s: float) -> tuple[Exception | None, float]:
    """Run `ex.execute` in a thread; returns what it raised (None if it
    finished) and its seconds. A run still going at the deadline is a hang:
    its prep processes are terminated and AssertionError raised."""
    import io

    err: list = [None]

    def run():
        try:
            ex.execute(io.StringIO())
        except Exception as exc:
            err[0] = exc

    t0 = time.monotonic()
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(deadline_s)
    seconds = time.monotonic() - t0
    if thread.is_alive():
        for p in list(ex._procs):
            p.terminate()
        raise AssertionError(f"the run still went on after {deadline_s} s")
    return err[0], seconds


def run_and_kill(ex, target: str, deadline_s: float = 60.0) -> dict:
    """Run the executor (prep processes) while a thread SIGKILLs one prep
    worker once a payload has arrived ("worker"), the coordinator once it
    is up ("coordinator", before it forks its workers) or the coordinator
    once a payload has arrived ("coordinator mid-batch": its workers are
    orphaned while they hold windows). Returns what the run raised
    ("err"), its seconds, the pid killed, the worker pids found, those that
    /proc/PID/task/PID/children listed (None: the file is missing), and the
    run's /dev/shm segments still there up to 8 s after it ended ("leaked";
    None where /dev/shm cannot be listed)."""
    out = {"killed": None, "coordinator": None, "kids": [], "listed": None}

    def killer():
        stop = time.monotonic() + deadline_s
        while time.monotonic() < stop:
            procs = list(ex._procs)
            if procs and procs[0].is_alive():
                coord = out["coordinator"] = procs[0].pid
                if target == "coordinator":
                    os.kill(coord, signal.SIGKILL)
                    out["killed"] = coord
                    return
                kids = child_pids(coord)
                with ex._results_cv:
                    busy = len(ex._results) > 0
                if kids and busy:
                    out["kids"] = kids
                    out["listed"] = listed_children(coord)
                    out["killed"] = kids[0] if target == "worker" else coord
                    os.kill(out["killed"], signal.SIGKILL)
                    return
            time.sleep(0.02)

    thread = threading.Thread(target=killer, daemon=True)
    thread.start()
    out["err"], out["seconds"] = run_with_deadline(ex, deadline_s)
    thread.join()
    # orphaned workers reclaim their in-flight segment within their
    # watchdog's 2 s beat
    stop = time.monotonic() + 8
    while True:
        leaked = shm_segments(out["coordinator"])
        if not leaked or time.monotonic() > stop:
            break
        time.sleep(0.25)
    out["leaked"] = leaked
    return out


def fault_setup(workdir: str) -> tuple:
    """The JAX package's fault-injection fixture built with the port's
    simulator: 30 kb, a somatic SNV every 2.5 kb, 20x/28x, seed 11.
    Returns (params, ref, samples, windows)."""
    from lancet2_tpu_torch.cbdg.graph import GraphParams
    from lancet2_tpu_torch.core.read_collector import CollectorParams
    from lancet2_tpu_torch.core.sample_info import make_sample_list
    from lancet2_tpu_torch.core.variant_builder import BuilderParams
    from lancet2_tpu_torch.utils.simulate import (
        Variant,
        make_tumor_normal_fixture,
        random_reference,
    )

    ref_seq = random_reference(30000, seed=11)
    somatic = [Variant(pos0=p, ref=ref_seq[p],
                       alt="G" if ref_seq[p] != "G" else "T", vaf=0.4)
               for p in range(2000, 28000, 2500)]
    fx = make_tumor_normal_fixture(workdir, ref_len=30000, somatic=somatic,
                                   normal_cov=20, tumor_cov=28, seed=11)
    samples = make_sample_list([fx["normal"]], [fx["tumor"]], [])
    params = BuilderParams(
        graph=GraphParams(num_samples=len(samples), min_anchor_cov=3),
        collector=CollectorParams(), aligner_backend="evidence")
    ref, windows = whole_reference(fx["fasta"])
    return params, ref, samples, windows


def whole_reference(fasta: str) -> tuple:
    """(Reference, windows over the whole reference, default parameters)."""
    from lancet2_tpu_torch.core.window_builder import WindowBuilder, WindowParams
    from lancet2_tpu_torch.hts.fasta import Reference

    ref = Reference(fasta)
    wb = WindowBuilder(ref, WindowParams())
    wb.add_whole_reference()
    wb.sort_input_regions()
    return ref, list(wb.build_windows())


def make_executor(params, ref, samples, windows, device, **kw):
    """The batch executor as the JAX fault tests build theirs: 2 prep
    processes, 4-window batches, 256-pair chunks."""
    from lancet2_tpu_torch.core.batch_pipeline import TorchBatchPipelineExecutor

    kw.setdefault("num_workers", 2)
    kw.setdefault("window_batch", 4)
    kw.setdefault("pair_chunk", 256)
    kw.setdefault("prep_mode", "processes")
    return TorchBatchPipelineExecutor(params, ref, samples, list(windows),
                                      device=device, **kw)


def setup_failures(params, ref, samples, windows, device) -> dict:
    """Prep processes whose setup fails, each run to its error:
      "coordinator": s3:// inputs forced onto prep processes (past the
        check of TorchBatchPipelineExecutor._use_processes) with no s3
        transport in the spawned coordinator, whose reader warm-up raises
        SystemExit from hts_open;
      "worker": a VariantBuilder setup that raises TypeError in each forked
        worker (gc_fraction None), which the coordinator never reads;
      "thread": the same setup failure in each prep thread
        (prep_mode="threads", which s3:// and gs:// inputs take).
    Returns {case: (what the run raised, seconds)}."""
    import dataclasses

    from lancet2_tpu_torch.core.sample_info import SampleInfo

    s3_samples = [SampleInfo(path="s3://bkt/" + os.path.basename(s.path),
                             sample_name=s.sample_name, tag=s.tag,
                             sample_index=s.sample_index) for s in samples]
    out = {}
    ex = make_executor(params, ref, s3_samples, windows, device)
    ex._use_processes = lambda: True
    out["coordinator"] = run_with_deadline(ex, 60.0)
    for case, mode in (("worker", "processes"), ("thread", "threads")):
        ex = make_executor(dataclasses.replace(params, gc_fraction=None), ref,
                           samples, windows, device, prep_mode=mode)
        out[case] = run_with_deadline(ex, 60.0)
    return out


# ---------------------------------------------------------------------------
# the golden fixture
# ---------------------------------------------------------------------------

GOLDEN_VCF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                          "golden_somatic.vcf")


def golden_fixture(workdir: str) -> tuple[str, str, str]:
    """tests/test_truth_harness.py's golden fixture with the port's
    simulator: 3.6 kb with a 10 bp T homopolymer at 1700, a somatic SNV,
    a homopolymer insertion and a 2 bp deletion, 42x/60x, seeds 61-63.
    Returns (fasta, normal, tumor)."""
    from lancet2_tpu_torch.hts.bam import BamWriter
    from lancet2_tpu_torch.hts.fasta import write_fasta
    from lancet2_tpu_torch.utils.simulate import (
        ReadSimulator,
        Variant,
        structured_reference,
    )

    ref_len, chrom = 3600, "chrS"
    ref_seq = structured_reference(ref_len, [(1700, "homopolymer", "T", 10)],
                                   seed=61)
    fasta = os.path.join(workdir, "ref.fa")
    write_fasta(fasta, {chrom: ref_seq})
    zoo = [
        Variant(900, ref_seq[900], "G" if ref_seq[900] != "G" else "T",
                vaf=0.40),
        Variant(1699, ref_seq[1699], ref_seq[1699] + "T", vaf=0.45),
        Variant(2600, ref_seq[2600:2603], ref_seq[2600], vaf=0.40),
    ]
    paths = []
    for name, variants, cov, seed, prefix in (
            ("normal", [], 42.0, 62, "n"), ("tumor", zoo, 60.0, 63, "t")):
        path = os.path.join(workdir, f"{name}.bam")
        w = BamWriter(path, [(chrom, ref_len)], sample_name=name.upper())
        ReadSimulator(ref_seq, chrom, seed=seed).simulate(
            variants, cov, w, qname_prefix=prefix)
        w.close()
        paths.append(path)
    return fasta, paths[0], paths[1]


def golden_records() -> list[str]:
    with open(GOLDEN_VCF) as fh:
        return fh.read().splitlines()


class PortProcess:
    """This script run on `jobs` in a process of its own, started at once,
    with two intra-op threads; `results()` waits for it (once) and returns
    {name: result}, after asserting that it loaded no module of jax or
    lancet2_tpu."""

    def __init__(self, jobs: list[dict], names: list[str], cwd):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
        self.names = names
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), json.dumps(jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(cwd))
        self._results = None

    def results(self) -> dict:
        if self._results is None:
            stdout, stderr = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, stderr[-4000:]
            out = json.loads(stdout.strip().splitlines()[-1])
            assert out["loaded"] == [], out["loaded"]
            self._results = dict(zip(self.names, out["results"]))
        return self._results

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def main() -> None:
    results = []
    for job in json.loads(sys.argv[1]):
        kind = job["kind"]
        if kind == "cli":
            results.append(run_cli(job["argv"]))
        elif kind == "s3":
            results.append(run_s3(job["argv"], job["objects"], job["vcf"]))
        elif kind == "http":
            results.append(run_http(job["argv"], job["files"]))
        else:
            raise ValueError(f"unknown job kind {kind!r}")
    print(json.dumps({"results": results, "loaded": sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "lancet2_tpu"))}))


if __name__ == "__main__":
    main()
