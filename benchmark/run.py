"""Benchmark of the PyTorch/CUDA port: one run is one whole calling job
through the port's CLI entry on the default batch path.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of BENCHMARK.json's `workloads`) names a configuration
(`benchmark/configs/<name>.json`: the deployment, its samples, read model
and planted variants) and a traffic mix (`benchmark/traffic/<name>.json`:
settings laid over the configuration, depths by sample role, further
pipeline arguments and how the inputs are served);
`benchmark/cells/<cell>.json` holds the job's size (`sizing_windows_per_s`
x `--seconds` windows) and the limits of the correctness check. Set-up
makes the inputs from the seed (cached under `benchmark/.cache/<cell>/<seed>`;
other seeds' files are deleted), loads the port and runs one warm job on a
tiny fixture. The measured window is one call of `run_pipeline` from its
start to its return with the VCF closed. With `--trace 1` the job runs
under torch.profiler, with the program's calls wrapped in named ranges from
this harness, and the per-layer metrics (`benchmark/metrics/<name>.py`, one
reader each) are reported instead of the end-to-end ones.

Once the window has closed and the device's peak memory has been read, the
plain reference (`benchmark/reference.py`) judges the job's VCF. The last
line of standard output is one JSON object; the numbers compared, each
beside its limit, are the last lines of standard error.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = {"jax", "jaxlib", "flax", "lancet2_tpu"}
# CLI flags of the configuration's `cli` settings
CLI_FLAGS = {"window": "-w", "overlap_pct": "-p", "padding": "-P",
             "min_kmer": "-k", "max_kmer": "-K", "kmer_step": "--kmer-step",
             "min_anchor_cov": "--min-anchor-cov",
             "min_node_cov": "--min-node-cov",
             "max_sample_cov": "--max-sample-cov"}
ROLE_FLAGS = {"normal": "-n", "tumor": "-t"}
# how a traffic mix serves the job's reads: the BAMs as written, CRAM 3.0
# made from them by the port's own converter, or the BAMs from memory
# through an s3 transport registered in the job's process
INPUTS = ("bam", "cram", "s3")
TRAFFIC_KEYS = {"config", "depth", "pipeline_args", "inputs"}


def merged(base: dict, over: dict) -> dict:
    """`over` laid on `base`: nested objects key by key, any other value
    replaced whole."""
    out = dict(base)
    for k, v in over.items():
        both = isinstance(v, dict) and isinstance(out.get(k), dict)
        out[k] = merged(out[k], v) if both else v
    return out


def load_cell(name: str, root: str = ROOT, traffic: str | None = None) -> dict:
    """Everything a run of cell `name` needs, found by the names in
    BENCHMARK.json; `traffic` names another mix to run in its place."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    centry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, centry["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(HERE, "cells", name + ".json")) as fh:
        cell = json.load(fh)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {"name": name, "chips": wl["chips"], "cell": cell,
            **apply_traffic(cfg, load_traffic(traffic or wl["traffic"])),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def load_traffic(name: str, where: str = HERE) -> dict:
    with open(os.path.join(where, "traffic", name + ".json")) as fh:
        traffic = json.load(fh)
    unknown = set(traffic) - TRAFFIC_KEYS
    if unknown:
        raise SystemExit(f"traffic {name!r}: unknown keys {sorted(unknown)}")
    if traffic.get("inputs", "bam") not in INPUTS:
        raise SystemExit(f"traffic {name!r}: inputs must be one of {INPUTS}")
    return traffic


def apply_traffic(cfg: dict, traffic: dict) -> dict:
    """The configuration as the traffic runs it: `config` laid over it (the
    generator and the CLI settings read the result), `depth` by sample
    role, `pipeline_args` after the configuration's own, `inputs` one of
    INPUTS."""
    cfg = merged(cfg, traffic.get("config", {}))
    depths = {s["role"]: float(s["depth"]) for s in cfg["samples"]}
    for role, d in traffic.get("depth", {}).items():
        if role not in depths:
            raise SystemExit(f"traffic depth for {role!r}: no such sample")
        depths[role] = float(d)
    return {"cfg": cfg, "traffic": traffic, "depths": depths,
            "inputs": traffic.get("inputs", "bam"),
            "pipeline_args": [str(a) for a in traffic.get("pipeline_args", [])]}


def job_windows(cell: dict, seconds: float) -> int:
    return max(int(round(cell["cell"]["sizing_windows_per_s"] * seconds)), 1)


def prepare_inputs(cell: dict, key: str, n_windows: int, seed: int,
                   threads: int, keep_others: bool = False) -> dict:
    """The job's inputs under benchmark/.cache/<cell>/<key>, made from the
    seed unless they are there already; every other key's files of the
    cell are deleted, the warm fixture's excepted. `inputs` maps each
    sample role to what the job reads, in the traffic's format."""
    from simulate import Planted, make_job_inputs

    base = os.path.join(CACHE, cell["name"])
    d = os.path.join(base, key)
    if not keep_others and os.path.isdir(base):
        for other in os.listdir(base):
            if other not in (key, "warm"):
                shutil.rmtree(os.path.join(base, other), ignore_errors=True)
    meta = os.path.join(d, "inputs.json")
    if os.path.exists(meta):
        with open(meta) as fh:
            fx = json.load(fh)
        if fx["n_windows"] == n_windows and fx["seed"] == seed and \
                fx["format"] == cell["inputs"]:
            fx["truth"] = [Planted(**{**v, "haps": tuple(v["haps"])})
                           for v in fx["truth"]]
            return fx
    shutil.rmtree(d, ignore_errors=True)
    fx = make_job_inputs(d, cell["cfg"], cell["depths"], n_windows, seed,
                         threads)
    fx.update(n_windows=n_windows, seed=seed, dir=d, format=cell["inputs"],
              inputs=dict(fx["bams"]))
    if cell["inputs"] == "cram":
        from lancet2_tpu_torch.cli.main import main as cli_main

        for role, bam in fx["bams"].items():
            fx["inputs"][role] = bam[:-4] + ".cram"
            if cli_main(["cram", bam, "-r", fx["fasta"], "-o",
                         fx["inputs"][role]]) != 0:
                raise SystemExit(f"cram conversion of {bam} failed")
    elif cell["inputs"] == "s3":
        fx["inputs"] = {role: f"s3://bench/{os.path.basename(bam)}"
                        for role, bam in fx["bams"].items()}
    with open(meta + ".tmp", "w") as fh:
        json.dump({**fx, "truth": [v.__dict__ for v in fx["truth"]]}, fh)
    os.replace(meta + ".tmp", meta)
    return fx


def pipeline_argv(cell: dict, fx: dict, out_vcf: str, device: str,
                  threads: int) -> list[str]:
    argv = ["pipeline", "-r", fx["fasta"], "-o", out_vcf, "-T", str(threads),
            "--device", device]
    for k, flag in CLI_FLAGS.items():
        argv += [flag, str(cell["cfg"]["cli"][k])]
    for s in cell["cfg"]["samples"]:
        argv += [ROLE_FLAGS[s["role"]], fx["inputs"][s["role"]]]
    return argv + cell["pipeline_args"]


class Served:
    """For `s3` inputs: the job's BAMs read into an in-memory transport of
    the port's, registered for s3:// while the job runs (set-up reads the
    files; the job reads the transport). Other formats: nothing."""

    def __init__(self, cell: dict, fx: dict):
        self.blobs = {}
        if cell["inputs"] == "s3":
            for role, bam in fx["bams"].items():
                with open(bam, "rb") as fh:
                    self.blobs[fx["inputs"][role]] = fh.read()

    def __enter__(self):
        if self.blobs:
            from lancet2_tpu_torch.hts import uri

            uri.register_transport("s3", uri.MemTransport(self.blobs))
        return self

    def __exit__(self, *exc):
        if self.blobs:
            from lancet2_tpu_torch.hts import uri

            uri.unregister_transport("s3")


class Run:
    """What one job leaves for the metric readers."""

    def __init__(self, stats: dict, windows: int, job_s: float):
        self.stats = stats
        self.windows = windows
        self.job_s = job_s
        self.setup_s = None
        self.trace = None
        self.work = None
        self.clock_hz = None
        self.sms = None


def run_job(cell: dict, fx: dict, out_vcf: str, device: str, threads: int,
            trace: bool = False, served: Served | None = None) -> Run:
    """One call of the port's CLI entry on the job's inputs (`served`: the
    inputs as set-up staged them, else staged here)."""
    from lancet2_tpu_torch.cli.main import build_parser, run_pipeline

    argv = pipeline_argv(cell, fx, out_vcf, device, threads)
    args = build_parser().parse_args(argv)
    cmd = "benchmark " + " ".join(argv)
    if os.path.exists(out_vcf):
        os.remove(out_vcf)
    served = served or Served(cell, fx)
    if not trace:
        with served:
            t0 = time.monotonic()
            stats = run_pipeline(args, cmd)
            job_s = time.monotonic() - t0
        return Run(stats, stats["windows"], job_s)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import devtrace as tr
    from wrap import Wrapped

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with served, Wrapped() as wrapped, \
            profile(activities=acts) as prof:
        with record_function("bench.job"):
            t0 = time.monotonic()
            stats = run_pipeline(args, cmd)
            job_s = time.monotonic() - t0
            if device == "cuda":
                torch.cuda.synchronize()
    run = Run(stats, stats["windows"], job_s)
    run.trace = tr.from_profiler(prof, "bench.job")
    run.work = wrapped.work
    return run


def read_metrics(entries: list, run: Run) -> dict:
    """Each metric's reader, `benchmark/metrics/<name>.py`: read(run) gives
    a number or None (then the metric is left out)."""
    out = {}
    for m in entries:
        path = os.path.join(HERE, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        v = mod.read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(cell: dict, fx: dict, out_vcf: str, windows_done: int) -> dict:
    """The numbers compared, each {value, limit}: planted variants missed,
    extra calls, likelihood fields off their float64 recomputation, windows
    not done."""
    import reference as ref

    with open(fx["fasta"]) as fh:
        seq = "".join(fh.read().split("\n", 1)[1].split())
    _names, records = ref.read_vcf(out_vcf)
    truth = ref.against_truth(records, fx["truth"], cell["cfg"], seq)
    lik = ref.likelihood_mismatches(records, cell["cfg"])
    lim = cell["cell"]["limits"]
    return {
        "windows_missing": {"value": fx["n_windows"] - windows_done,
                            "limit": 0},
        "missed_share": {"value": truth["missed_share"],
                         "limit": lim["missed_share"]},
        "extra_share": {"value": truth["extra_share"],
                        "limit": lim["extra_share"]},
        "likelihood_mismatches": {"value": lik["mismatches"],
                                  "limit": lim["likelihood_mismatches"]},
    }


def verdict(checks: dict) -> bool:
    """`correct`: every number compared at or under its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def card_clock_hz() -> float | None:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=30).stdout
        return float(out.split()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (names compared whole: lancet2_tpu_torch is not lancet2_tpu)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [HERE, ROOT]
    import lancet2_tpu_torch  # noqa: F401  (the system under test; no result without it)

    cell = load_cell(args.workload)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    threads = len(os.sched_getaffinity(0))
    n_windows = job_windows(cell, args.seconds)
    fx = prepare_inputs(cell, str(args.seed), n_windows, args.seed, threads)
    warm = prepare_inputs(cell, "warm", cell["cell"]["warm_windows"], 0,
                          threads, keep_others=True)
    run_job(cell, warm, os.path.join(warm["dir"], "job.vcf.gz"), "cuda",
            threads)
    served = Served(cell, fx)
    torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - T_START

    out_vcf = os.path.join(fx["dir"], "job.vcf.gz")
    run = run_job(cell, fx, out_vcf, "cuda", threads, trace=bool(args.trace),
                  served=served)
    del served
    run.setup_s = setup_s
    print("job: " + json.dumps({
        "windows": run.windows, "job_s": run.job_s, "setup_s": setup_s,
        "wall": {k: v["seconds"] for k, v in
                 run.stats.get("wall_profile", {}).items()}}),
        file=sys.stderr)
    peak = max(torch.cuda.max_memory_allocated(i)
               for i in range(cell["chips"]))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": n_windows,
              "failed": n_windows - run.windows}
    if args.trace:
        import devtrace as tr

        run.clock_hz = card_clock_hz()
        run.sms = torch.cuda.get_device_properties(0).multi_processor_count
        result["metrics"] = read_metrics(cell["per_layer"], run)
        device["busy_s"] = tr.busy_seconds(run.trace)
        device["window_s"] = tr.window_seconds(run.trace)
        result["breakdown"] = {"device_ops": tr.device_ops(run.trace),
                               "idle_gaps": tr.idle_by_host_call(run.trace)}
        from wrap import EVIDENCE_CALLS

        w = run.work
        print("trace: " + json.dumps({
            **tr.attribution(run.trace, EVIDENCE_CALLS),
            "evidence_ops": w.ops, "evidence_bytes": w.bytes,
            "pairs": w.pairs, "kept": w.kept, "pass2": run.stats.get("pass2"),
            "clock_hz": run.clock_hz, "sms": run.sms}), file=sys.stderr)
    else:
        result["metrics"] = read_metrics(cell["end_to_end"], run)
    result["device"] = device
    del run
    torch.cuda.empty_cache()

    checks = judge(cell, fx, out_vcf, n_windows - result["failed"])
    result["correct"] = verdict(checks)
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
