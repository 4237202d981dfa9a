"""The port's side of tests/test_torch_options.py, run in one process (and
its checkpoint steps, in chip_smoke.py's phase 13).

    python tests/torch_options_jobs.py JOBS_JSON

JOBS_JSON is a list of jobs, run in order; each is {"kind": ..., ...}:

  cli         {"argv": [...]}: the port's CLI. A `pipeline` command returns
              its window count, run time, status counts and INFO log
              messages; a SystemExit is returned as its message, not raised.
  cram        {"argv": [...]}: the `cram` or `index` subcommand with the
              gzip module's clock held at FROZEN_CLOCK, because a gzip
              member's header holds the time it was written
  checkpoint  {"argv": [...], "window_batch": n, "snapshots": dir,
              "resume_argv": [...]}: the pipeline with --checkpoint, its
              batch executor built with `window_batch` windows per batch; at
              every cursor it saves, the VCF file as it then stands on disk
              is copied into `snapshots` and the cursor file's contents are
              kept. Then `resume_argv` runs (the plain CLI) on a copy of the
              first snapshot, with its cursor file beside it, as a run
              killed after that cursor would leave them
              (`prepare_resume`)
  soak        {"windows": n, "workdir": dir}: the batch executor (prep
              threads) streaming n windows of an all-N contig from
              WindowBuilder.iter_windows; returns the status counts and the
              growth of peak RSS (PeakRss)

Prints one JSON line last: {"results": [...], "loaded": [...]}, where
"loaded" lists the modules of jax or lancet2_tpu that were imported (none
may be).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
import threading
import types

FROZEN_CLOCK = 1_700_000_000.0


class PeakRss:
    """This process's peak resident set from the start of the sampling,
    read from /proc/self/statm every `interval` seconds by a daemon thread.
    getrusage's ru_maxrss is no good here: a process started from a larger
    one reads the parent's peak at the fork until it outgrows it. VmHWM is
    missing from gVisor's /proc."""

    def __init__(self, interval: float = 0.02):
        self._page = os.sysconf("SC_PAGE_SIZE")
        self.start_mb = self.peak_mb = self.rss_mb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample,
                                        args=(interval,), daemon=True)
        self._thread.start()

    def rss_mb(self) -> float:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * self._page / 2**20

    def _sample(self, interval: float) -> None:
        while not self._stop.wait(interval):
            self.peak_mb = max(self.peak_mb, self.rss_mb())

    def stop(self) -> float:
        """Stop sampling; returns the growth of the peak over the start."""
        self._stop.set()
        self._thread.join()
        self.peak_mb = max(self.peak_mb, self.rss_mb())
        return self.peak_mb - self.start_mb


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def run_cli(argv: list[str]) -> dict:
    from lancet2_tpu_torch.cli.main import build_parser, main, run_pipeline

    if argv[0] != "pipeline":
        return {"exit": main(argv)}
    handler = _Messages()
    logger = logging.getLogger("lancet2_tpu_torch")
    logger.addHandler(handler)
    try:
        stats = run_pipeline(build_parser().parse_args(argv),
                             "lancet2-tpu-torch " + " ".join(argv))
    except SystemExit as exc:
        return {"exit": str(exc), "log": handler.messages}
    finally:
        logger.removeHandler(handler)
    return {"exit": 0, "windows": stats["windows"],
            "runtime_s": stats.get("runtime_s"),
            "status_counts": stats.get("status_counts"),
            "log": handler.messages}


def run_cram(argv: list[str]) -> dict:
    import gzip

    clock = gzip.time
    gzip.time = types.SimpleNamespace(time=lambda: FROZEN_CLOCK)
    try:
        return run_cli(argv)
    finally:
        gzip.time = clock


def run_checkpoint(argv: list[str], window_batch: int, snapshots: str,
                   resume_argv: list[str] | None = None, resume_from: int = 0
                   ) -> dict:
    from lancet2_tpu_torch.core import batch_pipeline, checkpoint

    saves: list[dict] = []
    base_file, base_executor = (checkpoint.CheckpointFile,
                                batch_pipeline.TorchBatchPipelineExecutor)

    class Recording(base_file):
        def save(self, cursor_chrom_index, cursor_pos1, done):
            super().save(cursor_chrom_index, cursor_pos1, done)
            snap = os.path.join(snapshots, f"save{len(saves)}.vcf.gz")
            shutil.copyfile(self.path[:-len(".ckpt")], snap)
            saves.append({"cursor": [cursor_chrom_index, cursor_pos1, done],
                          "file": self.load(), "vcf": snap})

    class SmallBatches(base_executor):
        def __init__(self, *args, **kwargs):
            kwargs["window_batch"] = window_batch
            super().__init__(*args, **kwargs)

    os.makedirs(snapshots, exist_ok=True)
    checkpoint.CheckpointFile = Recording
    batch_pipeline.TorchBatchPipelineExecutor = SmallBatches
    try:
        out = run_cli(argv)
    finally:
        checkpoint.CheckpointFile = base_file
        batch_pipeline.TorchBatchPipelineExecutor = base_executor
    out["saves"] = saves
    if resume_argv is not None:
        out["resume"] = run_cli(prepare_resume(saves[resume_from],
                                               resume_argv))
    return out


def prepare_resume(save: dict, resume_argv: list[str]) -> list[str]:
    """Lay out what a run killed after `save` leaves behind, at the output
    path of `resume_argv`: the VCF as it then stood on disk and the cursor
    file beside it. Returns `resume_argv`."""
    resume_vcf = resume_argv[resume_argv.index("-o") + 1]
    shutil.copyfile(save["vcf"], resume_vcf)
    with open(resume_vcf + ".ckpt", "w") as fh:
        json.dump(save["file"], fh)
    return resume_argv


class _ChromInfo:
    def __init__(self, name: str, index: int, length: int):
        self.name, self.index, self.length = name, index, length


class _AllNReference:
    """One all-N contig without a FASTA: every window stops at the all-N
    gate, so the soak exercises the streaming scheduler and flush."""

    path = None

    def __init__(self, length: int):
        self._info = _ChromInfo("chrBig", 0, length)

    def list_chroms(self):
        return [self._info]

    def find_chrom(self, name):
        if name != "chrBig":
            raise KeyError(name)
        return self._info

    def fetch(self, chrom, start1, end1):
        return "N" * (end1 - start1 + 1)


def run_soak(windows: int, workdir: str) -> dict:
    from lancet2_tpu_torch.cbdg.graph import GraphParams
    from lancet2_tpu_torch.core.batch_pipeline import TorchBatchPipelineExecutor
    from lancet2_tpu_torch.core.read_collector import CollectorParams
    from lancet2_tpu_torch.core.sample_info import make_sample_list
    from lancet2_tpu_torch.core.variant_builder import BuilderParams
    from lancet2_tpu_torch.core.window_builder import WindowBuilder, WindowParams
    from lancet2_tpu_torch.hts.bam import BamWriter

    length = 800 * (windows - 1) + 1000  # step 800, window 1000
    bam = os.path.join(workdir, "empty.bam")
    BamWriter(bam, [("chrBig", length)], sample_name="S1").close()
    ref = _AllNReference(length)
    wb = WindowBuilder(ref, WindowParams())
    wb.add_whole_reference()
    wb.sort_input_regions()
    params = BuilderParams(graph=GraphParams(num_samples=1),
                           collector=CollectorParams(),
                           skip_active_region=True, device="cpu")
    rss = PeakRss()
    ex = TorchBatchPipelineExecutor(
        params, ref, make_sample_list([bam], [], []), wb.iter_windows(),
        num_workers=2, total_hint=wb.expected_target_windows(),
        prep_mode="threads", device="cpu")
    streaming = ex.streaming and ex.windows is None
    stats = ex.execute(types.SimpleNamespace(write=lambda _text: None))
    return {"expected": wb.expected_target_windows(), "streaming": streaming,
            "windows": stats["windows"],
            "status_counts": stats["status_counts"],
            "rss_growth_mb": rss.stop(), "rss_before_mb": rss.start_mb}


def main() -> None:
    results = []
    for job in json.loads(sys.argv[1]):
        kind = job["kind"]
        if kind == "cli":
            results.append(run_cli(job["argv"]))
        elif kind == "cram":
            results.append(run_cram(job["argv"]))
        elif kind == "checkpoint":
            results.append(run_checkpoint(job["argv"], job["window_batch"],
                                          job["snapshots"],
                                          job["resume_argv"]))
        elif kind == "soak":
            results.append(run_soak(job["windows"], job["workdir"]))
        else:
            raise ValueError(f"unknown job kind {kind!r}")
    print(json.dumps({"results": results, "loaded": sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "lancet2_tpu"))}))


if __name__ == "__main__":
    main()
