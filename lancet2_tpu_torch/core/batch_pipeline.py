"""Batch executor on a list of torch devices: parallel phase-A prep + fused
cross-window evidence DP.

The JAX package's `core/batch_pipeline.py` with its JAX-only branches deleted:
an explicit `torch.device` and the port's `TorchGenotyper`. `devices`, as in
the JAX package, lists the devices phase B and the device PLs run on: None
means every visible CUDA device when `device` is a CUDA device (one on a
one-card host, where the run is the one-device run), else `[device]`. With
more than one entry the executor builds a mesh (parallel/mesh.py; the same
card may repeat, each entry on its own stream), passes it to the genotyper,
whose pass 1 and pass 2 are then sharded over it, and splits phase C's PL
rows over it; records are those of the one-device run.

  phase A  prep coordinator and fork workers (core/prep_worker.py), or with
           prep_mode 'threads' (also 'auto' on a host without fork) the
           same prepare+pack function in threads of this process; both run
           the CPU layout on every device (max_regions = R_MAX, lt buckets
           _TARGET_BUCKETS, lq buckets _QUERY_BUCKETS), so payloads equal the
           JAX batch executor's on the CPU
  phase B  per window batch: pools uploaded, pass-1 span launched (async);
           the previous batch's pass 2 and phase C run while it executes
  phase C  evidence assembly, VariantCall with float64 DM PLs (on a CUDA
           device or over the mesh through ops/genotype.py, else on the
           host), ordered VCF flush

No CUDA call happens before the prep workers start: the coordinator is
spawned, and it forks the workers; the devices are resolved after that.
Prep threads fork nothing and never touch the device.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import traceback
from collections import deque

import numpy as np
import torch

from lancet2_tpu_torch.caller.genotyper import (
    _QUERY_BUCKETS,
    _TARGET_BUCKETS,
    TorchGenotyper,
)
from lancet2_tpu_torch.caller.variant_call import VariantCall
from lancet2_tpu_torch.core.prep_worker import (
    PackedWindow,
    coordinator_main,
    log_decode_route,
    map_pair_arrays,
    prepare_and_pack,
    unlink_segment,
)
from lancet2_tpu_torch.core.variant_builder import (
    BuilderParams,
    StatusCode,
    VariantBuilder,
)
from lancet2_tpu_torch.core.variant_store import VariantStore
from lancet2_tpu_torch.hts.uri import scheme_served_here
from lancet2_tpu_torch.ops.evidence_layout import R_MAX
from lancet2_tpu_torch.ops.genotype import batched_genotype_pls_exact
from lancet2_tpu_torch.utils.logging import get_logger
from lancet2_tpu_torch.utils.profiling import StageTimer, profiler_on

LOG = get_logger("batch_pipeline")

DEFAULT_WINDOW_BATCH = 64
LOOKAHEAD = 3  # window batches queued to the prep workers
# wall_profile's phases: the spans whose names start with these
WALL_PHASES = {"prep_wait": "prep.wait", "device": "phase_b.",
               "phase_c": "phase_c.", "flush": "output."}


def resolve_devices(device, devices=None) -> list[torch.device]:
    """The run's device list: `devices` checked entry by entry, or with
    None every visible CUDA device (for a CUDA `device`) or `[device]`."""
    if devices is None:
        device = check_device(device)
        if device.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [device]
    devices = [check_device(d) for d in devices]
    if not devices:
        raise ValueError("devices: an empty list")
    return devices


def check_device(device: torch.device) -> torch.device:
    """Resolve the run's device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


class TorchBatchPipelineExecutor:
    def __init__(
        self,
        params: BuilderParams,
        ref,
        samples,
        windows,
        *,
        device: torch.device,
        num_workers: int = 2,
        window_batch: int = DEFAULT_WINDOW_BATCH,
        pair_chunk: int = 2048,
        checkpoint=None,
        min_emit_pos=None,
        band_margin: int | None = 96,
        total_hint: int | None = None,
        prep_mode: str = "auto",
        devices: list | None = None,
        timer: StageTimer | None = None,
    ):
        self.device = torch.device(device)
        self.devices = devices
        self._mesh = None
        self.genotyper: TorchGenotyper | None = None
        self.params = params
        self.ref = ref
        self.samples = samples
        self.streaming = not isinstance(windows, (list, tuple))
        self.windows = windows if not self.streaming else None
        self._window_iter = iter(windows) if self.streaming else None
        self.total_hint = total_hint if total_hint is not None else (
            len(windows) if not self.streaming else None
        )
        self.num_workers = max(1, num_workers)
        self.window_batch = window_batch
        self.pair_chunk = pair_chunk
        self.checkpoint = checkpoint
        self.band_margin = band_margin
        self.store = VariantStore(
            windows if not self.streaming else [], min_emit_pos=min_emit_pos
        )
        self.status_counts: dict[StatusCode, int] = {}
        # the run's spans and counters (utils/profiling.py), with events
        # when the run starts under torch.profiler
        self.timer = timer if timer is not None else StageTimer(
            record=profiler_on())
        # prep backend: 'processes' (fork, default on posix), 'threads'
        self.prep_mode = prep_mode
        self._reader_pool: dict = {}
        self._procs: list = []
        self._threads: list = []
        self._work_q = None
        self._result_q = None
        # results land here via a dedicated drain thread: worker->parent
        # payloads are ~MB-scale and the mp.Queue pipe holds only ~64 KB,
        # so if the parent read results only while waiting, workers would
        # block on the pipe during the parent's whole device phase and
        # prep/device overlap would collapse (measured: zero overlap at
        # chr scale before the drain thread)
        self._results: dict[int, PackedWindow] = {}
        self._results_cv = threading.Condition()
        self._drain_thread = None
        self._drain_error = None
        self._coordinator_traces: list[dict] = []

    # ------------------------------------------------------------------
    # phase A: one spawned coordinator that forks the prep workers, or
    # threads of this process
    # ------------------------------------------------------------------
    def _use_processes(self) -> bool:
        """Fork prep workers from a spawned coordinator, or prep in threads.
        Inputs over a transport registered in this process (s3://, gs://:
        hts/uri.py's registry is process memory) open only here, so `auto`
        takes threads for them and `processes` refuses them before
        spawning."""
        if self.prep_mode == "threads":
            return False
        paths = [s.path for s in self.samples] + [self.ref.path]
        local = sorted({scheme_served_here(p) for p in paths if p} - {None})
        if local and self.prep_mode == "processes":
            raise ValueError(
                f"--prep-mode processes: the {', '.join(local)}:// inputs "
                "are served by a transport registered in this process, "
                "which a spawned prep coordinator does not have; use "
                "--prep-mode threads")
        if local:
            LOG.info("prep: threads, not processes: the %s:// inputs are "
                     "served by a transport registered in this process, "
                     "which a spawned prep coordinator would not have",
                     ", ".join(local))
            return False
        if self.prep_mode == "processes":
            return True
        return hasattr(os, "fork") and os.name == "posix"

    def _start_prep_workers(self, max_regions, lq_buckets, lt_buckets):
        import multiprocessing as mp

        n = max(1, min(self.num_workers, os.cpu_count() or self.num_workers))
        self._n_prep_workers = n
        self.timer.count("prep.workers", n)
        if not self._use_processes():
            self._start_prep_threads(n, max_regions, lq_buckets, lt_buckets)
            return
        # SPAWN one clean coordinator (this process will hold the CUDA
        # context, which a forked child cannot use); the coordinator decodes
        # inputs once, then forks the N workers, which inherit the pools
        # copy-on-write and talk to us through these spawn-context queues.
        with self.timer.stage("prep.spawn"):
            ctx = mp.get_context("spawn")
            self._work_q = ctx.Queue()
            self._result_q = ctx.Queue()
            p = ctx.Process(
                target=coordinator_main,
                args=(self._work_q, self._result_q, self.params,
                      self.ref.path, self.samples, self.band_margin,
                      max_regions, lt_buckets, lq_buckets, n,
                      self.timer.events is not None),
                daemon=False,  # daemons may not fork the workers
            )
            p.start()
            self._procs.append(p)
            self._start_drain_thread()
        LOG.info("prep: spawned coordinator + %d fork worker(s)", n)

    def _start_prep_threads(self, n, max_regions, lq_buckets, lt_buckets):
        """The threads fallback: same protocol, same packed payloads. The
        inputs are decoded and indexed, and the native assembly core built,
        once before the threads start, as the coordinator does before it
        forks (the JAX package's threads each decode every input while the
        pool is still empty)."""
        import copy

        from lancet2_tpu_torch.base import native_core
        from lancet2_tpu_torch.caller.genotyper import Genotyper
        from lancet2_tpu_torch.core.prep_worker import warm_readers

        with self.timer.stage("prep.decode"):
            warm_readers(self.samples, self.params, self._reader_pool,
                         need_event_index=not self.params.skip_active_region,
                         timer=self.timer)
            native_core.available()
        self._work_q = queue.Queue()
        self._result_q = queue.Queue()
        record = self.timer.events is not None

        def thread_main():
            # a failure is reported, never left to end the thread unheard:
            # the setup's as a fatal, a window's as that window's error
            # (BaseException: hts_open raises SystemExit)
            try:
                samples = [copy.copy(s) for s in self.samples]
                builder = VariantBuilder(self.params, self.ref, samples,
                                         reader_pool=self._reader_pool)
                genotyper = Genotyper(backend="evidence")
            except BaseException as exc:
                self._result_q.put(
                    (-1, "fatal", (repr(exc), traceback.format_exc())))
                return
            while True:
                item = self._work_q.get()
                if item is None:
                    return
                seq, window = item
                try:
                    payload = prepare_and_pack(
                        builder, genotyper, window, self.band_margin,
                        max_regions, lt_buckets, lq_buckets, record=record,
                    )
                    self._result_q.put((seq, "ok", payload))
                except BaseException as exc:
                    self._result_q.put(
                        (seq, "error", (repr(exc), traceback.format_exc()))
                    )

        for _ in range(n):
            t = threading.Thread(target=thread_main, daemon=True)
            t.start()
            self._threads.append(t)
        self._start_drain_thread()
        LOG.info("prep: %d worker thread(s)", n)

    def _stop_prep_workers(self):
        if self._work_q is None:
            return
        # one sentinel per worker (the coordinator exits when its forked
        # workers do; threads consume their own)
        for _ in range(max(len(self._threads),
                           getattr(self, "_n_prep_workers", 1))):
            self._work_q.put(None)
        for t in self._threads:
            t.join(timeout=30)
        spawned = bool(self._procs)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        self._procs = []
        self._threads = []
        if self._drain_thread is not None:
            self._result_q.put(self._DRAIN_STOP)
            self._drain_thread.join(timeout=30)
            self._drain_thread = None
        if spawned and not self._coordinator_traces:
            # the coordinator sends it before it forks the workers, and
            # flushes its queue before it exits
            LOG.warning("prep: the coordinator's trace never arrived; this "
                        "run's spans lack prep.decode")
        # error/abort paths can leave unconsumed shm payloads (workers
        # unregister from their resource tracker — the executor owns the
        # unlink); reclaim anything still parked in the results dict
        for payload in self._results.values():
            pairs = getattr(payload, "pairs", None)
            if pairs and "shm" in pairs:
                unlink_segment(pairs["shm"])
        self._results.clear()

    _DRAIN_STOP = ("__drain_stop__", None, None)

    def _start_drain_thread(self):
        def drain():
            while True:
                item = self._result_q.get()
                if item[0] == "__drain_stop__":
                    return
                seq, kind, payload = item
                with self._results_cv:
                    if kind == "trace":  # the coordinator's prep.decode
                        self._coordinator_traces.append(payload)
                    elif kind in ("error", "fatal"):
                        # the first report names the cause; a coordinator's
                        # note that the reporting worker then exited follows
                        if self._drain_error is None:
                            self._drain_error = payload
                    else:
                        self._results[seq] = payload
                    self._results_cv.notify_all()

        self._drain_thread = threading.Thread(target=drain, daemon=True)
        self._drain_thread.start()

    def _wait_for(self, seqs: list[int]) -> list[PackedWindow]:
        """Block until every seq in `seqs` has a payload; returns in order.

        Fail-fast: raises on (a) a worker-reported error, (b) a coordinator
        fatal (e.g. a killed worker, with the window seq it was processing),
        or (c) silent coordinator death — never hangs on lost work."""
        with self._results_cv:
            while True:
                if self._drain_error is not None:
                    msg, tb = self._drain_error
                    raise RuntimeError(f"prepare failed: {msg}\n{tb}")
                if all(s in self._results for s in seqs):
                    return [self._results.pop(s) for s in seqs]
                self._results_cv.wait(timeout=1.0)
                workers = self._procs or self._threads
                if workers and not any(w.is_alive() for w in workers):
                    # give the drain thread one beat to surface a queued
                    # fatal before declaring silent death
                    self._results_cv.wait(timeout=1.0)
                    if self._drain_error is not None:
                        continue
                    if all(s in self._results for s in seqs):
                        continue
                    missing = [s for s in seqs if s not in self._results]
                    who = ("prep coordinator" if self._procs
                           else "prep threads")
                    raise RuntimeError(
                        f"{who} died without reporting; "
                        f"windows (seq) never prepared: {missing[:8]}"
                    )

    def _batches(self):
        """Yield window batches from the list or the streaming iterator."""
        if self.streaming:
            batch: list = []
            for w in self._window_iter:
                batch.append(w)
                if len(batch) >= self.window_batch:
                    yield batch
                    batch = []
            if batch:
                yield batch
        else:
            for lo in range(0, len(self.windows), self.window_batch):
                yield self.windows[lo : lo + self.window_batch]


    # ------------------------------------------------------------------
    def _device_pl_tables(self, pending_rows) -> dict:
        """Batched DM PLs on the CUDA device for every (call, sample) of a
        window batch, grouped by allele count K, in float64: bit-equal to
        the host engine (caller/likelihood.compute_genotype_pls); with a
        mesh, the rows split over its entries. Returns
        {row_index: {sample_name: pls}}; empty on one CPU device, where
        VariantCall computes the same PLs per sample on the host."""
        if not pending_rows or (self._mesh is None
                                and self.device.type != "cuda"):
            return {}
        by_k: dict[int, list[tuple[int, str, list[int]]]] = {}
        for row_idx, (_bi, _payload, variant, supports) in enumerate(pending_rows):
            k = len(variant.alts) + 1
            for sample_name, sup in supports.items():
                counts = [sup.total_allele_cov(i) for i in range(k)]
                by_k.setdefault(k, []).append((row_idx, sample_name, counts))

        tables: dict[int, dict[str, object]] = {}
        for k, rows in by_k.items():
            counts = np.array([r[2] for r in rows], np.int64)
            pls = batched_genotype_pls_exact(counts, k, self.device,
                                             mesh=self._mesh)
            for (row_idx, sample_name, _c), pl_row in zip(rows, pls):
                tables.setdefault(row_idx, {})[sample_name] = pl_row
        return tables

    # ------------------------------------------------------------------
    def execute(self, out) -> dict:
        if not self.streaming and len(self.windows) == 0:
            return {"windows": 0, "flushed": 0}
        t_start = time.monotonic()
        timer = self.timer
        self._start_prep_workers(R_MAX, _QUERY_BUCKETS, _TARGET_BUCKETS)

        flushed = 0
        num_done = 0
        seq_counter = 0

        def enqueue(batch) -> list[int]:
            nonlocal seq_counter
            seqs = []
            for w in batch:
                self._work_q.put((seq_counter, w))
                seqs.append(seq_counter)
                seq_counter += 1
            return seqs

        try:
            with timer.stage("device.setup"):
                devices = resolve_devices(self.device, self.devices)
                self.device = devices[0]
                if len(devices) > 1:
                    from lancet2_tpu_torch.parallel.mesh import make_mesh

                    self._mesh = make_mesh(devices)
                    LOG.info("devices: %s, a mesh of %d entries",
                             ", ".join(map(str, devices)), len(devices))
                genotyper = self.genotyper = TorchGenotyper(
                    self.device, mesh=self._mesh, timer=timer)
            batch_iter = self._batches()
            pending: deque = deque()

            def top_up():
                with timer.stage("prep.enqueue"):
                    while len(pending) < LOOKAHEAD:
                        b = next(batch_iter, None)
                        if b is None:
                            return
                        pending.append((b, enqueue(b)))

            top_up()
            if not pending:
                return {"windows": 0, "flushed": 0}

            def submit_phase_b(payloads):
                """Group windows by padded shape, concatenate their pools with
                index offsets and launch pass 1 for every group."""
                groups: dict[tuple[int, int], list[int]] = {}
                for bi, p in enumerate(payloads):
                    if p.pairs is not None:
                        key = (p.pairs["lq_bucket"], p.pairs["lt_bucket"])
                        groups.setdefault(key, []).append(bi)
                subs = []
                for key in sorted(groups):
                    members = groups[key]
                    with timer.stage("phase_b.pack"):
                        pools, pairs = _pack_group(payloads, members, key[1])
                    st = genotyper.begin_evidence_indexed(
                        pools, pairs, pair_chunk=self.pair_chunk)
                    subs.append((members, st))
                return subs

            def finish_phase_b(payloads, subs):
                outs_by_bi: dict[int, dict] = {}
                for members, st in subs:
                    outs = genotyper.finish_evidence_indexed(st)
                    off = 0
                    for bi in members:
                        n = payloads[bi].pairs["n_pairs"]
                        outs_by_bi[bi] = {k: v[off:off + n]
                                          for k, v in outs.items()}
                        off += n
                return outs_by_bi

            def complete_batch(prev, next_first_window):
                nonlocal flushed, num_done
                batch, payloads, subs, lo = prev
                timer.request = lo
                outs_by_bi = finish_phase_b(payloads, subs)

                pending_rows: list = []
                with timer.stage("phase_c.assemble"):
                    for bi, payload in enumerate(payloads):
                        if payload.components is None:
                            continue
                        wouts = outs_by_bi.get(bi) or {}
                        for comp in payload.components:
                            comp_outs = {
                                k: v[comp.pair_start:comp.pair_stop]
                                for k, v in wouts.items()
                            }
                            geno = genotyper.assemble_evidence_packed(
                                payload.reads, comp.variants, comp, comp_outs)
                            for vi, variant in enumerate(comp.variants):
                                supports = geno.get(vi)
                                if not supports or not any(
                                        s.total_alt_cov() > 0
                                        for s in supports.values()):
                                    continue
                                pending_rows.append(
                                    (bi, payload, variant, supports))

                with timer.stage("phase_c.pls"):
                    pls_tables = self._device_pl_tables(pending_rows)
                per_window_calls: dict[int, list[VariantCall]] = {}
                with timer.stage("phase_c.variant_call"):
                    for row_idx, (bi, payload, variant, supports) in \
                            enumerate(pending_rows):
                        per_window_calls.setdefault(bi, []).append(
                            VariantCall(
                                variant, supports, payload.sample_summaries,
                                payload.window.length,
                                window_index=payload.window.genome_index,
                                pls_lookup=pls_tables.get(row_idx),
                            ))

                with timer.stage("phase_c.store"):
                    for bi, payload in enumerate(payloads):
                        code = payload.status
                        calls = per_window_calls.get(bi, [])
                        if payload.components is not None:
                            code = (StatusCode.FOUND_GENOTYPED_VARIANT if calls
                                    else StatusCode.MISSING_NO_MSA_VARIANTS)
                        self.status_counts[code] = (
                            self.status_counts.get(code, 0) + 1)
                        if calls:
                            self.store.add_variants(calls)
                        num_done += 1

                # windows complete in genomic batch order: everything before
                # the next in-flight batch's first window is final
                if next_first_window is not None:
                    w = next_first_window
                    with timer.stage("output.flush"):
                        flushed += self.store.flush_before_pos(
                            w.chrom_index, w.start1, out)
                    if self.checkpoint is not None:
                        with timer.stage("output.checkpoint"):
                            self.checkpoint.save(w.chrom_index, w.start1,
                                                 num_done)
                rate = num_done / (time.monotonic() - t_start)
                LOG.info("batch %d-%d done (%.2f win/s)",
                         lo, lo + len(batch) - 1, rate)

            # software pipeline: batch N's pass 2 and phase C run while batch
            # N+1's pass-1 launches execute on the device
            prev = None
            while pending:
                batch, cur_seqs = pending.popleft()
                lo = batch[0].genome_index
                timer.request = lo
                top_up()
                with timer.stage("prep.wait"):
                    payloads = self._wait_for(cur_seqs)
                for p in payloads:
                    timer.absorb(p.trace)
                subs = submit_phase_b(payloads)
                if prev is not None:
                    complete_batch(prev, next_first_window=batch[0])
                prev = (batch, payloads, subs, lo)
            if prev is not None:
                complete_batch(prev, next_first_window=None)
        finally:
            timer.request = None
            with timer.stage("prep.stop"):
                self._stop_prep_workers()
            for trace in self._coordinator_traces:
                timer.absorb(trace)
            self._coordinator_traces = []
            log_decode_route(timer.counters)

        with timer.stage("output.flush"):
            flushed += self.store.flush_all(out)
        runtime = time.monotonic() - t_start
        stage_report = timer.report()
        if stage_report:
            LOG.info("stage profile: %s", ", ".join(
                f"{k}={v['pct']}%" for k, v in stage_report.items()))
        return {
            "windows": num_done,
            "flushed": flushed,
            "runtime_s": runtime,
            "windows_per_s": num_done / runtime if runtime > 0 else 0.0,
            "status_counts": {k.name: v for k, v in self.status_counts.items()},
            "stage_profile": stage_report,
            "wall_profile": wall_profile(timer, runtime),
            "pass2": dict(genotyper.pass2_stats),
            "device": str(self.device),
            "devices": [str(d) for d in (self._mesh.devices if self._mesh
                                         else [self.device])],
        }


def _pack_group(payloads, members, lt_bucket):
    """One shape group's pools concatenated, with its pairs' read and
    haplotype indices offset into them; the members' shm segments are
    closed once copied."""
    pool_parts = {k: [] for k in (
        "reads_q", "reads_qu", "read_lens", "haps")}
    ix_parts = {k: [] for k in (
        "read_ix", "hap_ix", "band_start", "tlens")}
    regs, closers = [], []
    r_off = h_off = 0
    hap_w = max(payloads[bi].pairs["hap_w"] for bi in members)
    for bi in members:
        arrays, closer = map_pair_arrays(payloads[bi].pairs)
        closers.append(closer)
        for k in ("reads_q", "reads_qu", "read_lens"):
            pool_parts[k].append(arrays[k])
        h = arrays["haps"]
        if h.shape[1] < hap_w:
            h = np.pad(h, ((0, 0), (0, hap_w - h.shape[1])),
                       constant_values=5)
        pool_parts["haps"].append(h)
        ix_parts["read_ix"].append(arrays["read_ix"] + r_off)
        ix_parts["hap_ix"].append(arrays["hap_ix"] + h_off)
        ix_parts["band_start"].append(arrays["band_start"])
        ix_parts["tlens"].append(arrays["tlens"])
        r_off += payloads[bi].pairs["n_reads"]
        h_off += payloads[bi].pairs["n_haps"]
        regs.append(np.concatenate(
            [c.regions for c in payloads[bi].components]))
    pools = {k: np.concatenate(v) for k, v in pool_parts.items()}
    pairs = {k: np.concatenate(v) for k, v in ix_parts.items()}
    pairs["regions"] = np.concatenate(regs)
    pairs["lt_bucket"] = lt_bucket
    for closer in closers:
        closer()  # shm consumed by the concatenation
    return pools, pairs


def wall_profile(timer: StageTimer, runtime: float) -> dict:
    """The executor's wall by phase (WALL_PHASES: the seconds and counts of
    their spans summed), each in % of `runtime`; `other` is the rest."""
    report = {}
    for phase, prefix in WALL_PHASES.items():
        names = [k for k in timer.totals if k.startswith(prefix)]
        if names:
            secs = sum(timer.totals[k] for k in names)
            report[phase] = {"seconds": round(secs, 3),
                             "count": sum(timer.counts[k] for k in names)}
    other_s = max(runtime - sum(v["seconds"] for v in report.values()), 0.0)
    report["other"] = {"seconds": round(other_s, 3), "count": 1}
    for v in report.values():
        v["pct"] = round(100.0 * v["seconds"] / runtime, 1) if runtime > 0 \
            else 0.0
    return report
