"""Pipeline executor: window scheduling, worker pool, ordered VCF flush.

Reference: src/lancet/core/pipeline_executor.{h,cpp}, async_worker.{h,cpp}.
Windows stream through a work queue to N worker threads (each owning a full
VariantBuilder — no shared mutable state during processing); results update
a done-bitmap and the contiguous-done cursor (minus a 100-window lag) drives
genomically ordered flushing from the sharded store. Any worker exception is
fail-fast with maximal window context (crash-slot model).

The per-worker crash context mirrors the reference's async-signal-safe crash
slots: each worker records the window it is processing so a crash report can
say exactly what every thread was doing.

The JAX package's `core/pipeline.py` on one explicit torch device: every
worker's genotyper runs its engine (the dirs engine for backend 'jax', the
evidence DP for 'evidence') there, one window at a time. A CUDA device
without a card raises at construction. The workers launch on the device's
default stream, each from its own host thread; nothing forks.

One change from the JAX package: the workers share one pool of decoded
readers, decoded and indexed once before they start (as the batch
executor's prep threads share theirs), where each worker of the JAX
package decodes every input itself. Results do not change; the per-worker
decodes held the GIL through most of a short run and kept one copy of the
inputs per worker (PERF.md). Everything the workers share is safe to use
from several threads: the Reference's file handle and the readers' cached
records' tags (hts/fasta.py, hts/bam.py), the store and the probe writer.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field

from lancet2_tpu_torch.core.variant_builder import BuilderParams, StatusCode, VariantBuilder
from lancet2_tpu_torch.core.variant_store import FLUSH_LAG_WINDOWS, VariantStore
from lancet2_tpu_torch.utils.logging import get_logger

LOG = get_logger("pipeline")


@dataclass
class WindowResult:
    window_index: int
    status: StatusCode


class CrashSlots:
    """Per-worker 'currently processing' context (reference: base/crash_handler)."""

    def __init__(self, num_workers: int):
        self.slots: list[str | None] = [None] * num_workers

    def set(self, worker_id: int, context: str | None) -> None:
        self.slots[worker_id] = context

    def report(self) -> str:
        lines = []
        for wid, ctx in enumerate(self.slots):
            lines.append(f"  worker {wid}: {ctx or '<idle>'}")
        return "\n".join(lines)


class PipelineExecutor:
    def __init__(
        self,
        params: BuilderParams,
        ref,
        samples,
        windows,
        num_workers: int = 2,
        probe_tracker_factory=None,
        checkpoint=None,
        min_emit_pos=None,
        total_hint: int | None = None,
        *,
        device,
        timer=None,
    ):
        """windows: a list (monolithic) or any iterable (streaming; WGS-scale
        runs keep O(queue) memory — reference pipeline_executor.cpp:137-150).
        total_hint sizes progress/ETA logs in streaming mode. device: the
        torch device of the genotyper's engines ("cuda" raises without a
        card). timer: the run's recorder (utils/profiling.py), into which
        the workers' stage totals are merged."""
        import dataclasses

        from lancet2_tpu_torch.core.batch_pipeline import check_device

        self.device = check_device(device)
        self.params = dataclasses.replace(params, device=str(self.device))
        self.ref = ref
        self.samples = samples
        self.streaming = not isinstance(windows, (list, tuple))
        self.windows = windows if not self.streaming else None
        self._window_iter = iter(windows) if self.streaming else None
        self.total_hint = total_hint if total_hint is not None else (
            len(windows) if not self.streaming else None
        )
        self.num_workers = max(1, num_workers)
        self.store = VariantStore(
            windows if not self.streaming else [], min_emit_pos=min_emit_pos
        )
        self.checkpoint = checkpoint
        self.status_counts: dict[StatusCode, int] = {}
        self.crash_slots = CrashSlots(self.num_workers)
        self.probe_tracker_factory = probe_tracker_factory
        self.shard_paths: list[str] = []
        self._reader_pool: dict = {}
        self._failure: list = []
        from lancet2_tpu_torch.utils.profiling import StageTimer

        self.stage_timer = timer if timer is not None else StageTimer()

    # ------------------------------------------------------------------
    def execute(self, out) -> dict:
        """Run all windows; write ordered VCF records to `out`."""
        if not self.streaming:
            n = len(self.windows)
            if n == 0:
                return {"windows": 0, "flushed": 0}

        # bounded input queue: in streaming mode the feeder thread keeps at
        # most FEED_DEPTH windows in flight (WGS memory bound); list mode
        # feeds everything upfront through the same path
        FEED_DEPTH = 4096
        in_q: queue.Queue = queue.Queue(maxsize=FEED_DEPTH)
        out_q: queue.Queue = queue.Queue()
        stop = threading.Event()
        feed_done = threading.Event()
        self._num_fed = 0
        self._win_meta: dict[int, tuple[int, int]] = {}  # idx -> (chrom_idx, start1)

        def feeder() -> None:
            try:
                source = self.windows if not self.streaming else self._window_iter
                for w in source:
                    if stop.is_set():
                        break
                    self._win_meta[w.genome_index] = (w.chrom_index, w.start1)
                    self._num_fed += 1
                    while not stop.is_set():
                        try:
                            in_q.put(w, timeout=1.0)
                            break
                        except queue.Full:
                            continue
            finally:
                feed_done.set()
                for _ in range(self.num_workers):  # one sentinel per worker
                    while not stop.is_set():
                        try:
                            in_q.put(None, timeout=1.0)
                            break
                        except queue.Full:
                            continue

        def worker(worker_id: int) -> None:
            # Each worker owns its builder (readers, graph, scorers). Any
            # construction failure must still unblock the main loop.
            import copy

            shard_writer = None
            try:
                samples = [copy.copy(s) for s in self.samples]
                probe = (
                    self.probe_tracker_factory(worker_id)
                    if self.probe_tracker_factory
                    else None
                )
                if self.params.graphs_shards_dir:
                    import os

                    from lancet2_tpu_torch.utils.targz import TarGzWriter

                    shard_path = os.path.join(
                        self.params.graphs_shards_dir, f"worker_{worker_id}.tar.gz"
                    )
                    shard_writer = TarGzWriter(shard_path)
                    self.shard_paths.append(shard_path)
                builder = VariantBuilder(self.params, self.ref, samples,
                                         probe_tracker=probe, shard_writer=shard_writer,
                                         reader_pool=self._reader_pool)
            except Exception as exc:
                LOG.error("worker %d failed during construction: %s", worker_id, exc)
                self._failure.append((None, exc, traceback.format_exc()))
                stop.set()
                out_q.put(None)
                return
            try:
                while not stop.is_set():
                    try:
                        window = in_q.get(timeout=0.5)
                    except queue.Empty:
                        continue
                    if window is None:  # feeder's end-of-stream sentinel
                        return
                    self.crash_slots.set(worker_id, window.to_samtools())
                    try:
                        calls = builder.process_window(window)
                    except Exception as exc:  # fail fast with window context
                        LOG.error(
                            "worker %d failed on window %s: %s\ncrash context:\n%s",
                            worker_id, window.to_samtools(), exc, self.crash_slots.report(),
                        )
                        self._failure.append((window, exc, traceback.format_exc()))
                        stop.set()
                        out_q.put(None)
                        return
                    if calls:
                        self.store.add_variants(calls)
                    out_q.put(WindowResult(window.genome_index,
                                           builder.current_code))
                    self.crash_slots.set(worker_id, None)
            finally:
                self.stage_timer.merge(builder.timer)
                if shard_writer is not None:
                    shard_writer.close()

        # decode and index the inputs, and build (or load) the native
        # assembly core, once, before any worker runs
        from lancet2_tpu_torch.base import native_core
        from lancet2_tpu_torch.core.prep_worker import (
            log_decode_route, warm_readers)

        warm_readers(self.samples, self.params, self._reader_pool,
                     need_event_index=not self.params.skip_active_region,
                     timer=self.stage_timer)
        log_decode_route(self.stage_timer.counters)
        native_core.available()
        feed_thread = threading.Thread(target=feeder, daemon=True)
        feed_thread.start()
        threads = [
            threading.Thread(target=worker, args=(wid,), daemon=True)
            for wid in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        done_set: set[int] = set()
        contiguous_done = -1
        last_flush_target = -1
        num_done = 0
        flushed = 0
        t_start = time.monotonic()
        last_log = t_start
        while True:
            if feed_done.is_set() and num_done >= self._num_fed:
                break
            try:
                result = out_q.get(timeout=10.0)
            except queue.Empty:
                # liveness check: if every worker thread died without posting
                # a failure sentinel, don't wait forever
                if not any(t.is_alive() for t in threads):
                    if feed_done.is_set() and num_done >= self._num_fed:
                        break
                    LOG.error(
                        "all workers exited with %d/%d windows done; crash context:\n%s",
                        num_done, self._num_fed, self.crash_slots.report(),
                    )
                    break
                continue
            if result is None:  # worker failure
                break
            num_done += 1
            done_set.add(result.window_index)
            self.status_counts[result.status] = self.status_counts.get(result.status, 0) + 1
            while contiguous_done + 1 in done_set:
                contiguous_done += 1
                done_set.remove(contiguous_done)
            # ordered flush with lag buffer (overlapping windows may still
            # add variants just behind the cursor)
            target = contiguous_done - FLUSH_LAG_WINDOWS
            if target > last_flush_target:
                chrom_idx, start1 = self._win_meta[target]
                flushed += self.store.flush_before_pos(chrom_idx, start1, out)
                if self.checkpoint is not None:
                    self.checkpoint.save(chrom_idx, start1, num_done)
                # window meta below the cursor is never needed again
                for idx in range(last_flush_target, target):
                    self._win_meta.pop(idx, None)
                last_flush_target = target
            now = time.monotonic()
            if now - last_log > 10.0:
                total = self.total_hint or self._num_fed
                rate = num_done / (now - t_start)
                eta = (total - num_done) / rate if rate > 0 else float("inf")
                LOG.info(
                    "progress %.1f%% (%d/%d windows), %.1f win/s, ETA %.0fs",
                    100.0 * num_done / max(total, 1), num_done, total, rate, eta,
                )
                last_log = now

        stop.set()
        feed_thread.join(timeout=30)
        for t in threads:
            t.join(timeout=30)
        if self._failure:
            window, exc, tb = self._failure[0]
            where = window.to_samtools() if window is not None else "<construction>"
            raise RuntimeError(f"worker failed on window {where}: {exc}\n{tb}")
        flushed += self.store.flush_all(out)
        runtime = time.monotonic() - t_start
        LOG.info(
            "processed %d windows in %.2fs (%.2f win/s), flushed %d records",
            num_done, runtime, num_done / runtime if runtime > 0 else 0.0, flushed,
        )
        stage_report = self.stage_timer.report()
        if stage_report:
            LOG.info("stage profile: %s",
                     ", ".join(f"{k}={v['pct']}%" for k, v in stage_report.items()))
        return {
            "windows": num_done,
            "flushed": flushed,
            "runtime_s": runtime,
            "windows_per_s": num_done / runtime if runtime > 0 else 0.0,
            "status_counts": {k.name: v for k, v in self.status_counts.items()},
            "stage_profile": stage_report,
        }
