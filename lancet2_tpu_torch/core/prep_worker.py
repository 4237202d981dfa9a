"""Phase-A prep workers for the batch executor: fork processes.

The reference gets linear phase-A scaling from N independent jthread workers
(reference: core/pipeline_executor.cpp:174); CPython threads cannot give that
— the GIL serializes the Python parts of gate/collect/assemble/extract, and
at -T 8 on a 2-core host the measured executor ran at 40% of single-thread
phase-A speed. Process workers restore the reference's scaling model:

  * the parent decodes every input BAM/CRAM into the shared columnar pools
    and builds the active-region event index ONCE, then forks — workers
    inherit the pools copy-on-write (no per-worker decode, no extra RSS)
  * each worker owns a full VariantBuilder (zero shared mutable state,
    mirroring the reference's per-thread builders) and returns a compact
    PACKED payload: device-ready padded pair arrays + per-component variant
    metadata + lightweight read views — numpy buffers, so IPC is a few
    large pickles rather than thousands of small objects
  * workers never touch the device: device handling stays in the executor
    (a CUDA context does not survive a fork)

The JAX package also runs the same prepare+pack function in threads; this
package's executor runs the processes only.
"""

from __future__ import annotations

import os
import traceback
from typing import NamedTuple

import numpy as np

from lancet2_tpu_torch.utils.logging import get_logger
from lancet2_tpu_torch.utils.profiling import StageTimer

LOG = get_logger("prep_worker")


class ReadLite(NamedTuple):
    """The read fields evidence assembly consumes (caller/genotyper.py
    assemble_evidence) — everything else (codes/quals/qname) stays in the
    worker, so a prepared window pickles in ~100 us instead of ~5 ms."""

    length: int
    sample_name: str
    insert_size: int
    start0: int
    qname_hash: int
    mapq: int
    is_soft_clipped: bool
    is_proper_pair: bool
    is_reverse: bool


class ReadCols:
    """Columnar ReadLite: one numpy array per field instead of ~500
    NamedTuples per window. The payload pickles/unpickles in ~10 us and the
    EXECUTOR process — the contended CPU while prep and the device stream
    overlap — no longer deserializes thousands of per-read objects per
    batch. assemble_evidence_packed reads fields either vectorized
    (read_len) or per WINNER row only (a handful per window)."""

    __slots__ = ("length", "start0", "insert_size", "qname_hash", "mapq",
                 "flags", "sample_idx", "sample_names")

    F_SOFT_CLIPPED, F_PROPER_PAIR, F_REVERSE = 1, 2, 4

    def __init__(self, reads):
        n = len(reads)
        self.length = np.empty(n, np.int64)
        self.start0 = np.empty(n, np.int64)
        self.insert_size = np.empty(n, np.int64)
        self.qname_hash = np.empty(n, np.uint64)
        self.mapq = np.empty(n, np.int32)
        self.flags = np.empty(n, np.uint8)
        self.sample_idx = np.empty(n, np.int16)
        names: list[str] = []
        name_of: dict[str, int] = {}
        for i, r in enumerate(reads):
            self.length[i] = r.length
            self.start0[i] = r.start0
            self.insert_size[i] = r.insert_size
            self.qname_hash[i] = r.qname_hash
            self.mapq[i] = r.mapq
            self.flags[i] = (
                (1 if r.is_soft_clipped else 0)
                | (2 if r.is_proper_pair else 0)
                | (4 if r.is_reverse else 0)
            )
            si = name_of.get(r.sample_name)
            if si is None:
                si = name_of[r.sample_name] = len(names)
                names.append(r.sample_name)
            self.sample_idx[i] = si
        self.sample_names = names

    def __len__(self) -> int:
        return len(self.length)


class PackedComponent(NamedTuple):
    variants: list
    anchor_pos1: int
    pair_start: int   # window-local pair index span [start, stop)
    pair_stop: int
    meta_r: np.ndarray      # i32 [n] read index per pair
    meta_h: np.ndarray      # i32 [n] haplotype index per pair
    meta_vis: np.ndarray    # i32 [n] index into vis_table
    regions: np.ndarray     # i32 [n, R_MAX, 2] per-pair region slots
    vis_table: list         # unique vis lists [(vi, allele_idx), ...]


class PackedWindow(NamedTuple):
    window: object
    status: object          # StatusCode
    trace: dict | None      # the window's StageTimer.trace()
    reads: list | None      # list[ReadLite]
    components: list | None  # list[PackedComponent]
    sample_summaries: list | None
    pairs: dict | None      # {qs,qus,qlens,ts,tlens,lq_bucket,lt_bucket}


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


def _pair_array_layout(n: int, lq: int, nr: int, nh: int, lh: int):
    """(offset, shape, dtype) table for one window's INDEXED pair arrays
    packed back-to-back in a shared-memory segment: pools of unique reads
    and haplotypes plus four i32 index columns per pair — ~5x smaller than
    the round-4 expanded [n, Lq]/[n, Lt] layout (each read used to ship
    once per haplotype x region-chunk)."""
    specs = [
        ("reads_q", (nr, lq), np.uint8),
        ("reads_qu", (nr, lq), np.uint8),
        ("read_lens", (nr,), np.int32),
        ("haps", (nh, lh), np.uint8),
        ("hap_lens", (nh,), np.int32),
        ("read_ix", (n,), np.int32),
        ("hap_ix", (n,), np.int32),
        ("band_start", (n,), np.int32),
        ("tlens", (n,), np.int32),
    ]
    out, off = [], 0
    for name, shape, dt in specs:
        size = int(np.prod(shape)) * np.dtype(dt).itemsize
        out.append((name, off, shape, dt))
        off += size
    return out, off


def _alloc_pair_arrays(n: int, lq: int, nr: int, nh: int, lh: int,
                       shm_prefix: str | None):
    """The pair arrays in numpy memory, or with `shm_prefix` in one shared
    memory segment named `shm_prefix` + random hex."""
    layout, total = _pair_array_layout(n, lq, nr, nh, lh)
    if shm_prefix is None:
        arrays = {nm: np.empty(shape, dt)
                  for nm, _off, shape, dt in layout}
        return arrays, None
    import secrets
    from multiprocessing import shared_memory

    while True:
        try:
            shm = shared_memory.SharedMemory(
                name=shm_prefix + secrets.token_hex(4), create=True,
                size=max(total, 1))
            break
        except FileExistsError:
            continue
    try:
        # ownership transfers to the executor (it unlinks after consuming);
        # unregister from THIS process's resource tracker so worker exit
        # doesn't spew "leaked shared_memory" warnings for segments the
        # parent already reclaimed
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass
    arrays = {
        nm: np.ndarray(shape, dt, buffer=shm.buf, offset=off)
        for nm, off, shape, dt in layout
    }
    return arrays, shm


_PAIR_KEYS = ("reads_q", "reads_qu", "read_lens", "haps", "hap_lens",
              "read_ix", "hap_ix", "band_start", "tlens")


def map_pair_arrays(pairs: dict):
    """Parent-side view of one window's indexed pair arrays.

    Returns (arrays_dict, closer) — `closer()` must run after the arrays'
    contents have been consumed (the group concatenation copies them),
    closing AND unlinking the shm segment."""
    if "shm" not in pairs:
        return {k: pairs[k] for k in _PAIR_KEYS}, lambda: None
    from multiprocessing import shared_memory

    layout, _total = _pair_array_layout(
        pairs["n_pairs"], pairs["lq_bucket"],
        pairs["n_reads"], pairs["n_haps"], pairs["hap_w"])
    shm = shared_memory.SharedMemory(name=pairs["shm"])
    arrays = {
        nm: np.ndarray(shape, dt, buffer=shm.buf, offset=off)
        for nm, off, shape, dt in layout
    }

    def closer():
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass

    return arrays, closer


def prepare_and_pack(builder, genotyper, window, band_margin,
                     max_regions: int, lt_buckets, lq_buckets,
                     shm_prefix: str | None = None,
                     shm_notify=None, record: bool = False) -> PackedWindow:
    """Run phase A (gate/collect/assemble/extract/annotate) + pair building
    + padding for one window; returns the packed payload. With `shm_prefix`
    the pair arrays travel in a shared-memory segment of that prefix. The
    payload's `trace` holds the window's `prep.window` span and the builder
    stages inside it, with their events when `record`."""
    timer = builder.timer = StageTimer(record=record)
    timer.request = window.genome_index
    with timer.stage("prep.window"):
        packed = _prepare_and_pack(builder, genotyper, window, band_margin,
                                   max_regions, lt_buckets, lq_buckets,
                                   shm_prefix, shm_notify)
    return packed._replace(trace=timer.trace())


def _prepare_and_pack(builder, genotyper, window, band_margin,
                      max_regions, lt_buckets, lq_buckets, shm_prefix,
                      shm_notify) -> PackedWindow:
    from lancet2_tpu_torch.base.dna import encode
    from lancet2_tpu_torch.core.variant_builder import PreparedWindow

    prepared = builder.prepare_window(window)
    code = builder.current_code
    timer = builder.timer
    if not isinstance(prepared, PreparedWindow):
        return PackedWindow(window, code, None, None, None, None, None)

    with timer.stage("build_pairs"):
        components = []
        hap_codes_all: list[np.ndarray] = []
        per_comp: list[dict] = []
        n_pairs = 0
        for pc in prepared.components:
            hap_codes = [encode(h) for h in pc.hap_seqs]
            idx = genotyper.build_pair_indices(
                [len(h) for h in hap_codes], prepared.reads, pc.variants,
                anchor_pos1=pc.anchor_pos1, band_margin=band_margin,
                max_regions=max_regions,
            )
            n = len(idx["read_ix"])
            start = n_pairs
            components.append(PackedComponent(
                pc.variants, pc.anchor_pos1, start, start + n,
                idx["read_ix"], idx["hap_local"], idx["meta_vis"],
                idx["regions"], idx["vis_table"],
            ))
            idx["hap_offset"] = len(hap_codes_all)
            hap_codes_all.extend(hap_codes)
            per_comp.append(idx)
            n_pairs += n

        pairs = None
        if n_pairs:
            reads = prepared.reads
            n_reads = len(reads)
            n_haps = len(hap_codes_all)
            lq_b = _bucket(max(r.length for r in reads), lq_buckets)
            hap_w = max(len(h) for h in hap_codes_all)
            lt_b = _bucket(
                max(int(ix["tlens"].max()) for ix in per_comp
                    if len(ix["tlens"])),
                lt_buckets,
            )
            arrays, shm = _alloc_pair_arrays(
                n_pairs, lq_b, n_reads, n_haps, hap_w, shm_prefix
            )
            arrays["reads_q"][:] = 5
            arrays["reads_qu"][:] = 0
            for i, r in enumerate(reads):
                arrays["reads_q"][i, : r.length] = r.codes
                arrays["reads_qu"][i, : r.length] = r.qual
                arrays["read_lens"][i] = r.length
            arrays["haps"][:] = 5
            for i, h in enumerate(hap_codes_all):
                arrays["haps"][i, : len(h)] = h
                arrays["hap_lens"][i] = len(h)
            off = 0
            for ix in per_comp:
                n = len(ix["read_ix"])
                sl = slice(off, off + n)
                arrays["read_ix"][sl] = ix["read_ix"]
                arrays["hap_ix"][sl] = ix["hap_local"] + ix["hap_offset"]
                arrays["band_start"][sl] = ix["band_start"]
                arrays["tlens"][sl] = ix["tlens"]
                off += n
            pairs = {
                "n_pairs": n_pairs, "n_reads": n_reads, "n_haps": n_haps,
                "hap_w": hap_w, "lq_bucket": lq_b, "lt_bucket": lt_b,
            }
            if shm is not None:
                # zero-copy to the parent: only the segment name crosses the
                # queue (pool blocks are ~100s-of-KB; pickling them would
                # burn host core-seconds on each side)
                pairs["shm"] = shm.name
                if shm_notify is not None:
                    # publish the in-flight segment so the coordinator can
                    # reclaim it if this worker dies before the result is
                    # queued (fault-injection contract)
                    shm_notify(shm.name)
                shm.close()
            else:
                pairs.update(arrays)

        reads_lite = ReadCols(prepared.reads)

    return PackedWindow(
        window, code, None, reads_lite, components,
        prepared.sample_summaries, pairs,
    )


def warm_readers(samples, params, reader_pool: dict, need_event_index: bool,
                 timer: StageTimer) -> None:
    """Decode every input file + build indexes in the PARENT before forking
    so child processes inherit the columnar pools copy-on-write. Counts the
    BAM records each decode route took on `timer` (`prep.records_native`,
    `prep.records_python`)."""
    from lancet2_tpu_torch.core.read_collector import ReadCollector
    from lancet2_tpu_torch.hts.bam import BamReader

    collector = ReadCollector(params.collector, samples,
                              reader_pool=reader_pool)
    records = {"native": 0, "python": 0}
    for reader in collector.readers.values():
        if not isinstance(reader, BamReader):
            continue  # CRAM and streamed BAMs decode on their own routes
        cols = reader._cols
        if cols is None:
            records["python"] += len(reader._records_raw)
            continue
        records["native"] += cols["count"]
        if getattr(reader, "_by_contig", None) is None:
            reader._build_index()
        reader.codes_pool()
        reader.softclip_csum()
        if need_event_index:
            from lancet2_tpu_torch.core.active_region import _event_index

            _event_index(reader)
    for route, n in records.items():
        timer.count(f"prep.records_{route}", n)


def log_decode_route(counters: dict) -> None:
    """One log line naming the route that decoded the job's BAM records,
    from `warm_readers`' counters."""
    n_native = counters.get("prep.records_native", 0)
    n_python = counters.get("prep.records_python", 0)
    if n_native or n_python:
        from lancet2_tpu_torch.hts import native

        LOG.info("BAM decode: %d records native (%s), %d in Python", n_native,
                 native.build_route() if n_native else "-", n_python)


TRACE_SEQ = -2  # the seq of the coordinator's "trace" message
_SHM_SLOT_W = 256  # bytes per worker in the in-flight-segment name table
SHM_PREFIX = "psm_"  # multiprocessing's own prefix for segment names


def unlink_segment(name: str) -> None:
    """Remove the shared-memory segment `name`, if it still exists."""
    from multiprocessing import shared_memory

    try:
        seg = shared_memory.SharedMemory(name=name)
        seg.close()
        seg.unlink()
    except Exception:
        pass


def _report_fatal(result_q, exc: BaseException) -> None:
    """Put a fatal carrying `exc` and its traceback on the result queue,
    flush the queue's feeder and exit 1. Call it from an except block."""
    result_q.put((-1, "fatal", (repr(exc), traceback.format_exc())))
    result_q.close()
    result_q.join_thread()
    os._exit(1)


def process_worker_main(work_q, result_q, params, ref, samples, reader_pool,
                        band_margin, max_regions, lt_buckets, lq_buckets,
                        slot_arr=None, slot_idx: int = 0, shm_slots=None,
                        record: bool = False):
    """Entry point of a prep worker process (forked from the coordinator).

    Never touches the device (device work stays in the executor process).
    Exits via os._exit so no inherited atexit hooks run here. `record`:
    each payload carries its spans' events.
    """
    import copy

    try:
        # diagnosability: SIGUSR1 dumps every thread's Python stack to
        # stderr (inherited), so a wedged worker can be inspected from
        # outside without killing the run
        import faulthandler
        import signal

        faulthandler.register(signal.SIGUSR1, all_threads=True)
    except Exception:
        pass

    # if the coordinator dies (its own watchdog, a crash), exit rather than
    # block on the work queue forever as an orphan — reclaiming this
    # worker's in-flight shm segment first (nobody else knows its name)
    def _watchdog(parent_pid):
        import time

        while True:
            if os.getppid() != parent_pid:
                if shm_slots is not None:
                    base = slot_idx * _SHM_SLOT_W
                    raw = bytes(shm_slots[base : base + _SHM_SLOT_W])
                    name = raw.split(b"\x00", 1)[0].decode(errors="replace")
                    if name:
                        unlink_segment(name)
                os._exit(1)
            time.sleep(2.0)

    import threading

    coordinator = os.getppid()
    threading.Thread(
        target=_watchdog, args=(coordinator,), daemon=True
    ).start()
    # a run's segments carry its coordinator's pid, so that what a run left
    # in /dev/shm can be told from another run's
    shm_prefix = f"{SHM_PREFIX}{coordinator}_"

    try:
        from lancet2_tpu_torch.caller.genotyper import Genotyper
        from lancet2_tpu_torch.core.variant_builder import VariantBuilder

        worker_samples = [copy.copy(s) for s in samples]
        builder = VariantBuilder(params, ref, worker_samples,
                                 reader_pool=reader_pool)
        genotyper = Genotyper(backend="evidence")
    except BaseException as exc:
        # a setup that fails is reported, never swallowed: the executor
        # raises with it (SystemExit too: hts_open raises it for a URI it
        # cannot open)
        _report_fatal(result_q, exc)
    try:
        while True:
            item = work_q.get()
            if item is None:
                break
            seq, window = item
            if slot_arr is not None:
                # crash context (reference: base/crash_handler.h per-thread
                # window slots): the coordinator reads this on worker death
                # so the fail-fast error names the window being processed
                slot_arr[slot_idx] = seq

            def shm_notify(name: str):
                if shm_slots is not None:
                    raw = name.encode()[: _SHM_SLOT_W - 1]
                    base = slot_idx * _SHM_SLOT_W
                    shm_slots[base : base + len(raw)] = raw
                    shm_slots[base + len(raw)] = 0

            try:
                payload = prepare_and_pack(
                    builder, genotyper, window, band_margin,
                    max_regions, lt_buckets, lq_buckets,
                    shm_prefix=shm_prefix,
                    shm_notify=shm_notify,
                    record=record,
                )
                if os.getppid() != coordinator:
                    # the coordinator is gone and the executor stops reading
                    # results once it sees that: a payload handed over now
                    # would leave its segment in /dev/shm
                    if "shm" in (payload.pairs or {}):
                        unlink_segment(payload.pairs["shm"])
                    os._exit(1)
                result_q.put((seq, "ok", payload))
            except Exception as exc:  # report, then keep serving
                result_q.put(
                    (seq, "error", (repr(exc), traceback.format_exc()))
                )
            finally:
                shm_notify("")  # ownership passed to the executor
                if slot_arr is not None:
                    slot_arr[slot_idx] = -1
    except KeyboardInterrupt:
        pass
    finally:
        result_q.close()
        result_q.join_thread()
        os._exit(0)


def coordinator_main(work_q, result_q, params, ref_path, samples,
                     band_margin, max_regions, lt_buckets, lq_buckets,
                     n_workers, record: bool = False):
    """Entry point of the SPAWNED prep coordinator.

    Why a coordinator at all: the executor process holds the device (a CUDA
    context, which a forked child cannot use), so it SPAWNS this clean
    process (fresh interpreter, no device state), which decodes every input
    file once and then FORKS the actual workers — fork from a process that
    never touched the device is safe, and the workers inherit the decoded columnar pools
    copy-on-write. The spawn-context queues are inherited straight through
    to the forked workers, so results flow worker -> executor with one
    pickle hop.

    Once the workers run it puts one `(TRACE_SEQ, "trace",
    StageTimer.trace())` message on the result queue: its `prep.decode`
    span, with the event when `record` (the workers' payloads then carry
    theirs too).
    """
    import multiprocessing as mp

    try:
        import faulthandler
        import signal

        faulthandler.register(signal.SIGUSR1, all_threads=True)
    except Exception:
        pass

    # the coordinator is non-daemonic (daemons may not fork workers): a
    # watchdog exits it if the executor process dies without sending the
    # shutdown sentinels, so no orphan tree survives a crashed parent
    def _watchdog(parent_pid):
        import time

        while True:
            if os.getppid() != parent_pid:
                os._exit(1)
            time.sleep(2.0)

    import threading

    threading.Thread(
        target=_watchdog, args=(os.getppid(),), daemon=True
    ).start()

    try:
        from lancet2_tpu_torch.hts.fasta import Reference

        ref = Reference(ref_path)
        reader_pool: dict = {}
        timer = StageTimer(record=record)
        with timer.stage("prep.decode"):
            warm_readers(samples, params, reader_pool,
                         need_event_index=not params.skip_active_region,
                         timer=timer)
            # build (or load) the native assembly core once, before the
            # fork: the workers inherit the loaded library instead of each
            # building it
            from lancet2_tpu_torch.base import native_core

            native_core.available()

        ctx = mp.get_context("fork")
        # crash-context slots: worker i publishes the window seq it is
        # processing (-1 = idle) so a killed worker's window is named in
        # the fail-fast error (reference: base/crash_handler.h:53-67);
        # shm_slots carries the in-flight segment name for reclaim
        slot_arr = ctx.Array("l", [-1] * n_workers, lock=False)
        shm_slots = ctx.Array("B", n_workers * _SHM_SLOT_W, lock=False)
        workers = [
            ctx.Process(
                target=process_worker_main,
                args=(work_q, result_q, params, ref, samples, reader_pool,
                      band_margin, max_regions, lt_buckets, lq_buckets,
                      slot_arr, i, shm_slots, record),
                daemon=True,
            )
            for i in range(n_workers)
        ]
        for w in workers:
            w.start()
        # only after the fork: a put starts this process's queue feeder
        # thread, and a forked child of a spawned process does not reset
        # the queue it inherits, so its own puts would wait on the parent's
        # feeder, which it does not have
        result_q.put((TRACE_SEQ, "trace", timer.trace()))
        # fail-fast supervision: a worker that dies abnormally (segfault,
        # OOM-kill, SIGKILL) takes its queued window with it — without
        # detection the executor would wait forever. Reclaim its in-flight
        # shm segment, report, and exit (reference fail-fast contract:
        # core/async_worker.cpp:76-97).
        import time as _time

        while True:
            if all(not w.is_alive() for w in workers):
                _check_queue_drained(work_q, workers)
                break
            for i, w in enumerate(workers):
                if not w.is_alive() and w.exitcode not in (0, None):
                    seq = slot_arr[i]
                    base = i * _SHM_SLOT_W
                    raw = bytes(shm_slots[base : base + _SHM_SLOT_W])
                    name = raw.split(b"\x00", 1)[0].decode(errors="replace")
                    if name:
                        unlink_segment(name)
                    result_q.put((-1, "fatal", (
                        f"prep worker pid {w.pid} died with exitcode "
                        f"{w.exitcode} while processing window seq {seq}",
                        "",
                    )))
                    # flush the queue feeder before hard-exit, else the
                    # fatal is lost and the executor sees silent death
                    result_q.close()
                    result_q.join_thread()
                    os._exit(1)
            _time.sleep(0.1)
        for w in workers:
            w.join()
    except BaseException as exc:
        # SystemExit too: hts_open raises it for a URI it cannot open
        _report_fatal(result_q, exc)
    result_q.close()
    result_q.join_thread()
    os._exit(0)


def _check_queue_drained(work_q, workers) -> None:
    """Raise if every worker has exited while windows were still queued: each
    exits 0 only after a shutdown sentinel, so a window left behind means
    the executor would wait for it forever."""
    import queue

    left = []
    while True:
        try:
            item = work_q.get(timeout=0.05)
        except queue.Empty:
            break
        if item is not None:
            left.append(item[0])
    if left:
        exits = ", ".join(f"pid {w.pid} exitcode {w.exitcode}"
                          for w in workers)
        raise RuntimeError(
            f"every prep worker exited ({exits}) while windows (seq) "
            f"{left[:8]} were still queued")
