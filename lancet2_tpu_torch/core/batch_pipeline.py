"""Batch executor on one torch device.

`TorchBatchPipelineExecutor` subclasses the JAX package's
`BatchPipelineExecutor` (`lancet2_tpu/core/batch_pipeline.py`) and rewrites
`execute` (reference `:325-613`) without jax: no `jax.devices()`, no mesh;
one explicit `torch.device` and the port's `TorchGenotyper`.

  phase A  the reference's prep coordinator and fork workers, unchanged,
           spawned through lancet2_tpu_torch.core.prep_worker; they run the
           CPU layout on every device (max_regions = R_MAX, lt buckets
           _TARGET_BUCKETS, lq buckets _QUERY_BUCKETS), so payloads equal the
           JAX batch executor's on the CPU
  phase B  per window batch: pools uploaded, pass-1 span launched (async);
           the previous batch's pass 2 and phase C run while it executes
  phase C  evidence assembly, VariantCall with host float64 DM PLs
           (`_device_pl_tables` returns {} as the reference does off-TPU),
           ordered VCF flush

No CUDA call happens before the prep workers start.
"""

from __future__ import annotations

import os
import time
from collections import deque

import numpy as np
import torch

from lancet2_tpu.caller.genotyper import _QUERY_BUCKETS, _TARGET_BUCKETS
from lancet2_tpu.caller.variant_call import VariantCall
from lancet2_tpu.core.batch_pipeline import BatchPipelineExecutor
from lancet2_tpu.core.prep_worker import map_pair_arrays
from lancet2_tpu.core.variant_builder import StatusCode
from lancet2_tpu.utils.logging import get_logger
from lancet2_tpu.utils.profiling import StageTimer
from lancet2_tpu_torch.caller.genotyper import TorchGenotyper
from lancet2_tpu_torch.core.prep_worker import coordinator_main
from lancet2_tpu_torch.ops.evidence_dp import R_MAX

LOG = get_logger("batch_pipeline")

LOOKAHEAD = 3  # window batches queued to the prep workers


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


class TorchBatchPipelineExecutor(BatchPipelineExecutor):
    def __init__(self, *args, device: torch.device, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = torch.device(device)
        self.genotyper: TorchGenotyper | None = None

    def _start_prep_workers(self, max_regions, lq_buckets, lt_buckets):
        if not self._use_processes():
            raise ValueError("the port runs phase A in prep processes only "
                             "(--prep-mode threads is not supported)")
        import multiprocessing as mp

        n = max(1, min(self.num_workers, os.cpu_count() or self.num_workers))
        self._n_prep_workers = n
        ctx = mp.get_context("spawn")
        self._work_q = ctx.Queue()
        self._result_q = ctx.Queue()
        p = ctx.Process(
            target=coordinator_main,
            args=(self._work_q, self._result_q, self.params, self.ref.path,
                  self.samples, self.band_margin, max_regions, lt_buckets,
                  lq_buckets, n),
            daemon=False,  # daemons may not fork the workers
        )
        p.start()
        self._procs.append(p)
        self._start_drain_thread()
        LOG.info("prep: spawned coordinator + %d fork worker(s)", n)

    def _device_pl_tables(self, pending_rows, devices):
        return {}  # DM PLs stay on the host (caller/likelihood.py, float64)

    # ------------------------------------------------------------------
    def execute(self, out) -> dict:
        if not self.streaming and len(self.windows) == 0:
            return {"windows": 0, "flushed": 0}
        t_start = time.monotonic()
        self._start_prep_workers(R_MAX, _QUERY_BUCKETS, _TARGET_BUCKETS)

        flushed = 0
        num_done = 0
        seq_counter = 0
        wall = StageTimer()

        def enqueue(batch) -> list[int]:
            nonlocal seq_counter
            seqs = []
            for w in batch:
                self._work_q.put((seq_counter, w))
                seqs.append(seq_counter)
                seq_counter += 1
            return seqs

        try:
            self.device = check_device(self.device)
            genotyper = self.genotyper = TorchGenotyper(self.device)
            batch_iter = self._batches()
            pending: deque = deque()

            def top_up():
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
                    pairs["lt_bucket"] = key[1]
                    for closer in closers:
                        closer()  # shm consumed by the concatenation
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
                with wall.stage("device"), \
                        self.stage_timer.stage("genotype_device"):
                    outs_by_bi = finish_phase_b(payloads, subs)

                pending_rows: list = []
                with wall.stage("phase_c"):
                    for bi, payload in enumerate(payloads):
                        if payload.components is None:
                            continue
                        wouts = outs_by_bi.get(bi) or {}
                        for comp in payload.components:
                            comp_outs = {
                                k: v[comp.pair_start:comp.pair_stop]
                                for k, v in wouts.items()
                            }
                            with self.stage_timer.stage("assemble_evidence"):
                                geno = genotyper.assemble_evidence_packed(
                                    payload.reads, comp.variants, comp,
                                    comp_outs)
                            for vi, variant in enumerate(comp.variants):
                                supports = geno.get(vi)
                                if not supports or not any(
                                        s.total_alt_cov() > 0
                                        for s in supports.values()):
                                    continue
                                pending_rows.append(
                                    (bi, payload, variant, supports))

                    pls_tables = self._device_pl_tables(pending_rows, None)
                    per_window_calls: dict[int, list[VariantCall]] = {}
                    for row_idx, (bi, payload, variant, supports) in \
                            enumerate(pending_rows):
                        per_window_calls.setdefault(bi, []).append(
                            VariantCall(
                                variant, supports, payload.sample_summaries,
                                payload.window.length,
                                window_index=payload.window.genome_index,
                                pls_lookup=pls_tables.get(row_idx),
                            ))

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
                    with wall.stage("flush"):
                        flushed += self.store.flush_before_pos(
                            w.chrom_index, w.start1, out)
                    if self.checkpoint is not None:
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
                top_up()
                lo = batch[0].genome_index
                with wall.stage("prep_wait"):
                    payloads = self._wait_for(cur_seqs)
                for p in payloads:
                    for k, v in p.timer_totals.items():
                        self.stage_timer.totals[k] += v
                    for k, v in p.timer_counts.items():
                        self.stage_timer.counts[k] += v
                with wall.stage("device"), \
                        self.stage_timer.stage("genotype_device"):
                    subs = submit_phase_b(payloads)
                if prev is not None:
                    complete_batch(prev, next_first_window=batch[0])
                prev = (batch, payloads, subs, lo)
            if prev is not None:
                complete_batch(prev, next_first_window=None)
        finally:
            self._stop_prep_workers()

        flushed += self.store.flush_all(out)
        runtime = time.monotonic() - t_start
        stage_report = self.stage_timer.report()
        if stage_report:
            LOG.info("stage profile: %s", ", ".join(
                f"{k}={v['pct']}%" for k, v in stage_report.items()))
        wall_report = wall.report()
        accounted = sum(v["seconds"] for v in wall_report.values())
        other_s = max(runtime - accounted, 0.0)
        if runtime > 0:
            for v in wall_report.values():
                v["pct"] = round(100.0 * v["seconds"] / runtime, 1)
        wall_report["other"] = {
            "seconds": round(other_s, 3),
            "pct": round(100.0 * other_s / runtime, 1) if runtime > 0 else 0.0,
            "count": 1,
        }
        return {
            "windows": num_done,
            "flushed": flushed,
            "runtime_s": runtime,
            "windows_per_s": num_done / runtime if runtime > 0 else 0.0,
            "status_counts": {k.name: v for k, v in self.status_counts.items()},
            "stage_profile": stage_report,
            "wall_profile": wall_report,
            "pass2": dict(genotyper.pass2_stats),
            "device": str(self.device),
        }
