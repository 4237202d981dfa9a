"""Sharded variant store with overlap dedup + genomically ordered VCF flush.

Reference: src/lancet/core/variant_store.{h,cpp}, pipeline_executor.cpp
FlushCompletedVariants. Duplicate records from overlapping windows (same
CHROM+POS+REF) keep the copy with higher total coverage; flush extracts all
variants genomically strictly before a window cursor, sorts, and writes —
guaranteeing a sorted VCF prefix despite out-of-order window completion.
"""

from __future__ import annotations

import threading

from lancet2_tpu_torch.caller.variant_call import VariantCall

NUM_SHARDS = 256
FLUSH_LAG_WINDOWS = 100


class VariantStore:
    def __init__(self, windows, min_emit_pos=None):
        self.windows = windows
        # resume support: records strictly before this (chrom_index, pos1)
        # were already emitted by a previous run's flushed prefix
        self.min_emit_pos = min_emit_pos
        self._shards: list[dict] = [dict() for _ in range(NUM_SHARDS)]
        self._locks = [threading.Lock() for _ in range(NUM_SHARDS)]

    @staticmethod
    def _shard_of(identity: tuple) -> int:
        return hash(identity) % NUM_SHARDS

    def add_variants(self, calls: list[VariantCall]) -> None:
        for call in calls:
            key = call.identity()
            shard_idx = self._shard_of(key)
            with self._locks[shard_idx]:
                shard = self._shards[shard_idx]
                existing = shard.get(key)
                # higher total coverage wins (reference: variant_store.cpp:36-43);
                # coverage TIES break to the earlier window — the reference
                # keeps first-arrival there, which is thread-schedule-dependent
                if existing is None or (
                    call.total_coverage() > existing.total_coverage()
                    or (call.total_coverage() == existing.total_coverage()
                        and call.window_index < existing.window_index)
                ):
                    shard[key] = call

    def _extract_before(self, chrom_index: int, pos1: int) -> list[VariantCall]:
        out = []
        for shard_idx in range(NUM_SHARDS):
            with self._locks[shard_idx]:
                shard = self._shards[shard_idx]
                keys = [
                    k
                    for k, call in shard.items()
                    if (call.chrom_index, call.pos1) < (chrom_index, pos1)
                ]
                for k in keys:
                    call = shard.pop(k)
                    if not call.has_alt_support:
                        continue
                    if self.min_emit_pos is not None and (
                        call.chrom_index, call.pos1
                    ) < self.min_emit_pos:
                        continue
                    out.append(call)
        return out

    def flush_before_window(self, window_index: int, out) -> int:
        """Flush records strictly before the given window's start."""
        if window_index < 0 or window_index >= len(self.windows):
            return 0
        window = self.windows[window_index]
        return self._flush(self._extract_before(window.chrom_index, window.start1), out)

    def flush_before_pos(self, chrom_index: int, pos1: int, out) -> int:
        """Flush records strictly before (chrom_index, pos1) — the streaming
        executors' cursor form (no window list required)."""
        return self._flush(self._extract_before(chrom_index, pos1), out)

    def flush_all(self, out) -> int:
        return self._flush(self._extract_before(1 << 62, 1 << 62), out)

    @staticmethod
    def _flush(calls: list[VariantCall], out) -> int:
        calls.sort(key=lambda c: (c.chrom_index, c.pos1, c.ref_allele))
        for call in calls:
            out.write(call.as_vcf_record() + "\n")
        return len(calls)
