"""Named ranges around the program's calls, from the harness's own files,
for a traced job; and the evidence work those calls are handed and keep.

`Wrapped()` replaces, for the life of the `with`, these methods of the
port with versions that run the original inside
`torch.profiler.record_function("bench.<name>")`:

    TorchBatchPipelineExecutor.execute               execute
    TorchBatchPipelineExecutor._start_prep_workers  prep_spawn
    TorchBatchPipelineExecutor._wait_for             prep_wait
    TorchBatchPipelineExecutor._device_pl_tables     device_pl_tables
    TorchGenotyper.begin_evidence_indexed            evidence_begin
    TorchGenotyper.finish_evidence_indexed           evidence_finish
    TorchGenotyper.assemble_evidence_packed          assemble_evidence
    VariantStore.flush_before_pos, flush_all         flush

The evidence wrappers also count the work (`Work`) from what the calls
are given (pools, pairs) and keep (the pairs the two-pass gate passes, at
their cropped span), by the frozen arithmetic of `roofline.py`.
"""

from __future__ import annotations

import functools

import numpy as np

import roofline

EVIDENCE_CALLS = {"evidence_begin", "evidence_finish"}


class Work:
    def __init__(self):
        self.ops = 0
        self.bytes = 0
        self.pairs = 0
        self.kept = 0
        self._pending: dict = {}


def _nbytes(d: dict) -> int:
    return sum(np.asarray(v).nbytes for v in d.values()
               if isinstance(v, np.ndarray))


class Wrapped:
    def __init__(self):
        self.work = Work()
        self._saved = []

    def _patch(self, cls, attr, fn):
        self._saved.append((cls, attr, cls.__dict__.get(attr)))
        setattr(cls, attr, functools.wraps(getattr(cls, attr))(fn))

    def __enter__(self):
        from torch.profiler import record_function

        from lancet2_tpu_torch.caller.genotyper import TorchGenotyper
        from lancet2_tpu_torch.core.batch_pipeline import (
            TorchBatchPipelineExecutor as Ex,
        )
        from lancet2_tpu_torch.core.variant_store import VariantStore

        def ranged(orig, name):
            def call(*a, **k):
                with record_function("bench." + name):
                    return orig(*a, **k)
            return call

        for cls, attr, name in (
                (Ex, "execute", "execute"),
                (Ex, "_start_prep_workers", "prep_spawn"),
                (Ex, "_wait_for", "prep_wait"),
                (Ex, "_device_pl_tables", "device_pl_tables"),
                (TorchGenotyper, "assemble_evidence_packed",
                 "assemble_evidence"),
                (VariantStore, "flush_before_pos", "flush"),
                (VariantStore, "flush_all", "flush")):
            self._patch(cls, attr, ranged(getattr(cls, attr), name))

        work = self.work
        begin = TorchGenotyper.__dict__["begin_evidence_indexed"]
        finish = TorchGenotyper.__dict__["finish_evidence_indexed"]

        def begin_evidence(gt, pools, pairs, *a, **k):
            with record_function("bench.evidence_begin"):
                st = begin(gt, pools, pairs, *a, **k)
            read_lens = np.asarray(pools["read_lens"], np.int64)
            read_ix = np.asarray(pairs["read_ix"], np.int64)
            tlens = np.asarray(pairs["tlens"], np.int64)
            lt = int(pairs.get("lt_bucket") or tlens.max(initial=1))
            work.ops += roofline.span_work(read_lens, read_ix, tlens, lt)
            work.bytes += _nbytes(pools) + _nbytes(pairs)
            work.pairs += read_ix.size
            work._pending[id(st)] = (st, read_lens[read_ix],
                                     np.asarray(pairs["regions"]))
            return st

        def finish_evidence(gt, st, *a, **k):
            with record_function("bench.evidence_finish"):
                outs = finish(gt, st, *a, **k)
            _st, rl, regions = work._pending.pop(id(st))
            ts = np.asarray(outs["t_start"], np.int64)
            te = np.asarray(outs["t_end"], np.int64)
            kept, slots = roofline.gate(np.asarray(outs["score"]), ts, te,
                                        regions, rl)
            work.ops += roofline.evidence_work(rl[kept], ts[kept], te[kept],
                                               slots)
            work.bytes += _nbytes(outs)
            work.kept += kept.size
            return outs

        self._patch(TorchGenotyper, "begin_evidence_indexed", begin_evidence)
        self._patch(TorchGenotyper, "finish_evidence_indexed", finish_evidence)
        return self

    def __exit__(self, *exc):
        for cls, attr, orig in reversed(self._saved):
            if orig is None:
                delattr(cls, attr)  # the base class's method shows again
            else:
                setattr(cls, attr, orig)
        self._saved = []
        return False
