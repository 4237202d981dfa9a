"""Per-stage timing + committed history tracking.

Reference: the gperftools profiling workflow and the committed trend file
profiling/history.jsonl (4 entries in the reference repo), reproduced as a
lightweight stage-timer: workers accumulate per-stage wall time, the
pipeline aggregates, and append_history() writes one JSON line per run so
perf regressions are visible in version control.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager

HISTORY_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "profiling",
    "history.jsonl",
)


class StageTimer:
    """Accumulates wall seconds per named pipeline stage."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def merge(self, other: "StageTimer") -> None:
        for k, v in other.totals.items():
            self.totals[k] += v
        for k, v in other.counts.items():
            self.counts[k] += v

    def report(self) -> dict:
        total = sum(self.totals.values()) or 1.0
        return {
            name: {
                "seconds": round(secs, 3),
                "pct": round(100.0 * secs / total, 1),
                "count": self.counts[name],
            }
            for name, secs in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }


def append_history(entry: dict, path: str = HISTORY_PATH) -> None:
    """Append one run's profile/bench entry to the committed trend file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    entry = dict(entry)
    entry.setdefault("ts", time.time())
    with open(path, "a") as fh:
        fh.write(json.dumps(entry) + "\n")
