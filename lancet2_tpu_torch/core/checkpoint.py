"""Window-cursor checkpoint / resume.

The reference has no checkpointing — a killed 40-hour run restarts from
scratch; its one partial-progress artifact is the already-flushed VCF
prefix, which the ordered flush guarantees is a valid genomic prefix
(reference: core/pipeline_executor.cpp:215-252, SURVEY.md §5). Windows are
independent, so a cursor checkpoint is nearly free and this framework adds
it: after each ordered flush the executor records the flush cursor
(chrom_index, pos1); on resume, records strictly before the cursor are
recovered from the partial VCF and only windows that can still produce
records at or beyond the cursor are reprocessed. With the deterministic
pipeline, a resumed run is record-identical to an uninterrupted one.
"""

from __future__ import annotations

import gzip
import json
import os


class CheckpointFile:
    def __init__(self, path: str):
        self.path = path
        # set by the CLI to the VCF writer's sync: run before each cursor is
        # written, it makes the records the cursor covers durable first. The
        # executors flush records into the writer's buffer; a cursor saved
        # ahead of them would drop them on resume (neither recovered from
        # the file nor regenerated, their windows lying before the cursor)
        self.sync = None

    def save(self, cursor_chrom_index: int, cursor_pos1: int, done: int) -> None:
        if self.sync is not None:
            self.sync()
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(
                {
                    "cursor_chrom_index": cursor_chrom_index,
                    "cursor_pos1": cursor_pos1,
                    "done": done,
                },
                fh,
            )
        os.replace(tmp, self.path)

    def load(self) -> dict | None:
        if not os.path.exists(self.path):
            return None
        try:
            with open(self.path) as fh:
                return json.load(fh)
        except (ValueError, OSError):
            return None

    def clear(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)


def split_windows_for_resume(windows: list, cursor: dict) -> tuple[list, tuple]:
    """Windows that must be reprocessed after resuming at `cursor`.

    A window is complete iff every record it could produce lies strictly
    before the cursor — i.e. its end is before the cursor position.
    """
    c = (cursor["cursor_chrom_index"], cursor["cursor_pos1"])
    remaining = [w for w in windows if (w.chrom_index, w.end1 + 1) >= c]
    return remaining, c


def recover_prefix_records(partial_vcf: str, cursor: tuple) -> list[str]:
    """Body records strictly before the cursor from the partial VCF.

    The partial file may end mid-BGZF-block after a crash; decode errors
    truncate cleanly (everything recovered remains a valid prefix).
    """
    chrom_index_cache: dict[str, int] = {}
    records: list[str] = []
    try:
        with gzip.open(partial_vcf, "rt") as fh:
            contig_rank = 0
            for line in fh:
                if line.startswith("##contig=<ID="):
                    name = line.split("ID=", 1)[1].split(",", 1)[0].split(">", 1)[0]
                    chrom_index_cache[name] = contig_rank
                    contig_rank += 1
                if line.startswith("#"):
                    continue
                cols = line.split("\t", 2)
                key = (chrom_index_cache.get(cols[0], 1 << 30), int(cols[1]))
                if key < cursor:
                    records.append(line if line.endswith("\n") else line + "\n")
    except (OSError, EOFError, ValueError):
        pass
    return records
