"""Active-region prescan: cheap mutation-evidence filter before assembly.

Reference: src/lancet/core/active_region_detector.cpp. A window is active
when any genome position accumulates >=2 supporting reads of mutation
evidence across one sample: MD-tag mismatches (base qual >= 20), CIGAR
I/D/X events, or soft-clip positions. Reads failing QC/dup/unmapped/MAPQ==0
are ignored.
"""

from __future__ import annotations

from collections import defaultdict

from lancet2_tpu_torch.hts.bam import BamRecord, BamReader
from lancet2_tpu_torch.hts.cigar import CONSUMES_REF, D, I, S, X

MIN_BASE_QUAL = 20


def _parse_md_hits(md: str, quals, start0: int, counts: dict) -> bool:
    """MD state machine; True when any position reaches 2 mismatch hits."""
    genome_pos = start0
    token = ""
    i = 0
    n = len(md)
    while i < n:
        ch = md[i]
        if ch.isdigit():
            token += ch
            i += 1
            continue
        genome_pos += int(token) if token else 0
        token = ""
        if ch == "^":
            # deletion run: skip deleted ref bases, do not advance genome_pos
            # counting (reference ParseMd ignores ^ runs for mismatch hits)
            i += 1
            while i < n and md[i].isalpha():
                i += 1
                genome_pos += 1
            continue
        base_pos = genome_pos - start0
        if 0 <= base_pos < len(quals) and quals[base_pos] >= MIN_BASE_QUAL:
            if ch.upper() in "ACGT":
                counts[genome_pos] += 1
                if counts[genome_pos] == 2:
                    return True
        genome_pos += 1
        i += 1
    return False


class MutationAccumulator:
    def __init__(self):
        self.mismatches = defaultdict(int)
        self.insertions = defaultdict(int)
        self.deletions = defaultdict(int)
        self.softclips = defaultdict(int)

    def check_alignment(self, rec: BamRecord) -> bool:
        if rec.is_qcfail or rec.is_duplicate or rec.is_unmapped or rec.mapq == 0:
            return False
        if self._check_md(rec):
            return True
        if self._check_cigar(rec):
            return True
        return self._check_softclips(rec)

    def _check_md(self, rec: BamRecord) -> bool:
        md = rec.tags.get("MD")
        if not isinstance(md, str):
            return False
        return _parse_md_hits(md, rec.qual, rec.pos0, self.mismatches)

    def _check_cigar(self, rec: BamRecord) -> bool:
        pos = rec.pos0
        for op, length in rec.cigar:
            if op in CONSUMES_REF:
                pos += length
            if op == I:
                self.insertions[pos] += 1
                if self.insertions[pos] == 2:
                    return True
            elif op == D:
                self.deletions[pos] += 1
                if self.deletions[pos] == 2:
                    return True
            elif op == X:
                self.mismatches[pos] += 1
                if self.mismatches[pos] == 2:
                    return True
        return False

    def _check_softclips(self, rec: BamRecord) -> bool:
        if not rec.cigar:
            return False
        hits = []
        if rec.cigar[0][0] == S:
            hits.append(rec.pos0)
        if len(rec.cigar) > 1 and rec.cigar[-1][0] == S:
            hits.append(rec.reference_end0())
        for pos in hits:
            self.softclips[pos] += 1
            if self.softclips[pos] == 2:
                return True
        return False


def _record_events(rec: BamRecord) -> list[tuple[int, int]]:
    """(genome_pos, kind) mutation events of one read; kind 0=mismatch
    (MD + X ops share one map, like the reference), 1=ins, 2=del, 3=clip."""
    if rec.is_qcfail or rec.is_duplicate or rec.is_unmapped or rec.mapq == 0:
        return []
    events: list[tuple[int, int]] = []
    md = rec.tags.get("MD")
    if isinstance(md, str):
        genome_pos = rec.pos0
        token = ""
        i, n = 0, len(md)
        quals = rec.qual
        start0 = rec.pos0
        while i < n:
            ch = md[i]
            if ch.isdigit():
                token += ch
                i += 1
                continue
            genome_pos += int(token) if token else 0
            token = ""
            if ch == "^":
                i += 1
                while i < n and md[i].isalpha():
                    i += 1
                    genome_pos += 1
                continue
            base_pos = genome_pos - start0
            if 0 <= base_pos < len(quals) and quals[base_pos] >= MIN_BASE_QUAL:
                if ch.upper() in "ACGT":
                    events.append((genome_pos, 0))
            genome_pos += 1
            i += 1
    pos = rec.pos0
    for op, length in rec.cigar:
        if op in CONSUMES_REF:
            pos += length
        if op == I:
            events.append((pos, 1))
        elif op == D:
            events.append((pos, 2))
        elif op == X:
            events.append((pos, 0))
    if rec.cigar:
        if rec.cigar[0][0] == S:
            events.append((rec.pos0, 3))
        if len(rec.cigar) > 1 and rec.cigar[-1][0] == S:
            events.append((rec.reference_end0(), 3))
    return events


def _event_index(reader: BamReader):
    """Per-read mutation events, computed ONCE per file and cached on the
    reader: {rid: (starts, run_max_end, ev_pos, ev_kind, ev_off)} with
    reads in the fetch index's start-sorted order. Turns the per-window MD
    state machine re-parse into two searchsorteds + a duplicate check."""
    cached = getattr(reader, "_active_event_index", None)
    if cached is not None:
        return cached
    import numpy as np

    if reader._by_contig is None:
        reader._build_index()

    # native fast path: one C pass over the columnar pools gives file-order
    # events; reorder into each contig's start-sorted handle order
    file_ev = None
    if getattr(reader, "_cols", None) is not None:
        from lancet2_tpu_torch.hts import native

        file_ev = native.event_scan(reader._cols)

    index: dict[int, tuple] = {}
    for rid, (starts, run_max_end, ends, handles) in reader._by_contig.items():
        if file_ev is not None:
            fpos, fkind, foff = file_ev
            h = np.asarray(handles, dtype=np.int64)
            lens = foff[h + 1] - foff[h]
            total = int(lens.sum())
            ev_off = np.zeros(len(starts) + 1, dtype=np.int64)
            np.cumsum(lens, out=ev_off[1:])
            if total:
                gather = (
                    np.repeat(foff[h], lens)
                    + np.arange(total, dtype=np.int64)
                    - np.repeat(ev_off[:-1], lens)
                )
                ev_pos_arr = fpos[gather]
                ev_kind_arr = fkind[gather]
            else:
                ev_pos_arr = np.empty(0, dtype=np.int64)
                ev_kind_arr = np.empty(0, dtype=np.int64)
            index[rid] = (starts, run_max_end, ends, ev_pos_arr, ev_kind_arr, ev_off)
            continue
        ev_pos: list[int] = []
        ev_kind: list[int] = []
        ev_off = np.zeros(len(starts) + 1, dtype=np.int64)
        for j in range(len(starts)):
            h = handles[j]
            rec = reader._record_at(int(h)) if not isinstance(h, BamRecord) else h
            for p, kd in _record_events(rec):
                ev_pos.append(p)
                ev_kind.append(kd)
            ev_off[j + 1] = len(ev_pos)
        index[rid] = (
            starts, run_max_end, ends,
            np.asarray(ev_pos, dtype=np.int64),
            np.asarray(ev_kind, dtype=np.int64),
            ev_off,
        )
    reader._active_event_index = index
    return index


def is_active_region(readers: list[BamReader], chrom: str, start1: int, end1: int) -> bool:
    """True when, within one sample, >=2 reads overlapping the window carry
    the same-kind mutation event at the same genome position (the event
    itself may sit just outside the window — reference semantics: events of
    overlapping reads, not events within bounds)."""
    import numpy as np

    for reader in readers:
        index = getattr(reader, "_active_event_index", None)
        if index is None and not hasattr(reader, "_by_contig"):
            # streaming readers: fall back to the per-window accumulator
            acc = MutationAccumulator()
            for rec in reader.fetch(chrom, start1, end1):
                if acc.check_alignment(rec):
                    return True
            continue
        index = _event_index(reader)
        rid = reader.ref_id(chrom)
        entry = index.get(rid)
        if entry is None:
            continue
        starts, run_max_end, ends, ev_pos, ev_kind, ev_off = entry
        lo0, hi0 = start1 - 1, end1
        hi_idx = int(np.searchsorted(starts, hi0, side="left"))
        # overlapping reads: scan back until the running max end clears lo0
        lo_idx = hi_idx
        for j in range(hi_idx - 1, -1, -1):
            if run_max_end[j] <= lo0:
                break
            lo_idx = j
        if lo_idx >= hi_idx:
            continue
        # gather events of reads [lo_idx, hi_idx) that truly overlap
        segs = []
        for j in range(lo_idx, hi_idx):
            if ends[j] <= lo0:
                continue
            a, b = int(ev_off[j]), int(ev_off[j + 1])
            if a < b:
                segs.append((a, b))
        if not segs:
            continue
        keys = np.concatenate([
            ev_pos[a:b] * 4 + ev_kind[a:b] for a, b in segs
        ])
        if keys.size < 2:
            continue
        keys.sort()
        if bool((keys[1:] == keys[:-1]).any()):
            return True
    return False


def has_md_tag(reader: BamReader, num_reads_to_peek: int = 1000) -> bool:
    cols = getattr(reader, "_cols", None)
    if cols is not None:
        # peek the columnar records without materializing BamRecords
        for i in range(min(num_reads_to_peek + 1, cols["count"])):
            if "MD" in reader._record_at(i).tags:
                return True
        return False
    for i, rec in enumerate(reader.all_records()):
        if i > num_reads_to_peek:
            break
        if "MD" in rec.tags:
            return True
    return False
