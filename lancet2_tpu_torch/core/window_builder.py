"""Genomic window generation: padding, step math, deterministic ordering.

Reference: src/lancet/core/window_builder.{h,cpp}, window.h, bed_parser.cpp.
Defaults: 1000bp windows, 20% overlap -> 800bp step (rounded up to a
multiple of 100), 500bp region padding clamped to contig bounds; windows
sorted genomically and assigned global genome indices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from lancet2_tpu_torch.hts.fasta import Reference

DEFAULT_WINDOW_LENGTH = 1000
DEFAULT_PCT_OVERLAP = 20
DEFAULT_REGION_PADDING = 500
MIN_WINDOW_LENGTH = 1000
MAX_WINDOW_LENGTH = 2500
MIN_PCT_OVERLAP = 10
MAX_PCT_OVERLAP = 90
DEFAULT_NUM_WINDOWS_BATCH = 65536

# contigs excluded when windowing the whole reference (decoys/alts)
_DECOY_MARKERS = ("_", "-", "EBV", "HLA", "M", "chrM", "MT")


@dataclass
class WindowParams:
    window_length: int = DEFAULT_WINDOW_LENGTH
    pct_overlap: int = DEFAULT_PCT_OVERLAP
    region_padding: int = DEFAULT_REGION_PADDING


@dataclass
class Window:
    chrom: str
    chrom_index: int
    start1: int
    end1: int
    genome_index: int = -1
    _seq: str | None = field(default=None, repr=False)

    @property
    def length(self) -> int:
        return self.end1 - self.start1 + 1

    def seq(self, ref: Reference) -> str:
        if self._seq is None:
            self._seq = ref.fetch(self.chrom, self.start1, self.end1)
        return self._seq

    def to_samtools(self) -> str:
        if ":" in self.chrom:
            return f"{{{self.chrom}}}:{self.start1}-{self.end1}"
        return f"{self.chrom}:{self.start1}-{self.end1}"


def step_size(params: WindowParams) -> int:
    val = (100 - params.pct_overlap) / 100.0 * params.window_length
    return int(math.ceil(val / 100.0) * 100)


def _is_decoy(name: str) -> bool:
    """Heuristic decoy/alt filter for whole-reference runs (reference:
    window_builder.cpp:36-57 skips decoys when no regions are given)."""
    return (
        "_" in name
        or name.endswith(("EBV", "hs37d5"))
        or name in ("chrM", "MT", "M")
    )


class WindowBuilder:
    def __init__(self, ref: Reference, params: WindowParams | None = None):
        self.ref = ref
        self.params = params or WindowParams()
        self.input_regions: list[tuple[str, int, int]] = []  # (chrom, start1, end1)

    def add_region_spec(self, spec: str) -> None:
        region = self.ref.parse_region(spec)
        self.input_regions.append((region.chrom, region.start1, region.end1))

    def add_bed_file(self, path: str) -> None:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith(("#", "track", "browser")):
                    continue
                fields = line.split("\t")
                chrom, start0, end1 = fields[0], int(fields[1]), int(fields[2])
                self.input_regions.append((chrom, start0 + 1, end1))

    def add_whole_reference(self) -> None:
        for info in self.ref.list_chroms():
            if not _is_decoy(info.name):
                self.input_regions.append((info.name, 1, info.length))

    def _pad_region(self, chrom: str, start1: int, end1: int) -> tuple[int, int]:
        info = self.ref.find_chrom(chrom)
        pad = self.params.region_padding
        start1 = 1 if start1 <= pad else start1 - pad
        end1 = info.length if end1 > info.length or info.length - end1 <= pad else end1 + pad
        # widen to at least one window length
        if end1 - start1 + 1 < self.params.window_length:
            diff = abs((end1 - start1 + 1) - self.params.window_length - 1)
            left_new = start1 - 1 if diff // 2 > start1 else start1 - diff // 2
            left_flank = start1 - left_new
            start1 = start1 - left_flank
            end1 = min(info.length, end1 + (diff - left_flank))
        return start1, end1

    def sort_input_regions(self) -> None:
        def key(region):
            chrom, start1, end1 = region
            try:
                idx = self.ref.find_chrom(chrom).index
            except KeyError:
                idx = -1
            return (idx, start1, end1)

        self.input_regions.sort(key=key)
        deduped = []
        for region in self.input_regions:
            if not deduped or deduped[-1] != region:
                deduped.append(region)
        self.input_regions = deduped

    def expected_target_windows(self) -> int:
        step = step_size(self.params)
        wl = self.params.window_length
        total = 0
        for chrom, s, e in self.input_regions:
            ps, pe = self._pad_region(chrom, s, e)
            rlen = pe - ps + 1
            total += 1 if rlen <= wl else (rlen - wl) // step + 1
        return total

    def build_windows(self) -> list[Window]:
        """Monolithic window generation, genomically sorted + indexed."""
        step = step_size(self.params)
        wl = self.params.window_length
        seen = set()
        windows: list[Window] = []
        for chrom, s, e in self.input_regions:
            info = self.ref.find_chrom(chrom)
            ps, pe = self._pad_region(chrom, s, e)
            if pe - ps + 1 <= wl:
                key = (info.index, ps, pe)
                if key not in seen:
                    seen.add(key)
                    windows.append(Window(chrom, info.index, ps, pe))
                continue
            start = ps
            while start + wl <= pe:
                key = (info.index, start, start + wl)
                if key not in seen:
                    seen.add(key)
                    windows.append(Window(chrom, info.index, start, start + wl))
                start += step
        windows.sort(key=lambda w: (w.chrom_index, w.start1, w.end1))
        for idx, w in enumerate(windows):
            w.genome_index = idx
        return windows

    def iter_windows(self):
        """Streaming window generation: same windows, same order, same
        genome indices as build_windows(), without materializing the list.

        WGS-scale runs (~3M windows) keep O(cluster) memory: padded input
        regions are grouped into overlapping clusters per contig; within a
        cluster the per-region window streams are heap-merged (duplicates
        from identical (chrom, start, end) keys become adjacent and are
        dropped); across clusters windows are already strictly ordered.
        Reference: core/pipeline_executor.cpp:137-150 streams 65,536-window
        batches for the same reason.
        """
        import heapq

        step = step_size(self.params)
        wl = self.params.window_length

        def region_windows(chrom, idx, ps, pe):
            if pe - ps + 1 <= wl:
                yield (idx, ps, pe, chrom)
                return
            start = ps
            while start + wl <= pe:
                yield (idx, start, start + wl, chrom)
                start += step

        # padded regions, genomically sorted (input_regions already sorted)
        padded = []
        for chrom, s, e in self.input_regions:
            info = self.ref.find_chrom(chrom)
            ps, pe = self._pad_region(chrom, s, e)
            padded.append((info.index, ps, pe, chrom))
        padded.sort(key=lambda r: (r[0], r[1], r[2]))

        genome_index = 0
        cluster: list = []
        cluster_end = None

        def flush_cluster():
            nonlocal genome_index
            streams = [region_windows(c, i, ps, pe) for (i, ps, pe, c) in cluster]
            last_key = None
            for idx, s1, e1, chrom in heapq.merge(
                *streams, key=lambda t: (t[0], t[1], t[2])
            ):
                key = (idx, s1, e1)
                if key == last_key:
                    continue
                last_key = key
                yield Window(chrom, idx, s1, e1, genome_index=genome_index)
                genome_index += 1

        for reg in padded:
            idx, ps, pe, chrom = reg
            if cluster and (idx != cluster[-1][0] or ps > cluster_end):
                yield from flush_cluster()
                cluster = []
            cluster.append(reg)
            cluster_end = pe if cluster_end is None or len(cluster) == 1 else max(cluster_end, pe)
        if cluster:
            yield from flush_cluster()

