"""Multi-host window-manifest sharding + host-side VCF shard merge.

The reference is single-process; users shard WGS runs manually by region
(SURVEY.md §5). The TPU-native scale-out (BASELINE.json north star) shards
the window manifest statically across hosts — windows are embarrassingly
parallel, so no runtime communication is needed: each host runs the full
pipeline over its contiguous window span with its own BAM readers, writes a
VCF shard, and process 0 merges shards in genomic order (the same
dedup-by-coverage rule the in-process store applies at overlap boundaries).

Contiguous (block) assignment keeps each host's windows genomically local so
per-host BAM decode stays sequential, and makes the merged VCF a simple
ordered concatenation with boundary dedup.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass


@dataclass(frozen=True)
class ManifestShard:
    host_index: int
    num_hosts: int
    start: int  # first window index (inclusive)
    stop: int  # last window index (exclusive)


def shard_manifest(num_windows: int, num_hosts: int) -> list[ManifestShard]:
    """Contiguous block partition of [0, num_windows) across hosts."""
    base = num_windows // num_hosts
    extra = num_windows % num_hosts
    shards = []
    start = 0
    for h in range(num_hosts):
        size = base + (1 if h < extra else 0)
        shards.append(ManifestShard(h, num_hosts, start, start + size))
        start += size
    return shards


def windows_for_host(windows: list, host_index: int, num_hosts: int) -> list:
    shard = shard_manifest(len(windows), num_hosts)[host_index]
    return windows[shard.start : shard.stop]


def _record_key(line: str) -> tuple:
    cols = line.split("\t", 4)
    return (cols[0], int(cols[1]), cols[3])


def _record_depth(line: str) -> int:
    """Total DP across samples (for cross-shard dedup-by-coverage)."""
    cols = line.rstrip("\n").split("\t")
    fmt = cols[8].split(":")
    try:
        dp_idx = fmt.index("DP")
    except ValueError:
        return 0
    total = 0
    for sample in cols[9:]:
        fields = sample.split(":")
        if dp_idx < len(fields) and fields[dp_idx].isdigit():
            total += int(fields[dp_idx])
    return total


def merge_vcf_shards(shard_paths: list[str], out_path: str, contig_order: list[str]) -> int:
    """Merge per-host VCF shards into one sorted bgzip VCF.

    The header is taken from the first shard. Overlap-boundary duplicates
    (same CHROM+POS+REF across neighboring shards) keep the higher-depth
    record (reference: variant_store.cpp dedup rule).
    """
    from lancet2_tpu_torch.hts.bgzf import BgzfWriter

    chrom_rank = {name: i for i, name in enumerate(contig_order)}
    header: list[str] = []
    by_key: dict[tuple, str] = {}
    for si, path in enumerate(shard_paths):
        with gzip.open(path, "rt") as fh:
            for line in fh:
                if line.startswith("#"):
                    if si == 0:
                        header.append(line)
                    continue
                key = _record_key(line)
                prev = by_key.get(key)
                if prev is None or _record_depth(line) > _record_depth(prev):
                    by_key[key] = line

    records = sorted(
        by_key.items(), key=lambda kv: (chrom_rank.get(kv[0][0], 1 << 30), kv[0][1], kv[0][2])
    )
    out = BgzfWriter(out_path)
    try:
        for line in header:
            out.write(line.encode())
        for _key, line in records:
            out.write(line.encode())
    finally:
        out.close()
    return len(records)
