"""CRAI index: build / load / query (CRAM spec appendix; reference parity:
htslib cram_index.c — the reference fetches CRAM regions via .crai-seeked
containers, hts/extractor.cpp).

A .crai is gzip-compressed text, one line per slice, six tab-separated
columns:

  ref_id  alignment_start(1-based)  alignment_span
  container_byte_offset             slice_byte_offset(within container data)
  slice_size_bytes

Query returns the container offsets whose slices overlap a region; the
CramReader maps offsets to its container table and decodes only those.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

from lancet2_tpu_torch.hts.uri import hts_open


@dataclass(frozen=True)
class CraiEntry:
    ref_id: int
    start1: int
    span: int
    container_offset: int
    slice_offset: int
    slice_size: int


def build_crai(cram_path: str, out_path: str | None = None) -> list[CraiEntry]:
    """Scan container + slice headers of a CRAM and write `.crai`.

    Only headers are parsed — slice data blocks are never decompressed, so
    indexing is IO-bound like htslib's cram_index_build."""
    from lancet2_tpu_torch.hts.cram import (
        CRAM_MAGIC,
        Block,
        ContainerHeader,
        SliceHeader,
    )

    data = hts_open(cram_path, "rb").read()
    if data[:4] != CRAM_MAGIC:
        raise ValueError(f"{cram_path}: not a CRAM file")
    p = 26  # magic + version + file id
    # skip SAM header container
    ch, q = ContainerHeader.parse(data, p)
    p = q + ch.length

    entries: list[CraiEntry] = []
    while p < len(data):
        ch, q = ContainerHeader.parse(data, p)
        if ch.ref_id == -1 and ch.nrecords == 0 and ch.start1 == 4542278:
            break  # EOF container
        end = q + ch.length
        # landmarks are slice-start offsets within the container data;
        # block 0 is the compression header
        _comp_blk, bp = Block.parse(data, q)
        for li, lm in enumerate(ch.landmarks):
            s_off = q + lm
            sh_blk, sb = Block.parse(data, s_off)
            sh = SliceHeader.parse(sh_blk.data)
            next_lm = (
                q + ch.landmarks[li + 1] if li + 1 < len(ch.landmarks) else end
            )
            entries.append(
                CraiEntry(
                    ref_id=sh.ref_id,
                    start1=sh.start1,
                    span=sh.span,
                    container_offset=p,
                    slice_offset=lm,
                    slice_size=next_lm - s_off,
                )
            )
        p = end

    if out_path is None:
        out_path = cram_path + ".crai"
    lines = "".join(
        f"{e.ref_id}\t{e.start1}\t{e.span}\t{e.container_offset}\t"
        f"{e.slice_offset}\t{e.slice_size}\n"
        for e in entries
    )
    with hts_open(out_path, "wb") as fh:
        fh.write(gzip.compress(lines.encode()))
    return entries


def load_crai(path: str) -> list[CraiEntry]:
    raw = hts_open(path, "rb").read()
    text = gzip.decompress(raw).decode()
    entries = []
    for line in text.splitlines():
        if not line:
            continue
        f = line.split("\t")
        entries.append(CraiEntry(int(f[0]), int(f[1]), int(f[2]),
                                 int(f[3]), int(f[4]), int(f[5])))
    return entries


def query_crai(entries: list[CraiEntry], ref_id: int, start1: int,
               end1: int) -> list[CraiEntry]:
    """Slices overlapping [start1, end1] on ref_id. Multi-ref slices
    (ref_id == -2) always match — their true span needs a decode."""
    lo0, hi0 = start1 - 1, end1
    out = []
    for e in entries:
        if e.ref_id == -2:
            out.append(e)
            continue
        if e.ref_id != ref_id:
            continue
        c_lo0 = e.start1 - 1
        if c_lo0 + e.span <= lo0 or c_lo0 >= hi0:
            continue
        out.append(e)
    return out
