"""BAI index: build, load, query + index-backed streaming BAM reader.

The reference relies on htslib's BAI/CSI random access (reference:
src/lancet/hts/extractor.{h,cpp} uses `sam_itr_querys` over `hts_idx_t`);
this module implements the same capability against the SAM spec's BAI
section directly: 6-level R-tree binning (16 kb leaf bins), a 16 kb linear
index, and BGZF virtual offsets (`coffset << 16 | uoffset`).

Two access modes compose with hts/bam.py:
  * `BamReader` (default): whole-file decode, in-memory binary-searched
    region queries — fastest when thousands of windows hit one contig.
  * `BamStreamReader` (here): header-only startup; each `fetch` seeks to
    the BAI chunk list and inflates only the BGZF blocks it covers —
    bounded memory on multi-GB inputs, with an LRU block cache.

`build_bai` writes htslib-compatible `.bai` files (metadata pseudo-bin
37450 + `n_no_coor` included), so indices made here work with samtools
and vice versa.
"""

from __future__ import annotations

import os
import struct
from collections import OrderedDict

import numpy as np

from lancet2_tpu_torch.hts import bgzf
from lancet2_tpu_torch.hts.bam import (
    BamRecord,
    parse_bam_header,
    parse_one_record,
)
from lancet2_tpu_torch.hts.cigar import CONSUMES_REF

from lancet2_tpu_torch.hts.uri import hts_open

BAI_MAGIC = b"BAI\x01"
LINEAR_SHIFT = 14  # 16 kb linear-index windows
META_BIN = 37450  # metadata pseudo-bin (SAM spec section 5.2)


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end) (SAM spec section 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins overlapping [beg, end) across the 6 levels."""
    out = [0]
    end -= 1
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return out


class BaiIndex:
    """Parsed .bai: per-ref {bin: [(vbeg, vend), ...]} + linear index."""

    def __init__(self, n_ref: int):
        self.bins: list[dict[int, list[tuple[int, int]]]] = [dict() for _ in range(n_ref)]
        self.linear: list[np.ndarray] = [np.zeros(0, np.uint64) for _ in range(n_ref)]
        self.n_no_coor = 0

    # ---- query -------------------------------------------------------
    def chunks_for_region(self, rid: int, beg0: int, end0: int) -> list[tuple[int, int]]:
        """Merged, sorted virtual-offset chunks that may contain records
        overlapping [beg0, end0) on reference `rid`."""
        if rid < 0 or rid >= len(self.bins) or end0 <= beg0:
            return []
        bindict = self.bins[rid]
        linear = self.linear[rid]
        widx = beg0 >> LINEAR_SHIFT
        min_off = int(linear[widx]) if widx < len(linear) else (
            int(linear[-1]) if len(linear) else 0
        )
        chunks = []
        for b in reg2bins(beg0, end0):
            for vbeg, vend in bindict.get(b, ()):
                if vend > min_off:
                    chunks.append((max(vbeg, min_off), vend))
        chunks.sort()
        merged: list[tuple[int, int]] = []
        for vbeg, vend in chunks:
            # merge chunks that touch the same compressed block
            if merged and (vbeg >> 16) <= (merged[-1][1] >> 16):
                merged[-1] = (merged[-1][0], max(merged[-1][1], vend))
            else:
                merged.append((vbeg, vend))
        return merged

    # ---- serialization ----------------------------------------------
    def save(self, path: str) -> None:
        out = bytearray(BAI_MAGIC)
        out += struct.pack("<i", len(self.bins))
        for rid in range(len(self.bins)):
            bindict = self.bins[rid]
            out += struct.pack("<i", len(bindict))
            for b in sorted(bindict):
                chunks = bindict[b]
                out += struct.pack("<Ii", b, len(chunks))
                for vbeg, vend in chunks:
                    out += struct.pack("<QQ", vbeg, vend)
            linear = self.linear[rid]
            out += struct.pack("<i", len(linear))
            out += linear.astype("<u8").tobytes()
        out += struct.pack("<Q", self.n_no_coor)
        with open(path, "wb") as fh:
            fh.write(bytes(out))

    @classmethod
    def load(cls, path: str) -> "BaiIndex":
        data = hts_open(path, "rb").read()
        if data[:4] != BAI_MAGIC:
            raise ValueError(f"{path} is not a BAI index")
        (n_ref,) = struct.unpack_from("<i", data, 4)
        idx = cls(n_ref)
        off = 8
        for rid in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = [
                    struct.unpack_from("<QQ", data, off + 16 * c) for c in range(n_chunk)
                ]
                off += 16 * n_chunk
                idx.bins[rid][b] = [(int(x), int(y)) for x, y in chunks]
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            idx.linear[rid] = np.frombuffer(data, dtype="<u8", count=n_intv, offset=off).copy()
            off += 8 * n_intv
        if off + 8 <= len(data):
            (idx.n_no_coor,) = struct.unpack_from("<Q", data, off)
        return idx


def _record_end0(data, off: int) -> tuple[int, int, int, int]:
    """(ref_id, pos0, end0, offset_after) without full record materialization."""
    (
        block_size, ref_id, pos, l_read_name, _mapq, _bin, n_cigar, _flag,
        _l_seq, _next_ref, _next_pos, _tlen,
    ) = struct.unpack_from("<iiiBBHHHiiii", data, off)
    p = off + 36 + l_read_name
    span = 0
    for c in struct.unpack_from(f"<{n_cigar}I", data, p):
        if (c & 0xF) in CONSUMES_REF:
            span += c >> 4
    return ref_id, pos, pos + max(span, 1), off + 4 + block_size


def build_bai(bam_path: str, out_path: str | None = None) -> str:
    """Index a coordinate-sorted BAM; returns the .bai path.

    Inflates the file block-by-block (one pass); virtual offsets come from
    mapping each record's uncompressed start offset back to its containing
    block's compressed offset.
    """
    out_path = out_path or bam_path + ".bai"
    block_ustarts = [0]
    block_coffsets = []
    chunks = []
    with hts_open(bam_path, "rb") as fh:
        while True:
            coffset = fh.tell()
            block = bgzf._read_block(fh)
            if block is None:
                break
            block_coffsets.append(coffset)
            block_ustarts.append(block_ustarts[-1] + len(block))
            chunks.append(block)
    data = b"".join(chunks)
    ustarts = np.array(block_ustarts[:-1], dtype=np.int64)
    coffs = np.array(block_coffsets, dtype=np.int64)
    eof_coffset = int(coffs[-1]) if len(coffs) else 0  # last block = BGZF EOF

    def voffset(u: int) -> int:
        i = int(np.searchsorted(ustarts, u, side="right")) - 1
        return (int(coffs[i]) << 16) | (u - int(ustarts[i]))

    _header, references, off = parse_bam_header(data)
    n_ref = len(references)
    idx = BaiIndex(n_ref)
    pending: list[dict[int, list[tuple[int, int]]]] = idx.bins
    linear_min: list[dict[int, int]] = [dict() for _ in range(n_ref)]
    stats = [
        {"vbeg": None, "vend": 0, "mapped": 0, "unmapped": 0} for _ in range(n_ref)
    ]

    n = len(data)
    while off + 4 <= n:
        ustart = off
        ref_id, pos0, end0, off = _record_end0(data, off)
        if ref_id < 0:
            idx.n_no_coor += 1
            continue
        vbeg, vend = voffset(ustart), voffset(off)
        flag = struct.unpack_from("<H", data, ustart + 18)[0]
        st = stats[ref_id]
        if st["vbeg"] is None:
            st["vbeg"] = vbeg
        st["vend"] = vend
        if flag & 0x4:
            st["unmapped"] += 1
        else:
            st["mapped"] += 1
        b = reg2bin(pos0, end0)
        blist = pending[ref_id].setdefault(b, [])
        if blist and (vbeg >> 16) <= (blist[-1][1] >> 16):
            blist[-1] = (blist[-1][0], vend)
        else:
            blist.append((vbeg, vend))
        lmin = linear_min[ref_id]
        for w in range(pos0 >> LINEAR_SHIFT, (end0 - 1 >> LINEAR_SHIFT) + 1):
            if w not in lmin or vbeg < lmin[w]:
                lmin[w] = vbeg

    eof_voffset = eof_coffset << 16
    for rid in range(n_ref):
        lmin = linear_min[rid]
        if lmin:
            size = max(lmin) + 1
            arr = np.zeros(size, dtype=np.uint64)
            fill = 0
            for w in range(size):
                fill = lmin.get(w, fill)  # back-fill gaps with the prior offset
                arr[w] = fill
            idx.linear[rid] = arr
        st = stats[rid]
        if st["vbeg"] is not None:
            # metadata pseudo-bin: file span + mapped/unmapped counts
            pending[rid][META_BIN] = [
                (st["vbeg"], st["vend"] or eof_voffset),
                (st["mapped"], st["unmapped"]),
            ]
    idx.save(out_path)
    return out_path


class _LruBlockCache:
    def __init__(self, fh, capacity: int = 512, path: str | None = None):
        import os

        self._fh = fh
        self._path = path or getattr(fh, "name", None)
        self._pid = os.getpid()
        self._cap = capacity
        self._cache: OrderedDict[int, tuple[bytes, int]] = OrderedDict()

    def _file(self):
        """Fork-safe handle: a forked child shares the parent's seek offset
        (same OS open-file description) — each process reopens its own.
        Cached inflated blocks are immutable and stay valid across forks."""
        import os

        if os.getpid() != self._pid:
            if self._path is None:
                raise RuntimeError(
                    "streaming reader used after fork without a reopenable path"
                )
            from lancet2_tpu_torch.hts.uri import hts_open

            self._fh = hts_open(self._path, "rb")
            self._pid = os.getpid()
        return self._fh

    def block_at(self, coffset: int) -> tuple[bytes, int]:
        """(inflated payload, next block's coffset)."""
        hit = self._cache.get(coffset)
        if hit is not None:
            self._cache.move_to_end(coffset)
            return hit
        fh = self._file()
        fh.seek(coffset)
        data = bgzf._read_block(fh)
        if data is None:
            data = b""
        entry = (data, fh.tell())
        self._cache[coffset] = entry
        if len(self._cache) > self._cap:
            self._cache.popitem(last=False)
        return entry


class _ChunkCursor:
    """Byte reader across BGZF block boundaries starting at a voffset."""

    def __init__(self, cache: _LruBlockCache, voffset: int):
        self._cache = cache
        self._coffset = voffset >> 16
        self._uoff = voffset & 0xFFFF
        self._buf = bytearray()
        self._buf_base_voffset = voffset

    @property
    def voffset(self) -> int:
        """Virtual offset of the next unconsumed byte."""
        return self._buf_base_voffset

    def _fill(self, need: int) -> bool:
        while len(self._buf) < need:
            data, nxt = self._cache.block_at(self._coffset)
            if not data and self._uoff == 0:
                return False  # clean EOF
            self._buf += data[self._uoff :]
            self._coffset, self._uoff = nxt, 0
        return True

    def peek(self, n: int):
        if not self._fill(n):
            return None
        return self._buf[:n]

    def consume(self, n: int) -> None:
        del self._buf[:n]
        # voffsets advance linearly within a block and jump at boundaries;
        # walk the (cached) block chain to find the new head's voffset
        self._buf_base_voffset = self._advance(self._buf_base_voffset, n)

    def _advance(self, voffset: int, n: int) -> int:
        coffset, uoff = voffset >> 16, voffset & 0xFFFF
        while n > 0:
            data, nxt = self._cache.block_at(coffset)
            avail = len(data) - uoff
            if n < avail:
                return (coffset << 16) | (uoff + n)
            n -= avail
            coffset, uoff = nxt, 0
            if not data:
                break
        return coffset << 16


class BamStreamReader:
    """Index-backed streaming reader with the BamReader query interface.

    Startup inflates only the header blocks; `fetch` touches only the BGZF
    blocks the BAI chunk list names. Builds the .bai on demand (one-time
    full pass) when missing.
    """

    def __init__(self, path: str, bai_path: str | None = None,
                 cache_blocks: int = 512):
        self.path = path
        self._fh = hts_open(path, "rb")
        self._cache = _LruBlockCache(self._fh, cache_blocks, path=path)
        buf = bytearray()
        coffset = 0
        while True:
            data, nxt = self._cache.block_at(coffset)
            if not data:
                raise ValueError(f"{path}: EOF before complete BAM header")
            buf += data
            coffset = nxt
            try:
                self.header_text, self.references, hdr_end = parse_bam_header(buf)
                break
            except (IndexError, struct.error):
                continue
        self._first_record_voffset = _ChunkCursor(self._cache, 0)._advance(0, hdr_end)
        self._ref_index = {name: i for i, (name, _) in enumerate(self.references)}

        bai_path = bai_path or _find_bai(path)
        if bai_path is None:
            bai_path = build_bai(path)
        if bai_path.endswith(".csi"):
            from lancet2_tpu_torch.hts.csi import CsiIndex

            self.index = CsiIndex.load(bai_path)
        else:
            self.index = BaiIndex.load(bai_path)

    def ref_name(self, ref_id: int) -> str:
        return self.references[ref_id][0] if 0 <= ref_id < len(self.references) else "*"

    def ref_id(self, name: str) -> int:
        return self._ref_index.get(name, -1)

    def _records_from(self, voffset: int, stop_voffset: int | None = None):
        cursor = _ChunkCursor(self._cache, voffset)
        while True:
            if stop_voffset is not None and cursor.voffset >= stop_voffset:
                return
            head = cursor.peek(4)
            if head is None or len(head) < 4:
                return
            (block_size,) = struct.unpack("<i", bytes(head))
            body = cursor.peek(4 + block_size)
            if body is None:
                return
            rec, _ = parse_one_record(bytes(body), 0)
            cursor.consume(4 + block_size)
            yield rec

    def all_records(self):
        """Sequential generator over every record (lazy; callers that stop
        early — e.g. the MD-tag probe — only pay for what they consume)."""
        yield from self._records_from(self._first_record_voffset)

    def fetch(self, chrom: str, start1: int, end1: int) -> list[BamRecord]:
        """All records overlapping [start1, end1] (1-based inclusive)."""
        rid = self.ref_id(chrom)
        beg0, end0 = start1 - 1, end1
        out = []
        for vbeg, vend in self.index.chunks_for_region(rid, beg0, end0):
            for rec in self._records_from(vbeg, vend):
                if rec.ref_id != rid or rec.pos0 >= end0:
                    break  # coordinate-sorted: nothing after can overlap
                if rec.reference_end0() > beg0:
                    out.append(rec)
        return out

    def close(self) -> None:
        self._fh.close()


def _find_bai(bam_path: str) -> str | None:
    stem = os.path.splitext(bam_path)[0]
    for cand in (bam_path + ".bai", stem + ".bai",
                 bam_path + ".csi", stem + ".csi"):
        if os.path.exists(cand):
            return cand
    return None
