"""CSI v1 index: the BAI generalization for contigs >= 2^29 bp.

Same binning scheme as BAI but with configurable min_shift/depth (SAM spec
section 5.2; defaults 14/5 reproduce BAI's 6-level 512 Mbp addressing;
14/6 covers 4 Gbp). Instead of a linear index, each bin carries `loffset` —
the smallest virtual offset of any record in or below the bin, used to
prune chunk lists exactly like BAI's 16 kb linear index.

The index payload is BGZF-compressed (htslib-compatible .csi files).
Reference parity: htslib CSI support used by the reference's Extractor for
long-contig assemblies (SURVEY.md §2 L2); listed as a gap in
docs/ARCHITECTURE.md until now.
"""

from __future__ import annotations

import struct

from lancet2_tpu_torch.hts import bgzf
from lancet2_tpu_torch.hts.bai import _record_end0
from lancet2_tpu_torch.hts.bam import parse_bam_header

from lancet2_tpu_torch.hts.uri import hts_open

CSI_MAGIC = b"CSI\x01"


def reg2bin_csi(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> int:
    """Smallest CSI bin containing [beg, end)."""
    end -= 1
    s = min_shift
    t = ((1 << (depth * 3)) - 1) // 7
    level = depth
    while level > 0:
        if beg >> s == end >> s:
            return t + (beg >> s)
        level -= 1
        s += 3
        t -= 1 << (level * 3)
    return 0


def reg2bins_csi(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> list[int]:
    """All CSI bins overlapping [beg, end) across depth+1 levels."""
    out = []
    end -= 1
    s = min_shift + depth * 3
    t = 0
    for level in range(depth + 1):
        out.extend(range(t + (beg >> s), t + (end >> s) + 1))
        t += 1 << (level * 3)
        s -= 3
    return out


class CsiIndex:
    """Parsed .csi: per-ref {bin: (loffset, [(vbeg, vend), ...])}."""

    def __init__(self, n_ref: int, min_shift: int = 14, depth: int = 5):
        self.min_shift = min_shift
        self.depth = depth
        self.bins: list[dict[int, tuple[int, list[tuple[int, int]]]]] = [
            dict() for _ in range(n_ref)
        ]
        self.n_no_coor = 0

    # ---- query -------------------------------------------------------
    def _min_offset(self, rid: int, beg0: int) -> int:
        """loffset of the deepest populated bin containing beg0 (walk up)."""
        bindict = self.bins[rid]
        s = self.min_shift
        t = ((1 << (self.depth * 3)) - 1) // 7
        level = self.depth
        while level >= 0:
            b = t + (beg0 >> s) if level > 0 else 0
            ent = bindict.get(b)
            if ent is not None:
                return ent[0]
            level -= 1
            s += 3
            t -= 1 << (level * 3) if level >= 0 else 0
        return 0

    def chunks_for_region(self, rid: int, beg0: int, end0: int) -> list[tuple[int, int]]:
        if rid < 0 or rid >= len(self.bins) or end0 <= beg0:
            return []
        bindict = self.bins[rid]
        min_off = self._min_offset(rid, beg0)
        chunks = []
        for b in reg2bins_csi(beg0, end0, self.min_shift, self.depth):
            ent = bindict.get(b)
            if ent is None:
                continue
            for vbeg, vend in ent[1]:
                if vend > min_off:
                    chunks.append((max(vbeg, min_off), vend))
        chunks.sort()
        merged: list[tuple[int, int]] = []
        for vbeg, vend in chunks:
            if merged and (vbeg >> 16) <= (merged[-1][1] >> 16):
                merged[-1] = (merged[-1][0], max(merged[-1][1], vend))
            else:
                merged.append((vbeg, vend))
        return merged

    # ---- serialization ----------------------------------------------
    def save(self, path: str) -> None:
        out = bytearray(CSI_MAGIC)
        out += struct.pack("<iii", self.min_shift, self.depth, 0)  # no aux
        out += struct.pack("<i", len(self.bins))
        for bindict in self.bins:
            out += struct.pack("<i", len(bindict))
            for b in sorted(bindict):
                loff, chunks = bindict[b]
                out += struct.pack("<IQi", b, loff, len(chunks))
                for vbeg, vend in chunks:
                    out += struct.pack("<QQ", vbeg, vend)
        out += struct.pack("<Q", self.n_no_coor)
        with bgzf.BgzfWriter(path) as fh:
            fh.write(bytes(out))

    @classmethod
    def load(cls, path: str) -> "CsiIndex":
        data = bgzf.decompress_file(path)
        if data[:4] != CSI_MAGIC:
            raise ValueError(f"{path} is not a CSI index")
        min_shift, depth, l_aux = struct.unpack_from("<iii", data, 4)
        off = 16 + l_aux
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        idx = cls(n_ref, min_shift, depth)
        for rid in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            for _ in range(n_bin):
                b, loff, n_chunk = struct.unpack_from("<IQi", data, off)
                off += 16
                chunks = [
                    tuple(map(int, struct.unpack_from("<QQ", data, off + 16 * c)))
                    for c in range(n_chunk)
                ]
                off += 16 * n_chunk
                idx.bins[rid][b] = (int(loff), chunks)
        if off + 8 <= len(data):
            (idx.n_no_coor,) = struct.unpack_from("<Q", data, off)
        return idx


def build_csi(bam_path: str, out_path: str | None = None,
              min_shift: int = 14, depth: int = 5) -> str:
    """Index a coordinate-sorted BAM with CSI binning; returns the .csi path."""
    import numpy as np

    out_path = out_path or bam_path + ".csi"
    block_ustarts = [0]
    block_coffsets = []
    parts = []
    with hts_open(bam_path, "rb") as fh:
        while True:
            coffset = fh.tell()
            block = bgzf._read_block(fh)
            if block is None:
                break
            block_coffsets.append(coffset)
            block_ustarts.append(block_ustarts[-1] + len(block))
            parts.append(block)
    data = b"".join(parts)
    ustarts = np.array(block_ustarts[:-1], dtype=np.int64)
    coffs = np.array(block_coffsets, dtype=np.int64)

    def voffset(u: int) -> int:
        i = int(np.searchsorted(ustarts, u, side="right")) - 1
        return (int(coffs[i]) << 16) | (u - int(ustarts[i]))

    _header, references, off = parse_bam_header(data)
    idx = CsiIndex(len(references), min_shift, depth)
    # per-(1<<min_shift)-window min voffset over the FULL [pos0, end0) span of
    # every record (htslib semantics, matching bai.build_bai) — a record that
    # crosses a window boundary must lower the loffset of every window it
    # touches, or ancestor-bin chunks get wrongly pruned in chunks_for_region.
    linear_min: list[dict[int, int]] = [dict() for _ in range(len(references))]

    n = len(data)
    while off + 4 <= n:
        ustart = off
        ref_id, pos0, end0, off = _record_end0(data, off)
        if ref_id < 0:
            idx.n_no_coor += 1
            continue
        vbeg, vend = voffset(ustart), voffset(off)
        b = reg2bin_csi(pos0, end0, min_shift, depth)
        ent = idx.bins[ref_id].get(b)
        if ent is None:
            idx.bins[ref_id][b] = (0, [(vbeg, vend)])
        else:
            loff, blist = ent
            if blist and (vbeg >> 16) <= (blist[-1][1] >> 16):
                blist[-1] = (blist[-1][0], vend)
            else:
                blist.append((vbeg, vend))
        lmin = linear_min[ref_id]
        for w in range(pos0 >> min_shift, ((end0 - 1) >> min_shift) + 1):
            if w not in lmin or vbeg < lmin[w]:
                lmin[w] = vbeg

    # seed each bin's loffset from the back-filled window map at the bin's
    # interval start (the value the query's _min_offset walk will read)
    t_of_level = []
    t = 0
    for level in range(depth + 1):
        t_of_level.append(t)
        t += 1 << (level * 3)
    for rid, bindict in enumerate(idx.bins):
        lmin = linear_min[rid]
        if not lmin:
            continue
        size = max(lmin) + 1
        filled = [0] * size
        fill = 0
        for w in range(size):
            fill = lmin.get(w, fill)  # back-fill gaps with the prior offset
            filled[w] = fill
        for b, (_, blist) in bindict.items():
            level = depth
            while level > 0 and b < t_of_level[level]:
                level -= 1
            start_win = (b - t_of_level[level]) << ((depth - level) * 3)
            loff = filled[min(start_win, size - 1)]
            bindict[b] = (loff, blist)
    idx.save(out_path)
    return out_path
