"""BAM container reader/writer in pure Python (numpy-assisted).

The execution image has neither htslib nor pysam, so BAM decode/encode is
implemented against the SAM/BAM spec directly. This replaces the role of the
reference's `hts::Extractor` / `hts::Alignment` (reference:
src/lancet/hts/extractor.{h,cpp}, alignment.{h,cpp}).

Design notes (TPU-first pipeline):
  * Whole-file decode into per-contig, start-sorted in-memory record arrays;
    region queries are then binary searches. Windows are served thousands of
    times per contig, so one linear decode amortizes far better than htslib's
    per-window BGZF seeks. The port's C++ decoder (csrc/bam_decoder.cpp via
    hts.native) parses records into columns when it builds.
  * Field decode is lazy-ish: seq/qual are kept as raw packed bytes until a
    record is actually collected for assembly (mirrors the reference's
    measured 3-4x lazy-decode win, SURVEY.md hts layer notes).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from lancet2_tpu_torch.hts import bgzf
from lancet2_tpu_torch.hts.cigar import Cigar, cigar_to_str, CONSUMES_REF

from lancet2_tpu_torch.hts.uri import hts_open

BAM_MAGIC = b"BAM\x01"

# 4-bit nibble code -> ASCII base (SAM spec table).
NIBBLE_BASES = "=ACMGRSVTWYHKDBN"
_NIBBLE_DECODE = np.frombuffer(NIBBLE_BASES.encode(), dtype=np.uint8)
_BASE_TO_NIBBLE = {ch: idx for idx, ch in enumerate(NIBBLE_BASES)}

FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800


@dataclass
class BamRecord:
    qname: str
    flag: int
    ref_id: int
    pos0: int  # 0-based leftmost
    mapq: int
    cigar: Cigar
    next_ref_id: int
    next_pos0: int
    tlen: int
    seq: str
    qual: np.ndarray  # uint8 phred values
    tags: dict[str, object]

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_duplicate(self) -> bool:
        return bool(self.flag & FLAG_DUP)

    @property
    def is_qcfail(self) -> bool:
        return bool(self.flag & FLAG_QCFAIL)

    @property
    def is_proper_pair(self) -> bool:
        return bool(self.flag & FLAG_PROPER_PAIR)

    @property
    def is_mate_mapped(self) -> bool:
        return not self.flag & FLAG_MATE_UNMAPPED

    @property
    def length(self) -> int:
        return len(self.seq)

    def reference_end0(self) -> int:
        """0-based exclusive end on the reference."""
        return self.pos0 + sum(l for op, l in self.cigar if op in CONSUMES_REF)


def _decode_seq(packed: bytes, l_seq: int) -> str:
    nib = np.frombuffer(packed, dtype=np.uint8)
    hi = nib >> 4
    lo = nib & 0x0F
    both = np.empty(nib.size * 2, dtype=np.uint8)
    both[0::2] = hi
    both[1::2] = lo
    return _NIBBLE_DECODE[both[:l_seq]].tobytes().decode("ascii")


def _encode_seq(seq: str) -> bytes:
    codes = np.fromiter(
        (_BASE_TO_NIBBLE.get(ch.upper(), 15) for ch in seq), dtype=np.uint8, count=len(seq)
    )
    if codes.size % 2:
        codes = np.append(codes, 0)
    return ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()


def _parse_aux(buf: bytes) -> dict[str, object]:
    tags: dict[str, object] = {}
    off = 0
    n = len(buf)
    while off + 3 <= n:
        tag = buf[off : off + 2].decode("ascii")
        typ = chr(buf[off + 2])
        off += 3
        if typ == "A":
            tags[tag] = chr(buf[off]); off += 1
        elif typ in "cC":
            tags[tag] = struct.unpack_from("<b" if typ == "c" else "<B", buf, off)[0]; off += 1
        elif typ in "sS":
            tags[tag] = struct.unpack_from("<h" if typ == "s" else "<H", buf, off)[0]; off += 2
        elif typ in "iI":
            tags[tag] = struct.unpack_from("<i" if typ == "i" else "<I", buf, off)[0]; off += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", buf, off)[0]; off += 4
        elif typ in "ZH":
            end = buf.index(b"\x00", off)
            tags[tag] = buf[off:end].decode("ascii")
            off = end + 1
        elif typ == "B":
            sub = chr(buf[off]); count = struct.unpack_from("<I", buf, off + 1)[0]
            off += 5
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            width = struct.calcsize(fmt)
            tags[tag] = list(struct.unpack_from(f"<{count}{fmt}", buf, off))
            off += count * width
        else:
            break  # unknown type: cannot continue safely
    return tags


class LazyTags:
    """Mapping view over raw aux bytes: the dict parse (_parse_aux) runs on
    first access only. Most consumers (read collection, assembly) never touch
    tags, so the columnar record path skips the per-record parse entirely."""

    __slots__ = ("_raw", "_dict")

    def __init__(self, raw: bytes):
        self._raw = raw
        self._dict: dict[str, object] | None = None

    def _materialize(self) -> dict[str, object]:
        # records are cached and shared by the threads executor's workers:
        # _dict is published before _raw is cleared, so a thread that reads
        # an emptied _raw finds _dict set when it looks again (the JAX
        # package's copy can parse b"" and publish empty tags)
        d = self._dict
        if d is None:
            raw = self._raw
            d = self._dict
            if d is None:
                d = _parse_aux(raw)
                self._dict = d
                self._raw = b""
        return d

    def get(self, key, default=None):
        return self._materialize().get(key, default)

    def __getitem__(self, key):
        return self._materialize()[key]

    def __contains__(self, key) -> bool:
        return key in self._materialize()

    def __iter__(self):
        return iter(self._materialize())

    def __len__(self) -> int:
        return len(self._materialize())

    def keys(self):
        return self._materialize().keys()

    def items(self):
        return self._materialize().items()

    def __eq__(self, other):
        if isinstance(other, LazyTags):
            other = other._materialize()
        return self._materialize() == other

    def __repr__(self) -> str:
        return f"LazyTags({self._materialize()!r})"


def _encode_aux(tags: dict[str, object]) -> bytes:
    out = bytearray()
    for tag, val in tags.items():
        out += tag.encode("ascii")
        if isinstance(val, bool):
            raise TypeError("bool aux values unsupported")
        if isinstance(val, int):
            out += b"i" + struct.pack("<i", val)
        elif isinstance(val, float):
            out += b"f" + struct.pack("<f", val)
        elif isinstance(val, str):
            out += b"Z" + val.encode("ascii") + b"\x00"
        elif isinstance(val, (list, tuple, np.ndarray)):
            arr = np.asarray(val, dtype=np.int32)
            out += b"B" + b"i" + struct.pack("<I", arr.size) + arr.astype("<i4").tobytes()
        else:
            raise TypeError(f"unsupported aux value type for {tag}: {type(val)}")
    return bytes(out)


_CORE_UNPACK = struct.Struct("<iiiBBHHHiiii").unpack_from


def parse_one_record(data, off: int) -> tuple[BamRecord, int]:
    """Parse the record starting at uncompressed offset `off`; returns
    (record, offset_after). `data` must contain the complete record."""
    (
        block_size, ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag,
        l_seq, next_ref, next_pos, tlen,
    ) = _CORE_UNPACK(data, off)
    start = off + 4
    end = start + block_size
    p = start + 32
    qname = bytes(data[p : p + l_read_name - 1]).decode("ascii")
    p += l_read_name
    cigar_raw = np.frombuffer(data, dtype="<u4", count=n_cigar, offset=p)
    cigar = [(int(c & 0xF), int(c >> 4)) for c in cigar_raw]
    p += 4 * n_cigar
    seq = _decode_seq(bytes(data[p : p + (l_seq + 1) // 2]), l_seq)
    p += (l_seq + 1) // 2
    qual = np.frombuffer(data, dtype=np.uint8, count=l_seq, offset=p).copy()
    p += l_seq
    tags = _parse_aux(bytes(data[p:end]))
    rec = BamRecord(
        qname, flag, ref_id, pos, mapq, cigar, next_ref, next_pos, tlen, seq, qual, tags
    )
    return rec, end


def parse_bam_header(data) -> tuple[str, list[tuple[str, int]], int]:
    """Parse magic + header text + reference list from uncompressed BAM bytes.

    Returns (header_text, references, offset_of_first_record). Raises
    IndexError/struct.error when `data` is too short (callers feeding
    streamed blocks catch and retry with more data).
    """
    if data[:4] != BAM_MAGIC:
        raise ValueError("not a BAM file")
    l_text = struct.unpack_from("<i", data, 4)[0]
    header_text = bytes(data[8 : 8 + l_text]).rstrip(b"\x00").decode("utf-8")
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    references: list[tuple[str, int]] = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        if off + 8 + l_name > len(data):
            raise IndexError("truncated reference list")
        name = bytes(data[off + 4 : off + 4 + l_name - 1]).decode("ascii")
        l_ref = struct.unpack_from("<i", data, off + 4 + l_name)[0]
        references.append((name, l_ref))
        off += 8 + l_name
    return header_text, references, off


def _is_cram(path: str) -> bool:
    with hts_open(path, "rb") as fh:
        return fh.read(4) == b"CRAM"


def read_bam_header(path: str) -> tuple[str, list[tuple[str, int]]]:
    """Header text + reference list by inflating only the leading BGZF
    blocks (cheap for multi-GB inputs; whole-file decode not required).
    Dispatches to the CRAM header parser for CRAM inputs."""
    if _is_cram(path):
        from lancet2_tpu_torch.hts.cram import read_cram_header

        return read_cram_header(path)
    buf = bytearray()
    with hts_open(path, "rb") as fh:
        while True:
            block = bgzf._read_block(fh)
            if block is None:
                raise ValueError(f"{path}: EOF before complete BAM header")
            buf += block
            try:
                header_text, references, _ = parse_bam_header(buf)
                return header_text, references
            except (IndexError, struct.error):
                continue  # need more blocks


def open_bam(path: str, stream: bool = False, ref: str | None = None):
    """Factory: in-memory BamReader (default), index-backed streaming
    reader (requires/creates a .bai; see hts/bai.py), or CramReader for
    CRAM inputs (detected by magic; needs `ref` for reference-based
    records — the same -r FASTA passed to the pipeline)."""
    if _is_cram(path):
        from lancet2_tpu_torch.hts.cram import CramReader

        return CramReader(path, ref)
    if stream:
        from lancet2_tpu_torch.hts.bai import BamStreamReader

        return BamStreamReader(path)
    return BamReader(path)


class BamReader:
    """Decode a BAM file into memory with per-contig region query support.

    Uses the port's native decoder (csrc/bam_decoder.cpp via
    lancet2_tpu_torch.hts.native) when it builds: BGZF inflation on threads
    + columnar record parse with lazy BamRecord materialization. Falls back
    to the pure-Python path (the correctness baseline) otherwise, or when
    `use_native` is False.
    """

    def __init__(self, path: str, use_native: bool = True):
        self.path = path
        from lancet2_tpu_torch.hts import native

        if use_native:
            with hts_open(path, "rb") as fh:
                data = native.bgzf_inflate(fh.read())
        else:
            data = bgzf.decompress_file(path)
        if data[:4] != BAM_MAGIC:
            raise ValueError(f"{path} is not a BAM file")
        l_text = struct.unpack_from("<i", data, 4)[0]
        self.header_text = data[8 : 8 + l_text].rstrip(b"\x00").decode("utf-8")
        off = 8 + l_text
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        self.references: list[tuple[str, int]] = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", data, off)[0]
            name = data[off + 4 : off + 4 + l_name - 1].decode("ascii")
            l_ref = struct.unpack_from("<i", data, off + 4 + l_name)[0]
            self.references.append((name, l_ref))
            off += 8 + l_name
        self._ref_index = {name: i for i, (name, _) in enumerate(self.references)}

        self._cols = native.parse_records(data, off) if use_native else None
        if self._cols is not None:
            self._rec_cache: dict[int, BamRecord] = {}
            self._records_raw = None
            self._ref_ends = self._compute_ref_ends()
        else:
            self._records_raw = self._parse_records(data, off)
        self._by_contig = None

    # ---- native columnar backend -------------------------------------
    def _compute_ref_ends(self) -> np.ndarray:
        """Vectorized reference_end0 for all records from the cigar pool."""
        cols = self._cols
        n = cols["count"]
        pool = cols["cigar_pool"]
        ops = pool & 0xF
        lens = pool >> 4
        # ref-consuming ops: M(0) D(2) N(3) =(7) X(8)
        consumes = np.isin(ops, (0, 2, 3, 7, 8))
        ref_lens = np.where(consumes, lens, 0).astype(np.int64)
        csum = np.concatenate([[0], np.cumsum(ref_lens)])
        starts = cols["cigar_off"]
        ends = starts + cols["n_cigar"]
        spans = csum[ends] - csum[starts]
        return cols["pos"].astype(np.int64) + spans

    def _record_at(self, i: int) -> BamRecord:
        rec = self._rec_cache.get(i)
        if rec is not None:
            return rec
        cols = self._cols
        qo, ql = int(cols["qname_off"][i]), int(cols["qname_len"][i])
        qname = cols["qname_pool"][qo : qo + ql].tobytes().decode("ascii")
        co, nc = int(cols["cigar_off"][i]), int(cols["n_cigar"][i])
        cigar = [
            (int(x & 0xF), int(x >> 4)) for x in cols["cigar_pool"][co : co + nc]
        ]
        so, ls = int(cols["seq_off"][i]), int(cols["l_seq"][i])
        seq = cols["seq_pool"][so : so + ls].tobytes().decode("ascii")
        qual = cols["qual_pool"][so : so + ls].copy()
        ao, al = int(cols["aux_off"][i]), int(cols["aux_len"][i])
        tags = LazyTags(cols["aux_pool"][ao : ao + al].tobytes())
        rec = BamRecord(
            qname, int(cols["flag"][i]), int(cols["ref_id"][i]), int(cols["pos"][i]),
            int(cols["mapq"][i]), cigar, int(cols["next_ref_id"][i]),
            int(cols["next_pos"][i]), int(cols["tlen"][i]), seq, qual, tags,
        )
        self._rec_cache[i] = rec
        return rec

    def _parse_records(self, data: bytes, off: int) -> list[BamRecord]:
        records = []
        n = len(data)
        while off + 4 <= n:
            rec, off = parse_one_record(data, off)
            records.append(rec)
        return records

    def ref_name(self, ref_id: int) -> str:
        return self.references[ref_id][0] if 0 <= ref_id < len(self.references) else "*"

    def ref_id(self, name: str) -> int:
        return self._ref_index.get(name, -1)

    def all_records(self) -> list[BamRecord]:
        if self._cols is not None:
            return [self._record_at(i) for i in range(self._cols["count"])]
        return self._records_raw

    def _build_index(self) -> None:
        # per contig: (starts sorted, running max end, record handles).
        # Built into a LOCAL dict and published with one assignment: readers
        # are shared across executor prep threads, and a concurrent fetch
        # must never observe a partially-filled index (it would silently
        # return zero reads for a contig).
        index: dict = {}
        if self._cols is not None:
            cols = self._cols
            ref_ids = cols["ref_id"]
            pos = cols["pos"].astype(np.int64)
            ends = self._ref_ends
            for rid in np.unique(ref_ids):
                if rid < 0:
                    continue
                idxs = np.nonzero(ref_ids == rid)[0]
                order = idxs[np.argsort(pos[idxs], kind="stable")]
                starts = pos[order]
                run_max_end = np.maximum.accumulate(ends[order])
                index[int(rid)] = (starts, run_max_end, ends[order], order)
            self._by_contig = index
            return
        by: dict[int, list[BamRecord]] = {}
        for rec in self._records_raw:
            if rec.ref_id < 0:
                continue
            by.setdefault(rec.ref_id, []).append(rec)
        for rid, recs in by.items():
            recs.sort(key=lambda r: r.pos0)
            starts = np.array([r.pos0 for r in recs], dtype=np.int64)
            ends = np.array([r.reference_end0() for r in recs], dtype=np.int64)
            run_max_end = np.maximum.accumulate(ends)
            index[rid] = (starts, run_max_end, ends, recs)
        self._by_contig = index

    def fetch(self, chrom: str, start1: int, end1: int) -> list[BamRecord]:
        """All records overlapping [start1, end1] (1-based inclusive)."""
        if self._by_contig is None:
            self._build_index()
        rid = self.ref_id(chrom)
        entry = self._by_contig.get(rid)
        if entry is None:
            return []
        starts, run_max_end, ends, handles = entry
        lo0, hi0 = start1 - 1, end1  # half-open
        # records with start < hi0 and end > lo0
        hi_idx = int(np.searchsorted(starts, hi0, side="left"))
        out = []
        # scan backwards until running max end <= lo0 proves no more overlaps
        for i in range(hi_idx - 1, -1, -1):
            if run_max_end[i] <= lo0:
                break
            if ends[i] > lo0:
                if self._cols is not None:
                    out.append(self._record_at(int(handles[i])))
                else:
                    out.append(handles[i])
        out.reverse()
        return out

    def fetch_handles(self, chrom: str, start1: int, end1: int) -> np.ndarray:
        """Columnar-record indices overlapping the region, in the same order
        fetch() yields records — no BamRecord materialization. Only valid on
        the columnar (native) backend."""
        assert self._cols is not None
        if self._by_contig is None:
            self._build_index()
        rid = self.ref_id(chrom)
        entry = self._by_contig.get(rid)
        if entry is None:
            return np.empty(0, np.int64)
        starts, run_max_end, ends, handles = entry
        lo0, hi0 = start1 - 1, end1
        hi_idx = int(np.searchsorted(starts, hi0, side="left"))
        lo_idx = hi_idx
        for i in range(hi_idx - 1, -1, -1):
            if run_max_end[i] <= lo0:
                break
            lo_idx = i
        sel = np.arange(lo_idx, hi_idx)
        sel = sel[ends[lo_idx:hi_idx] > lo0]
        return np.asarray(handles, np.int64)[sel]

    def codes_pool(self) -> np.ndarray:
        """Whole-file 0..4 base codes parallel to seq_pool (lazy, cached):
        per-read codes become zero-copy views."""
        pool = getattr(self, "_codes_pool", None)
        if pool is None:
            from lancet2_tpu_torch.base.dna import ENCODE_TABLE

            pool = ENCODE_TABLE[self._cols["seq_pool"]]
            self._codes_pool = pool
        return pool

    def softclip_csum(self) -> np.ndarray:
        """Cumulative soft-clipped length over the cigar pool (lazy, cached):
        a record's total soft clip is csum[end] - csum[start]."""
        csum = getattr(self, "_softclip_csum", None)
        if csum is None:
            pool = self._cols["cigar_pool"]
            sc = np.where((pool & 0xF) == 4, pool >> 4, 0).astype(np.int64)
            csum = np.concatenate([[0], np.cumsum(sc)])
            self._softclip_csum = csum
        return csum


class BamWriter:
    """Compose a coordinate-sorted BAM file (used by tests and the simulator)."""

    def __init__(self, path: str, references: list[tuple[str, int]], sample_name: str | None = None,
                 read_group: str | None = None, extra_header: str = ""):
        self.path = path
        self.references = references
        header_lines = ["@HD\tVN:1.6\tSO:coordinate"]
        for name, length in references:
            header_lines.append(f"@SQ\tSN:{name}\tLN:{length}")
        if sample_name is not None:
            rg = read_group or sample_name
            header_lines.append(f"@RG\tID:{rg}\tSM:{sample_name}")
        if extra_header:
            header_lines.append(extra_header.rstrip("\n"))
        self.header_text = "\n".join(header_lines) + "\n"
        self._records: list[BamRecord] = []

    def add(self, rec: BamRecord) -> None:
        self._records.append(rec)

    @staticmethod
    def _reg2bin(beg: int, end: int) -> int:
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

    def _encode_record(self, rec: BamRecord) -> bytes:
        name = rec.qname.encode("ascii") + b"\x00"
        cigar_raw = b"".join(struct.pack("<I", (l << 4) | op) for op, l in rec.cigar)
        seq_packed = _encode_seq(rec.seq)
        qual = np.asarray(rec.qual, dtype=np.uint8).tobytes()
        if len(qual) != len(rec.seq):
            qual = b"\xff" * len(rec.seq)
        aux = _encode_aux(rec.tags)
        end0 = max(rec.reference_end0(), rec.pos0 + 1)
        core = struct.pack(
            "<iiBBHHHiiii",
            rec.ref_id, rec.pos0, len(name), rec.mapq,
            self._reg2bin(rec.pos0, end0), len(rec.cigar), rec.flag,
            len(rec.seq), rec.next_ref_id, rec.next_pos0, rec.tlen,
        )
        body = core + name + cigar_raw + seq_packed + qual + aux
        return struct.pack("<i", len(body)) + body

    def close(self) -> None:
        self._records.sort(key=lambda r: (r.ref_id if r.ref_id >= 0 else 1 << 30, r.pos0))
        out = bytearray()
        header_bytes = self.header_text.encode("utf-8")
        out += BAM_MAGIC
        out += struct.pack("<i", len(header_bytes))
        out += header_bytes
        out += struct.pack("<i", len(self.references))
        for name, length in self.references:
            nb = name.encode("ascii") + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        for rec in self._records:
            out += self._encode_record(rec)
        with open(self.path, "wb") as fh:
            fh.write(bgzf.compress_bytes(bytes(out)))


def parse_sample_name(header_text: str) -> str | None:
    """First SM tag from @RG lines (reference: core/sample_header_reader)."""
    for line in header_text.splitlines():
        if line.startswith("@RG"):
            for fieldv in line.split("\t")[1:]:
                if fieldv.startswith("SM:"):
                    return fieldv[3:]
    return None
