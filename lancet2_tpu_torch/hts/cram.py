"""CRAM 3.0 container IO implemented from the specification.

The reference delegates CRAM to htslib (hts/extractor.cpp; SURVEY.md §2 L2
lists CRAM decode as a required input capability). This module implements
the format natively: file definition, containers, compression-header
preservation/encoding maps, slices, blocks (raw/gzip/rANS-4x8 codecs), the
core bit stream, and reference-based record reconstruction from features.

Reader scope (what htslib emits plus our writer):
  encodings EXTERNAL, HUFFMAN (canonical, incl. the 0-bit constant case),
  BETA, GAMMA, BYTE_ARRAY_STOP, BYTE_ARRAY_LEN; single- and multi-ref
  slices; absolute and delta AP; detached mates and downstream-mate (NF)
  pairing; feature codes B X I D i S H P N Q b q.
Writer scope: one slice per container, all-EXTERNAL series (ITF8 ints),
  BYTE_ARRAY_STOP read names, BYTE_ARRAY_LEN arrays, detached mate info,
  reference-based features with substitution-matrix X codes, gzip or
  rans4x8 block compression.

CRC32s are emitted correctly but not validated on read.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from lancet2_tpu_torch.hts import rans4x8
from lancet2_tpu_torch.hts.bam import (
    FLAG_MATE_REVERSE,
    FLAG_MATE_UNMAPPED,
    FLAG_UNMAPPED,
    BamRecord,
    parse_sample_name,
)
from lancet2_tpu_torch.hts.cigar import CIGAR_OPS, CONSUMES_REF, Cigar

from lancet2_tpu_torch.hts.uri import hts_open

CRAM_MAGIC = b"CRAM"

# block compression methods
M_RAW, M_GZIP, M_BZIP2, M_LZMA, M_RANS4x8, M_RANSNx16 = 0, 1, 2, 3, 4, 5
# block content types
CT_FILE_HEADER, CT_COMPRESSION_HEADER, CT_SLICE_HEADER, CT_EXTERNAL, CT_CORE = 0, 1, 2, 4, 5
# encoding codec ids
E_NULL, E_EXTERNAL, E_GOLOMB, E_HUFFMAN, E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP, E_BETA, E_SUBEXP, E_GOLOMB_RICE, E_GAMMA = range(10)

EOF_CONTAINER = bytes.fromhex(
    "0f000000ffffffff0fe0454f4600000000010005bdd94f0001000606010001"
    "00010000ee63014b"
)

_BASES = "ACGTN"


# ------------------------------------------------------------------ varints

def write_itf8(out: bytearray, v: int) -> None:
    v &= 0xFFFFFFFF
    if v < 0x80:
        out.append(v)
    elif v < 0x4000:
        out += bytes([0x80 | (v >> 8), v & 0xFF])
    elif v < 0x200000:
        out += bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    elif v < 0x10000000:
        out += bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    else:
        out += bytes([0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                      (v >> 4) & 0xFF, v & 0x0F])


def read_itf8(buf, p: int) -> tuple[int, int]:
    b = buf[p]
    if b < 0x80:
        v, p = b, p + 1
    elif b < 0xC0:
        v, p = ((b & 0x3F) << 8) | buf[p + 1], p + 2
    elif b < 0xE0:
        v, p = ((b & 0x1F) << 16) | (buf[p + 1] << 8) | buf[p + 2], p + 3
    elif b < 0xF0:
        v = ((b & 0x0F) << 24) | (buf[p + 1] << 16) | (buf[p + 2] << 8) | buf[p + 3]
        p += 4
    else:
        v = ((b & 0x0F) << 28) | (buf[p + 1] << 20) | (buf[p + 2] << 12) | (
            buf[p + 3] << 4) | (buf[p + 4] & 0x0F)
        p += 5
    if v >= 1 << 31:
        v -= 1 << 32
    return v, p


def write_ltf8(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1
    if v < 0x80:
        out.append(v)
        return
    nbytes = 1
    while nbytes < 8 and v >= (1 << (7 * (nbytes + 1) - nbytes)):
        nbytes += 1
    # leading `nbytes` ones then data; fall back to full 9-byte form
    for nb in range(1, 9):
        bits = 8 - nb - 1  # payload bits in the first byte
        if nb < 8 and v < (1 << (bits + 8 * nb)):
            prefix = (0xFF << (8 - nb)) & 0xFF
            first = prefix | (v >> (8 * nb))
            out.append(first)
            for k in range(nb - 1, -1, -1):
                out.append((v >> (8 * k)) & 0xFF)
            return
    out.append(0xFF)
    for k in range(7, -1, -1):
        out.append((v >> (8 * k)) & 0xFF)


def read_ltf8(buf, p: int) -> tuple[int, int]:
    b = buf[p]
    nb = 0
    while nb < 8 and (b << nb) & 0x80:
        nb += 1
    if nb == 8:
        v = int.from_bytes(buf[p + 1: p + 9], "big")
        return v, p + 9
    v = b & (0xFF >> (nb + 1)) if nb < 7 else 0
    for k in range(nb):
        v = (v << 8) | buf[p + 1 + k]
    return v, p + 1 + nb


# ------------------------------------------------------------------ bit IO

class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 0

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos]
            v = (v << 1) | ((byte >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v


# ------------------------------------------------------------------ blocks

def _compress_block(data: bytes, method: int) -> bytes:
    if method == M_RAW:
        return data
    if method == M_GZIP:
        return gzip.compress(data, 6)
    if method == M_RANS4x8:
        return rans4x8.compress(data, order=0)
    raise ValueError(f"unsupported CRAM write method {method}")


def _uncompress_block(data: bytes, method: int, raw_size: int) -> bytes:
    if method == M_RAW:
        return data
    if method == M_GZIP:
        return gzip.decompress(data)
    if method == M_RANS4x8:
        return rans4x8.uncompress(data)
    raise ValueError(f"unsupported CRAM compression method {method} "
                     "(bzip2/lzma/ransNx16 blocks are not implemented)")


@dataclass
class Block:
    content_type: int
    content_id: int
    data: bytes
    method: int = M_RAW

    def tobytes(self) -> bytes:
        comp = _compress_block(self.data, self.method)
        out = bytearray([self.method, self.content_type])
        write_itf8(out, self.content_id)
        write_itf8(out, len(comp))
        write_itf8(out, len(self.data))
        out += comp
        out += struct.pack("<I", zlib.crc32(bytes(out)))
        return bytes(out)

    @staticmethod
    def parse(buf: bytes, p: int) -> tuple["Block", int]:
        method, ctype = buf[p], buf[p + 1]
        p += 2
        cid, p = read_itf8(buf, p)
        csize, p = read_itf8(buf, p)
        rsize, p = read_itf8(buf, p)
        raw = _uncompress_block(bytes(buf[p: p + csize]), method, rsize)
        p += csize + 4  # skip crc
        return Block(ctype, cid, raw, method), p


# ------------------------------------------------------------------ encodings

@dataclass
class Encoding:
    codec: int
    params: dict = field(default_factory=dict)

    def tobytes(self) -> bytes:
        out = bytearray()
        write_itf8(out, self.codec)
        body = bytearray()
        if self.codec == E_EXTERNAL:
            write_itf8(body, self.params["cid"])
        elif self.codec == E_BYTE_ARRAY_STOP:
            body.append(self.params["stop"])
            write_itf8(body, self.params["cid"])
        elif self.codec == E_BYTE_ARRAY_LEN:
            body += self.params["len_enc"].tobytes()
            body += self.params["val_enc"].tobytes()
        elif self.codec == E_HUFFMAN:
            syms = self.params["symbols"]
            lens = self.params["lengths"]
            write_itf8(body, len(syms))
            for s in syms:
                write_itf8(body, s)
            write_itf8(body, len(lens))
            for l in lens:
                write_itf8(body, l)
        elif self.codec == E_BETA:
            write_itf8(body, self.params["offset"])
            write_itf8(body, self.params["nbits"])
        elif self.codec not in (E_NULL,):
            raise ValueError(f"unsupported encoding write {self.codec}")
        write_itf8(out, len(body))
        out += body
        return bytes(out)

    @staticmethod
    def parse(buf: bytes, p: int) -> tuple["Encoding", int]:
        codec, p = read_itf8(buf, p)
        blen, p = read_itf8(buf, p)
        end = p + blen
        params: dict = {}
        if codec == E_EXTERNAL:
            params["cid"], p = read_itf8(buf, p)
        elif codec == E_BYTE_ARRAY_STOP:
            params["stop"] = buf[p]
            p += 1
            params["cid"], p = read_itf8(buf, p)
        elif codec == E_BYTE_ARRAY_LEN:
            params["len_enc"], p = Encoding.parse(buf, p)
            params["val_enc"], p = Encoding.parse(buf, p)
        elif codec == E_HUFFMAN:
            n, p = read_itf8(buf, p)
            syms = []
            for _ in range(n):
                v, p = read_itf8(buf, p)
                syms.append(v)
            m, p = read_itf8(buf, p)
            lens = []
            for _ in range(m):
                v, p = read_itf8(buf, p)
                lens.append(v)
            params["symbols"], params["lengths"] = syms, lens
        elif codec == E_BETA:
            params["offset"], p = read_itf8(buf, p)
            params["nbits"], p = read_itf8(buf, p)
        elif codec == E_GAMMA:
            params["offset"], p = read_itf8(buf, p)
        return Encoding(codec, params), end


def _huffman_decoder(enc: Encoding):
    syms = enc.params["symbols"]
    lens = enc.params["lengths"]
    if all(l == 0 for l in lens):
        const = syms[0]
        return lambda core, ext: const
    # canonical codes, shortest first, ties by symbol order as listed
    order = sorted(range(len(syms)), key=lambda i: (lens[i], i))
    codes = {}
    code, prev_len = 0, 0
    for i in order:
        code <<= lens[i] - prev_len
        prev_len = lens[i]
        codes[(lens[i], code)] = syms[i]
        code += 1

    def read(core: BitReader, ext) -> int:
        v, n = 0, 0
        while True:
            v = (v << 1) | core.read_bits(1)
            n += 1
            if (n, v) in codes:
                return codes[(n, v)]
            if n > 31:
                raise ValueError("bad huffman stream")
    return read


class SeriesReader:
    """Decodes one data series given its encoding + external block map."""

    def __init__(self, enc: Encoding, ext_blocks: dict[int, bytes]):
        self.enc = enc
        self.pos: dict[int, int] = {}
        self.ext = ext_blocks
        if enc.codec == E_HUFFMAN:
            self._huff = _huffman_decoder(enc)

    def _take(self, cid: int, n: int) -> bytes:
        p = self.pos.get(cid, 0)
        data = self.ext[cid]
        self.pos[cid] = p + n
        return data[p: p + n]

    def read_int(self, core: BitReader) -> int:
        c = self.enc.codec
        if c == E_EXTERNAL:
            cid = self.enc.params["cid"]
            data = self.ext[cid]
            v, newp = read_itf8(data, self.pos.get(cid, 0))
            self.pos[cid] = newp
            return v
        if c == E_HUFFMAN:
            return self._huff(core, self.ext)
        if c == E_BETA:
            return core.read_bits(self.enc.params["nbits"]) - self.enc.params["offset"]
        if c == E_GAMMA:
            n = 0
            while core.read_bits(1) == 0:
                n += 1
            v = 1
            for _ in range(n):
                v = (v << 1) | core.read_bits(1)
            return v - self.enc.params.get("offset", 0)
        raise ValueError(f"unsupported int encoding {c}")

    def read_byte(self, core: BitReader) -> int:
        c = self.enc.codec
        if c == E_EXTERNAL:
            cid = self.enc.params["cid"]
            return self._take(cid, 1)[0]
        if c == E_HUFFMAN:
            return self._huff(core, self.ext)
        if c == E_BETA:
            return self.read_int(core)
        raise ValueError(f"unsupported byte encoding {c}")

    def read_bytes(self, core: BitReader, sub: dict) -> bytes:
        c = self.enc.codec
        if c == E_BYTE_ARRAY_STOP:
            stop = self.enc.params["stop"]
            cid = self.enc.params["cid"]
            data = self.ext[cid]
            p = self.pos.get(cid, 0)
            q = data.index(stop, p)
            self.pos[cid] = q + 1
            return data[p:q]
        if c == E_BYTE_ARRAY_LEN:
            le = sub["len_reader"]
            ve = sub["val_reader"]
            n = le.read_int(core)
            vc = ve.enc.codec
            if vc == E_EXTERNAL:
                return ve._take(ve.enc.params["cid"], n)
            return bytes(ve.read_byte(core) for _ in range(n))
        raise ValueError(f"unsupported byte-array encoding {c}")


# ------------------------------------------------------------------ maps

DS_KEYS = [
    "BF", "CF", "RI", "RL", "AP", "RG", "RN", "MF", "NS", "NP", "TS", "NF",
    "TL", "FN", "FC", "FP", "DL", "BB", "QQ", "BS", "IN", "SC", "HC", "PD",
    "RS", "BA", "QS", "MQ", "TC", "TN",
]


def _default_sub_matrix() -> bytes:
    # code c for ref base r = c-th base of ACGTN excluding r
    return bytes([0b00011011] * 5)


def _sub_alt(matrix: bytes, ref_base: str, code: int) -> str:
    r = _BASES.find(ref_base.upper())
    if r < 0:
        r = 4
    alts = [b for b in _BASES if b != _BASES[r]]
    byte = matrix[r]
    for pos in range(4):
        if (byte >> (6 - 2 * pos)) & 3 == code:
            return alts[pos]
    return "N"


def _sub_code(matrix: bytes, ref_base: str, alt_base: str) -> int | None:
    r = _BASES.find(ref_base.upper())
    if r < 0:
        return None
    alts = [b for b in _BASES if b != _BASES[r]]
    if alt_base.upper() not in alts:
        return None
    pos = alts.index(alt_base.upper())
    return (matrix[r] >> (6 - 2 * pos)) & 3


@dataclass
class CompressionHeader:
    preserve_rn: bool = True
    ap_delta: bool = False
    ref_required: bool = True
    sub_matrix: bytes = field(default_factory=_default_sub_matrix)
    tag_dict: list[list[tuple[str, str]]] = field(default_factory=lambda: [[]])
    ds_enc: dict[str, Encoding] = field(default_factory=dict)
    tag_enc: dict[int, Encoding] = field(default_factory=dict)

    def tobytes(self) -> bytes:
        pres = bytearray()
        n = 0
        body = bytearray()
        for key, val in (("RN", self.preserve_rn), ("AP", self.ap_delta),
                         ("RR", self.ref_required)):
            body += key.encode()
            body.append(1 if val else 0)
            n += 1
        body += b"SM" + self.sub_matrix
        n += 1
        td = bytearray()
        for line in self.tag_dict:
            for tag, typ in line:
                td += tag.encode() + typ.encode()
            td.append(0)
        body += b"TD"
        write_itf8(body, len(td))
        body += td
        n += 1
        write_itf8(pres, n)
        pres = _sized(bytes(pres) + bytes(body))

        dsm = bytearray()
        write_itf8(dsm, len(self.ds_enc))
        for key, enc in self.ds_enc.items():
            dsm += key.encode()
            dsm += enc.tobytes()
        dsm = _sized(bytes(dsm))

        tgm = bytearray()
        write_itf8(tgm, len(self.tag_enc))
        for key, enc in self.tag_enc.items():
            write_itf8(tgm, key)
            tgm += enc.tobytes()
        tgm = _sized(bytes(tgm))
        return bytes(pres) + bytes(dsm) + bytes(tgm)

    @staticmethod
    def parse(buf: bytes) -> "CompressionHeader":
        h = CompressionHeader(ds_enc={}, tag_enc={})
        p = 0
        _, p = read_itf8(buf, p)  # preservation map byte size
        n, p = read_itf8(buf, p)
        for _ in range(n):
            key = buf[p: p + 2].decode()
            p += 2
            if key in ("RN", "AP", "RR"):
                val = bool(buf[p])
                p += 1
                if key == "RN":
                    h.preserve_rn = val
                elif key == "AP":
                    h.ap_delta = val
                else:
                    h.ref_required = val
            elif key == "SM":
                h.sub_matrix = bytes(buf[p: p + 5])
                p += 5
            elif key == "TD":
                tlen, p = read_itf8(buf, p)
                td = buf[p: p + tlen]
                p += tlen
                h.tag_dict = []
                line: list[tuple[str, str]] = []
                q = 0
                while q < len(td):
                    if td[q] == 0:
                        h.tag_dict.append(line)
                        line = []
                        q += 1
                    else:
                        line.append((td[q: q + 2].decode(), chr(td[q + 2])))
                        q += 3
                if not h.tag_dict:
                    h.tag_dict = [[]]
            else:
                raise ValueError(f"unknown preservation key {key}")
        _, p = read_itf8(buf, p)  # data-series map byte size
        n, p = read_itf8(buf, p)
        for _ in range(n):
            key = buf[p: p + 2].decode()
            p += 2
            enc, p = Encoding.parse(buf, p)
            h.ds_enc[key] = enc
        _, p = read_itf8(buf, p)  # tag map byte size
        n, p = read_itf8(buf, p)
        for _ in range(n):
            key, p = read_itf8(buf, p)
            enc, p = Encoding.parse(buf, p)
            h.tag_enc[key] = enc
        return h


def _sized(body: bytes) -> bytes:
    out = bytearray()
    write_itf8(out, len(body))
    return bytes(out) + body


# ------------------------------------------------------------------ slices

@dataclass
class SliceHeader:
    ref_id: int
    start1: int
    span: int
    nrecords: int
    counter: int
    nblocks: int
    content_ids: list[int]
    embedded_ref: int = -1
    md5: bytes = b"\x00" * 16

    def tobytes(self) -> bytes:
        out = bytearray()
        write_itf8(out, self.ref_id)
        write_itf8(out, self.start1)
        write_itf8(out, self.span)
        write_itf8(out, self.nrecords)
        write_ltf8(out, self.counter)
        write_itf8(out, self.nblocks)
        write_itf8(out, len(self.content_ids))
        for cid in self.content_ids:
            write_itf8(out, cid)
        write_itf8(out, self.embedded_ref)
        out += self.md5
        return bytes(out)

    @staticmethod
    def parse(buf: bytes) -> "SliceHeader":
        p = 0
        rid, p = read_itf8(buf, p)
        start1, p = read_itf8(buf, p)
        span, p = read_itf8(buf, p)
        nrec, p = read_itf8(buf, p)
        counter, p = read_ltf8(buf, p)
        nblk, p = read_itf8(buf, p)
        ncid, p = read_itf8(buf, p)
        cids = []
        for _ in range(ncid):
            v, p = read_itf8(buf, p)
            cids.append(v)
        embref, p = read_itf8(buf, p)
        md5 = bytes(buf[p: p + 16]) if p + 16 <= len(buf) else b"\x00" * 16
        return SliceHeader(rid, start1, span, nrec, counter, nblk, cids, embref, md5)


# feature code -> which series it consumes
_TAG_TYPE_SIZES = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}


def _decode_tag_value(typ: str, raw: bytes):
    import struct as _s

    if typ == "A":
        return raw[:1].decode()
    if typ in ("c", "C", "s", "S", "i", "I"):
        fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}[typ]
        return _s.unpack(fmt, raw[: _TAG_TYPE_SIZES[typ]])[0]
    if typ == "f":
        return _s.unpack("<f", raw[:4])[0]
    if typ == "Z":
        return raw.split(b"\x00")[0].decode()
    if typ == "H":
        return raw.split(b"\x00")[0].decode()
    if typ == "B":
        sub = chr(raw[0])
        n = _s.unpack("<i", raw[1:5])[0]
        sz = _TAG_TYPE_SIZES[sub]
        fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
        return list(_s.unpack(f"<{n}{fmt}", raw[5: 5 + n * sz]))
    return raw


def _encode_tag_value(typ: str, val) -> bytes:
    import struct as _s

    if typ == "A":
        return val.encode()[:1]
    if typ in ("c", "C", "s", "S", "i", "I"):
        fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}[typ]
        return _s.pack(fmt, int(val))
    if typ == "f":
        return _s.pack("<f", float(val))
    if typ in ("Z", "H"):
        return str(val).encode() + b"\x00"
    if typ == "B":
        arr = list(val)
        sub = "i"
        fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
        return b"i" + _s.pack("<i", len(arr)) + _s.pack(f"<{len(arr)}{fmt}", *arr)
    raise ValueError(f"tag type {typ}")


def _bam_tag_type(val) -> str:
    if isinstance(val, bool):
        return "c"
    if isinstance(val, int):
        return "i" if -(1 << 31) <= val < (1 << 31) else "I"
    if isinstance(val, float):
        return "f"
    if isinstance(val, (list, tuple, np.ndarray)):
        return "B"
    s = str(val)
    return "A" if len(s) == 1 and not s.isdigit() else "Z"


class _SliceDecoder:
    """Decodes one slice's records into BamRecords."""

    def __init__(self, comp: CompressionHeader, sh: SliceHeader, core: bytes,
                 ext: dict[int, bytes], ref_lookup, ref_names: list[str]):
        self.h = comp
        self.sh = sh
        self.core = BitReader(core)
        self.ext = ext
        self.ref_lookup = ref_lookup  # fn(ref_id, start1, end1) -> str
        self.ref_names = ref_names
        self.readers: dict[str, SeriesReader] = {}
        self.sub_readers: dict[str, dict] = {}
        for key, enc in comp.ds_enc.items():
            self.readers[key] = SeriesReader(enc, ext)
            if enc.codec == E_BYTE_ARRAY_LEN:
                self.sub_readers[key] = {
                    "len_reader": SeriesReader(enc.params["len_enc"], ext),
                    "val_reader": SeriesReader(enc.params["val_enc"], ext),
                }
        self.tag_readers: dict[int, SeriesReader] = {}
        self.tag_subs: dict[int, dict] = {}
        for key, enc in comp.tag_enc.items():
            self.tag_readers[key] = SeriesReader(enc, ext)
            if enc.codec == E_BYTE_ARRAY_LEN:
                self.tag_subs[key] = {
                    "len_reader": SeriesReader(enc.params["len_enc"], ext),
                    "val_reader": SeriesReader(enc.params["val_enc"], ext),
                }

    def _int(self, key: str) -> int:
        return self.readers[key].read_int(self.core)

    def _byte(self, key: str) -> int:
        return self.readers[key].read_byte(self.core)

    def _bytes(self, key: str) -> bytes:
        return self.readers[key].read_bytes(self.core, self.sub_readers.get(key, {}))

    def _read_quals(self, rl: int):
        """QS series for one record: fast path for EXTERNAL (bulk slice),
        per-byte decode for any other spec-valid codec."""
        import numpy as np

        qs = self.readers["QS"]
        if qs.enc.codec == E_EXTERNAL:
            qraw = qs._take(qs.enc.params["cid"], rl)
            return np.frombuffer(qraw, np.uint8).copy()
        return np.array([qs.read_byte(self.core) for _ in range(rl)], np.uint8)

    def decode_records(self) -> list[BamRecord]:
        recs: list[BamRecord] = []
        mate_fixups: list[tuple[int, int]] = []  # (rec idx, nf distance)
        prev_ap = self.sh.start1
        for idx in range(self.sh.nrecords):
            bf = self._int("BF")
            cf = self._int("CF")
            if self.sh.ref_id == -2:
                rid = self._int("RI")
            else:
                rid = self.sh.ref_id
            rl = self._int("RL")
            ap = self._int("AP")
            if self.h.ap_delta:
                ap = prev_ap + ap
                prev_ap = ap
            rg = self._int("RG")
            qname = f"rec{self.sh.counter + idx}"
            if self.h.preserve_rn:
                qname = self._bytes("RN").decode()
            mate_rid, mate_pos1, tlen = -1, 0, 0
            nf = None
            if cf & 2:  # detached
                mf = self._int("MF")
                if not self.h.preserve_rn and "RN" in self.readers:
                    qname = self._bytes("RN").decode()
                mate_rid = self._int("NS")
                mate_pos1 = self._int("NP")
                tlen = self._int("TS")
                if mf & 1:
                    bf |= FLAG_MATE_REVERSE
                if mf & 2:
                    bf |= FLAG_MATE_UNMAPPED
            elif cf & 4:  # mate downstream in this slice
                nf = self._int("NF")
            tl = self._int("TL")
            tags: dict[str, object] = {}
            if 0 <= tl < len(self.h.tag_dict):
                for tag, typ in self.h.tag_dict[tl]:
                    key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
                    raw = self.tag_readers[key].read_bytes(
                        self.core, self.tag_subs.get(key, {}))
                    tags[tag] = _decode_tag_value(typ, raw)

            if not bf & FLAG_UNMAPPED:
                rec = self._decode_mapped(bf, cf, rid, ap, rl, qname)
            else:
                rec = self._decode_unmapped(bf, cf, rid, ap, rl, qname)
            rec.tags = tags
            rec.next_ref_id = mate_rid
            rec.next_pos0 = mate_pos1 - 1
            rec.tlen = tlen
            del rg
            if nf is not None:
                mate_fixups.append((idx, nf))
            recs.append(rec)

        for idx, nf in mate_fixups:
            mate = recs[idx + nf + 1]
            rec = recs[idx]
            rec.next_ref_id = mate.ref_id
            rec.next_pos0 = mate.pos0
            if mate.is_reverse:
                rec.flag |= FLAG_MATE_REVERSE
            if mate.is_unmapped:
                rec.flag |= FLAG_MATE_UNMAPPED
            mate.next_ref_id = rec.ref_id
            mate.next_pos0 = rec.pos0
            if rec.is_reverse:
                mate.flag |= FLAG_MATE_REVERSE
            if rec.is_unmapped:
                mate.flag |= FLAG_MATE_UNMAPPED
            # leftmost-to-rightmost template span
            lo = min(rec.pos0, mate.pos0)
            hi = max(rec.reference_end0(), mate.reference_end0())
            sign = 1 if rec.pos0 <= mate.pos0 else -1
            rec.tlen = sign * (hi - lo)
            mate.tlen = -sign * (hi - lo)
        return recs

    def _decode_mapped(self, bf, cf, rid, ap, rl, qname) -> BamRecord:
        nfeat = self._int("FN")
        feats = []
        fpos = 0
        for _ in range(nfeat):
            fc = chr(self._byte("FC"))
            fdelta = self._int("FP")
            fpos += fdelta
            if fc == "B":
                feats.append((fpos, fc, (self._byte("BA"), self._byte("QS"))))
            elif fc == "X":
                feats.append((fpos, fc, self._byte("BS")))
            elif fc == "I":
                feats.append((fpos, fc, self._bytes("IN")))
            elif fc == "i":
                feats.append((fpos, fc, self._byte("BA")))
            elif fc == "D":
                feats.append((fpos, fc, self._int("DL")))
            elif fc == "S":
                feats.append((fpos, fc, self._bytes("SC")))
            elif fc == "H":
                feats.append((fpos, fc, self._int("HC")))
            elif fc == "P":
                feats.append((fpos, fc, self._int("PD")))
            elif fc == "N":
                feats.append((fpos, fc, self._int("RS")))
            elif fc == "Q":
                feats.append((fpos, fc, self._byte("QS")))
            elif fc == "b":
                feats.append((fpos, fc, self._bytes("BB")))
            elif fc == "q":
                feats.append((fpos, fc, self._bytes("QQ")))
            else:
                raise ValueError(f"unknown feature code {fc!r}")
        mq = self._int("MQ")
        quals = np.full(rl, 255, np.uint8)
        if cf & 1:
            quals = self._read_quals(rl)

        seq, cigar = self._reconstruct(rid, ap, rl, feats, quals)
        return BamRecord(qname, bf & 0xFFFF, rid, ap - 1, mq, cigar,
                         -1, -1, 0, seq, quals, {})

    def _reconstruct(self, rid, ap, rl, feats, quals):
        seq = ["?"] * rl
        cigar_ops: Cigar = []
        rpos = ap  # 1-based reference position of next aligned base
        qpos = 1   # 1-based read position of next base

        def emit(op, n):
            if n <= 0:
                return
            op = CIGAR_OPS.index(op)
            if cigar_ops and cigar_ops[-1][0] == op:
                cigar_ops[-1] = (op, cigar_ops[-1][1] + n)
            else:
                cigar_ops.append((op, n))

        def fill_match(upto_q):
            nonlocal rpos, qpos
            n = upto_q - qpos
            if n > 0:
                ref = self.ref_lookup(rid, rpos, rpos + n - 1)
                for k in range(n):
                    seq[qpos - 1 + k] = ref[k] if k < len(ref) else "N"
                emit("M", n)
                rpos += n
                qpos += n

        for fpos, fc, val in feats:
            if fc in ("B", "X", "Q", "b", "q"):
                fill_match(fpos)
            else:
                fill_match(fpos)
            if fc == "B":
                base, q = val
                seq[fpos - 1] = chr(base)
                quals[fpos - 1] = q
                emit("M", 1)
                rpos += 1
                qpos += 1
            elif fc == "X":
                ref = self.ref_lookup(rid, rpos, rpos)
                seq[fpos - 1] = _sub_alt(self.h.sub_matrix, ref[:1] or "N", val)
                emit("M", 1)
                rpos += 1
                qpos += 1
            elif fc == "I":
                ins = val.decode()
                for k, ch in enumerate(ins):
                    seq[fpos - 1 + k] = ch
                emit("I", len(ins))
                qpos += len(ins)
            elif fc == "i":
                seq[fpos - 1] = chr(val)
                emit("I", 1)
                qpos += 1
            elif fc == "D":
                emit("D", val)
                rpos += val
            elif fc == "S":
                sc = val.decode()
                for k, ch in enumerate(sc):
                    seq[fpos - 1 + k] = ch
                emit("S", len(sc))
                qpos += len(sc)
            elif fc == "H":
                emit("H", val)
            elif fc == "P":
                emit("P", val)
            elif fc == "N":
                emit("N", val)
                rpos += val
            elif fc == "Q":
                quals[fpos - 1] = val
            elif fc == "b":
                bb = val.decode()
                for k, ch in enumerate(bb):
                    seq[fpos - 1 + k] = ch
                emit("M", len(bb))
                rpos += len(bb)
                qpos += len(bb)
            elif fc == "q":
                for k, q in enumerate(val):
                    quals[fpos - 1 + k] = q
        fill_match(rl + 1)
        return "".join(seq), cigar_ops

    def _decode_unmapped(self, bf, cf, rid, ap, rl, qname) -> BamRecord:
        bases = bytes(self._byte("BA") for _ in range(rl))
        quals = np.full(rl, 255, np.uint8)
        if cf & 1:
            quals = self._read_quals(rl)
        return BamRecord(qname, bf & 0xFFFF, rid, ap - 1, 0, [],
                         -1, -1, 0, bases.decode(), quals, {})


# ------------------------------------------------------------------ containers

@dataclass
class ContainerHeader:
    length: int
    ref_id: int
    start1: int
    span: int
    nrecords: int
    counter: int
    nbases: int
    nblocks: int
    landmarks: list[int]

    def tobytes(self) -> bytes:
        out = bytearray(struct.pack("<i", self.length))
        write_itf8(out, self.ref_id)
        write_itf8(out, self.start1)
        write_itf8(out, self.span)
        write_itf8(out, self.nrecords)
        write_ltf8(out, self.counter)
        write_ltf8(out, self.nbases)
        write_itf8(out, self.nblocks)
        write_itf8(out, len(self.landmarks))
        for lm in self.landmarks:
            write_itf8(out, lm)
        out += struct.pack("<I", zlib.crc32(bytes(out)))
        return bytes(out)

    @staticmethod
    def parse(buf: bytes, p: int) -> tuple["ContainerHeader", int]:
        (length,) = struct.unpack_from("<i", buf, p)
        p += 4
        rid, p = read_itf8(buf, p)
        start1, p = read_itf8(buf, p)
        span, p = read_itf8(buf, p)
        nrec, p = read_itf8(buf, p)
        counter, p = read_ltf8(buf, p)
        nbases, p = read_ltf8(buf, p)
        nblk, p = read_itf8(buf, p)
        nlm, p = read_itf8(buf, p)
        lms = []
        for _ in range(nlm):
            v, p = read_itf8(buf, p)
            lms.append(v)
        p += 4  # crc
        return ContainerHeader(length, rid, start1, span, nrec, counter,
                               nbases, nblk, lms), p


def parse_sq_lines(header_text: str) -> list[tuple[str, int]]:
    refs = []
    for line in header_text.splitlines():
        if line.startswith("@SQ"):
            name, ln = None, 0
            for fld in line.split("\t")[1:]:
                if fld.startswith("SN:"):
                    name = fld[3:]
                elif fld.startswith("LN:"):
                    ln = int(fld[3:])
            if name:
                refs.append((name, ln))
    return refs


class CramReader:
    """Whole-file CRAM decoder with the BamReader region-query surface.

    Reference-based records require the FASTA used at write time
    (`ref_path`); slices with embedded references use those instead.
    """

    def __init__(self, path: str, ref_path: str | None = None):
        from lancet2_tpu_torch.hts.fasta import Reference

        self.path = path
        data = hts_open(path, "rb").read()
        if data[:4] != CRAM_MAGIC:
            raise ValueError(f"{path}: not a CRAM file")
        self.major, self.minor = data[4], data[5]
        if self.major not in (2, 3):
            raise ValueError(f"CRAM major version {self.major} unsupported")
        p = 26  # magic + version + 20-byte file id
        self._fasta = Reference(ref_path) if ref_path else None
        self._ref_cache: dict[int, str] = {}

        # SAM header container
        ch, p = ContainerHeader.parse(data, p)
        hdr_block, _ = Block.parse(data, p)
        p += ch.length
        (hlen,) = struct.unpack_from("<i", hdr_block.data, 0)
        self.header_text = hdr_block.data[4: 4 + hlen].decode()
        self.references = parse_sq_lines(self.header_text)
        self._name2rid = {n: i for i, (n, _) in enumerate(self.references)}
        self.sample_name = parse_sample_name(self.header_text)

        # Containers are scanned (headers only) here and DECODED LAZILY:
        # region fetch() decodes only containers whose (ref_id, start1,
        # span) overlap the query — bounded memory on multi-GB CRAMs
        # (reference: htslib's .crai-indexed cram_seek path). The container
        # table carries the same fields a .crai line does (hts/crai.py).
        self._data = data
        self._containers: list[tuple[int, ContainerHeader, int]] = []
        counter = 0
        while p < len(data):
            ch, q = ContainerHeader.parse(data, p)
            if ch.ref_id == -1 and ch.nrecords == 0 and ch.start1 == 4542278:
                break  # EOF container
            base = ch.counter if ch.counter else counter
            self._containers.append((p, ch, base))
            counter = base + ch.nrecords
            p = q + ch.length
        self._decoded: dict[int, list[BamRecord]] = {}
        self._records: list[BamRecord] | None = None

    def _decode_container(self, ci: int) -> list[BamRecord]:
        cached = self._decoded.get(ci)
        if cached is not None:
            return cached
        data = self._data
        p, ch, counter = self._containers[ci]
        _, q = ContainerHeader.parse(data, p)
        end = q + ch.length
        blocks = []
        bp = q
        while bp < end:
            blk, bp = Block.parse(data, bp)
            blocks.append(blk)
        comp = CompressionHeader.parse(blocks[0].data)
        records: list[BamRecord] = []
        bi = 1
        while bi < len(blocks):
            sh = SliceHeader.parse(blocks[bi].data)
            core = b""
            ext: dict[int, bytes] = {}
            for blk in blocks[bi + 1: bi + 1 + sh.nblocks]:
                if blk.content_type == CT_CORE:
                    core = blk.data
                else:
                    ext[blk.content_id] = blk.data
            sh.counter = sh.counter or counter
            embedded = None
            if sh.embedded_ref >= 0 and sh.embedded_ref in ext:
                embedded = (sh.start1, ext[sh.embedded_ref].decode())
            dec = _SliceDecoder(
                comp, sh, core, ext,
                self._make_ref_lookup(embedded), [n for n, _ in self.references],
            )
            records.extend(dec.decode_records())
            counter += sh.nrecords
            bi += 1 + sh.nblocks
        self._decoded[ci] = records
        return records

    @property
    def records(self) -> list[BamRecord]:
        """All records (decodes every container on first access)."""
        if self._records is None:
            out: list[BamRecord] = []
            for ci in range(len(self._containers)):
                out.extend(self._decode_container(ci))
            self._records = out
        return self._records

    def _make_ref_lookup(self, embedded):
        def lookup(rid: int, start1: int, end1: int) -> str:
            if end1 < start1:
                return ""
            if embedded is not None:
                off, seq = embedded
                return seq[start1 - off: end1 - off + 1]
            if self._fasta is None:
                return "N" * (end1 - start1 + 1)
            name = self.references[rid][0]
            return self._fasta.fetch(name, start1, end1)
        return lookup

    # ---- BamReader-compatible surface ----
    def ref_name(self, ref_id: int) -> str:
        return self.references[ref_id][0]

    def ref_id(self, name: str) -> int:
        return self._name2rid[name]

    def all_records(self) -> list[BamRecord]:
        return self.records

    def fetch(self, chrom: str, start1: int, end1: int) -> list[BamRecord]:
        """Region fetch decoding ONLY containers whose header span overlaps
        the query (multi-ref containers, ref_id == -2, are always decoded —
        their span is unknown until decode)."""
        rid = self._name2rid.get(chrom)
        if rid is None:
            return []
        lo0, hi0 = start1 - 1, end1
        recs: list[BamRecord] = []
        for ci, (_p, ch, _base) in enumerate(self._containers):
            if ch.ref_id == -2:
                recs.extend(self._decode_container(ci))
                continue
            if ch.ref_id != rid:
                continue
            c_lo0 = ch.start1 - 1
            if c_lo0 + ch.span <= lo0 or c_lo0 >= hi0:
                continue
            recs.extend(self._decode_container(ci))
        out = [
            r for r in recs
            if r.ref_id == rid and r.pos0 < hi0 and r.reference_end0() > lo0
        ]
        out.sort(key=lambda r: r.pos0)  # stable: file order preserved on ties
        return out

    def close(self) -> None:
        if self._fasta is not None:
            self._fasta.close()


# ------------------------------------------------------------------ writer

_EXT_SERIES_INT = ["BF", "CF", "RL", "AP", "RG", "MF", "NS", "NP", "TS",
                   "TL", "FN", "FP", "DL", "MQ", "HC", "PD", "RS"]
_EXT_SERIES_BYTE = ["FC", "BA", "BS", "QS"]
_EXT_SERIES_ARR = ["IN", "SC", "BB", "QQ"]


class CramWriter:
    """Coordinate-sorted CRAM 3.0 writer: one slice per container,
    reference-based features, detached mate info, EXTERNAL series."""

    def __init__(self, path: str, header_text: str, ref_path: str,
                 records_per_slice: int = 10000, method: int = M_GZIP):
        from lancet2_tpu_torch.hts.fasta import Reference

        self.fh = open(path, "wb")
        self.method = method
        self.rps = records_per_slice
        self.header_text = header_text
        self.references = parse_sq_lines(header_text)
        self._fasta = Reference(ref_path)
        self._pending: list[BamRecord] = []
        self._counter = 0
        self.fh.write(CRAM_MAGIC + bytes([3, 0]) + (path.encode() + b"\x00" * 20)[:20])
        hdr = struct.pack("<i", len(header_text.encode())) + header_text.encode()
        blk = Block(CT_FILE_HEADER, 0, hdr, M_RAW).tobytes()
        chd = ContainerHeader(len(blk), 0, 0, 0, 0, 0, 0, 1, [0])
        self.fh.write(chd.tobytes() + blk)

    def add(self, rec: BamRecord) -> None:
        self._pending.append(rec)
        if len(self._pending) >= self.rps:
            self._flush_slice()

    def _features(self, rec: BamRecord, sm: bytes):
        """BAM record -> (features, uses_ref). Feature positions are 1-based
        read coordinates; deltas are emitted by the caller."""
        feats = []
        qpos = 1
        rpos = rec.pos0 + 1
        seq = rec.seq.upper()
        for op, ln in rec.cigar:
            opc = CIGAR_OPS[op]
            if opc in ("M", "=", "X"):
                ref = self._fasta.fetch(self.references[rec.ref_id][0],
                                        rpos, rpos + ln - 1).upper()
                for k in range(ln):
                    rb = ref[k] if k < len(ref) else "N"
                    qb = seq[qpos - 1 + k]
                    if qb != rb:
                        code = _sub_code(sm, rb, qb)
                        if code is not None:
                            feats.append((qpos + k, "X", code))
                        else:
                            feats.append((qpos + k, "B",
                                          (ord(qb), int(rec.qual[qpos - 1 + k]))))
                qpos += ln
                rpos += ln
            elif opc == "I":
                feats.append((qpos, "I", seq[qpos - 1: qpos - 1 + ln].encode()))
                qpos += ln
            elif opc == "S":
                feats.append((qpos, "S", seq[qpos - 1: qpos - 1 + ln].encode()))
                qpos += ln
            elif opc == "D":
                feats.append((qpos, "D", ln))
                rpos += ln
            elif opc == "N":
                feats.append((qpos, "N", ln))
                rpos += ln
            elif opc == "H":
                feats.append((qpos, "H", ln))
            elif opc == "P":
                feats.append((qpos, "P", ln))
        return feats

    def _flush_slice(self) -> None:
        recs = self._pending
        self._pending = []
        if not recs:
            return
        sm = _default_sub_matrix()
        # tag dictionary: one line per distinct tag signature
        tag_lines: list[tuple] = []
        line_of: dict[tuple, int] = {}
        rec_tl = []
        for r in recs:
            sig = tuple(sorted((k, _bam_tag_type(v)) for k, v in r.tags.items()))
            if sig not in line_of:
                line_of[sig] = len(tag_lines)
                tag_lines.append(sig)
            rec_tl.append(line_of[sig])

        comp = CompressionHeader(
            preserve_rn=True, ap_delta=False, ref_required=True, sub_matrix=sm,
            tag_dict=[list(sig) for sig in tag_lines] or [[]],
        )
        streams: dict[str, bytearray] = {}
        cid_of: dict[str, int] = {}
        next_cid = 1

        def cid(key: str) -> int:
            nonlocal next_cid
            if key not in cid_of:
                cid_of[key] = next_cid
                streams[key] = bytearray()
                next_cid += 1
            return cid_of[key]

        for key in _EXT_SERIES_INT + _EXT_SERIES_BYTE:
            comp.ds_enc[key] = Encoding(E_EXTERNAL, {"cid": cid(key)})
        comp.ds_enc["RN"] = Encoding(E_BYTE_ARRAY_STOP, {"stop": 0, "cid": cid("RN")})
        for key in _EXT_SERIES_ARR:
            comp.ds_enc[key] = Encoding(E_BYTE_ARRAY_LEN, {
                "len_enc": Encoding(E_EXTERNAL, {"cid": cid(key + ".len")}),
                "val_enc": Encoding(E_EXTERNAL, {"cid": cid(key + ".val")}),
            })
        tag_keys = {}
        for sig in tag_lines:
            for tag, typ in sig:
                key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
                if key not in tag_keys:
                    skey = f"tag.{tag}.{typ}"
                    comp.tag_enc[key] = Encoding(E_BYTE_ARRAY_LEN, {
                        "len_enc": Encoding(E_EXTERNAL, {"cid": cid(skey + ".len")}),
                        "val_enc": Encoding(E_EXTERNAL, {"cid": cid(skey + ".val")}),
                    })
                    tag_keys[key] = skey

        def put_int(key: str, v: int) -> None:
            write_itf8(streams[key], v)

        def put_byte(key: str, v: int) -> None:
            streams[key].append(v & 0xFF)

        def put_arr(key: str, data: bytes) -> None:
            write_itf8(streams[key + ".len"], len(data))
            streams[key + ".val"] += data

        rid = recs[0].ref_id
        multiref = any(r.ref_id != rid for r in recs)
        slice_rid = -2 if multiref else rid
        if multiref:
            comp.ds_enc["RI"] = Encoding(E_EXTERNAL, {"cid": cid("RI")})
        start1 = min(r.pos0 for r in recs) + 1
        span = max(r.reference_end0() for r in recs) - start1 + 1

        nbases = 0
        for i, r in enumerate(recs):
            nbases += len(r.seq)
            cf = 1 | 2  # quals stored + detached
            put_int("BF", r.flag)
            put_int("CF", cf)
            if multiref:
                put_int("RI", r.ref_id)
            put_int("RL", len(r.seq))
            put_int("AP", r.pos0 + 1)
            put_int("RG", -1)
            streams["RN"] += r.qname.encode() + b"\x00"
            mf = (1 if r.flag & FLAG_MATE_REVERSE else 0) | (
                2 if r.flag & FLAG_MATE_UNMAPPED else 0)
            put_int("MF", mf)
            put_int("NS", r.next_ref_id)
            put_int("NP", r.next_pos0 + 1)
            put_int("TS", r.tlen)
            put_int("TL", rec_tl[i])
            for tag, typ in tag_lines[rec_tl[i]]:
                skey = tag_keys[(ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)]
                put_arr(skey, _encode_tag_value(typ, r.tags[tag]))
            if not r.flag & FLAG_UNMAPPED:
                feats = self._features(r, sm)
                put_int("FN", len(feats))
                last = 0
                for fpos, fc, val in feats:
                    put_byte("FC", ord(fc))
                    put_int("FP", fpos - last)
                    last = fpos
                    if fc == "X":
                        put_byte("BS", val)
                    elif fc == "B":
                        put_byte("BA", val[0])
                        put_byte("QS", val[1])
                    elif fc in ("I", "S"):
                        put_arr({"I": "IN", "S": "SC"}[fc], val)
                    elif fc == "D":
                        put_int("DL", val)
                    elif fc == "N":
                        put_int("RS", val)
                    elif fc == "H":
                        put_int("HC", val)
                    elif fc == "P":
                        put_int("PD", val)
                put_int("MQ", r.mapq)
                streams["QS"] += bytes(np.asarray(r.qual, np.uint8))
            else:
                for ch in r.seq:
                    put_byte("BA", ord(ch))
                streams["QS"] += bytes(np.asarray(r.qual, np.uint8))

        ext_blocks = []
        content_ids = []
        for key, buf in streams.items():
            bcid = cid_of[key]
            content_ids.append(bcid)
            ext_blocks.append(Block(CT_EXTERNAL, bcid, bytes(buf),
                                    self.method if buf else M_RAW))
        core = Block(CT_CORE, 0, b"", M_RAW)
        sh = SliceHeader(slice_rid, start1 if not multiref else 0,
                         span if not multiref else 0, len(recs),
                         self._counter, 1 + len(ext_blocks), content_ids)
        slice_blocks = [Block(CT_SLICE_HEADER, 0, sh.tobytes(), M_RAW), core] + ext_blocks

        comp_block = Block(CT_COMPRESSION_HEADER, 0, comp.tobytes(), M_RAW)
        payload = bytearray()
        landmarks = []
        for blk in [comp_block] + slice_blocks:
            if blk is slice_blocks[0]:
                landmarks.append(len(payload))
            payload += blk.tobytes()
        chd = ContainerHeader(
            len(payload), slice_rid, sh.start1, sh.span, len(recs),
            self._counter, nbases, 1 + len(slice_blocks), landmarks)
        self.fh.write(chd.tobytes() + bytes(payload))
        self._counter += len(recs)

    def close(self) -> None:
        self._flush_slice()
        self.fh.write(EOF_CONTAINER)
        self.fh.close()
        self._fasta.close()


def is_cram(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(4) == CRAM_MAGIC


def bam_to_cram(bam_path: str, cram_path: str, ref_path: str,
                method: int = M_GZIP) -> int:
    """Convert a BAM to CRAM 3.0; returns the record count."""
    from lancet2_tpu_torch.hts.bam import BamReader

    br = BamReader(bam_path, use_native=False)
    w = CramWriter(cram_path, br.header_text, ref_path, method=method)
    n = 0
    for rec in br.all_records():
        w.add(rec)
        n += 1
    w.close()
    return n


def read_cram_header(path: str) -> tuple[str, list[tuple[str, int]]]:
    """Header-only CRAM read: file definition + first container."""
    with open(path, "rb") as fh:
        head = fh.read(26)
        if head[:4] != CRAM_MAGIC:
            raise ValueError(f"{path}: not a CRAM file")
        chunk = fh.read(1 << 20)
    ch, p = ContainerHeader.parse(chunk, 0)
    blk, _ = Block.parse(chunk, p)
    (hlen,) = struct.unpack_from("<i", blk.data, 0)
    text = blk.data[4: 4 + hlen].decode()
    return text, parse_sq_lines(text)
