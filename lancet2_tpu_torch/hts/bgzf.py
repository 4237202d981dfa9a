"""BGZF (blocked gzip) reader/writer in pure Python + zlib.

BGZF is the container format for BAM and bgzipped VCF: a series of gzip
members, each carrying a "BC" extra subfield with the compressed block size,
terminated by a fixed 28-byte EOF block. Output written here is readable by
standard htslib/bgzip tooling.

Replaces the role of the reference's htslib BGZF layer and BgzfOstream
(reference: src/lancet/hts/bgzf_ostream.{h,cpp}). A native C++ decoder with
libdeflate is the planned hot-path replacement; this module defines the
format contract and is the correctness baseline.
"""

from __future__ import annotations

import io
import struct
import zlib

from lancet2_tpu_torch.hts.uri import hts_open

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_MAX_BLOCK = 65280  # uncompressed payload per block (matches htslib)


class BgzfError(ValueError):
    pass


def _read_block(fh) -> bytes | None:
    """Read and inflate one BGZF block; None at clean EOF."""
    header = fh.read(12)
    if len(header) == 0:
        return None
    if len(header) < 12:
        raise BgzfError("truncated BGZF header")
    magic1, magic2, method, flags, _mtime, _xfl, _os, xlen = struct.unpack(
        "<BBBBIBBH", header
    )
    if magic1 != 0x1F or magic2 != 0x8B or method != 8 or not flags & 4:
        raise BgzfError("not a BGZF block (bad gzip magic/flags)")
    extra = fh.read(xlen)
    if len(extra) < xlen:
        raise BgzfError("truncated BGZF extra field")
    bsize = None
    off = 0
    while off + 4 <= xlen:
        si1, si2, slen = extra[off], extra[off + 1], struct.unpack_from("<H", extra, off + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            bsize = struct.unpack_from("<H", extra, off + 4)[0] + 1
        off += 4 + slen
    if bsize is None:
        raise BgzfError("missing BC subfield: not BGZF")
    cdata_len = bsize - xlen - 19 - 1
    cdata = fh.read(cdata_len)
    tail = fh.read(8)
    if len(cdata) < cdata_len or len(tail) < 8:
        raise BgzfError("truncated BGZF block")
    crc_expected, isize = struct.unpack("<II", tail)
    data = zlib.decompress(cdata, wbits=-15)
    if len(data) != isize:
        raise BgzfError("BGZF ISIZE mismatch")
    if zlib.crc32(data) != crc_expected:
        raise BgzfError("BGZF CRC mismatch")
    return data


def decompress_file(path: str) -> bytes:
    """Inflate an entire BGZF file into one bytes object."""
    chunks = []
    with hts_open(path, "rb") as fh:
        while True:
            block = _read_block(fh)
            if block is None:
                break
            chunks.append(block)
    return b"".join(chunks)


def _make_block(payload: bytes, level: int) -> bytes:
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    bsize = len(cdata) + 25 + 1  # header(12) + extra(6) + cdata + crc/isize(8)
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 8, 4, 0, 0, 0xFF,
        6, 0x42, 0x43, 2, bsize - 1,
    )
    tail = struct.pack("<II", zlib.crc32(payload), len(payload))
    return header + cdata + tail


class BgzfWriter(io.RawIOBase):
    """Streaming BGZF writer. Produces htslib-compatible blocks + EOF marker."""

    def __init__(self, path_or_fh, level: int = 6):
        self._own = isinstance(path_or_fh, (str, bytes))
        self._fh = hts_open(path_or_fh, "wb") if self._own else path_or_fh
        self._buf = bytearray()
        self._level = level

    def write(self, data) -> int:
        self._buf += bytes(data)
        while len(self._buf) >= _MAX_BLOCK:
            self._fh.write(_make_block(bytes(self._buf[:_MAX_BLOCK]), self._level))
            del self._buf[:_MAX_BLOCK]
        return len(data)

    def flush_block(self) -> None:
        if self._buf:
            self._fh.write(_make_block(bytes(self._buf), self._level))
            self._buf.clear()

    def sync(self) -> None:
        """Hand everything written so far to the operating system, as whole
        blocks: a reader of the file sees it even if this process dies."""
        self.flush_block()
        self._fh.flush()

    def close(self) -> None:
        if self.closed:
            return
        self.flush_block()
        self._fh.write(BGZF_EOF)
        self._fh.flush()
        if self._own:
            self._fh.close()
        super().close()


def compress_bytes(data: bytes, level: int = 6) -> bytes:
    """Compress a full buffer into BGZF blocks + EOF marker."""
    out = bytearray()
    for off in range(0, len(data), _MAX_BLOCK):
        out += _make_block(data[off : off + _MAX_BLOCK], level)
    out += BGZF_EOF
    return bytes(out)
