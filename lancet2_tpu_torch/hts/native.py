"""ctypes bindings for the port's columnar BAM decoder (csrc/bam_decoder.cpp).

Builds the shared library from the package's csrc/bam_decoder.cpp on first
use, into this package's own build directory (g++ with no link flags: the
source needs no third-party header or library; utils/native_build.py), and
exposes:

  bgzf_inflate(raw: bytes) -> bytes        BGZF blocks inflated on threads
  parse_records(buf, off)  -> dict of numpy columnar arrays + pools
  hash_batch, event_scan                   qname hashes, active-region events

Inflation is Python's zlib, which releases the GIL while it inflates, over a
small thread pool; it needs no library. When the build fails, hts.bam
decodes records in Python, the correctness baseline: the failure is logged
once, and `build_error()` returns the compiler's messages.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lancet2_tpu_torch.hts import bgzf
from lancet2_tpu_torch.utils.logging import get_logger
from lancet2_tpu_torch.utils.native_build import build_library

LOG = get_logger("native")

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
ROUTE = "csrc/bam_decoder.cpp, zlib inflation, no library linked"
_MAX_INFLATE_THREADS = 8

_lib = None
_build_err: str | None = None  # set once the build or load has failed


def _error_text(exc: Exception) -> str:
    if isinstance(exc, subprocess.CalledProcessError):
        err = exc.stderr.decode(errors="replace") if exc.stderr else ""
        return err.strip() or repr(exc)
    return repr(exc)


def build_error() -> str | None:
    """The compiler's (or loader's) messages when the decoder failed to
    build or load; None when it loaded."""
    _ensure_lib()
    return _build_err


def build_route() -> str | None:
    """The build route that loaded the decoder; None when it did not."""
    return ROUTE if _ensure_lib() is not None else None


def _ensure_lib():
    global _lib, _build_err
    if _lib is not None or _build_err is not None:
        return _lib
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    try:
        lib = ctypes.CDLL(build_library("bam_decoder.cpp", _CSRC))
        lib.l2t_bam_count.restype = ctypes.c_int64
        lib.l2t_bam_count.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t]
        lib.l2t_bam_parse.restype = ctypes.c_int64
        lib.l2t_bam_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t, i64,
            *[vp] * 20,  # 15 columns, 5 pools
        ]
        lib.l2t_hash_batch.restype = None
        lib.l2t_hash_batch.argtypes = [vp, vp, vp, i64, vp]
        lib.l2t_event_scan.restype = ctypes.c_int64
        lib.l2t_event_scan.argtypes = [i64, *[vp] * 12, i64, vp, vp, vp]
        _lib = lib
    except (subprocess.CalledProcessError, OSError, AttributeError) as exc:
        _build_err = _error_text(exc)
        LOG.warning("native BAM decoder unavailable, decoding in Python: %s",
                    _build_err.splitlines()[-1])
    return _lib


def available() -> bool:
    return _ensure_lib() is not None


def bgzf_inflate(raw: bytes) -> bytes:
    """Inflate a whole BGZF file held in memory: the bytes of
    `bgzf.decompress_file`, with its checks (ISIZE, CRC32, framing),
    contiguous runs of blocks on up to 8 threads."""
    spans = bgzf.block_spans(raw)
    view = memoryview(raw)
    n = min(_MAX_INFLATE_THREADS, os.cpu_count() or 1)
    step = max(1, -(-len(spans) // n))
    runs = [spans[i : i + step] for i in range(0, len(spans), step)]

    def inflate(run):
        return [bgzf.inflate_block(view[a:b], view[b : b + 8]) for a, b in run]

    with ThreadPoolExecutor(max(1, len(runs))) as pool:
        return b"".join(itertools.chain.from_iterable(pool.map(inflate, runs)))


def parse_records(buf: bytes, off: int) -> dict | None:
    """Columnar parse of the BAM records region starting at byte `off`."""
    lib = _ensure_lib()
    if lib is None:
        return None
    n = int(lib.l2t_bam_count(buf, len(buf), off))
    if n < 0:
        return None
    size = len(buf)

    i32 = lambda: np.zeros(n, dtype=np.int32)
    i64 = lambda: np.zeros(n, dtype=np.int64)
    cols = {
        "ref_id": i32(), "pos": i32(), "next_ref_id": i32(), "next_pos": i32(),
        "tlen": i32(), "flag": np.zeros(n, dtype=np.uint16),
        "mapq": np.zeros(n, dtype=np.uint8), "l_seq": i32(),
        "n_cigar": np.zeros(n, dtype=np.uint16),
        "qname_off": i64(), "qname_len": np.zeros(n, dtype=np.uint8),
        "cigar_off": i64(), "seq_off": i64(), "aux_off": i64(),
        "aux_len": i32(),
    }
    # pools sized by the raw region size (upper bound on payload)
    region = size - off
    pools = {
        "qname_pool": np.zeros(region, dtype=np.uint8),
        "cigar_pool": np.zeros(max(region // 4, 1), dtype=np.uint32),
        "seq_pool": np.zeros(2 * region, dtype=np.uint8),
        "qual_pool": np.zeros(2 * region, dtype=np.uint8),
        "aux_pool": np.zeros(region, dtype=np.uint8),
    }
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    parsed = lib.l2t_bam_parse(
        buf, size, off, n,
        c(cols["ref_id"]), c(cols["pos"]), c(cols["next_ref_id"]), c(cols["next_pos"]),
        c(cols["tlen"]), c(cols["flag"]), c(cols["mapq"]), c(cols["l_seq"]),
        c(cols["n_cigar"]), c(cols["qname_off"]), c(cols["qname_len"]),
        c(cols["cigar_off"]), c(cols["seq_off"]), c(cols["aux_off"]), c(cols["aux_len"]),
        c(pools["qname_pool"]), c(pools["cigar_pool"]), c(pools["seq_pool"]),
        c(pools["qual_pool"]), c(pools["aux_pool"]),
    )
    if parsed != n:
        return None
    cols.update(pools)
    cols["count"] = n
    return cols


def hash_batch(pool: np.ndarray, offs: np.ndarray, lens: np.ndarray) -> np.ndarray | None:
    """FNV-1a-64 + avalanche of n pool slices (bit-identical to
    base.hashing.hash_str64); None when native is unavailable."""
    lib = _ensure_lib()
    if lib is None:
        return None
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    out = np.empty(len(offs), np.uint64)
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.l2t_hash_batch(c(pool), c(offs), c(lens), len(offs), c(out))
    return out


def event_scan(cols: dict) -> tuple | None:
    """Active-region mutation events for every record of a columnar parse,
    in file order: (ev_pos int64[T], ev_kind int64[T], ev_off int64[n+1]).
    Single C pass over the cigar/aux/qual pools — replaces the per-record
    Python MD state machine (core/active_region.py::_record_events)."""
    lib = _ensure_lib()
    if lib is None:
        return None
    n = int(cols["count"])
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    ev_off = np.zeros(n + 1, dtype=np.int64)
    cap = max(8 * n, 64)
    for _ in range(2):
        ev_pos = np.zeros(cap, dtype=np.int64)
        ev_kind = np.zeros(cap, dtype=np.uint8)
        total = int(lib.l2t_event_scan(
            n,
            c(cols["pos"]), c(cols["flag"]), c(cols["mapq"]),
            c(cols["n_cigar"]), c(cols["cigar_off"]), c(cols["cigar_pool"]),
            c(cols["l_seq"]), c(cols["seq_off"]), c(cols["qual_pool"]),
            c(cols["aux_off"]), c(cols["aux_len"]), c(cols["aux_pool"]),
            cap, c(ev_pos), c(ev_kind), c(ev_off),
        ))
        if total <= cap:
            return ev_pos[:total], ev_kind[:total].astype(np.int64), ev_off
        cap = total
    return None
