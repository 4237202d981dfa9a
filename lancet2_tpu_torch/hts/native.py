"""ctypes bindings for the native BGZF/BAM decoder (native/bam_decoder.cpp).

Builds the shared library from the repo's native/bam_decoder.cpp on first
use, into this package's own build directory (g++ + libdeflate;
utils/native_build.py) and exposes:

  bgzf_inflate(raw: bytes) -> bytes        parallel libdeflate inflation
  parse_records(buf, off)  -> dict of numpy columnar arrays + pools

The build tries, in order: the system's libdeflate header and `-ldeflate`;
the port's declaration of the three libdeflate functions the decoder calls
(csrc/libdeflate_decl/libdeflate.h, for a host with the library but not its
header) with `-ldeflate`; the same with the runtime library's soname
(`-l:libdeflate.so.0`, for a host without the unversioned link). When every
attempt fails, hts.bam decodes in Python, the correctness baseline: the
failure is logged once, and `build_error()` returns the compiler's messages.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from lancet2_tpu_torch.utils.logging import get_logger
from lancet2_tpu_torch.utils.native_build import build_library

LOG = get_logger("native")

_DECL_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
    "libdeflate_decl")
BUILD_ATTEMPTS = (
    ("system header, -ldeflate", ("-ldeflate",)),
    ("port declaration, -ldeflate", ("-I", _DECL_DIR, "-ldeflate")),
    ("port declaration, libdeflate.so.0",
     ("-I", _DECL_DIR, "-l:libdeflate.so.0")),
)

_lib = None
_load_failed = False
_build_log: list[tuple[str, str | None]] = []  # (attempt, error or None)


def _error_text(exc: Exception) -> str:
    if isinstance(exc, subprocess.CalledProcessError):
        err = exc.stderr.decode(errors="replace") if exc.stderr else ""
        return err.strip() or repr(exc)
    return repr(exc)


def _build():
    """Load the decoder from the first build attempt that works."""
    for name, flags in BUILD_ATTEMPTS:
        try:
            lib = ctypes.CDLL(build_library("bam_decoder.cpp", flags))
        except (subprocess.CalledProcessError, OSError) as exc:
            _build_log.append((name, _error_text(exc)))
            continue
        _build_log.append((name, None))
        return lib
    return None


def build_error() -> str | None:
    """The messages of every failed build attempt when no attempt loaded
    (the decoder is then unavailable); None when one did or none ran."""
    _ensure_lib()
    if _lib is not None or not _build_log:
        return None
    return "\n".join(f"[{name}] {err}" for name, err in _build_log)


def build_route() -> str | None:
    """The build attempt that loaded the decoder, if any."""
    _ensure_lib()
    return next((name for name, err in _build_log if err is None), None)


def _ensure_lib():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = _build()
        if lib is None:
            _load_failed = True
            LOG.warning("native BAM decoder unavailable, decoding in "
                        "Python: %s", "; ".join(
                            f"[{n}] {e.splitlines()[-1] if e else e}"
                            for n, e in _build_log))
            return None
        lib.l2t_bgzf_inflate.restype = ctypes.c_int
        lib.l2t_bgzf_inflate.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.l2t_free.argtypes = [ctypes.c_void_p]
        lib.l2t_bam_count.restype = ctypes.c_int64
        lib.l2t_bam_count.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t]
        lib.l2t_bam_parse.restype = ctypes.c_int64
        lib.l2t_event_scan.restype = ctypes.c_int64
        lib.l2t_hash_batch.restype = None
        _lib = lib
    except Exception as exc:
        _build_log.append(("bind", _error_text(exc)))
        _load_failed = True
        _lib = None
    return _lib


def available() -> bool:
    return _ensure_lib() is not None


def bgzf_inflate(raw: bytes) -> bytes | None:
    lib = _ensure_lib()
    if lib is None:
        return None
    out_ptr = ctypes.c_void_p()
    out_size = ctypes.c_size_t()
    rc = lib.l2t_bgzf_inflate(raw, len(raw), ctypes.byref(out_ptr), ctypes.byref(out_size))
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out_ptr, out_size.value)
    finally:
        lib.l2t_free(out_ptr)


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
    lib.l2t_hash_batch(c(pool), c(offs), c(lens),
                       ctypes.c_int64(len(offs)), c(out))
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
            ctypes.c_int64(n),
            c(cols["pos"]), c(cols["flag"]), c(cols["mapq"]),
            c(cols["n_cigar"]), c(cols["cigar_off"]), c(cols["cigar_pool"]),
            c(cols["l_seq"]), c(cols["seq_off"]), c(cols["qual_pool"]),
            c(cols["aux_off"]), c(cols["aux_len"]), c(cols["aux_pool"]),
            ctypes.c_int64(cap), c(ev_pos), c(ev_kind), c(ev_off),
        ))
        if total <= cap:
            return ev_pos[:total], ev_kind[:total].astype(np.int64), ev_off
        cap = total
    return None
