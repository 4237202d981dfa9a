"""Deterministic 64-bit hashing for k-mer identities and read names.

The reference derives node identity from a 64-bit string hash of the canonical
k-mer sequence (reference: src/lancet/base/hash.h:10, src/lancet/cbdg/kmer.cpp
Kmer::Kmer). The exact hash function is an internal detail — only determinism
and collision resistance matter — so we use FNV-1a-64 with an avalanche
finalizer, which vectorizes cleanly over numpy uint64 matrices (one lane per
k-mer) and is byte-for-byte reproducible across hosts/runs.
"""

from __future__ import annotations

import numpy as np

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)

# splitmix64 finalizer constants for avalanche mixing.
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _mix64(x: np.ndarray | np.uint64) -> np.ndarray | np.uint64:
    x = np.uint64(x) if np.isscalar(x) else x.astype(np.uint64)
    x ^= x >> np.uint64(30)
    x *= _MIX1
    x ^= x >> np.uint64(27)
    x *= _MIX2
    x ^= x >> np.uint64(31)
    return x


_M64 = (1 << 64) - 1


def hash_str64(data: str | bytes) -> int:
    """FNV-1a-64 + avalanche of a byte string. Deterministic across runs.

    Pure-int implementation (no numpy scalar ops — this is called once per
    read qname and profiles hot); bit-identical to the vectorized formulas.
    """
    if isinstance(data, str):
        data = data.encode("ascii")
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & _M64
    # splitmix64 avalanche (_mix64)
    h ^= h >> 30
    h = (h * 0xBF58476D1CE4E5B9) & _M64
    h ^= h >> 27
    h = (h * 0x94D049BB133111EB) & _M64
    h ^= h >> 31
    return h


def hash_u64_array(words: np.ndarray) -> np.ndarray:
    """Row-wise hash of a [n, w] uint64 matrix -> [n] uint64.

    Used to hash packed k-mer words: each row is one k-mer's 2-bit packing.
    """
    words = np.asarray(words, dtype=np.uint64)
    if words.ndim == 1:
        words = words[:, None]
    with np.errstate(over="ignore"):
        h = np.full(words.shape[0], _FNV_OFFSET, dtype=np.uint64)
        for col in range(words.shape[1]):
            h = (h ^ words[:, col]) * _FNV_PRIME
        return _mix64(h)


def hash_kmer_matrix(codes: np.ndarray) -> np.ndarray:
    """Hash a [n, k] uint8 code matrix row-wise -> [n] uint64 identifiers.

    Packs 8 bases per uint64 word using the raw 0..4 codes (so N bases hash
    distinctly) then applies the row-wise word hash. Deterministic.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n, k = codes.shape
    pad = (-k) % 8
    if pad:
        codes = np.concatenate(
            [codes, np.zeros((n, pad), dtype=np.uint8)], axis=1
        )
    # View groups of 8 bytes as little-endian uint64 words.
    words = codes.reshape(n, -1, 8).astype(np.uint64)
    shifts = (np.arange(8, dtype=np.uint64) * np.uint64(8))[None, None, :]
    packed = (words << shifts).sum(axis=2, dtype=np.uint64)
    # Mix in k so equal-prefix kmers of different lengths never collide.
    with np.errstate(over="ignore"):
        out = hash_u64_array(packed)
        out ^= _mix64(np.uint64(k))
    return out
