"""DNA alphabet encoding and reverse-complement primitives.

Numeric base encoding follows the reference caller's convention
(reference: src/lancet/caller/scoring_constants.h:812-838):
    A/a -> 0, C/c -> 1, G/g -> 2, T/t -> 3, everything else -> 4 (N)

The 0..3 code order matches lexicographic DNA order (A<C<G<T), so comparing
code vectors lexicographically is equivalent to comparing sequence strings —
which is what canonical-kmer selection relies on
(reference: src/lancet/cbdg/kmer.cpp IsCanonicallyPlus).
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4

# ASCII -> code lookup (256 entries).
ENCODE_TABLE = np.full(256, N, dtype=np.uint8)
for _ch, _code in (("A", A), ("C", C), ("G", G), ("T", T)):
    ENCODE_TABLE[ord(_ch)] = _code
    ENCODE_TABLE[ord(_ch.lower())] = _code

# code -> ASCII lookup.
DECODE_TABLE = np.frombuffer(b"ACGTN", dtype=np.uint8).copy()

# code -> complement code. N complements to N.
COMPLEMENT_CODE = np.array([T, G, C, A, N], dtype=np.uint8)

# ASCII -> complement ASCII (for string-level revcomp; unknown -> 'N').
_COMPLEMENT_ASCII = np.full(256, ord("N"), dtype=np.uint8)
for _fwd, _rev in (("A", "T"), ("C", "G"), ("G", "C"), ("T", "A")):
    _COMPLEMENT_ASCII[ord(_fwd)] = ord(_rev)
    _COMPLEMENT_ASCII[ord(_fwd.lower())] = ord(_rev)


def encode(seq: str | bytes) -> np.ndarray:
    """Encode an ASCII DNA sequence into uint8 codes (0..4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return ENCODE_TABLE[raw]


def decode(codes: np.ndarray) -> str:
    """Decode uint8 codes (0..4) back to an ASCII DNA string."""
    return DECODE_TABLE[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement a code vector (or batch along the last axis)."""
    return COMPLEMENT_CODE[codes][..., ::-1]


def revcomp_str(seq: str) -> str:
    """Reverse-complement an ASCII DNA string."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _COMPLEMENT_ASCII[raw][::-1].tobytes().decode("ascii")
