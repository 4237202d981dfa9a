"""K-mer repeat detection over reference window sequences.

Reproduces the reference's two repeat gates (reference: src/lancet/base/repeat.h:12-28,
repeat.cpp:13-69, used at src/lancet/core/variant_builder.cpp:117 and
src/lancet/cbdg/graph.cpp:120):

  * exact repeat : any k-mer occurring twice in the window -> window skipped
                   (a de Bruijn graph over it would contain a cycle by construction)
  * approx repeat: any pair of k-mers within `max_mismatch` Hamming distance
                   (default 2) -> skip this k in the retry cascade

The reference's SIMD Hamming kernel is 9.4% of its CPU profile. Host-side we
vectorize with numpy popcounts over 2-bit-packed words.
"""

from __future__ import annotations

import numpy as np

from lancet2_tpu_torch.base.hashing import hash_kmer_matrix


def sliding_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """All k-length windows of a 1-D code vector as a [n-k+1, k] view."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if codes.size < k:
        return np.empty((0, k), dtype=np.uint8)
    return np.lib.stride_tricks.sliding_window_view(codes, k)


def pack_2bit(kmers: np.ndarray) -> np.ndarray:
    """Pack a [n, k] code matrix (codes 0..3; N clamped to 0) into uint64 words.

    Returns [n, ceil(k/32)] uint64. Two bits per base.
    """
    kmers = np.asarray(kmers, dtype=np.uint8)
    n, k = kmers.shape
    clamped = np.where(kmers > 3, 0, kmers).astype(np.uint64)
    pad = (-k) % 32
    if pad:
        clamped = np.concatenate([clamped, np.zeros((n, pad), dtype=np.uint64)], axis=1)
    grouped = clamped.reshape(n, -1, 32)
    shifts = (np.arange(32, dtype=np.uint64) * np.uint64(2))[None, None, :]
    return (grouped << shifts).sum(axis=2, dtype=np.uint64)


def hamming_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise Hamming distance between two [.., k] code matrices."""
    return np.count_nonzero(np.asarray(a) != np.asarray(b), axis=-1)


def has_exact_repeat(codes: np.ndarray, k: int) -> bool:
    """True if any k-mer occurs more than once in the sequence.

    Equivalent to the reference's hash-set O(n) exact check
    (reference: src/lancet/base/repeat.cpp HasExactRepeat).
    """
    kmers = sliding_codes(codes, k)
    if kmers.shape[0] < 2:
        return False
    ids = hash_kmer_matrix(kmers)
    ids.sort()
    return bool(np.any(ids[1:] == ids[:-1]))


_XOR_PAIR_MASK = np.uint64(0x5555555555555555)


def has_approx_repeat(
    codes: np.ndarray, k: int, max_mismatch: int = 2, chunk: int = 512
) -> bool:
    """True if any *distinct-position* pair of k-mers differs by <= max_mismatch bases.

    Mirrors the reference's O(n^2) pairwise early-exit scan with SIMD Hamming
    distance (reference: src/lancet/base/repeat.cpp approximate path; allows 2
    mismatches for the per-k reference-repeat gate, src/lancet/cbdg/graph.h:127-131).

    Implementation: pack 2-bit codes into uint64 words; the per-base mismatch
    count of (x XOR y) is popcount((lo|hi) of each 2-bit lane), computed via
    ((v | (v >> 1)) & 0x5555...). Chunked to bound memory at ~chunk*n words.
    """
    kmers = sliding_codes(codes, k)
    n = kmers.shape[0]
    if n < 2:
        return False
    if max_mismatch <= 0:
        return has_exact_repeat(codes, k)

    from lancet2_tpu_torch.base import native_core

    nat = native_core.has_approx_repeat_native(codes, k, max_mismatch)
    if nat is not None:
        return nat

    packed = pack_2bit(kmers)  # [n, w]
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        block = packed[lo:hi]  # [c, w]
        # Compare block rows against all later rows to visit each pair once.
        rest = packed[lo + 1 :]  # [m, w]
        if rest.shape[0] == 0:
            break
        x = block[:, None, :] ^ rest[None, :, :]  # [c, m, w]
        lanes = (x | (x >> np.uint64(1))) & _XOR_PAIR_MASK
        dist = np.bitwise_count(lanes).sum(axis=-1, dtype=np.int64)  # [c, m]
        # Mask pairs (i, j) with j <= i (already visited / self).
        rows = np.arange(lo, hi)[:, None]
        cols = np.arange(lo + 1, n)[None, :]
        valid = cols > rows
        if bool(np.any(valid & (dist <= max_mismatch))):
            return True
    return False
