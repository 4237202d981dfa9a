"""Canonical k-mer model for the colored bidirected de Bruijn graph.

Follows the BCALM2 bidirected conventions used by the reference
(reference: src/lancet/cbdg/kmer.{h,cpp}):

  * canonical sequence = lexicographically smaller of seq / revcomp(seq)
  * Sign PLUS means the node's canonical sequence was in the original
    orientation of the sequence that first created the node
  * 4 bidirected edge kinds {++, +-, -+, --}; an edge's mirror is
    (dst -> src) with both endpoint signs flipped
  * unitig merge concatenates the neighbor's non-overlapping suffix/prefix
    according to the connecting edge kind (Kmer::Merge / MergeCords)

Signs are encoded PLUS=0 / MINUS=1 so that kind == (src_sign << 1) | dst_sign
reproduces the reference enum order PLUS_PLUS=0, PLUS_MINUS=1, MINUS_PLUS=2,
MINUS_MINUS=3.
"""

from __future__ import annotations

import numpy as np

from lancet2_tpu_torch.base.dna import revcomp_codes
from lancet2_tpu_torch.base.hashing import hash_kmer_matrix

PLUS, MINUS = 0, 1
PP, PM, MP, MM = 0, 1, 2, 3


def make_kind(src_sign: int, dst_sign: int) -> int:
    return (src_sign << 1) | dst_sign


def src_sign(kind: int) -> int:
    return kind >> 1


def dst_sign(kind: int) -> int:
    return kind & 1


_REV_KIND = (3, 1, 2, 0)  # PP<->MM, PM/MP fixed


def rev_kind(kind: int) -> int:
    """Mirror-edge kind: flip both endpoint signs (PP<->MM, PM/MP fixed)."""
    return _REV_KIND[kind]


def flip_sign(sign: int) -> int:
    return 1 - sign


def canonicalize_batch(kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Canonicalize a [n, k] code matrix.

    Returns (canonical [n, k] uint8, occurrence_signs [n] uint8) where sign is
    PLUS when the input row was already canonical (palindromes -> PLUS, matching
    the reference's convention in IsCanonicallyPlus).
    """
    kmers = np.asarray(kmers, dtype=np.uint8)
    rc = revcomp_codes(kmers)
    # First column where fwd and rc differ decides the lexicographic order.
    diff = kmers != rc
    any_diff = diff.any(axis=1)
    first = np.where(any_diff, diff.argmax(axis=1), 0)
    rows = np.arange(kmers.shape[0])
    fwd_smaller = kmers[rows, first] <= rc[rows, first]
    is_plus = np.where(any_diff, fwd_smaller, True)
    canonical = np.where(is_plus[:, None], kmers, rc)
    signs = np.where(is_plus, PLUS, MINUS).astype(np.uint8)
    return canonical, signs


def kmer_ids(canonical: np.ndarray) -> np.ndarray:
    """[n] uint64 node identifiers from canonical code rows."""
    return hash_kmer_matrix(canonical)


def merge_codes(k1: np.ndarray, k2: np.ndarray, kind: int, k: int) -> np.ndarray:
    """Merge node sequences during unitig compaction.

    Reference: src/lancet/cbdg/kmer.cpp MergeCords. k1/k2 are canonical code
    vectors (k1 may exceed k after prior merges); returns the merged canonical
    sequence for the surviving node.
    """
    if kind == PP:
        return np.concatenate([k1, k2[k - 1 :]])
    if kind == PM:
        return np.concatenate([k1, revcomp_codes(k2)[k - 1 :]])
    if kind == MP:
        rc = revcomp_codes(k2)
        return np.concatenate([rc[: len(k2) - k + 1], k1])
    # MM
    return np.concatenate([k2[: len(k2) - k + 1], k1])
