"""Device k-mer graph construction of one window: canonicalize, sort and
segment-sum on a torch device.

Ports `lancet2_tpu/ops/graph_tpu.py` (`build_graph_device`), an XLA pass
there, plain torch ops here (sorts, cumulative sums, index_add_ and
scatter_reduce); `ops/graph_tape.py` runs the same steps over many windows.

  1. every (sequence, offset) k-mer occurrence becomes one lane;
  2. canonicalization = lexicographic min(fwd, revcomp) on 4-bit packed
     big-endian words (word compare == base-code lex compare); words are
     held in int64, and invalid lanes take 0xFFFFFFFF, above every valid
     word (codes are at most 5), so they sort last as the JAX pass's
     uint32 lanes do;
  3. occurrences are grouped by a multi-word lexsort, done as stable sorts
     from the least significant key, and segment boundaries;
  4. the per-read expected-error k-mer filter from prefix sums of the
     error probabilities, in float64 as the numpy path computes it
     (`cbdg/graph.py`; the JAX pass sums in float32);
  5. MateMer dedup = first occurrence per (k-mer, qname-hash, tag) group
     with at least one expected-error-clean member;
  6. per-(node, sample) support and per-role counts as segment sums.

The host hashes only the surviving canonical k-mers to FNV-1a-64 node ids.
Eager torch compiles nothing per shape, so the JAX pass's shape buckets are
gone: the occurrence grid is [S, L - k + 1] for the longest sequence L.
"""

from __future__ import annotations

import numpy as np
import torch

from lancet2_tpu_torch.base.phred import PHRED_TO_ERROR_PROB

BASES_PER_WORD = 8  # 4 bits per base code (0..4; N=4), MSB-first
INVALID_WORD = 0xFFFFFFFF
LABEL_REFERENCE = 1
LABEL_CASE = 4
_COMP = (3, 2, 1, 0, 4, 5)


def num_words(k: int) -> int:
    return -(-k // BASES_PER_WORD)


def pack_words(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """[n, k] int64 codes -> [n, W] int64 big-endian 4-bit packed words."""
    n = kmers.shape[0]
    W = num_words(k)
    pad = torch.zeros((n, W * BASES_PER_WORD - k), dtype=torch.int64,
                      device=kmers.device)
    words = torch.cat([kmers, pad], dim=1).reshape(n, W, BASES_PER_WORD)
    shifts = torch.arange(BASES_PER_WORD - 1, -1, -1, device=kmers.device) * 4
    return (words << shifts).sum(dim=2)


def canonical_words(kmers: torch.Tensor, k: int):
    """[n, k] int64 codes -> (canonical words [n, W], sign [n] int64: 0 when
    the forward k-mer is the canonical one, 1 for its reverse complement)."""
    comp = torch.tensor(_COMP, dtype=torch.int64, device=kmers.device)
    fwd_w = pack_words(kmers, k)
    rc_w = pack_words(comp[kmers.flip(1)], k)
    diff = fwd_w != rc_w
    first = torch.argmax(diff.to(torch.int8), dim=1, keepdim=True)
    is_plus = ~diff.any(dim=1) | (fwd_w.gather(1, first)
                                  <= rc_w.gather(1, first))[:, 0]
    canon = torch.where(is_plus[:, None], fwd_w, rc_w)
    return canon, (~is_plus).to(torch.int64)


def expected_error_ok(quals: torch.Tensor, k: int) -> torch.Tensor:
    """[R, L] u8 quals -> [R, L - k + 1] bool: floor(sum of the error
    probabilities of the k-mer's bases) <= 0, from a float64 prefix sum."""
    table = torch.from_numpy(PHRED_TO_ERROR_PROB).to(quals.device)
    errs = table[quals.to(torch.int64)]
    prefix = torch.cat([torch.zeros((errs.shape[0], 1), dtype=errs.dtype,
                                    device=errs.device),
                        torch.cumsum(errs, dim=1)], dim=1)
    return torch.floor(prefix[:, k:] - prefix[:, :-k]) <= 0


def lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """np.lexsort: the permutation sorting by keys[-1], then keys[-2], ...;
    ties keep their index order. Stable sorts from the least significant
    key."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in keys:
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def boundaries(*cols: torch.Tensor) -> torch.Tensor:
    """[n] bool: lane i opens a run (i == 0, or any column differs from lane
    i - 1); a 2-D column compares all its words."""
    n = cols[0].shape[0]
    new = torch.zeros(n, dtype=torch.bool, device=cols[0].device)
    if n:
        new[0] = True
    for c in cols:
        d = c[1:] != c[:-1]
        new[1:] |= d.any(dim=1) if d.dim() == 2 else d
    return new


def unpack_words(words: np.ndarray, k: int) -> np.ndarray:
    """[n, W] packed words -> [n, k] u8 codes (inverse of pack_words)."""
    words = np.asarray(words, np.uint64)
    n, W = words.shape
    shifts = np.arange(BASES_PER_WORD - 1, -1, -1, dtype=np.uint64) * np.uint64(4)
    bases = (words[:, :, None] >> shifts[None, None, :]) & np.uint64(0xF)
    return bases.reshape(n, W * BASES_PER_WORD)[:, :k].astype(np.uint8)


def support_counts(contrib: torch.Tensor, sample: torch.Tensor,
                   tag: torch.Tensor, seg: torch.Tensor, n_seg: int,
                   num_samples: int):
    """Segment sums of the MateMer contributions: per-(segment, sample)
    counts [n_seg, num_samples] and per-(segment, role) counts [n_seg, 2]
    (role 1 = case reads)."""
    dev = contrib.device
    counts = torch.zeros((n_seg * num_samples,), dtype=torch.int64, device=dev)
    counts.index_add_(0, seg * num_samples
                      + sample.clamp(0, num_samples - 1), contrib)
    roles = torch.zeros((n_seg * 2,), dtype=torch.int64, device=dev)
    roles.index_add_(0, seg * 2 + (tag == LABEL_CASE).to(torch.int64), contrib)
    return counts.reshape(n_seg, num_samples), roles.reshape(n_seg, 2)


def matemer_contrib(new_kmer, qlo, qhi, tag, ee):
    """Per lane 1 where it opens a (k-mer, qname-hash, tag) group with at
    least one expected-error-clean member, else 0 (lanes sorted)."""
    new_group = new_kmer | boundaries(qlo, qhi, tag)
    grp = torch.cumsum(new_group.to(torch.int64), 0) - 1
    n_grp = int(grp[-1]) + 1 if grp.numel() else 0
    has_ee = torch.zeros(n_grp, dtype=torch.int64, device=grp.device)
    has_ee.index_add_(0, grp, ee.to(torch.int64))
    return (new_group & (has_ee[grp] > 0)).to(torch.int64)


def build_graph_device(seqs, seq_quals, seq_meta, k: int, num_samples: int,
                       device: torch.device | str):
    """Device construction pass over one window's sequences on `device`.

    seqs: list of [len] u8 code arrays (ref first when present);
    seq_quals: list of [len] u8 or None; seq_meta: (label, sample, tag,
    qhash). Sequences shorter than k+1 must be pre-filtered by the caller.

    Returns the JAX function's dict: uniq ids/codes/counts/roles in segment
    (sorted) order, first_idx (grid index s*M + offset of each k-mer's first
    occurrence), and the per-occurrence inverse/sign/valid maps [S, M] with
    M = grid_m; None for no sequences.
    """
    from lancet2_tpu_torch.base.hashing import hash_kmer_matrix

    S = len(seqs)
    if S == 0:
        return None
    dev = torch.device(device)
    L = max(len(s) for s in seqs)
    M = L - k + 1
    codes = np.zeros((S, L), np.uint8)
    quals = np.zeros((S, L), np.uint8)
    lens = np.zeros(S, np.int64)
    meta = np.zeros((S, 5), np.int64)  # label, sample, tag, qlo, qhi
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = s
        lab, smp, tg, qh = seq_meta[i]
        if lab == LABEL_REFERENCE:
            quals[i, :len(s)] = 255  # ref occurrences never pass the EE gate
        elif seq_quals[i] is not None:
            quals[i, :len(s)] = seq_quals[i]
        lens[i] = len(s)
        meta[i] = (lab, max(smp, 0), tg, qh & 0xFFFFFFFF,
                   (qh >> 32) & 0xFFFFFFFF)

    t_codes = torch.from_numpy(codes).to(dev)
    t_meta = torch.from_numpy(meta).to(dev)
    is_ref = t_meta[:, 0] == LABEL_REFERENCE
    offs = torch.arange(M, device=dev)
    occ_valid = (offs[None, :] < (torch.from_numpy(lens).to(dev)[:, None]
                                  - k + 1)).reshape(-1)
    n_occ = S * M

    kmers = t_codes.to(torch.int64).unfold(1, k, 1).reshape(n_occ, k)
    canon, signs = canonical_words(kmers, k)
    canon = torch.where(occ_valid[:, None], canon,
                        torch.full_like(canon, INVALID_WORD))
    ee = (expected_error_ok(torch.from_numpy(quals).to(dev), k)
          & ~is_ref[:, None]).reshape(-1) & occ_valid

    occ_seq = torch.arange(S, device=dev).repeat_interleave(M)
    o_meta = t_meta[occ_seq]
    occ_orig = torch.arange(n_occ, device=dev)
    keys = [occ_orig, o_meta[:, 2], o_meta[:, 3], o_meta[:, 4]]
    keys += [canon[:, w] for w in range(canon.shape[1] - 1, -1, -1)]
    order = lexsort(keys)
    nv = int(occ_valid.sum())
    order = order[:nv]  # invalid lanes sort last
    s_w = canon[order]
    s_meta = o_meta[order]
    s_orig = occ_orig[order]

    new_kmer = boundaries(s_w)
    seg = torch.cumsum(new_kmer.to(torch.int64), 0) - 1
    n_uniq = int(seg[-1]) + 1 if nv else 0
    contrib = matemer_contrib(new_kmer, s_meta[:, 3], s_meta[:, 4],
                              s_meta[:, 2], ee[order])
    counts, roles = support_counts(contrib, s_meta[:, 1], s_meta[:, 2], seg,
                                   n_uniq, num_samples)
    first_idx = torch.full((n_uniq,), n_occ, dtype=torch.int64, device=dev)
    first_idx.scatter_reduce_(0, seg, s_orig, reduce="amin")
    inverse = torch.full((n_occ,), max(n_uniq - 1, 0), dtype=torch.int64,
                         device=dev)
    inverse[s_orig] = seg

    uniq_words = s_w[new_kmer].cpu().numpy()
    canon_codes = unpack_words(uniq_words, k)
    return {
        "ids": hash_kmer_matrix(canon_codes),
        "codes": canon_codes,
        "counts": counts.cpu().numpy(),
        "roles": roles.cpu().numpy(),
        "first_idx": first_idx.cpu().numpy(),
        "inverse": inverse.reshape(S, M).cpu().numpy(),
        "occ_sign": signs.reshape(S, M).cpu().numpy(),
        "occ_valid": occ_valid.reshape(S, M).cpu().numpy(),
        "grid_m": M,
    }
