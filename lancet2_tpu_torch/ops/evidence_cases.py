"""Seeded pair batches that drive the evidence DP (K1/K2) through its edges.

`edge_pairs` is the batch that `chip_smoke.py`, `tests/test_torch_cuda.py`
and `tests/test_torch_evidence_cell.py` hold the kernel and its host
reference to against the plain version (ops/evidence_dp.py). Numpy only,
so that the jax-free card tests and the CPU tests share it.
"""

from __future__ import annotations

import numpy as np

from lancet2_tpu_torch.ops.evidence_layout import R_MAX


def edge_pairs(seed: int, B: int, Lq: int, Lt: int, R: int):
    """(q, qu, q_lens, t, t_lens, regions) as numpy arrays of the wrappers'
    dtypes: q, qu [B, Lq] uint8, q_lens [B] int32, t [B, Lt] uint8,
    t_lens [B] int32, regions [B, R_MAX, 2] int32 (slots >= R inactive).

    The first 88 pairs take every combination of q_len in {0, 1, 31, 32,
    33, 63, 64, 65, Lq, Lq+1, -1} and t_len in {0, 1, 5, 31, 32, 33, Lt,
    Lt+9}: the kernel's warp owns 32 query rows at a time (stripes end at
    rows 32 and 64) and moves its boundary row in chunks of 32 target
    columns. The rest draw q_len in [1, Lq] and t_len in [q_len, Lt].
    Reads are cut from their targets, and by pair index % 4 carry nothing
    more, a 3-8 base insertion at read rows 29.. (it crosses the stripe
    boundary at row 32), a 33-45 column deletion, or are random. A third
    of the targets are tandem repeats of a 1-3 base motif, where
    equal-score paths put the tie rules to work. 3% of read and target
    bases are N (code 4), positions past the lengths hold random codes,
    and each region slot is, by pair, at column 0, negative, ending at
    t_len, inactive, or random."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 6, (B, Lq)).astype(np.uint8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    q_lens = np.zeros(B, np.int32)
    t_lens = np.zeros(B, np.int32)
    q_grid = (0, 1, 31, 32, 33, 63, 64, 65, Lq, Lq + 1, -1)
    t_grid = (0, 1, 5, 31, 32, 33, Lt, Lt + 9)
    for b in range(B):
        if b < len(q_grid) * len(t_grid):
            ql, tl = q_grid[b % len(q_grid)], t_grid[b // len(q_grid)]
        else:
            ql = int(rng.integers(1, Lq + 1))
            tl = int(rng.integers(min(ql, Lt), Lt + 1))
        q_lens[b], t_lens[b] = ql, tl
        n, m = max(0, min(ql, Lq)), max(0, min(tl, Lt))
        if (b // 4) % 3 == 1:  # a tandem repeat: many equal-score paths
            motif = rng.integers(0, 4, int(rng.integers(1, 4)))
            t[b] = np.where(rng.random(Lt) < 0.05, rng.integers(0, 4, Lt),
                            np.resize(motif, Lt))
        kind = b % 4
        gap = int(rng.integers(33, 46)) if kind == 2 else int(rng.integers(3, 9))
        need = n + (gap if kind == 2 else 0)
        off = int(rng.integers(0, max(1, m - need)))
        seg = t[b, off:off + min(need, m)]
        if kind == 1:
            cut = min(29, seg.size)
            read = np.concatenate([seg[:cut], rng.integers(0, 4, gap), seg[cut:]])
        elif kind == 2:
            cut = n // 2
            read = np.concatenate([seg[:cut], seg[cut + gap:]])
        elif kind == 3:
            read = rng.integers(0, 4, n)
        else:
            read = seg
        read = np.concatenate([read, rng.integers(0, 4, n)])[:n]
        q[b, :n] = read
    q[rng.random((B, Lq)) < 0.03] = 4
    t[rng.random((B, Lt)) < 0.03] = 4
    qu = rng.integers(2, 42, (B, Lq)).astype(np.uint8)

    regions = np.zeros((B, R_MAX, 2), np.int32)
    tl = np.clip(t_lens, 0, Lt)
    for r in range(R):
        s = rng.integers(-12, Lt, B)
        e = s + rng.integers(1, 12, B)
        kind = (np.arange(B) + r) % 5
        s = np.where(kind == 0, 0, np.where(kind == 1, -rng.integers(1, 6, B), s))
        e = np.where(kind == 0, rng.integers(1, 8, B),
                     np.where(kind == 1, rng.integers(-1, 4, B), e))
        s = np.where(kind == 2, tl - rng.integers(1, 6, B), s)
        e = np.where(kind == 2, tl, e)
        e = np.where(kind == 3, s - rng.integers(0, 3, B), e)
        regions[:, r, 0] = s
        regions[:, r, 1] = np.minimum(e, Lt)
    return q, qu, q_lens, t, t_lens, regions
