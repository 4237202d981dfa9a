"""Seeded pair batches that drive K3, the score-only fitting DP, through its
edges.

`edge_pairs` is the batch that `chip_smoke.py`, `tests/test_torch_cuda.py`
and `tests/test_torch_sw_cell.py` hold the kernel and its host schedule to
against the plain version (ops/sw_dp.py). Numpy only, so that the jax-free
card tests and the CPU tests share it.
"""

from __future__ import annotations

import numpy as np

# Rows per lane of the kernel at the main path's shapes: 4 at the window
# step's Lq 128, 5 at bench.py's Lq 152 (csrc/sw_fitting.cuh, `plan`).
RPL_IN_USE = (4, 5)


def q_len_grid(Lq: int, rpls=RPL_IN_USE) -> list[int]:
    """q_len values at the kernel's edges: none, one row, a lane's worth of
    rows either side of 32, every stripe boundary 32 * rpl * k +- 1 up to
    Lq for each rows-per-lane value, Lq, and the two out of range."""
    grid = {0, 1, 31, 32, 33, Lq, Lq + 1, -1}
    for rpl in rpls:
        rows = 32 * rpl
        for k in range(1, Lq // rows + 2):
            grid.update(x for x in (k * rows - 1, k * rows, k * rows + 1)
                        if 1 <= x <= Lq)
    return sorted(grid)


def edge_pairs(seed: int, B: int, Lq: int, Lt: int, rpls=RPL_IN_USE):
    """(q, q_lens, t, t_lens) as numpy arrays of the wrapper's dtypes:
    q [B, Lq] uint8, q_lens [B] int32, t [B, Lt] uint8, t_lens [B] int32.

    The first pairs take every combination of q_len in `q_len_grid(Lq,
    rpls)` and t_len in {0, 1, 31, 32, 33, Lt, Lt+9}: a warp's lanes sweep
    the target's columns 32 apart, and its stripes of 32 * rpl query rows
    meet at boundary rows. The rest draw q_len in [1, Lq] (several stripes
    where Lq passes 32 * rpl) and t_len in [1, Lt]. Reads are cut from
    their targets, and by pair index % 4 carry nothing more, a 3-8 base
    insertion, a 5-40 column deletion, or are random. A third of the
    targets are tandem repeats of a 1-3 base motif, where ties for the first
    maximum are common. 3% of read and target bases are N (code 4); past
    the lengths even pairs hold padding (code 5) and odd pairs random codes
    0-5."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, Lq), np.uint8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    q_lens = np.zeros(B, np.int32)
    t_lens = np.zeros(B, np.int32)
    q_grid = q_len_grid(Lq, rpls)
    t_grid = (0, 1, 31, 32, 33, Lt, Lt + 9)
    for b in range(B):
        if b < len(q_grid) * len(t_grid):
            ql, tl = q_grid[b % len(q_grid)], t_grid[b // len(q_grid)]
        else:
            ql = int(rng.integers(1, Lq + 1))
            tl = int(rng.integers(1, Lt + 1))
        q_lens[b], t_lens[b] = ql, tl
        n, m = max(0, min(ql, Lq)), max(0, min(tl, Lt))
        if (b // 4) % 3 == 1:  # a tandem repeat: many equal-score paths
            motif = rng.integers(0, 4, int(rng.integers(1, 4)))
            t[b] = np.where(rng.random(Lt) < 0.05, rng.integers(0, 4, Lt),
                            np.resize(motif, Lt))
        kind = b % 4
        gap = int(rng.integers(5, 41)) if kind == 2 else int(rng.integers(3, 9))
        need = n + (gap if kind == 2 else 0)
        off = int(rng.integers(0, max(1, m - need)))
        seg = t[b, off:off + min(need, m)]
        if kind == 1:
            cut = seg.size // 2
            read = np.concatenate([seg[:cut], rng.integers(0, 4, gap), seg[cut:]])
        elif kind == 2:
            cut = n // 2
            read = np.concatenate([seg[:cut], seg[cut + gap:]])
        elif kind == 3:
            read = rng.integers(0, 4, n)
        else:
            read = seg
        q[b, :n] = np.concatenate([read, rng.integers(0, 4, n)])[:n]
        if b % 2 == 0:
            q[b, n:] = 5
            t[b, m:] = 5
        else:
            q[b, n:] = rng.integers(0, 6, Lq - n)
            t[b, m:] = rng.integers(0, 6, Lt - m)
    q[(rng.random((B, Lq)) < 0.03) & (q < 4)] = 4
    t[(rng.random((B, Lt)) < 0.03) & (t < 4)] = 4
    return q, q_lens, t, t_lens
