"""Batched dual-affine gap alignment DP — the framework's core compute op.

Replaces the reference's two alignment engines with one parameterizable DP:

  * read -> haplotype "fitting" alignment (query-global, free target end
    gaps): reproduces the scoring contract of the reference's minimap2
    configuration — single-affine a=1 b=4 q=q2=12 e=e2=3 with a dominant
    end_bonus forcing full-query extension (reference:
    src/lancet/caller/genotyper.cpp:89-191). This engine replaces the 36%
    ksw_extz2_sse CPU budget and is the flagship TPU kernel target.
  * haplotype -> reference-anchor global alignment with SPOA's convex
    dual-affine parameters m=0 mis=6 gap1=(6,2) gap2=(26,1) (reference:
    src/lancet/caller/msa_builder.h:17-71) — feeds bubble extraction in
    place of the POA graph walk.

Formulation (maps 1:1 onto the TPU):
  scan over query rows; vertical (insertion) gaps are an elementwise max;
  horizontal (deletion) gaps use the exact max-plus prefix-scan identity
    F[j] = cummax_k<=j(H_tmp[k-1] + e*k) - (q + e) - e*j
  so each row is pure vectorized work over [batch, target_len] — no
  per-cell sequential dependency (pure-system gaps dominate mixed-system
  gaps for convex params, so opening F from pre-F H is exact).

Direction bits are emitted per cell for host-side traceback:
  bits 0-2: H winner (0=diag, 1=V1, 2=V2, 3=F1, 4=F2)
  bit 3: V1 extend   bit 4: V2 extend   bit 5: F1 extend   bit 6: F2 extend

The numpy implementation is the correctness baseline; `jax_align_rows`
is the jitted device version (identical recurrences via lax.scan).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

NEG_INF = np.int32(-(1 << 29))

# H-winner codes
DIAG, V1, V2, F1, F2 = 0, 1, 2, 3, 4
# op codes for traceback output (match CIGAR op ids M/I/D)
OP_M, OP_I, OP_D = 0, 1, 2


@dataclass(frozen=True)
class AlignParams:
    match: int = 1
    mismatch: int = 4  # penalty (positive)
    gap_open1: int = 12  # affine: first gap base costs open+extend
    gap_extend1: int = 3
    gap_open2: int = 0  # second (convex) system; 0 disables
    gap_extend2: int = 0
    free_target_ends: bool = True  # fitting mode; False = global

    @property
    def dual(self) -> bool:
        return self.gap_open2 > 0 or self.gap_extend2 > 0


# Strict read->haplotype params (reference scoring_constants.h).
READ_TO_HAP = AlignParams(match=1, mismatch=4, gap_open1=12, gap_extend1=3,
                          free_target_ends=True)
# Forgiving haplotype->reference params (reference msa_builder.h; SPOA convex).
HAP_TO_REF = AlignParams(match=0, mismatch=6, gap_open1=6, gap_extend1=2,
                         gap_open2=26, gap_extend2=1, free_target_ends=False)


def substitution_scores(q_codes: np.ndarray, t_codes: np.ndarray, p: AlignParams) -> np.ndarray:
    """s(q, t): +match / -mismatch; any N (code 4) or pad (code>4) scores 0."""
    q = np.asarray(q_codes)
    t = np.asarray(t_codes)
    eq = q == t
    any_n = (q >= 4) | (t >= 4)
    return np.where(any_n, 0, np.where(eq, p.match, -p.mismatch)).astype(np.int32)


def align_batch_numpy(
    queries: np.ndarray,  # [B, Lq] uint8 codes (pad with 5)
    q_lens: np.ndarray,  # [B]
    targets: np.ndarray,  # [B, Lt] uint8 codes (pad with 5)
    t_lens: np.ndarray,  # [B]
    p: AlignParams,
) -> dict:
    """Reference-quality batched DP. Returns scores, end positions, dir matrix.

    Matrix layout: rows i=1..Lq (query), cols j=1..Lt (target); H has a
    virtual row/col 0. dirs[b, i-1, j-1] holds the packed direction byte for
    cell (i, j).
    """
    B, Lq = queries.shape
    Lt = targets.shape[1]
    q1, e1 = p.gap_open1, p.gap_extend1
    q2, e2 = (p.gap_open2, p.gap_extend2) if p.dual else (p.gap_open1, p.gap_extend1)

    jcols = np.arange(1, Lt + 1, dtype=np.int64)

    # target-pad mask per column
    t_valid = jcols[None, :] <= t_lens[:, None]  # [B, Lt]

    # H row 0: free leading target gap (fitting) or charged deletion (global)
    if p.free_target_ends:
        H_prev = np.zeros((B, Lt + 1), dtype=np.int32)
    else:
        del1 = -(q1 + e1 * jcols)
        del2 = -(q2 + e2 * jcols) if p.dual else del1
        row0 = np.maximum(del1, del2)[None, :].repeat(B, axis=0)
        H_prev = np.concatenate([np.zeros((B, 1), np.int32), row0.astype(np.int32)], axis=1)
        H_prev[:, 1:][~t_valid] = NEG_INF
    V1_prev = np.full((B, Lt + 1), NEG_INF, dtype=np.int32)
    V2_prev = np.full((B, Lt + 1), NEG_INF, dtype=np.int32)

    dirs = np.zeros((B, Lq, Lt), dtype=np.uint8)
    final_H = H_prev.copy()  # H row at i == q_len per pair

    brange = np.arange(B)
    for i in range(1, Lq + 1):
        qi = queries[:, i - 1]  # [B]
        sub = substitution_scores(qi[:, None], targets, p)  # [B, Lt]
        q_active = i <= q_lens  # [B]

        diag = H_prev[:, :-1] + sub  # [B, Lt]

        # vertical (insertion in query) gaps
        v1_open = H_prev[:, 1:] - (q1 + e1)
        v1_ext = V1_prev[:, 1:] - e1
        V1_row = np.maximum(v1_open, v1_ext)
        v1_is_ext = v1_ext >= v1_open
        if p.dual:
            v2_open = H_prev[:, 1:] - (q2 + e2)
            v2_ext = V2_prev[:, 1:] - e2
            V2_row = np.maximum(v2_open, v2_ext)
            v2_is_ext = v2_ext >= v2_open
        else:
            V2_row = np.full_like(V1_row, NEG_INF)
            v2_is_ext = np.zeros_like(v1_is_ext)

        H_tmp = np.maximum(diag, np.maximum(V1_row, V2_row))

        # horizontal (deletion from target) gaps via max-plus prefix scan
        # F[j] = cummax_{k<=j}(Htmp_full[k-1] + e*k) - (q+e) - e*j,
        # where Htmp_full[0] is the column-0 H value of this row.
        if p.free_target_ends:
            h_col0 = np.full(B, NEG_INF, dtype=np.int64)
            # column 0 = query prefix unaligned -> only valid as insertion run
            col0_h = np.maximum(
                -(q1 + e1 * i), -(q2 + e2 * i) if p.dual else NEG_INF
            )
            h_col0 = np.full(B, col0_h, dtype=np.int64)
        else:
            col0_h = max(-(q1 + e1 * i), -(q2 + e2 * i) if p.dual else int(NEG_INF))
            h_col0 = np.full(B, col0_h, dtype=np.int64)

        Htmp_full = np.concatenate([h_col0[:, None], H_tmp.astype(np.int64)], axis=1)
        C1 = Htmp_full[:, :-1] + e1 * (jcols - 1)[None, :] + e1  # H[k-1] + e*k
        F1_row = (np.maximum.accumulate(C1, axis=1) - (q1 + e1) - e1 * (jcols - 1)[None, :] - e1)
        f1_is_ext = np.zeros_like(F1_row, dtype=bool)
        f1_is_ext[:, 1:] = F1_row[:, 1:] == F1_row[:, :-1] - e1
        if p.dual:
            C2 = Htmp_full[:, :-1] + e2 * (jcols - 1)[None, :] + e2
            F2_row = (np.maximum.accumulate(C2, axis=1) - (q2 + e2) - e2 * (jcols - 1)[None, :] - e2)
            f2_is_ext = np.zeros_like(F2_row, dtype=bool)
            f2_is_ext[:, 1:] = F2_row[:, 1:] == F2_row[:, :-1] - e2
        else:
            F2_row = np.full_like(F1_row, np.int64(NEG_INF))
            f2_is_ext = np.zeros_like(f1_is_ext)

        F1_row = np.maximum(F1_row, np.int64(NEG_INF)).astype(np.int64)
        H_row = np.maximum(H_tmp.astype(np.int64), np.maximum(F1_row, F2_row))

        # winner codes (priority: diag > V1 > V2 > F1 > F2)
        winner = np.full(H_tmp.shape, F2, dtype=np.uint8)
        winner[F1_row >= H_row] = F1
        winner[V2_row >= H_row] = V2
        winner[V1_row >= H_row] = V1
        winner[diag >= H_row] = DIAG

        packed = (
            winner
            | (v1_is_ext.astype(np.uint8) << 3)
            | (v2_is_ext.astype(np.uint8) << 3 + 1)
            | (f1_is_ext.astype(np.uint8) << 3 + 2)
            | (f2_is_ext.astype(np.uint8) << 3 + 3)
        )
        dirs[:, i - 1, :] = packed

        H_row = H_row.astype(np.int32)
        H_row[~t_valid] = NEG_INF
        H_full = np.concatenate([h_col0[:, None].astype(np.int32), H_row], axis=1)
        V1_full = np.concatenate([np.full((B, 1), NEG_INF), V1_row], axis=1)
        V1_full[:, 1:][~t_valid] = NEG_INF
        V2_full = np.concatenate([np.full((B, 1), NEG_INF), V2_row], axis=1)
        V2_full[:, 1:][~t_valid] = NEG_INF

        # rows beyond a pair's query length must not evolve its state
        H_prev = np.where(q_active[:, None], H_full, H_prev)
        V1_prev = np.where(q_active[:, None], V1_full, V1_prev)
        V2_prev = np.where(q_active[:, None], V2_full, V2_prev)
        final_H = np.where((i == q_lens)[:, None], H_prev, final_H)

    if p.free_target_ends:
        masked = np.where(
            np.concatenate([np.zeros((B, 1), bool), t_valid], axis=1), final_H, NEG_INF
        )
        t_end = masked.argmax(axis=1)  # column index (==target pos, 1-based)
        score = masked[brange, t_end]
    else:
        t_end = t_lens.astype(np.int64)
        score = final_H[brange, t_end]

    return {"score": score.astype(np.int64), "t_end": t_end.astype(np.int64), "dirs": dirs}


def traceback_batch(
    dirs: np.ndarray,  # [B, Lq, Lt] packed direction bytes
    q_lens: np.ndarray,
    t_ends: np.ndarray,
    p: AlignParams,
) -> list[list[tuple[int, int]]]:
    """Recover CIGARs (list of (op, len), op in {M,I,D}) per pair.

    Walks from (q_len, t_end) to row 0. In fitting mode the walk stops at
    i == 0 (free leading target gap, start recorded); in global mode the
    remaining target prefix at i == 0 becomes a leading deletion.

    Vectorized across the batch: one fancy-indexed step per iteration.
    Returns CIGARs ordered 5'->3' plus the target start via op bookkeeping.
    """
    B, Lq, Lt = dirs.shape
    i = q_lens.astype(np.int64).copy()
    j = t_ends.astype(np.int64).copy()
    st = np.zeros(B, dtype=np.int8)  # 0=H, 1=V1, 2=V2, 3=F1, 4=F2
    active = i > 0
    max_steps = int(Lq + Lt + 2)
    ops_buf = np.full((B, max_steps), -1, dtype=np.int8)
    ptr = np.zeros(B, dtype=np.int64)

    for _ in range(max_steps):
        if not active.any():
            break
        bi = np.nonzero(active)[0]
        ii = i[bi]
        jj = j[bi]
        cell = dirs[bi, ii - 1, np.maximum(jj - 1, 0)]
        winner = cell & 0x7
        in_h = st[bi] == 0
        # state H: adopt winner; diag emits M, V* enters vertical, F* horizontal
        eff = np.where(in_h, winner, st[bi])

        emit = np.full(bi.size, OP_M, dtype=np.int8)
        di = np.zeros(bi.size, dtype=np.int64)
        dj = np.zeros(bi.size, dtype=np.int64)

        # Handle j == 0 in fitting/global: pure insertion column
        at_j0 = jj == 0
        # DIAG
        is_diag = (eff == DIAG) & ~at_j0
        emit[is_diag] = OP_M
        di[is_diag] = 1
        dj[is_diag] = 1
        # vertical (insertion)
        is_v = (eff == V1) | (eff == V2) | at_j0
        emit[is_v] = OP_I
        di[is_v] = 1
        # horizontal (deletion)
        is_f = ((eff == F1) | (eff == F2)) & ~at_j0
        emit[is_f] = OP_D
        dj[is_f] = 1

        # next state: for V/F, stay in gap state if extend bit set, else H
        v1_ext = (cell >> 3) & 1
        v2_ext = (cell >> 4) & 1
        f1_ext = (cell >> 5) & 1
        f2_ext = (cell >> 6) & 1
        nxt = np.zeros(bi.size, dtype=np.int8)
        nxt[(eff == V1) & (v1_ext == 1)] = 1
        nxt[(eff == V2) & (v2_ext == 1)] = 2
        nxt[(eff == F1) & (f1_ext == 1)] = 3
        nxt[(eff == F2) & (f2_ext == 1)] = 4
        nxt[at_j0] = 0

        ops_buf[bi, ptr[bi]] = emit
        ptr[bi] += 1
        i[bi] = ii - di
        j[bi] = jj - dj
        st[bi] = nxt
        active = i > 0

    cigars: list[list[tuple[int, int]]] = []
    for b in range(B):
        ops = ops_buf[b, : ptr[b]][::-1]
        if not p.free_target_ends and j[b] > 0:
            ops = np.concatenate([np.full(int(j[b]), OP_D, dtype=np.int8), ops])
        runs: list[tuple[int, int]] = []
        for op in ops:
            if runs and runs[-1][0] == op:
                runs[-1] = (int(op), runs[-1][1] + 1)
            else:
                runs.append((int(op), 1))
        cigars.append(runs)
    return cigars


def align_and_traceback(
    queries, q_lens, targets, t_lens, p: AlignParams
) -> list[dict]:
    """Convenience host API: per-pair {score, t_start, t_end, cigar}.

    Dispatches to the native C++ engine (native/assembly_core.cpp, bit-exact
    twin, ~10x) when available; the numpy path below is the baseline.
    """
    q_lens = np.asarray(q_lens, dtype=np.int64)
    t_lens = np.asarray(t_lens, dtype=np.int64)
    from lancet2_tpu_torch.base import native_core

    native = native_core.align_batch(queries, q_lens, targets, t_lens, p)
    if native is not None:
        return native
    out = align_batch_numpy(queries, q_lens, targets, t_lens, p)
    cigars = traceback_batch(out["dirs"], q_lens, out["t_end"], p)
    results = []
    for b in range(queries.shape[0]):
        cigar = cigars[b]
        t_span = sum(l for op, l in cigar if op in (OP_M, OP_D))
        t_end = int(out["t_end"][b])
        results.append(
            {
                "score": int(out["score"][b]),
                "t_end": t_end,
                "t_start": t_end - t_span if p.free_target_ends else 0,
                "cigar": cigar,
            }
        )
    return results
