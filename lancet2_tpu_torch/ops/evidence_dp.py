"""Plain PyTorch version of the traceback-free evidence DP.

A line-by-line port of the XLA-scan engine of
`lancet2_tpu/ops/evidence_dp.py` (`_make_engine`, `evidence_dp`): a loop over
query rows, each row vectorized over [pairs, target columns]; deletions go
through the packed value+source `torch.cummax` and their companions through
`torch.gather` from the gap-opening column. It is the contract the CUDA
kernel (csrc/evidence_dp.cu) is held to bit for bit, the CPU engine of the
port, and the oracle `chip_smoke.py` compares the kernel with on the card.

Per (read, haplotype) pair and per variant region r < r_max it returns
score, t_end, t_start, nm and, per region, qv, aligned, min_bq, raw, pbq and
matches (the reference's RegionAccumulator surface). `r_max=0` is the span
mode: score, t_end, t_start and nm only.

Tie rules (as the reference engine): diagonal wins over V, V over F; V
extension wins over V open; the earliest deletion source wins. A deletion's
pbq is the source's pbq plus float(overlap) * ge, added once. Float
accumulators are updated by separate torch ops (a product, then a sum), so
each rounds exactly as in the reference engine.
"""

from __future__ import annotations

import numpy as np
import torch

from lancet2_tpu_torch.ops.affine_dp import NEG_INF, READ_TO_HAP, AlignParams
from lancet2_tpu_torch.ops.evidence_layout import (  # noqa: F401
    BIG_BQ,
    R_MAX,
    REGION_FILL,
    REGION_FLOAT_KEYS,
    REGION_INT_KEYS,
    SPAN_KEYS,
)
from lancet2_tpu_torch.ops.params import KernelParams, from_jax

# The packed cummax keeps the column in 13 bits and the clamped value in 18:
# exact while |C| < 2^17, which Lq, Lt <= MAX_LEN guarantees.
MAX_LEN = 8192


def evidence_dp_torch(q, qu, q_lens, t, t_lens, regions, kp: KernelParams,
                      r_max: int = R_MAX) -> dict:
    """Tensors on one device: q, qu [B, Lq] uint8; q_lens [B] int32;
    t [B, Lt] uint8; t_lens [B] int32; regions [B, >=r_max, 2] int32 (start,
    end; end <= start deactivates a slot). Only slots < r_max are read; with
    r_max=0 neither `qu` nor `regions` is read (they may be None).
    Returns a dict of [B] and [B, r_max] tensors on the same device."""
    dev = q.device
    B, Lq = q.shape
    Lt = t.shape[1]
    R = r_max
    go, ge = kp.gap_open, kp.gap_extend
    i32 = torch.int32
    neg = int(NEG_INF)

    jcols = torch.arange(1, Lt + 1, dtype=i32, device=dev)
    tcols = jcols - 1
    t_codes = t.to(i32)
    t_lens = t_lens.to(i32)
    q_lens = q_lens.to(i32)
    t_valid = jcols[None, :] <= t_lens[:, None]

    NI, NF = 2 + 3 * R, 3 * R
    I_QV, I_AL, I_MB = 2, 2 + R, 2 + 2 * R
    F_RAW, F_PBQ, F_MT = 0, R, 2 * R

    if R:
        conf = kp.to(dev).conf[qu.long()]
        quals_i = qu.to(i32)
        vs = regions[:, :R, 0].to(i32)
        ve = regions[:, :R, 1].to(i32)
        active = ve > vs
        in_reg_col = ((tcols[None, None, :] >= vs[:, :, None])
                      & (tcols[None, None, :] < ve[:, :, None])
                      & active[:, :, None])
        pref = torch.cat([torch.zeros((B, R, 1), dtype=i32, device=dev),
                          torch.cumsum(in_reg_col.to(i32), dim=2, dtype=i32)],
                         dim=2)
        ins_in = ((jcols[None, None, :] >= vs[:, :, None])
                  & (jcols[None, None, :] < ve[:, :, None])
                  & active[:, :, None])
        consume_vs = (tcols[None, None, :] == vs[:, :, None]) & active[:, :, None]
        in0 = (vs <= 0) & (ve > 0) & active

    # ---- row 0 --------------------------------------------------------------
    H = torch.zeros((B, Lt + 1), dtype=i32, device=dev)
    V = torch.full((B, Lt + 1), neg, dtype=i32, device=dev)
    Hi = torch.zeros((B, NI, Lt + 1), dtype=i32, device=dev)
    Hi[:, 0, :] = torch.arange(0, Lt + 1, dtype=i32, device=dev)[None, :]
    if R:
        Hi[:, I_QV:I_QV + R, :] = -1
        Hi[:, I_MB:I_MB + R, :] = BIG_BQ
    Hf = torch.zeros((B, NF, Lt + 1), dtype=torch.float32, device=dev)
    Vi, Vf = Hi.clone(), Hf.clone()
    final_H, final_i, final_f = H.clone(), Hi.clone(), Hf.clone()
    minq_prefix = torch.full((B,), BIG_BQ, dtype=i32, device=dev)

    # rows past the longest query never reach `final`
    n_rows = min(Lq, int(q_lens.max())) if B else 0
    for i in range(1, n_rows + 1):
        qi = q[:, i - 1].to(i32)

        # ---- column-0 state of this row ---------------------------------
        col0_val = torch.full((B,), -(go + ge * i), dtype=i32, device=dev)
        col0_i = torch.zeros((B, NI), dtype=i32, device=dev)
        col0_i[:, 1] = i
        col0_f = torch.zeros((B, NF), dtype=torch.float32, device=dev)
        if R:
            qual_row = quals_i[:, i - 1]
            qconf = conf[:, i - 1]
            minq_prefix = torch.minimum(minq_prefix, qual_row)
            col0_i[:, I_QV:I_QV + R] = -1
            col0_i[:, I_AL:I_AL + R] = torch.where(in0, i, 0).to(i32)
            col0_i[:, I_MB:I_MB + R] = torch.where(
                in0, minq_prefix[:, None], BIG_BQ).to(i32)
            col0_f[:, F_PBQ:F_PBQ + R] = torch.where(
                in0, float(ge) * float(i), 0.0)

        # ---- diagonal candidate -----------------------------------------
        any_n = (qi[:, None] >= 4) | (t_codes >= 4)
        eq = qi[:, None] == t_codes
        sub = torch.where(any_n, 0,
                          torch.where(eq, kp.match, -kp.mismatch)).to(i32)
        diag = H[:, :-1] + sub
        di = Hi[:, :, :-1].clone()
        df = Hf[:, :, :-1].clone()
        di[:, 1, :] += (~eq).to(i32)
        if R:
            subf = sub.to(torch.float32)
            di[:, I_AL:I_AL + R, :] += in_reg_col.to(i32)
            mb = di[:, I_MB:I_MB + R, :]
            di[:, I_MB:I_MB + R, :] = torch.where(
                in_reg_col, torch.minimum(mb, qual_row[:, None, None]), mb)
            qv_old = di[:, I_QV:I_QV + R, :]
            di[:, I_QV:I_QV + R, :] = torch.where(
                consume_vs & (qv_old < 0), i - 1, qv_old).to(i32)
            df[:, F_RAW:F_RAW + R, :] += torch.where(
                in_reg_col, subf[:, None, :], 0.0)
            df[:, F_PBQ:F_PBQ + R, :] += torch.where(
                in_reg_col, subf[:, None, :] * qconf[:, None, None], 0.0)
            df[:, F_MT:F_MT + R, :] += torch.where(
                in_reg_col & eq[:, None, :], 1.0, 0.0)

        # ---- vertical (insertion) candidate -----------------------------
        v_open = H[:, 1:] - (go + ge)
        v_ext = V[:, 1:] - ge
        V_row = torch.maximum(v_open, v_ext)
        use_ext = (v_ext >= v_open)[:, None, :]
        vi = torch.where(use_ext, Vi[:, :, 1:], Hi[:, :, 1:])
        vf = torch.where(use_ext, Vf[:, :, 1:], Hf[:, :, 1:])
        vi[:, 1, :] += 1
        if R:
            vi[:, I_AL:I_AL + R, :] += ins_in.to(i32)
            mb = vi[:, I_MB:I_MB + R, :]
            vi[:, I_MB:I_MB + R, :] = torch.where(
                ins_in, torch.minimum(mb, qual_row[:, None, None]), mb)
            vf[:, F_PBQ:F_PBQ + R, :] += torch.where(ins_in, float(ge), 0.0)

        # ---- H_tmp = max(diag, V) (diag wins ties) ----------------------
        use_diag = (diag >= V_row)[:, None, :]
        H_tmp = torch.maximum(diag, V_row)
        ti = torch.where(use_diag, di, vi)
        tf = torch.where(use_diag, df, vf)

        # ---- F (deletions) via packed cummax ----------------------------
        Htmp_full = torch.cat([col0_val[:, None], H_tmp], dim=1)
        C = Htmp_full[:, :-1] + ge * jcols[None, :]
        ks = jcols[None, :]
        Cc = torch.clamp(C, -(1 << 17) + 1, (1 << 17) - 1)
        packed = ((Cc + (1 << 17)) << 13) + (Lt - ks)
        run_max = torch.cummax(packed, dim=1).values
        k_star = Lt - (run_max & ((1 << 13) - 1))
        c_star = (run_max >> 13) - (1 << 17)
        F_row = c_star - (go + ge) - ge * (jcols[None, :] - 1) - ge

        ti_full = torch.cat([col0_i[:, :, None], ti], dim=2)
        tf_full = torch.cat([col0_f[:, :, None], tf], dim=2)
        src = (k_star - 1).long()
        fi = torch.gather(ti_full, 2, src[:, None, :].expand(B, NI, Lt))
        ff = torch.gather(tf_full, 2, src[:, None, :].expand(B, NF, Lt))
        run_len = jcols[None, :] - k_star + 1
        fi[:, 1, :] += run_len
        if R:
            lo = torch.gather(pref, 2, src[:, None, :].expand(B, R, Lt))
            hi_c = pref[:, :, 1:]
            overlap = hi_c - lo
            fi[:, I_AL:I_AL + R, :] += overlap
            ff[:, F_PBQ:F_PBQ + R, :] += overlap.to(torch.float32) * ge
            # deletion flanks: q[i-1] and, when it exists, q[i]; ungated by
            # the region, once per run, only for runs starting before ve
            flank_next = torch.where(
                i < q_lens, quals_i[:, min(i, Lq - 1)], BIG_BQ)
            flank = torch.minimum(qual_row, flank_next)[:, None, None]
            src_col = (k_star - 1)[:, None, :]
            run_before_end = (src_col < ve[:, :, None]) & active[:, :, None]
            mb = fi[:, I_MB:I_MB + R, :]
            fi[:, I_MB:I_MB + R, :] = torch.where(
                run_before_end, torch.minimum(mb, flank), mb)
            vs_in_run = ((vs[:, :, None] >= src_col)
                         & (vs[:, :, None] < jcols[None, None, :])
                         & active[:, :, None])
            qv_old = fi[:, I_QV:I_QV + R, :]
            fi[:, I_QV:I_QV + R, :] = torch.where(
                vs_in_run & (qv_old < 0), i, qv_old).to(i32)

        # ---- H = max(H_tmp, F) (H_tmp wins ties) ------------------------
        use_tmp = (H_tmp >= F_row)[:, None, :]
        H_row = torch.maximum(H_tmp, F_row)
        hi = torch.where(use_tmp, ti, fi)
        hf = torch.where(use_tmp, tf, ff)

        H = torch.cat([col0_val[:, None], H_row], dim=1)
        Hi = torch.cat([col0_i[:, :, None], hi], dim=2)
        Hf = torch.cat([col0_f[:, :, None], hf], dim=2)
        V = torch.cat([torch.full((B, 1), neg, dtype=i32, device=dev), V_row],
                      dim=1)
        Vi = torch.cat([col0_i[:, :, None], vi], dim=2)
        Vf = torch.cat([col0_f[:, :, None], vf], dim=2)

        # the state of rows past q_len is never read: final is taken at
        # i == q_len
        hit = i == q_lens
        final_H = torch.where(hit[:, None], H, final_H)
        final_i = torch.where(hit[:, None, None], Hi, final_i)
        final_f = torch.where(hit[:, None, None], Hf, final_f)

    masked = torch.where(
        torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev), t_valid],
                  dim=1), final_H, neg)
    t_end = torch.argmax(masked, dim=1)
    score = torch.gather(masked, 1, t_end[:, None])[:, 0]
    out_i = torch.gather(final_i, 2, t_end[:, None, None].expand(B, NI, 1))[:, :, 0]
    out_f = torch.gather(final_f, 2, t_end[:, None, None].expand(B, NF, 1))[:, :, 0]
    out = {
        "score": score,
        "t_end": t_end.to(i32),
        "t_start": out_i[:, 0],
        "nm": out_i[:, 1],
    }
    if R:
        out.update({
            "qv": out_i[:, I_QV:I_QV + R],
            "aligned": out_i[:, I_AL:I_AL + R],
            "min_bq": out_i[:, I_MB:I_MB + R],
            "raw": out_f[:, F_RAW:F_RAW + R],
            "pbq": out_f[:, F_PBQ:F_PBQ + R],
            "matches": out_f[:, F_MT:F_MT + R],
        })
    return out


def evidence_dp(queries, quals, q_lens, targets, t_lens, regions,
                p: AlignParams = READ_TO_HAP, r_max: int = R_MAX) -> dict:
    """Numpy in/out, the signature of lancet2_tpu.ops.evidence_dp.evidence_dp
    (plus `r_max`; 0 returns the span outputs only). Runs on the CPU."""
    queries = np.asarray(queries, np.uint8)
    targets = np.asarray(targets, np.uint8)
    if queries.shape[1] > MAX_LEN or targets.shape[1] > MAX_LEN:
        raise ValueError(f"Lq and Lt must be <= {MAX_LEN}")
    out = evidence_dp_torch(
        torch.from_numpy(queries),
        torch.from_numpy(np.asarray(quals, np.uint8)),
        torch.from_numpy(np.asarray(q_lens, np.int32)),
        torch.from_numpy(targets),
        torch.from_numpy(np.asarray(t_lens, np.int32)),
        torch.from_numpy(np.asarray(regions, np.int32)),
        from_jax(p), r_max=r_max,
    )
    return {k: v.numpy() for k, v in out.items()}
