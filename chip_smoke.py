"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from lancet2_tpu_torch/csrc (nvcc, sm_90a) and
     the repo's C++ (native/, g++; a missing toolchain or library leaves
     the numpy/Python paths, as in the JAX package): the BAM decoder's
     build route, or every attempt's compiler messages when none built;
  3. K1 (R=0) and K2 (R in 1, 2, 4) against their plain PyTorch versions on
     the card, exact equality required, on seeded pairs at Lq 160,
     Lt in {256, 384}, B 8192 with planted indels and deletions longer than
     31 columns, on the edge batch of ops/evidence_cases.py (B 1000, Lt 256:
     q_len and t_len at the kernel's stripe and chunk boundaries and out of
     range, N bases, regions at column 0, negative, ending at t_len and
     inactive) and at a long band (B 1024, Lt 2048); both times printed,
     and each R's resident warps per SM;
  4. the port's batch pipeline with --device cuda on the simulated 1 Mb
     tumor/normal fixture (40x/60x, seed 11): windows/s, wall time by
     phase, launch counts of both kernels (both must be > 0), pass-2
     fraction, and recall of the planted variants;
  5. a 5-window region with --device cuda and --device cpu: the VCF record
     lines must be byte-identical;
  6. K3 (the score-only fitting DP) against its plain version on the card,
     exact equality required, at bench.py's kernel shape (B 2048, Lq 152,
     Lt 1024), at the window step's (B 8192, Lq 128, Lt 256, the pairs of
     phase 7's batch), on an edge batch (N bases, padding, short and
     degenerate lengths), and on the edge batch of ops/sw_cases.py at Lq
     152 (q_len and t_len at the kernel's lane and stripe edges, tandem
     repeats), at Lq 520 (three stripes) and at Lt 2048; kernel and plain
     times and GCUPS printed, and each launch's rows per lane (phase 2
     logs each instantiation's resident warps per SM);
  7. the window step at bench.py's full width (16 windows of 128 reads of
     128 bases against 4 haplotypes of 512, band margin 64) on the card
     for a few steps: windows/s and K3's launch count (must be > 0); its
     output and that of the window-step entry point (graft_entry.entry)
     equal to the same step on the CPU (float32 PLs included); and the
     step's scan route (dp_backend="scan", the dirs engine's score pass) on
     dual and global parameter sets, on 4 of those windows, equal to the
     CPU's;
  8. the float64 DM PLs on the card against the host engine
     (caller/likelihood.py) on a sweep of K 2-4 and depths 0-3000: no
     mismatch allowed, as the batch executor's phase C relies on them;
  9. the threads executor on the card: with the evidence backend and -T =
     host cores over the 1 Mb fixture (K1 and K2 must both launch;
     windows/s and launches per window printed), its records byte-identical
     to phase 4's (the batch executor's); the jax (dirs engine) and numpy
     backends and the batch executor with --prep-mode threads on phase 5's
     region, each byte-identical to phase 5's records, with times and peak
     device memory; and the dirs engine's time and peak memory per 512-pair
     chunk at Lq 160 and Lt 1024-2048;
 10. the kernels' bounds from this run's inputs;
 11. the multi-device path at full width on the device list [cuda:0] * 2
     (two entries, a stream each): the batch executor over the whole 1 Mb
     fixture, its records byte-identical to phase 4's, span and evidence
     dispatches sharded (SPMD_STATS) and no span dispatch fallen back
     (plain_span_with_mesh 0), windows/s and wall by phase; the sharded
     window step at phase 7's shape equal to the one-device step; and
     graft_entry.dryrun_multichip(2);
 12. the device graph build on the card: for the first 200 windows of the
     1 Mb fixture at the first k, the one-window pass (build_graph_device)
     and the tape over all 200 windows at once (build_graphs_tape), each
     bit-identical to the numpy path (node ids, codes, signs, labels,
     counts, roles, edges, reference path, node order), ms per window of
     each; and the threads executor with --graph-backend device on phase
     5's region, its records equal to phase 5's;
 13. the pipeline options on the card: --stream-windows on over the whole
     1 Mb fixture, its records byte-identical to phase 4's (windows/s of
     both printed); the window manifest of an all-N contig of more than
     131072 windows through the CLI in a process of its own, where
     --stream-windows auto must switch streaming on by itself, every window
     must end SKIPPED_NONLY_REF_BASES and peak RSS may grow by less than
     400 MB; and on a 30 kb fixture at the 1 Mb fixture's depth and seed:
     CRAM inputs (gzip and rans4x8, converted by the port's `cram` and
     indexed by its `index`), --stream-bam and a checkpoint resume (from a
     cursor the run saved part-way through, with the VCF as it then stood
     on disk) each write the records of the run with no option, and
     --read-filter, --no-active-region, --extract-pairs and a three-sample
     run (-s path:case) on a 5-window region write on cuda the records of a
     cpu run of the same option; K1 and K2 must launch in every cuda run;
 14. the kernels' JSON line (K1/K2 also carry their launches on phase 9's
     threads run, phase 11's mesh run and phase 13's option runs, K3 on
     phase 11's sharded step), the card line, and the result line last.

Without a CUDA device it exits non-zero before printing any result. Inputs
are made from seeds; the fixture is cached under .smoke_cache/ (gitignored).
"""

from __future__ import annotations

import ctypes
import gzip
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
LQ, B = 160, 8192
CASES = [(0, 384), (0, 256), (1, 256), (1, 384), (2, 256), (2, 384),
         (4, 256), (4, 384)]
MAIN_SHAPE = {0: 384, 1: 256}  # (R -> Lt) reported per kernel in the JSON
# (B, Lq, Lt) of phase 3's other batches: the edge batch of
# ops/evidence_cases.py (every stripe and chunk boundary, degenerate lengths,
# N bases, regions at the edges) and a long target band
EDGE_CASES = {"edge": (1000, LQ, 256), "long_band": (1024, LQ, 2048)}
# (B, Lq, Lt) of phase 6's batches from ops/sw_cases.py: the shared K3 edge
# batch at bench.py's Lq (rows per lane 5, one stripe), queries of three
# stripes, and a long band
SW_CASES = {"shared_edge": (1000, 152, 256), "long_query": (1024, 520, 640),
            "long_band": (1024, 152, 2048)}
TOLERANCE = 0  # the kernel must equal its plain version bit for bit
# the window step at bench.py's shape (bench_window_step)
STEP = dict(num_windows=16, reads_per_window=128, read_len=128, num_haps=4,
            hap_len=512, num_samples=2)
STEP_MARGIN, STEP_REPS = 64, 5
SCAN_WINDOWS = 4  # phase 7: windows of the step batch run through the scan
GRAPH_WINDOWS = 200  # phase 12: windows of the 1 Mb fixture
# phase 13: the options fixture (kb; the 1 Mb fixture's depth and seed), a
# 5-window region of it, windows per batch of the checkpointed run, and the
# all-N manifest: more windows than the 131072 above which --stream-windows
# auto streams, at the default window of 1000 and step of 800
OPT_KB, OPT_REGION, OPT_CKPT_BATCH = 30, "chrS:10001-13600", 8
MANIFEST_WINDOWS, STREAM_AUTO_ABOVE = 135_000, 131_072
MANIFEST_RSS_LIMIT_MB = 400  # tests/test_streaming_soak.py's bound
# phase 9: the dirs engine's chunk (pairs x query bucket) and target buckets
DIRS_CHUNK, DIRS_LQ, DIRS_LTS = 512, 160, (1024, 1536, 2048)

# The bound of a kernel: the larger of its int32 operations over the card's
# int32 rate and its bytes (each input read once, each output written once)
# over the 3.35 TB/s of HBM. The int32 rate is 64 lanes per SM x SMs x the
# SM clock nvidia-smi reports x 2 operations per lane and clock: sm_90a's
# three-input integer instructions (VIADDMNMX, max(a + b, c), and IADD3)
# do two operations in one issue, and ptxas fuses the DP's adds and maxes
# into them unasked, so one per clock would be no lower bound.
# Operations per DP cell of the minimal recurrence, counted from the
# kernels' code: K3 10 (substitution score 1, diagonal 1, V 3, Ht 1, F 3,
# H 1); K1 20 (K3's 10, plus a three-way select of the start and NM
# companions and NM's four updates); K2 20 + 36 per region slot (six
# companions, each a three-way select, and the slot's membership tests and
# updates along the diagonal, vertical and deletion moves).
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
INT32_OPS_PER_LANE_CLOCK = 2


def ops_per_cell(name: str, R: int = 0) -> int:
    return {"sw_fitting": 10, "span": 20}.get(name, 20 + 36 * R)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def card_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


def bound(ops: float, nbytes: float, clock_hz: float, sms: int):
    """(least ms for the work on this card, "operations" or "bytes")."""
    t_ops = ops / (INT32_LANES_PER_SM * INT32_OPS_PER_LANE_CLOCK * sms
                   * clock_hz)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def dp_cells(q_lens, t_lens, Lq: int, Lt: int) -> int:
    """DP cells a pair batch needs: q_len rows (none outside [1, Lq]) by
    min(t_len, Lt) columns."""
    import numpy as np

    ql = np.asarray(q_lens, np.int64)
    rows = np.where((ql >= 1) & (ql <= Lq), ql, 0)
    cols = np.clip(np.asarray(t_lens, np.int64), 0, Lt)
    return int((rows * cols).sum())


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


def make_pairs(seed: int, Lt: int, R: int):
    """Seeded reads against haplotype bands: ~2% substitutions, a planted
    1-8 bp indel in a quarter of the pairs and a 32-60 bp deletion in an
    eighth, and R region slots (some inactive, some with negative starts,
    as after the pass-2 crop)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q = np.full((B, LQ), 5, np.uint8)
    qu = rng.integers(2, 42, (B, LQ)).astype(np.uint8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    q_lens = rng.integers(100, LQ + 1, B).astype(np.int32)
    t_lens = rng.integers(LQ, Lt + 1, B).astype(np.int32)
    for b in range(B):
        ql, tl = int(q_lens[b]), int(t_lens[b])
        kind = b % 8
        gap = int(rng.integers(32, 61)) if kind == 0 else int(rng.integers(1, 9))
        need = ql + (gap if kind in (0, 2, 4) else 0)
        off = int(rng.integers(0, max(1, tl - need)))
        seg = t[b, off:off + need].copy()
        cut = ql // 2
        if kind in (0, 2, 4):      # deletion in the read
            read = np.concatenate([seg[:cut], seg[cut + gap:]])
        elif kind == 6:            # insertion in the read
            ins = rng.integers(0, 4, gap).astype(np.uint8)
            read = np.concatenate([seg[:cut], ins, seg[cut:]])
        else:
            read = seg
        read = read[:ql]
        if read.size < ql:
            read = np.concatenate([read, rng.integers(0, 4, ql - read.size)])
        sub = rng.random(ql) < 0.02
        read = np.where(sub, rng.integers(0, 5, ql), read).astype(np.uint8)
        q[b, :ql] = read
    regions = np.zeros((B, 4, 2), np.int32)
    for r in range(R):
        s = rng.integers(-12, Lt - 2, B)
        e = s + rng.integers(1, 12, B)
        e = np.where(rng.random(B) < 0.15, s, e)  # inactive slot
        regions[:, r, 0] = s
        regions[:, r, 1] = np.minimum(e, Lt)
    return q, qu, q_lens, t, t_lens, regions


def time_cuda(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def hold_kernel(dev, R: int, host, what: str, reps: int = 5) -> dict:
    """K1 (R=0) or K2 on the pairs `host` (numpy arrays, as make_pairs)
    against its plain version on the card: exact equality required."""
    import torch

    from lancet2_tpu_torch.ops import evidence_cuda as ec
    from lancet2_tpu_torch.ops.evidence_dp import evidence_dp_torch
    from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS

    kp = READ_TO_HAP_PARAMS.to(dev)
    q, qu, ql, t, tl, reg = (torch.from_numpy(a).to(dev) for a in host)
    Bn, Lq = q.shape
    Lt = t.shape[1]

    def kernel():
        if R == 0:
            return ec.span_pairs_submit(q, ql, t, tl, kp), None
        return ec.evidence_pairs_submit(q, qu, ql, t, tl, reg, R, kp)

    def plain():
        return ec._pack(evidence_dp_torch(q, qu, ql, t, tl, reg, kp,
                                          r_max=R), R)

    k_i, k_f = kernel()
    torch.cuda.synchronize()
    io_bytes = nbytes(q, ql, t, tl, k_i) if R == 0 else nbytes(
        q, qu, ql, t, tl, reg, kp.conf, k_i, k_f)
    p_i, p_f = plain()
    torch.cuda.synchronize()
    err = int((k_i.long() - p_i.long()).abs().max())
    if R:
        err = max(err, float((k_f - p_f).abs().max()))
    exact = torch.equal(k_i, p_i) and (R == 0 or torch.equal(
        k_f.view(torch.int32), p_f.view(torch.int32)))
    long_dels = int((p_i[:, 3] >= 32).sum())
    ms = time_cuda(kernel, reps)
    plain_ms = time_cuda(plain, 1)
    cells = dp_cells(host[2], host[4], Lq, Lt)
    log(f"kernel {what} R={R} Lq={Lq} Lt={Lt} B={Bn}: exact={exact} "
        f"max_abs_err={err} pairs_nm>=32={long_dels} kernel_ms={ms:.3f} "
        f"plain_ms={plain_ms:.3f} kernel_gcups={cells / (ms * 1e6):.3f} "
        f"cells={cells}")
    if not exact or err > TOLERANCE:
        raise AssertionError(f"kernel {what} R={R} Lt={Lt} disagrees with its "
                             f"plain version (max_abs_err={err})")
    if long_dels == 0:
        raise AssertionError(f"{what}: no deletion longer than 31 won")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, cells=cells,
                bytes=io_bytes)


def check_kernels(dev) -> dict:
    """Phase 3: every instantiated kernel against its plain version, at the
    main path's shapes, on the edge batch and at a long target band."""
    from lancet2_tpu_torch.ops.evidence_cases import edge_pairs

    results = {}
    for R, Lt in CASES:
        results[("main", R, Lt)] = hold_kernel(
            dev, R, make_pairs(1000 + 10 * R + Lt, Lt, R), "main")
    for R in (0, 1, 2, 4):
        for what, (Bn, Lq, Lt) in EDGE_CASES.items():
            results[(what, R, Lt)] = hold_kernel(
                dev, R, edge_pairs(2000 + 10 * R + Lt, Bn, Lq, Lt, R), what,
                reps=1)
    return results


def sw_edge_pairs(seed: int, B: int, Lq: int, Lt: int):
    """Reads cut from their targets with 10% noise (N included), padded
    with 5 past q_len; targets padded past t_len and sprinkled with N; and
    degenerate lengths: q_len 0, > Lq and < 0, t_len 0 and > Lt."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    q = np.full((B, Lq), 5, np.uint8)
    q_lens = rng.integers(1, Lq + 1, B).astype(np.int32)
    t_lens = rng.integers(1, Lt + 1, B).astype(np.int32)
    for b in range(B):
        n = int(q_lens[b])
        off = int(rng.integers(0, max(1, Lt - n)))
        read = np.concatenate([t[b, off:off + n], rng.integers(0, 4, n)])[:n]
        q[b, :n] = np.where(rng.random(n) < 0.1, rng.integers(0, 5, n), read)
        t[b, t_lens[b]:] = 5
    t[rng.random((B, Lt)) < 0.02] = 4
    q_lens[:4] = (0, Lq + 1, -1, 3)
    t_lens[3:5] = (0, Lt + 9)
    return q, q_lens, t, t_lens


def step_batch(device):
    """Phase 7's window batch (bench.py's shape and seed) on `device`."""
    import numpy as np

    from lancet2_tpu_torch.ops.window_step import synth_window_batch

    batch = synth_window_batch(np.random.default_rng(1), **STEP)
    return {k: v.to(device) for k, v in batch.items()}


def sw_main_pairs(dev) -> dict:
    """K3's inputs at the main path's two shapes, on `dev`: bench.py's
    kernel shape (B 2048, Lq 152, Lt 1024) and the pairs of phase 7's
    window step (B 8192, Lq 128, Lt 256)."""
    import numpy as np
    import torch

    from lancet2_tpu_torch.ops.window_step import window_pairs

    rng = np.random.default_rng(0)  # bench.py bench_sw_kernel's inputs
    B, Lq, Lt = 2048, 152, 1024
    bench = (rng.integers(0, 4, (B, Lq)).astype(np.uint8),
             np.full(B, Lq, np.int32),
             rng.integers(0, 4, (B, Lt)).astype(np.uint8),
             np.full(B, Lt, np.int32))
    sb = step_batch(dev)
    return {
        "bench": [torch.from_numpy(a).to(dev) for a in bench],
        "window_step": list(window_pairs(
            sb["reads"], sb["read_lens"], sb["haps"], sb["hap_lens"],
            sb["read_offset"], STEP_MARGIN)),
    }


def check_sw_fitting(dev) -> dict:
    """Phase 6: K3 against its plain version at the main path's shapes and
    on an edge batch."""
    import torch

    from lancet2_tpu_torch.ops import sw_cases, sw_cuda
    from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS
    from lancet2_tpu_torch.ops.sw_cuda import fitting_scores
    from lancet2_tpu_torch.ops.sw_dp import fitting_scores_torch

    kp = READ_TO_HAP_PARAMS.to(dev)
    cases = sw_main_pairs(dev)
    cases["edge"] = [torch.from_numpy(a).to(dev)
                     for a in sw_edge_pairs(500, 1000, 77, 203)]
    for i, (name, (Bn, Lq, Lt)) in enumerate(SW_CASES.items()):
        cases[name] = [torch.from_numpy(a).to(dev) for a in sw_cases.edge_pairs(
            600 + i, Bn, Lq, Lt, rpls=(4, 5, sw_cuda.rows_per_lane(Lq)))]
    results = {}
    for name, (q, ql, t, tl) in cases.items():
        B, Lq = q.shape
        Lt = t.shape[1]

        def kernel():
            return fitting_scores(q, ql, t, tl, kp)

        def plain():
            return fitting_scores_torch(q, ql, t, tl, kp)

        k_s, k_e = kernel()
        torch.cuda.synchronize()
        p_s, p_e = plain()
        torch.cuda.synchronize()
        err = max(int((k_s.long() - p_s.long()).abs().max()),
                  int((k_e.long() - p_e.long()).abs().max()))
        exact = torch.equal(k_s, p_s) and torch.equal(k_e, p_e)
        ms = time_cuda(kernel, 20)
        plain_ms = time_cuda(plain, 1)
        cells = dp_cells(ql.cpu().numpy(), tl.cpu().numpy(), Lq, Lt)
        log(f"K3 {name} B={B} Lq={Lq} Lt={Lt} rows_per_lane="
            f"{sw_cuda.rows_per_lane(Lq)}: exact={exact} "
            f"max_abs_err={err} kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
            f"kernel_gcups={cells / (ms * 1e6):.3f} cells={cells}")
        if not exact or err > TOLERANCE:
            raise AssertionError(f"K3 {name} disagrees with its plain "
                                 f"version (max_abs_err={err})")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             cells=cells,
                             bytes=nbytes(q, ql, t, tl, k_s, k_e))
    if cases["window_step"][0].shape != (8192, 128) or \
            cases["window_step"][2].shape[1] != 256:
        raise AssertionError("the window step's pairs are not 8192 x 128 "
                             "against 256 columns")
    return results


def assert_step_equal(got: dict, want: dict, what: str) -> None:
    """The window step on the card against the CPU: every output equal,
    the float32 PLs, GQ and best genotype included (ops/lgamma_f32.py runs
    the same float operations on both)."""
    import torch

    got = {k: v.cpu() for k, v in got.items()}
    for k in want:
        if not torch.equal(got[k], want[k].cpu()):
            d = float((got[k].double() - want[k].cpu().double()).abs().max())
            raise AssertionError(f"{what}: {k} differs from the CPU step "
                                 f"(max abs difference {d})")


def run_window_step(dev) -> dict:
    """Phase 7: the window step at full width on the card, its launches,
    and both it and the entry point against the CPU."""
    import torch

    from lancet2_tpu_torch import graft_entry
    from lancet2_tpu_torch.ops import _build
    from lancet2_tpu_torch.ops.window_step import make_window_step

    keys = ("reads", "read_lens", "read_sample", "read_valid", "haps",
            "hap_lens", "hap_allele", "read_offset")
    nw, ns = STEP["num_windows"], STEP["num_samples"]
    batch = step_batch(dev)
    args = [batch[k] for k in keys]
    step = make_window_step(ns, 2, device=dev, band_margin=STEP_MARGIN)
    _build.reset_launches()
    t0 = time.monotonic()
    out = step(*args)
    torch.cuda.synchronize()
    first_s = time.monotonic() - t0
    t0 = time.monotonic()
    for _ in range(STEP_REPS):
        out = step(*args)
    torch.cuda.synchronize()
    per_step = (time.monotonic() - t0) / STEP_REPS
    launches = _build.LAUNCHES["sw_fitting"]
    log(f"phase 7: window step W={nw} on cuda: {per_step * 1e3:.3f} ms per "
        f"step = {nw / per_step:.3f} windows/s (first step "
        f"{first_s * 1e3:.3f} ms); sw_fitting launches {launches}; depth "
        f"{int(out['allele_counts'].sum())}")
    if launches != 1 + STEP_REPS:
        raise AssertionError(f"the window step launched K3 {launches} times "
                             f"in {1 + STEP_REPS} steps")
    want = make_window_step(ns, 2, device="cpu", band_margin=STEP_MARGIN)(
        *[a.cpu() for a in args])
    assert_step_equal(out, want, "window step")
    for k, v in out.items():
        if not torch.isfinite(v.float()).all():
            raise AssertionError(f"window step: non-finite {k}")
    if int(out["allele_counts"].sum()) == 0:
        raise AssertionError("window step counted no read")
    e_step, e_args = graft_entry.entry(dev)
    c_step, c_args = graft_entry.entry("cpu")
    assert_step_equal(e_step(*e_args), c_step(*c_args), "graft entry")
    log("phase 7: window step and graft entry equal the CPU step")
    check_scan_step(args)
    return dict(launches=launches, windows_per_s=nw / per_step)


def check_scan_step(args) -> None:
    """Phase 7: the window step's scan route (the dirs engine's score pass)
    on parameter sets K3 does not take, on the card against the CPU."""
    from lancet2_tpu_torch.ops.affine_dp import HAP_TO_REF, AlignParams
    from lancet2_tpu_torch.ops.window_step import make_window_step

    dual_fitting = AlignParams(match=1, mismatch=4, gap_open1=12,
                               gap_extend1=3, gap_open2=30, gap_extend2=1,
                               free_target_ends=True)
    part = [a[:SCAN_WINDOWS] for a in args]
    for name, params in (("HAP_TO_REF (dual, global)", HAP_TO_REF),
                         ("dual fitting", dual_fitting)):
        outs = []
        for device in ("cuda", "cpu"):
            step = make_window_step(STEP["num_samples"], 2, params=params,
                                    device=device, band_margin=STEP_MARGIN,
                                    dp_backend="scan")
            t0 = time.monotonic()
            outs.append(step(*[a.to(device) for a in part]))
            if device == "cuda":
                import torch

                torch.cuda.synchronize()
            log(f"phase 7: scan step {name}, W={SCAN_WINDOWS} on {device}: "
                f"{(time.monotonic() - t0) * 1e3:.3f} ms")
        assert_step_equal(outs[0], outs[1], f"scan step {name}")
        # HAP_TO_REF scores no read above the step's gate (match 0, global):
        # its depths are 0 there too, so its scores are what is held
        if outs[1]["scores"].unique().numel() < 2 or (
                params.match > 0 and int(outs[0]["allele_counts"].sum()) == 0):
            raise AssertionError(f"scan step {name}: degenerate output")
    log("phase 7: the scan route on cuda equals the CPU on dual and global "
        "params")


def check_pls(dev) -> None:
    """Phase 8: float64 DM PLs on the card against the host engine."""
    import numpy as np

    from lancet2_tpu_torch.caller.likelihood import compute_genotype_pls
    from lancet2_tpu_torch.ops.genotype import batched_genotype_pls_exact

    rng = np.random.default_rng(7)  # TestDevicePlsExact's sweep
    bad = rows = 0
    for K in (2, 3, 4):
        counts = np.concatenate([
            rng.integers(0, 60, (120, K)),
            rng.integers(0, 3000, (60, K)),
            np.zeros((4, K), np.int64),
        ]).astype(np.int64)
        got = batched_genotype_pls_exact(counts, K, dev)
        host = np.stack([np.asarray(compute_genotype_pls(list(c)), np.int64)
                         for c in counts])
        bad += int((got != host).any(axis=1).sum())
        rows += len(counts)
    log(f"phase 8: float64 PLs on cuda vs host engine: {bad} mismatching "
        f"rows of {rows}")
    if bad:
        raise AssertionError("device float64 PLs differ from the host engine")


def vcf_records(path: str) -> list[str]:
    with gzip.open(path, "rt") as fh:
        return [l for l in fh.read().splitlines() if l and not l.startswith("#")]


def port_argv(fx: dict, out_vcf: str, device: str, region=None,
              extra=()) -> list[str]:
    argv = ["pipeline", "-n", fx["normal"], "-t", fx["tumor"],
            "-r", fx["fasta"], "-o", out_vcf, "--device", device,
            "-T", str(os.cpu_count() or 4), *extra]
    if region:
        argv += ["-R", region]
    return argv


def run_port(fx: dict, out_vcf: str, device: str, region=None,
             extra=(), devices=None) -> dict:
    from lancet2_tpu_torch.cli.main import build_parser, run_pipeline

    argv = port_argv(fx, out_vcf, device, region, extra)
    return run_pipeline(build_parser().parse_args(argv),
                        "chip_smoke " + " ".join(argv), devices=devices)


def dirs_chunk(Lt: int):
    """A dirs-engine chunk of the jax backend's shape: 512 reads of 150
    bases (query bucket 160) cut from targets of Lt bases, 2% noise."""
    import numpy as np

    rng = np.random.default_rng(Lt)
    t = rng.integers(0, 4, (DIRS_CHUNK, Lt)).astype(np.uint8)
    q = np.full((DIRS_CHUNK, DIRS_LQ), 5, np.uint8)
    for b in range(DIRS_CHUNK):
        off = int(rng.integers(0, Lt - 150))
        q[b, :150] = np.where(rng.random(150) < 0.02,
                              rng.integers(0, 4, 150), t[b, off:off + 150])
    return (q, np.full(DIRS_CHUNK, 150, np.int64), t,
            np.full(DIRS_CHUNK, Lt, np.int64))


def run_threads(fx: dict, cache: str, recs_1mb: list, region5: str,
                recs5: list) -> dict:
    """Phase 9: the threads executor and the options that ride on it.
    Returns the threads run's launch counts."""
    import torch

    from lancet2_tpu_torch.ops import _build
    from lancet2_tpu_torch.ops.affine_dp import READ_TO_HAP
    from lancet2_tpu_torch.ops.affine_dp_torch import align_dirs_torch

    path = os.path.join(cache, "smoke_threads_evidence.vcf.gz")
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    st = run_port(fx, path, "cuda", None,
                  ["--executor", "threads", "--aligner-backend", "evidence"])
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    got = vcf_records(path)
    n = st["windows"]
    log(f"phase 9: threads executor, evidence, cuda, -T "
        f"{os.cpu_count()}: {n} windows in "
        f"{st['runtime_s']:.2f} s = {st['windows_per_s']:.3f} windows/s; "
        f"records {len(got)}; launches {json.dumps(launches)} = "
        f"{launches['span'] / max(n, 1):.3f} span and "
        f"{launches['evidence'] / max(n, 1):.3f} evidence per window; "
        f"peak device memory {peak:.1f} MiB")
    log("phase 9: threads stage profile (summed over workers) " + json.dumps(
        {k: v["seconds"] for k, v in st["stage_profile"].items()}))
    if n != 1249 or not got:
        raise AssertionError(f"threads run: {n} windows, {len(got)} records")
    if launches["span"] == 0 or launches["evidence"] == 0:
        raise AssertionError(f"the threads executor did not launch both "
                             f"kernels: {launches}")
    if got != recs_1mb:
        raise AssertionError("threads and batch records differ on the 1 Mb "
                             "fixture")
    log("phase 9: threads and batch (phase 4) records are byte-identical")

    for what, extra in (
            ("jax", ["--executor", "threads", "--aligner-backend", "jax"]),
            ("numpy", ["--executor", "threads", "--aligner-backend", "numpy"]),
            ("prep_threads", ["--prep-mode", "threads"])):
        path = os.path.join(cache, f"smoke_region_{what}.vcf.gz")
        torch.cuda.reset_peak_memory_stats()
        rst = run_port(fx, path, "cuda", region5, extra)
        peak = torch.cuda.max_memory_allocated() / 2**20
        log(f"phase 9: {what} on {region5}: {rst['windows']} windows in "
            f"{rst['runtime_s']:.2f} s; peak device memory {peak:.1f} MiB")
        if vcf_records(path) != recs5:
            raise AssertionError(f"{what}: records differ from phase 5's")
    log("phase 9: jax, numpy and prep-threads records equal phase 5's")

    for Lt in DIRS_LTS:
        chunk = dirs_chunk(Lt)
        align_dirs_torch(*chunk, READ_TO_HAP, device="cuda")  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        for _ in range(3):
            align_dirs_torch(*chunk, READ_TO_HAP, device="cuda")
        ms = (time.monotonic() - t0) / 3 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**20
        log(f"phase 9: dirs engine chunk B={DIRS_CHUNK} Lq={DIRS_LQ} "
            f"Lt={Lt} on cuda: {ms:.3f} ms per chunk (dirs copied to the "
            f"host included); peak device memory {peak:.1f} MiB")
    return launches


def run_multi_device(fx: dict, cache: str, recs_1mb: list) -> dict:
    """Phase 11: the multi-device path at full width on [cuda:0] * 2.
    Returns its launch counts (the mesh run's K1/K2, the sharded step's
    K3)."""
    import torch

    from lancet2_tpu_torch import graft_entry
    from lancet2_tpu_torch.caller import genotyper as gmod
    from lancet2_tpu_torch.ops import _build
    from lancet2_tpu_torch.ops.window_step import make_window_step
    from lancet2_tpu_torch.parallel import evidence_spmd as spmd
    from lancet2_tpu_torch.parallel.mesh import (
        make_mesh,
        make_sharded_window_step,
    )

    dev = torch.device("cuda", 0)
    devices = [dev, dev]
    for k in gmod.MESH_FALLBACK_STATS:
        gmod.MESH_FALLBACK_STATS[k] = 0
    spmd_before = dict(spmd.SPMD_STATS)
    path = os.path.join(cache, "smoke_1mb_mesh.vcf.gz")
    _build.reset_launches()
    st = run_port(fx, path, "cuda", devices=devices)
    launches = dict(_build.LAUNCHES)
    sharded = {k: spmd.SPMD_STATS[k] - spmd_before[k] for k in spmd_before}
    got = vcf_records(path)
    log(f"phase 11: batch executor on {st['devices']}: {st['windows']} "
        f"windows in {st['runtime_s']:.2f} s = {st['windows_per_s']:.3f} "
        f"windows/s; records {len(got)}; launches {json.dumps(launches)}; "
        f"sharded dispatches {json.dumps(sharded)}; fallbacks "
        f"{json.dumps(gmod.MESH_FALLBACK_STATS)}")
    log("phase 11: wall by phase " + json.dumps(
        {k: v["seconds"] for k, v in st["wall_profile"].items()}))
    if st["devices"] != ["cuda:0", "cuda:0"]:
        raise AssertionError(f"the executor ran on {st['devices']}")
    if got != recs_1mb:
        raise AssertionError("mesh and one-device records differ on the 1 Mb "
                             "fixture")
    if sharded["span_sharded"] == 0 or sharded["evidence_sharded"] == 0:
        raise AssertionError(f"the mesh run did not shard both kernels: "
                             f"{sharded}")
    if gmod.MESH_FALLBACK_STATS["plain_span_with_mesh"]:
        raise AssertionError("the mesh run fell back to a plain span "
                             "dispatch")
    log("phase 11: mesh and phase 4 records are byte-identical")

    mesh = make_mesh(devices)
    fn, shard = make_sharded_window_step(mesh, STEP["num_samples"], 2,
                                         band_margin=STEP_MARGIN)
    batch = step_batch("cpu")
    _build.reset_launches()
    t0 = time.monotonic()
    out = fn(*shard(batch))
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) * 1e3
    step_launches = _build.LAUNCHES["sw_fitting"]
    one = make_window_step(STEP["num_samples"], 2, device=dev,
                           band_margin=STEP_MARGIN)(
        *(batch[k].to(dev) for k in (
            "reads", "read_lens", "read_sample", "read_valid", "haps",
            "hap_lens", "hap_allele")), read_offset=batch["read_offset"])
    assert_step_equal({k: out[k] for k in one}, one, "sharded window step")
    log(f"phase 11: sharded window step W={STEP['num_windows']} on 2 "
        f"entries: {ms:.3f} ms (first call), sw_fitting launches "
        f"{step_launches}, total_alt_depth {float(out['total_alt_depth'])}, "
        f"equal to the one-device step")
    if step_launches != 2:
        raise AssertionError(f"the sharded step launched K3 {step_launches} "
                             f"times on 2 entries")

    t0 = time.monotonic()
    graft_entry.dryrun_multichip(2)
    log(f"phase 11: graft_entry.dryrun_multichip(2) passed in "
        f"{time.monotonic() - t0:.1f} s")
    return dict(span=launches["span"], evidence=launches["evidence"],
                sw_fitting=step_launches)


def graph_table(g) -> tuple:
    """A built Graph's node table, reference path, built ids and node
    order, for bit-for-bit comparison."""
    table = {nid: (tuple(n.codes.tolist()), n.sign, n.label,
                   tuple(n.counts.tolist()), tuple(n.role_counts),
                   tuple(sorted(n.edges)))
             for nid, n in g.nodes.items()}
    return table, list(g.ref_node_ids), set(g.all_built_ids), list(g.nodes)


def run_graph_build(fx: dict, cache: str, region5: str, recs5: list) -> None:
    """Phase 12: the device graph build on the card against the numpy
    path, and the threads executor with --graph-backend device."""
    import torch

    from lancet2_tpu_torch.base.dna import encode
    from lancet2_tpu_torch.cbdg.graph import LABEL_REFERENCE, Graph, GraphParams
    from lancet2_tpu_torch.core.read_collector import (
        CollectorParams,
        ReadCollector,
    )
    from lancet2_tpu_torch.core.sample_info import make_sample_list
    from lancet2_tpu_torch.core.window_builder import WindowBuilder, WindowParams
    from lancet2_tpu_torch.hts.fasta import Reference
    from lancet2_tpu_torch.ops.graph_tape import build_graphs_tape

    t0 = time.monotonic()
    ref = Reference(fx["fasta"])
    samples = make_sample_list([fx["normal"]], [fx["tumor"]], [])
    wb = WindowBuilder(ref, WindowParams())
    wb.add_whole_reference()
    wb.sort_input_regions()
    windows = wb.build_windows()[:GRAPH_WINDOWS]
    collector = ReadCollector(CollectorParams(), samples)
    k = GraphParams().min_kmer_len
    cases = []  # (ref codes, reads, (seqs, quals, meta))
    for w in windows:
        reads = collector.collect(w.chrom, w.start1, w.end1)
        ref_codes = encode(w.seq(ref))
        seqs, quals, meta = [ref_codes], [None], [(LABEL_REFERENCE, -1, 0, 0)]
        for r in reads:
            if r.passes_aln_filters and len(r.codes) >= k + 1:
                seqs.append(r.codes)
                quals.append(r.qual)
                meta.append((r.tag, r.sample_index, r.tag, r.qname_hash))
        cases.append((ref_codes, reads, (seqs, quals, meta)))
    log(f"phase 12: {len(cases)} windows collected in "
        f"{time.monotonic() - t0:.1f} s, k={k}, "
        f"{sum(len(c[2][0]) for c in cases)} sequences")

    def graph(backend):
        g = Graph(GraphParams(num_samples=len(samples), build_backend=backend,
                              build_device="cuda"))
        g.curr_k = k
        g.nodes, g.ref_node_ids = {}, []
        return g

    times = {}
    want = []
    t0 = time.monotonic()
    for ref_codes, reads, _inp in cases:
        g = graph("numpy")
        g._build_graph(ref_codes, reads, k)
        want.append(graph_table(g))
    times["numpy"] = time.monotonic() - t0
    for build in ("xla", "tape"):  # one window per device pass
        getattr(graph("device"), f"_build_graph_{build}")(*cases[0][2], k,
                                                           len(samples))
        torch.cuda.synchronize()  # warm-up
        t0 = time.monotonic()
        for (_r, _rd, inp), w in zip(cases, want):
            g = graph("device")
            getattr(g, f"_build_graph_{build}")(*inp, k, len(samples))
            if graph_table(g) != w:
                raise AssertionError(f"device graph ({build}) differs from "
                                     f"the numpy path")
        times[build] = time.monotonic() - t0
    t0 = time.monotonic()
    outs = build_graphs_tape([c[2] for c in cases], k, len(samples), "cuda")
    for out, (_r, _rd, (seqs, _q, meta)), w in zip(outs, cases, want):
        g = graph("device")
        g._materialize_tape_window(out, seqs, meta, k, len(samples))
        if graph_table(g) != w:
            raise AssertionError("batched tape graph differs from the numpy "
                                 "path")
    times["tape_batched"] = time.monotonic() - t0
    n = len(cases)
    log("phase 12: ms per window (host clock, host materialization "
        "included) " + json.dumps({b: round(v / n * 1e3, 3)
                                   for b, v in times.items()})
        + f"; nodes {sum(len(w[0]) for w in want)}; every backend "
        f"bit-identical to the numpy path")

    path = os.path.join(cache, "smoke_region_graph_device.vcf.gz")
    st = run_port(fx, path, "cuda", region5,
                  ["--executor", "threads", "--graph-backend", "device"])
    log(f"phase 12: threads executor, --graph-backend device on cuda, "
        f"{region5}: {st['windows']} windows in {st['runtime_s']:.2f} s")
    if vcf_records(path) != recs5:
        raise AssertionError("--graph-backend device: records differ from "
                             "phase 5's")
    log("phase 12: --graph-backend device records equal phase 5's")


# the manifest run, in a process of its own so that its peak RSS is its own
# (sampled from /proc/self/statm by tests/torch_options_jobs.PeakRss:
# ru_maxrss would start at this process's peak, inherited at the fork, and
# gVisor's /proc has no VmHWM); torch, the executor and the
# CUDA context are loaded before sampling starts, so the growth is the run's
MANIFEST_RUN = r"""
import json, sys, time
import torch
torch.zeros(1, device="cuda")
import lancet2_tpu_torch.core.batch_pipeline
from lancet2_tpu_torch.cli.main import build_parser, run_pipeline
from torch_options_jobs import PeakRss

argv = json.loads(sys.argv[1])
rss = PeakRss()
t0 = time.monotonic()
stats = run_pipeline(build_parser().parse_args(argv), "chip_smoke manifest")
seconds = time.monotonic() - t0
print(json.dumps({"seconds": seconds, "windows": stats["windows"],
                  "status_counts": stats["status_counts"],
                  "rss_growth_mb": rss.stop(),
                  "rss_before_mb": rss.start_mb}))
"""


def all_n_manifest(cache: str) -> tuple[str, str]:
    """An all-N contig of MANIFEST_WINDOWS windows (FASTA and .fai) and an
    empty BAM whose header names it at its length."""
    from lancet2_tpu_torch.hts.bam import BamWriter
    from lancet2_tpu_torch.hts.fasta import write_fai

    length = 800 * (MANIFEST_WINDOWS - 1) + 1000
    fasta = os.path.join(cache, f"all_n_{MANIFEST_WINDOWS}.fa")
    bam = os.path.join(cache, f"all_n_{MANIFEST_WINDOWS}.bam")
    if not os.path.exists(fasta + ".fai"):
        line = "N" * 60 + "\n"
        with open(fasta, "w") as fh:
            fh.write(">chrN\n" + line * (length // 60))
            if length % 60:
                fh.write("N" * (length % 60) + "\n")
        write_fai(fasta)
        BamWriter(bam, [("chrN", length)], sample_name="S1").close()
    return fasta, bam


def options_fixture(cache: str) -> dict:
    """Phase 13's fixture: OPT_KB kb at the 1 Mb fixture's depth and seed
    (planted SNVs and indels every ~1.9 kb), and a second case sample at the
    tumor's depth carrying every other planted variant."""
    from lancet2_tpu_torch.hts.bam import BamWriter
    from lancet2_tpu_torch.hts.fasta import Reference
    from lancet2_tpu_torch.utils.simulate import (
        ReadSimulator,
        Variant,
        make_chr_scale_fixture,
    )

    fx = dict(make_chr_scale_fixture(OPT_KB, cache))
    fx["tumor2"] = os.path.join(os.path.dirname(fx["tumor"]), "tumor2.bam")
    if not os.path.exists(fx["tumor2"]):
        ref_seq = Reference(fx["fasta"]).fetch(fx["chrom"], 1, fx["ref_len"])
        w = BamWriter(fx["tumor2"], [(fx["chrom"], fx["ref_len"])],
                      sample_name="TUMOR2")
        ReadSimulator(ref_seq, fx["chrom"], seed=14).simulate(
            [Variant(p, r, a, vaf=0.35) for p, r, a in fx["truth"][1::2]],
            60, w, qname_prefix="u")
        w.close()
    return fx


def run_options(fx_1mb: dict, cache: str, recs_1mb: list,
                stats_1mb: dict) -> dict:
    """Phase 13: the pipeline options on the card. Returns the launches of
    its cuda runs."""
    import shutil

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_options_jobs as jobs

    from lancet2_tpu_torch.cli.main import main as port_main
    from lancet2_tpu_torch.ops import _build

    t_phase = time.monotonic()
    launches = {"span": 0, "evidence": 0}

    def on_cuda(what: str, fn):
        """Run fn with the counts set to 0; both kernels must launch."""
        _build.reset_launches()
        out = fn()
        got = dict(_build.LAUNCHES)
        if got["span"] == 0 or got["evidence"] == 0:
            raise AssertionError(f"phase 13: {what} did not launch both "
                                 f"kernels on cuda: {got}")
        for k in launches:
            launches[k] += got[k]
        return out, got

    path = os.path.join(cache, "smoke_1mb_stream.vcf.gz")
    st, got = on_cuda("--stream-windows on", lambda: run_port(
        fx_1mb, path, "cuda", None, ["--stream-windows", "on"]))
    log(f"phase 13: --stream-windows on, 1 Mb: {st['windows']} windows in "
        f"{st['runtime_s']:.2f} s = {st['windows_per_s']:.3f} windows/s "
        f"(phase 4: {stats_1mb['windows_per_s']:.3f}); launches "
        f"{json.dumps(got)}")
    if st["windows"] != stats_1mb["windows"] or vcf_records(path) != recs_1mb:
        raise AssertionError("--stream-windows on: records differ from "
                             "phase 4's")
    log("phase 13: streamed and phase 4 records are byte-identical")

    t0 = time.monotonic()
    fasta, bam = all_n_manifest(cache)
    made_s = time.monotonic() - t0
    argv = ["pipeline", "-n", bam, "-r", fasta, "-o",
            os.path.join(cache, "smoke_manifest.vcf.gz"), "--device", "cuda",
            "-T", str(os.cpu_count() or 4)]
    proc = subprocess.run(
        [sys.executable, "-c", MANIFEST_RUN, json.dumps(argv)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT, os.path.join(ROOT, "tests")])), cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError("phase 13: the manifest run failed:\n"
                             + proc.stderr[-4000:])
    man = json.loads(proc.stdout.strip().splitlines()[-1])
    streamed = [l for l in proc.stderr.splitlines() if "streaming ~" in l]
    log(f"phase 13: all-N manifest ({made_s:.1f} s to write): "
        f"{man['windows']} windows in {man['seconds']:.2f} s = "
        f"{man['windows'] / man['seconds']:.1f} windows/s; RSS "
        f"{man['rss_before_mb']:.1f} MB at the start, peak growth "
        f"{man['rss_growth_mb']:.1f} MB; status "
        f"{json.dumps(man['status_counts'])}; "
        f"{streamed[0].split('] ')[-1] if streamed else 'not streamed'}")
    if not streamed:
        raise AssertionError("phase 13: --stream-windows auto did not stream "
                             "the manifest")
    if man["windows"] <= STREAM_AUTO_ABOVE or man["status_counts"] != {
            "SKIPPED_NONLY_REF_BASES": man["windows"]}:
        raise AssertionError(f"phase 13: manifest: {man['windows']} windows, "
                             f"{man['status_counts']}")
    if man["rss_growth_mb"] >= MANIFEST_RSS_LIMIT_MB:
        raise AssertionError(f"phase 13: the streamed manifest grew peak RSS "
                             f"by {man['rss_growth_mb']:.1f} MB")

    t0 = time.monotonic()
    fx = options_fixture(cache)
    odir = os.path.join(cache, "options")
    os.makedirs(odir, exist_ok=True)
    log(f"phase 13: {OPT_KB} kb options fixture ready in "
        f"{time.monotonic() - t0:.1f} s")

    def out(name):
        return os.path.join(odir, f"{name}.vcf.gz")

    st, got = on_cuda("the run with no option",
                      lambda: run_port(fx, out("base"), "cuda"))
    base = vcf_records(out("base"))
    log(f"phase 13: {OPT_KB} kb, no option: {st['windows']} windows, "
        f"{len(base)} records, {st['runtime_s']:.2f} s; launches "
        f"{json.dumps(got)}")
    if not base:
        raise AssertionError("phase 13: the options fixture called nothing")

    def same_as_base(name, st, got):
        recs = vcf_records(out(name))
        log(f"phase 13: {name}: {st['windows']} windows, {len(recs)} records, "
            f"{st['runtime_s']:.2f} s; launches {json.dumps(got)}")
        if recs != base:
            raise AssertionError(f"phase 13: {name}: records differ from the "
                                 f"run with no option")

    for codec in ("gzip", "rans4x8"):
        t0 = time.monotonic()
        crams = {}
        for s in ("normal", "tumor"):
            crams[s] = os.path.join(odir, f"{s}.{codec}.cram")
            if port_main(["cram", fx[s], "-r", fx["fasta"], "-o", crams[s],
                          "--codec", codec]) != 0 or \
                    port_main(["index", crams[s]]) != 0:
                raise AssertionError(f"phase 13: cram/index {codec} failed")
        conv_s = time.monotonic() - t0
        st, got = on_cuda(f"CRAM {codec}", lambda: run_port(
            dict(fx, **crams), out(f"cram_{codec}"), "cuda"))
        log(f"phase 13: {codec} CRAMs converted and indexed in {conv_s:.1f} s")
        same_as_base(f"cram_{codec}", st, got)

    sdir = os.path.join(odir, "stream")
    os.makedirs(sdir, exist_ok=True)
    copies = {}
    for s in ("normal", "tumor"):
        copies[s] = os.path.join(sdir, f"{s}.bam")
        shutil.copyfile(fx[s], copies[s])
        if os.path.exists(copies[s] + ".bai"):
            os.unlink(copies[s] + ".bai")
    st, got = on_cuda("--stream-bam", lambda: run_port(
        dict(fx, **copies), out("stream_bam"), "cuda", None,
        ["--stream-bam"]))
    if not all(os.path.exists(p + ".bai") for p in copies.values()):
        raise AssertionError("phase 13: --stream-bam built no index")
    same_as_base("stream_bam", st, got)

    for p in (out("ckpt"), out("ckpt") + ".ckpt", out("resume")):
        if os.path.exists(p):
            os.unlink(p)
    ck, got = on_cuda("--checkpoint", lambda: jobs.run_checkpoint(
        port_argv(fx, out("ckpt"), "cuda", None, ["--checkpoint"]),
        OPT_CKPT_BATCH, os.path.join(odir, "saves")))
    saves = ck["saves"]
    if len(saves) < 2 or os.path.exists(out("ckpt") + ".ckpt"):
        raise AssertionError(f"phase 13: checkpoint: {len(saves)} cursors "
                             f"saved, .ckpt left after the run")
    same_as_base("ckpt", ck, got)
    save = saves[len(saves) // 2]
    res, got = on_cuda("the resume", lambda: jobs.run_cli(jobs.prepare_resume(
        save, port_argv(fx, out("resume"), "cuda", None, ["--checkpoint"]))))
    if os.path.exists(out("resume") + ".ckpt") or not any(
            m.startswith("resuming at cursor") for m in res["log"]):
        raise AssertionError("phase 13: the resume did not resume, or left "
                             "its .ckpt")
    log(f"phase 13: checkpoint: cursors {[s['cursor'] for s in saves]}; "
        f"resumed at {save['cursor']} from a VCF of "
        f"{len(vcf_records(save['vcf']))} records")
    same_as_base("resume", res, got)

    for name, extra in (
            ("read_filter", ["--read-filter", "!flag.reverse && mapq >= 30"]),
            ("no_active_region", ["--no-active-region"]),
            ("extract_pairs", ["--extract-pairs"]),
            ("three_samples", ["-s", f"{fx['tumor2']}:case"])):
        recs = {}
        for device in ("cuda", "cpu"):
            path = out(f"{name}_{device}")
            if device == "cuda":
                st, got = on_cuda(name, lambda: run_port(
                    fx, path, "cuda", OPT_REGION, extra))
            else:
                st, got = run_port(fx, path, "cpu", OPT_REGION, extra), {}
            recs[device] = vcf_records(path)
            log(f"phase 13: {name} on {device}, {OPT_REGION}: "
                f"{st['windows']} windows, {len(recs[device])} records, "
                f"{st['runtime_s']:.2f} s; status "
                f"{json.dumps(st['status_counts'])}; launches "
                f"{json.dumps(got)}")
        if recs["cuda"] != recs["cpu"] or not recs["cuda"]:
            raise AssertionError(f"phase 13: {name}: cuda and cpu records "
                                 f"differ")
        if name == "three_samples" and len(recs["cuda"][0].split("\t")) != 12:
            raise AssertionError("phase 13: three_samples: not three sample "
                                 "columns")
    log(f"phase 13: every option equals its reference; launches "
        f"{json.dumps(launches)}; {time.monotonic() - t_phase:.1f} s")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    torch.cuda.init()

    from lancet2_tpu_torch.ops import _build
    from lancet2_tpu_torch.ops import evidence_cuda as ec

    _build.library()
    log(f"phase 2: kernels built in {_build.BUILD_INFO['seconds']:.1f} s "
        f"(fresh build: {_build.BUILD_INFO['built']})")
    with open(os.path.join(os.path.dirname(_build.BUILD_INFO["path"]),
                           "nvcc.log")) as f:
        for line in f:
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log("  ptxas: " + line.strip())

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for R in ec.KERNEL_R:
        resident = ctypes.c_int(0)
        if ec._kernel(R)[0](1 << 30, ctypes.byref(resident)) != 0:
            raise RuntimeError(f"occupancy query failed for R={R}")
        log(f"phase 2: evidence DP R={R}: {resident.value / sms:.1f} resident "
            f"warps (pairs in flight) per SM of {sms}")

    from lancet2_tpu_torch.ops import sw_cuda

    for rpl in range(1, 9):
        log(f"phase 2: K3 rows per lane {rpl}: "
            f"{sw_cuda.warps_per_sm(rpl, False)} resident warps (pairs in "
            f"flight) per SM in one stripe, "
            f"{sw_cuda.warps_per_sm(rpl, True)} with several")

    # the repo's C++ (native/) is built at first use too: build it here, so
    # that phase 4 times the pipeline and not g++
    from lancet2_tpu_torch.base import native_core
    from lancet2_tpu_torch.hts import native as bam_native

    t0 = time.monotonic()
    log(f"phase 2: native assembly core {native_core.available()}, native "
        f"BAM decoder {bam_native.available()} "
        f"({time.monotonic() - t0:.1f} s)")
    if bam_native.available():
        log(f"phase 2: native BAM decoder built with {bam_native.build_route()}")
    else:
        log("phase 2: native BAM decoder build failed; reads decode in "
            "Python. Compiler output:\n" + (bam_native.build_error() or ""))

    log("phase 3: kernels against their plain versions")
    kres = check_kernels(dev)

    from lancet2_tpu_torch.utils.simulate import make_chr_scale_fixture

    cache = os.path.join(ROOT, ".smoke_cache")
    os.makedirs(cache, exist_ok=True)
    t0 = time.monotonic()
    fx = make_chr_scale_fixture(1000, cache)
    log(f"phase 4: 1 Mb fixture ready in {time.monotonic() - t0:.1f} s")
    ec.reset_launches()
    stats = run_port(fx, os.path.join(cache, "smoke_1mb.vcf.gz"), "cuda")
    launches = dict(ec.LAUNCHES)
    recs = vcf_records(os.path.join(cache, "smoke_1mb.vcf.gz"))
    called = {int(r.split("\t")[1]) for r in recs}
    truth = [p + 1 for p, _r, _a in fx["truth"]]
    recall = sum(p in called for p in truth) / max(1, len(truth))
    quals = [float(r.split("\t")[5]) for r in recs]
    p2 = stats["pass2"]
    log(f"phase 4: {stats['windows']} windows in {stats['runtime_s']:.2f} s "
        f"= {stats['windows_per_s']:.3f} windows/s; records {len(recs)}; "
        f"planted-variant recall {recall:.3f} ({len(truth)} planted)")
    log("phase 4: wall by phase " + json.dumps(
        {k: v["seconds"] for k, v in stats["wall_profile"].items()}))
    log(f"phase 4: launches {json.dumps(launches)}; pass-2 fraction "
        f"{p2['pass2'] / max(1, p2['total']):.4f} "
        f"({p2['pass2']}/{p2['total']} pairs)")
    if launches["span"] == 0 or launches["evidence"] == 0:
        raise AssertionError(f"the main path did not launch both kernels: "
                             f"{launches}")
    if stats["windows"] != 1249 or not recs:
        raise AssertionError(f"unexpected 1 Mb result: {stats['windows']} "
                             f"windows, {len(recs)} records")
    if not all(q == q and q >= 0 for q in quals) or recall < 0.5:
        raise AssertionError(f"implausible calls: recall {recall:.3f}")

    region = f"{fx['chrom']}:100001-103600"  # 5 windows
    got = {}
    for device in ("cuda", "cpu"):
        path = os.path.join(cache, f"smoke_region_{device}.vcf.gz")
        st = run_port(fx, path, device, region)
        got[device] = vcf_records(path)
        log(f"phase 5: {region} on {device}: {st['windows']} windows, "
            f"{len(got[device])} records, {st['runtime_s']:.2f} s")
        if st["windows"] != 5:
            raise AssertionError(f"region ran {st['windows']} windows, not 5")
    if got["cuda"] != got["cpu"] or not got["cuda"]:
        raise AssertionError("cuda and cpu records differ on the region")
    log("phase 5: cuda and cpu records are byte-identical")

    log("phase 6: K3 against its plain version")
    swres = check_sw_fitting(dev)
    step_res = run_window_step(dev)
    check_pls(dev)
    thr_launches = run_threads(fx, cache, recs, region, got["cuda"])
    mesh_launches = run_multi_device(fx, cache, recs)
    run_graph_build(fx, cache, region, got["cuda"])
    opt_launches = run_options(fx, cache, recs, stats)

    clock_hz = card_clock_hz()
    log(f"phase 10: bounds at {clock_hz / 1e6:.0f} MHz x {sms} SMs x "
        f"{INT32_LANES_PER_SM} int32 lanes x {INT32_OPS_PER_LANE_CLOCK} "
        f"operations, {HBM_BYTES_PER_S / 1e12} TB/s")
    kernels = []
    for name, R, replaces, launch_key in (
            ("span", 0, "lancet2_tpu/ops/evidence_pallas.py:514", "span"),
            ("evidence", 1, "lancet2_tpu/ops/evidence_pallas.py:546",
             "evidence")):
        main = kres[("main", R, MAIN_SHAPE[R])]
        errs = [v["max_abs_err"] for (_what, r, _lt), v in kres.items()
                if (r == 0) == (R == 0)]
        bound_ms, bound_by = bound(ops_per_cell(name, R) * main["cells"],
                                   main["bytes"], clock_hz, sms)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "lancet2_tpu_torch/csrc/evidence_dp.cu",
            "replaces": replaces, "launches": launches[launch_key],
            "launches_threads": thr_launches[launch_key],
            "launches_mesh": mesh_launches[launch_key],
            "launches_options": opt_launches[launch_key],
            "max_abs_err": max(errs), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
        })
    for (what, R, Lt), v in kres.items():
        name = "span" if R == 0 else "evidence"
        b_ms, b_by = bound(ops_per_cell(name, R) * v["cells"], v["bytes"],
                           clock_hz, sms)
        log(f"phase 10: bound {what} R={R} Lt={Lt}: {b_ms:.4f} ms ({b_by}); "
            f"kernel {v['ms']:.3f} ms")
    for case, v in swres.items():
        b_ms, b_by = bound(ops_per_cell("sw_fitting") * v["cells"],
                           v["bytes"], clock_hz, sms)
        log(f"phase 10: bound K3 {case}: {b_ms:.4f} ms ({b_by}); kernel "
            f"{v['ms']:.3f} ms")
    main = swres["window_step"]
    bound_ms, bound_by = bound(ops_per_cell("sw_fitting") * main["cells"],
                               main["bytes"], clock_hz, sms)
    kernels.append({
        "name": "sw_fitting", "route": "cuda",
        "source": "lancet2_tpu_torch/csrc/sw_fitting.cu",
        "replaces": "lancet2_tpu/ops/sw_pallas.py:184",
        "launches": step_res["launches"],
        "launches_mesh": mesh_launches["sw_fitting"],
        "max_abs_err": max(v["max_abs_err"] for v in swres.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    raise SystemExit(main())
