"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from lancet2_tpu_torch/csrc (nvcc, sm_90a) and
     the repo's C++ (native/, g++; a missing toolchain or library leaves
     the numpy/Python paths, as in the JAX package);
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
     phase 7's batch) and on an edge batch (N bases, padding, short and
     degenerate lengths); kernel and plain times and GCUPS printed;
  7. the window step at bench.py's full width (16 windows of 128 reads of
     128 bases against 4 haplotypes of 512, band margin 64) on the card
     for a few steps: windows/s and K3's launch count (must be > 0); its
     output and that of the window-step entry point (graft_entry.entry)
     against the same step on the CPU;
  8. the float64 DM PLs on the card against the host engine
     (caller/likelihood.py) on a sweep of K 2-4 and depths 0-3000: no
     mismatch allowed, as the batch executor's phase C relies on them;
  9. the kernels' JSON line (each kernel's bound from this run's inputs),
     the card line, and the result line last.

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
TOLERANCE = 0  # the kernel must equal its plain version bit for bit
# the window step at bench.py's shape (bench_window_step)
STEP = dict(num_windows=16, reads_per_window=128, read_len=128, num_haps=4,
            hap_len=512, num_samples=2)
STEP_MARGIN, STEP_REPS = 64, 5

# The bound of a kernel: the larger of its int32 operations over the card's
# int32 issue rate (64 lanes per SM x SMs x the SM clock nvidia-smi reports)
# and its bytes (each input read once, each output written once) over the
# 3.35 TB/s of HBM. Operations per DP cell of the minimal recurrence,
# counted from the kernels' code: K3 10 (substitution score 1, diagonal 1,
# V 3, Ht 1, F 3, H 1); K1 20 (K3's 10, plus a three-way select of the
# start and NM companions and NM's four updates); K2 20 + 36 per region
# slot (six companions, each a three-way select, and the slot's membership
# tests and updates along the diagonal, vertical and deletion moves).
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64


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
    t_ops = ops / (INT32_LANES_PER_SM * sms * clock_hz)
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


def check_sw_fitting(dev) -> dict:
    """Phase 6: K3 against its plain version at the main path's shapes and
    on an edge batch."""
    import numpy as np
    import torch

    from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS
    from lancet2_tpu_torch.ops.sw_cuda import fitting_scores
    from lancet2_tpu_torch.ops.sw_dp import fitting_scores_torch
    from lancet2_tpu_torch.ops.window_step import window_pairs

    kp = READ_TO_HAP_PARAMS.to(dev)
    rng = np.random.default_rng(0)  # bench.py bench_sw_kernel's inputs
    B, Lq, Lt = 2048, 152, 1024
    bench = (rng.integers(0, 4, (B, Lq)).astype(np.uint8),
             np.full(B, Lq, np.int32),
             rng.integers(0, 4, (B, Lt)).astype(np.uint8),
             np.full(B, Lt, np.int32))
    sb = step_batch(dev)
    cases = {
        "bench": [torch.from_numpy(a).to(dev) for a in bench],
        "window_step": list(window_pairs(
            sb["reads"], sb["read_lens"], sb["haps"], sb["hap_lens"],
            sb["read_offset"], STEP_MARGIN)),
        "edge": [torch.from_numpy(a).to(dev)
                 for a in sw_edge_pairs(500, 1000, 77, 203)],
    }
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
        ms = time_cuda(kernel, 5)
        plain_ms = time_cuda(plain, 1)
        cells = dp_cells(ql.cpu().numpy(), tl.cpu().numpy(), Lq, Lt)
        log(f"K3 {name} B={B} Lq={Lq} Lt={Lt}: exact={exact} "
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


def assert_step_close(got: dict, want: dict, what: str) -> None:
    """The window step on the card against the CPU: scores and depth counts
    exact; float32 PLs and GQ within 1 (torch's float32 lgamma on the card
    and on the CPU may differ in the last bit); best genotype equal where
    the CPU row's two lowest PLs differ by 2 or more."""
    import torch

    got = {k: v.cpu() for k, v in got.items()}
    for k in ("scores", "allele_counts"):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k} differs from the CPU step")
    for k in ("pls", "gq"):
        d = int((got[k].long() - want[k].long()).abs().max())
        if d > 1:
            raise AssertionError(f"{what}: {k} off by {d} from the CPU step")
    low2 = torch.sort(want["pls"], dim=-1).values[..., :2]
    clear = (low2[..., 1] - low2[..., 0]) >= 2
    if not torch.equal(got["best_gt"][clear], want["best_gt"][clear]):
        raise AssertionError(f"{what}: best_gt differs from the CPU step")


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
    assert_step_close(out, want, "window step")
    for k, v in out.items():
        if not torch.isfinite(v.float()).all():
            raise AssertionError(f"window step: non-finite {k}")
    if int(out["allele_counts"].sum()) == 0:
        raise AssertionError("window step counted no read")
    e_step, e_args = graft_entry.entry(dev)
    c_step, c_args = graft_entry.entry("cpu")
    assert_step_close(e_step(*e_args), c_step(*c_args), "graft entry")
    log("phase 7: window step and graft entry agree with the CPU step")
    return dict(launches=launches, windows_per_s=nw / per_step)


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


def run_port(fx: dict, out_vcf: str, device: str, region=None) -> dict:
    from lancet2_tpu_torch.cli.main import build_parser, run_pipeline

    argv = ["pipeline", "-n", fx["normal"], "-t", fx["tumor"],
            "-r", fx["fasta"], "-o", out_vcf, "--device", device,
            "-T", str(os.cpu_count() or 4)]
    if region:
        argv += ["-R", region]
    return run_pipeline(build_parser().parse_args(argv),
                        "chip_smoke " + " ".join(argv))


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

    # the repo's C++ (native/) is built at first use too: build it here, so
    # that phase 4 times the pipeline and not g++
    from lancet2_tpu_torch.base import native_core
    from lancet2_tpu_torch.hts import native as bam_native

    t0 = time.monotonic()
    log(f"phase 2: native assembly core {native_core.available()}, native "
        f"BAM decoder {bam_native.available()} "
        f"({time.monotonic() - t0:.1f} s)")

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

    clock_hz = card_clock_hz()
    log(f"phase 9: bounds at {clock_hz / 1e6:.0f} MHz x {sms} SMs x "
        f"{INT32_LANES_PER_SM} int32 lanes, {HBM_BYTES_PER_S / 1e12} TB/s")
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
            "max_abs_err": max(errs), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
        })
    for (what, R, Lt), v in kres.items():
        name = "span" if R == 0 else "evidence"
        b_ms, b_by = bound(ops_per_cell(name, R) * v["cells"], v["bytes"],
                           clock_hz, sms)
        log(f"phase 9: bound {what} R={R} Lt={Lt}: {b_ms:.4f} ms ({b_by}); "
            f"kernel {v['ms']:.3f} ms")
    for case, v in swres.items():
        b_ms, b_by = bound(ops_per_cell("sw_fitting") * v["cells"],
                           v["bytes"], clock_hz, sms)
        log(f"phase 9: bound K3 {case}: {b_ms:.4f} ms ({b_by}); kernel "
            f"{v['ms']:.3f} ms")
    main = swres["window_step"]
    bound_ms, bound_by = bound(ops_per_cell("sw_fitting") * main["cells"],
                               main["bytes"], clock_hz, sms)
    kernels.append({
        "name": "sw_fitting", "route": "cuda",
        "source": "lancet2_tpu_torch/csrc/sw_fitting.cu",
        "replaces": "lancet2_tpu/ops/sw_pallas.py:184",
        "launches": step_res["launches"],
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
