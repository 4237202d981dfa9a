"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits 0 only if all pass):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from lancet2_tpu_torch/csrc (nvcc, sm_90a);
  3. K1 (R=0) and K2 (R in 1, 2, 4) against their plain PyTorch versions on
     the card, exact equality required, on seeded pairs at Lq 160,
     Lt in {256, 384}, B 8192 with planted indels and deletions longer than
     31 columns; both times printed;
  4. the port's batch pipeline with --device cuda on the simulated 1 Mb
     tumor/normal fixture (40x/60x, seed 11): windows/s, wall time by
     phase, launch counts of both kernels (both must be > 0), pass-2
     fraction, and recall of the planted variants;
  5. a 5-window region with --device cuda and --device cpu: the VCF record
     lines must be byte-identical;
  6. the kernels' JSON line, the card line, and the result line last.

Without a CUDA device it exits non-zero before printing any result. Inputs
are made from seeds; the fixture is cached under .smoke_cache/ (gitignored).
"""

from __future__ import annotations

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
TOLERANCE = 0  # the kernel must equal its plain version bit for bit


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


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


def check_kernels(dev) -> dict:
    """Phase 3: every instantiated kernel against its plain version."""
    import numpy as np
    import torch

    from lancet2_tpu_torch.ops import evidence_cuda as ec
    from lancet2_tpu_torch.ops.evidence_dp import evidence_dp_torch
    from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS

    kp = READ_TO_HAP_PARAMS.to(dev)
    results = {}
    for R, Lt in CASES:
        host = make_pairs(1000 + 10 * R + Lt, Lt, R)
        q, qu, ql, t, tl, reg = (torch.from_numpy(a).to(dev) for a in host)

        def kernel():
            if R == 0:
                return ec.span_pairs_submit(q, ql, t, tl, kp), None
            return ec.evidence_pairs_submit(q, qu, ql, t, tl, reg, R, kp)

        def plain():
            return ec._pack(evidence_dp_torch(q, qu, ql, t, tl, reg, kp,
                                              r_max=R), R)

        k_i, k_f = kernel()
        torch.cuda.synchronize()
        p_i, p_f = plain()
        torch.cuda.synchronize()
        err = int((k_i.long() - p_i.long()).abs().max())
        if R:
            err = max(err, float((k_f - p_f).abs().max()))
        exact = torch.equal(k_i, p_i) and (R == 0 or torch.equal(k_f, p_f))
        nm = p_i[:, 3].cpu().numpy()
        long_dels = int((nm >= 32).sum())
        ms = time_cuda(kernel, 5)
        plain_ms = time_cuda(plain, 1)
        gcups = B * LQ * Lt / (ms * 1e6)
        log(f"kernel R={R} Lq={LQ} Lt={Lt} B={B}: exact={exact} "
            f"max_abs_err={err} pairs_nm>=32={long_dels} "
            f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
            f"kernel_gcups={gcups:.3f}")
        if not exact or err > TOLERANCE:
            raise AssertionError(f"kernel R={R} Lt={Lt} disagrees with its "
                                 f"plain version (max_abs_err={err})")
        if long_dels == 0:
            raise AssertionError("fixture planted no deletion longer than 31")
        results[(R, Lt)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return results


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
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())

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

    kernels = []
    for name, R, replaces, launch_key in (
            ("span", 0, "lancet2_tpu/ops/evidence_pallas.py:514", "span"),
            ("evidence", 1, "lancet2_tpu/ops/evidence_pallas.py:546",
             "evidence")):
        main = kres[(R, MAIN_SHAPE[R])]
        errs = [v["max_abs_err"] for (r, _lt), v in kres.items()
                if (r == 0) == (R == 0)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "lancet2_tpu_torch/csrc/evidence_dp.cu",
            "replaces": replaces, "launches": launches[launch_key],
            "max_abs_err": max(errs), "ms": main["ms"],
            "plain_ms": main["plain_ms"],
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
