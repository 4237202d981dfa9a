"""The threads executor of lancet2_tpu_torch on the 1 Mb fixture, on the card.

    python scripts/torch_threads.py [--windows N] [--backend evidence|jax|numpy]
                                    [-T THREADS] [--cache DIR]

Runs chip_smoke.py's 1 Mb simulated tumor/normal fixture (40x/60x, seed 11;
made once under --cache, default .smoke_cache of this checkout) through
`python -m lancet2_tpu_torch pipeline --executor threads --device cuda`
over its first N windows (0, the default: all 1249), after building the
CUDA kernels and the native code as chip_smoke.py's phase 2 does, and
prints one JSON line: windows, seconds, windows/s, K1/K2/K3 launches and
the stage totals (summed over the worker threads). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=0)
    ap.add_argument("--backend", default="evidence",
                    choices=["evidence", "jax", "numpy"])
    ap.add_argument("-T", "--threads", type=int, default=os.cpu_count())
    ap.add_argument("--cache", default=os.path.join(ROOT, ".smoke_cache"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_threads: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line
    from lancet2_tpu_torch.base import native_core
    from lancet2_tpu_torch.cli.main import build_parser, run_pipeline
    from lancet2_tpu_torch.ops import _build
    from lancet2_tpu_torch.utils.simulate import make_chr_scale_fixture

    os.makedirs(args.cache, exist_ok=True)
    fx = make_chr_scale_fixture(1000, args.cache)
    _build.library()
    native_core.available()
    out_vcf = os.path.join(args.cache, f"threads_{args.backend}.vcf.gz")
    argv = ["pipeline", "-n", fx["normal"], "-t", fx["tumor"],
            "-r", fx["fasta"], "-o", out_vcf, "--device", "cuda",
            "-T", str(args.threads), "--executor", "threads",
            "--aligner-backend", args.backend]
    if args.windows:
        # window i starts at 800 * i + 1: this region builds the first N
        argv += ["-R", f"{fx['chrom']}:1-{800 * args.windows}"]
    _build.reset_launches()
    st = run_pipeline(build_parser().parse_args(argv), "torch_threads")
    print(json.dumps({
        "card": card_line(), "backend": args.backend, "threads": args.threads,
        "windows": st["windows"], "seconds": st["runtime_s"],
        "windows_per_s": st["windows_per_s"], "launches": dict(_build.LAUNCHES),
        "stages": {k: v["seconds"] for k, v in st["stage_profile"].items()},
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
