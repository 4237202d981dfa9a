"""K3 (the score-only fitting DP, lancet2_tpu_torch/csrc/sw_fitting.cu) on the
card: its rows per lane, and one tree against another.

    python scripts/torch_sw_tune.py rpl [--reps N]
        Builds a tuning library under lancet2_tpu_torch/_build/tune/: a
        source that includes csrc/sw_fitting.cu and launches its kernel at
        any rows per lane 1-8, where the shipped entry point always takes
        the plan's. Prints ptxas's registers and spills per instantiation
        and the SASS opcodes that carry the cell in the one-stripe kernels
        at 4 and 5 rows per lane, then times every rows-per-lane value at
        chip_smoke.py's two main K3 shapes (bench.py's B 2048, Lq 152,
        Lt 1024 and the window step's B 8192, Lq 128, Lt 256). Every output
        is held to the plain version (ops/sw_dp.py), score and t_end equal.

    python scripts/torch_sw_tune.py trees TREE:TAG [TREE:TAG ...]
        For each tree (this checkout, or an older commit unpacked with `git
        archive`), in a fresh process in the order given: runs that tree's
        chip_smoke.py phase 6 (K3 against its plain version) and phase 7
        (the window step at bench.py's width), and prints one JSON line of
        K3's ms at both main shapes and the window step's ms per step.

Times are CUDA events around --reps launches, in ms per launch. Needs a
CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The tuning library: sw_fitting.cu's kernel behind a launch that takes the
# rows per lane as an argument.
_TUNE_CU = r"""
#include "sw_fitting.cu"

extern "C" long long l2t_sw_tune_scratch_bytes(int rpl, int B, int Lq,
                                               int Lt) {
  return Lq > 32 * rpl ? (long long)B * 2 * Lt * (long long)sizeof(int2) : 0;
}

extern "C" int l2t_sw_tune_launch(int rpl, const void* q, const void* q_lens,
                                  const void* t, const void* t_lens, int B,
                                  int Lq, int Lt, int match, int mismatch,
                                  int go, int ge, void* scratch, void* score,
                                  void* t_end, void* stream) {
  const l2t_sw::Params p{match, mismatch, go, ge};
  switch (rpl) {
#define L2T_CASE(R)                                                     \
  case R:                                                               \
    return launch_rpl<R>(q, q_lens, t, t_lens, B, Lq, Lt, p, scratch,   \
                         score, t_end, stream);
    L2T_CASE(1) L2T_CASE(2) L2T_CASE(3) L2T_CASE(4)
    L2T_CASE(5) L2T_CASE(6) L2T_CASE(7) L2T_CASE(8)
#undef L2T_CASE
  }
  return (int)cudaErrorInvalidValue;
}
"""

# Run inside a tree: that tree's chip_smoke.py phases 6 and 7.
_TREE = r"""
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as c
from lancet2_tpu_torch.ops import _build
dev = torch.device("cuda", 0)
_build.library()
k3 = c.check_sw_fitting(dev)
step = c.run_window_step(dev)
print(json.dumps({"tag": sys.argv[1],
                  "window_step_ms": k3["window_step"]["ms"],
                  "bench_ms": k3["bench"]["ms"],
                  "step_ms": 1e3 * c.STEP["num_windows"] / step["windows_per_s"]}))
"""


def build_tune_library() -> str:
    """nvcc the tuning library; print ptxas's and cuobjdump's findings."""
    sys.path.insert(0, ROOT)
    from lancet2_tpu_torch.ops import _build

    out = os.path.join(_build.BUILD_ROOT, "tune")
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, "sw_tune.cu"), os.path.join(out, "libsw.so")
    with open(src, "w") as f:
        f.write(_TUNE_CU)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-shared",
         "-o", lib, src], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log[-4000:]}")
    kernel = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"sw_fitting_kernelILi(\d)ELb(\d)E", m.group(1))
            kernel = f"rpl={k.group(1)} multi={k.group(2)}" if k else None
        elif kernel and ("registers" in line or "spill" in line):
            print(f"ptxas {kernel}: {line.strip()}", flush=True)
    sass_counts(lib)
    return lib


def sass_counts(path: str) -> None:
    """Per one-stripe kernel at 4 and 5 rows per lane: how many of its SASS
    instructions are each of the opcodes that carry the cell."""
    sass = subprocess.run(["cuobjdump", "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    for body in sass.split("Function : ")[1:]:
        k = re.match(r"\S*sw_fitting_kernelILi(\d)ELb0E", body)
        if not k or k.group(1) not in ("4", "5"):
            continue
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body)
        counts = {op: sum(o.split(".")[0] == op for o in ops) for op in (
            "VIADDMNMX", "VIMNMX", "IMNMX", "IADD3", "PRMT", "SHFL", "SEL",
            "ISETP", "LDG", "BRA")}
        print(f"sass rpl={k.group(1)}: {len(ops)} instructions, "
              f"{json.dumps(counts)}", flush=True)


def rows_per_lane_sweep(reps: int) -> None:
    import torch

    import chip_smoke
    from lancet2_tpu_torch.ops.params import READ_TO_HAP_PARAMS
    from lancet2_tpu_torch.ops.sw_dp import fitting_scores_torch

    lib = ctypes.CDLL(build_tune_library())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    launch = lib.l2t_sw_tune_launch
    launch.argtypes = [ci] + [vp] * 4 + [ci] * 7 + [vp] * 4
    launch.restype = ci
    scratch_bytes = lib.l2t_sw_tune_scratch_bytes
    scratch_bytes.argtypes = [ci] * 4
    scratch_bytes.restype = ctypes.c_longlong
    dev = torch.device("cuda", 0)
    kp = READ_TO_HAP_PARAMS
    for shape, (q, ql, t, tl) in chip_smoke.sw_main_pairs(dev).items():
        B, Lq = q.shape
        Lt = t.shape[1]
        want = fitting_scores_torch(q, ql, t, tl, kp.to(dev))
        for rpl in range(1, 9):
            n = scratch_bytes(rpl, B, Lq, Lt)
            scratch = torch.empty(max(n, 1), dtype=torch.uint8, device=dev)
            score = torch.empty(B, dtype=torch.int32, device=dev)
            t_end = torch.empty_like(score)

            def run():
                err = launch(rpl, q.data_ptr(), ql.data_ptr(), t.data_ptr(),
                             tl.data_ptr(), B, Lq, Lt, kp.match, kp.mismatch,
                             kp.gap_open, kp.gap_extend,
                             scratch.data_ptr() if n else None,
                             score.data_ptr(), t_end.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            exact = torch.equal(score, want[0]) and torch.equal(t_end, want[1])
            ms = chip_smoke.time_cuda(run, reps)
            print(json.dumps({"shape": shape, "rpl": rpl,
                              "stripes": -(-Lq // (32 * rpl)),
                              "exact": exact, "ms": ms}), flush=True)
            if not exact:
                raise AssertionError(f"rpl={rpl} {shape} differs from the "
                                     "plain version")


def trees(specs: list[str]) -> None:
    for spec in specs:
        tree, _, tag = spec.partition(":")
        proc = subprocess.run([sys.executable, "-c", _TREE, tag or tree],
                              cwd=tree, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{spec} failed:\n{proc.stdout[-2000:]}\n"
                               f"{proc.stderr[-4000:]}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("rpl", "trees"))
    ap.add_argument("trees", nargs="*", help="TREE:TAG (mode trees)")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_sw_tune: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    print(chip_smoke.card_line(), flush=True)
    if a.mode == "rpl":
        rows_per_lane_sweep(a.reps)
    else:
        trees(a.trees)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
