"""Phase A (host prep) of lancet2_tpu_torch's batch executor, measured two ways.

    python scripts/torch_phase_a.py pipeline TREE:TAG [TREE:TAG ...]
        Runs chip_smoke.py's 1 Mb simulated tumor/normal fixture through each
        tree's `chip_smoke.run_port` on CUDA, one fresh process per run, in
        the order given, and prints one JSON line per run: windows/s, wall
        time by phase and stage totals (summed over the prep workers). TREE
        is the root of a checkout: this one, or an older commit unpacked
        with `git archive`. Needs a CUDA device.

    python scripts/torch_phase_a.py coordinator TREE [TREE ...]
        Drives phase A alone through each tree's prep coordinator (spawned,
        as the executor spawns it) over the windows of a small fixture and
        prints the seconds to the first prepared window and to the last.
        Runs on the CPU.

--cache DIR holds the fixtures (default: .smoke_cache of this checkout).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PIPELINE = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
from chip_smoke import run_port
from lancet2_tpu_torch.utils.simulate import make_chr_scale_fixture
cache, tag = sys.argv[1], sys.argv[2]
fx = make_chr_scale_fixture(1000, cache)
st = run_port(fx, os.path.join(cache, tag + ".vcf.gz"), "cuda")
print(json.dumps({"tag": tag, "windows_per_s": st["windows_per_s"],
                  "wall": {k: v["seconds"] for k, v in st["wall_profile"].items()},
                  "stages": {k: v["seconds"] for k, v in st["stage_profile"].items()}}))
"""

_COORDINATOR = r"""
import multiprocessing as mp, os, sys, time

def main():
    sys.path.insert(0, os.getcwd())
    from lancet2_tpu_torch.caller.genotyper import _QUERY_BUCKETS, _TARGET_BUCKETS
    from lancet2_tpu_torch.cbdg.graph import GraphParams
    from lancet2_tpu_torch.core.prep_worker import coordinator_main
    from lancet2_tpu_torch.core.read_collector import CollectorParams
    from lancet2_tpu_torch.core.sample_info import make_sample_list
    from lancet2_tpu_torch.core.variant_builder import BuilderParams
    from lancet2_tpu_torch.core.window_builder import WindowBuilder, WindowParams
    from lancet2_tpu_torch.hts.fasta import Reference
    from lancet2_tpu_torch.utils.simulate import make_chr_scale_fixture

    cache, kb, workers = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    fx = make_chr_scale_fixture(kb, cache)
    ref = Reference(fx["fasta"])
    samples = make_sample_list([fx["normal"]], [fx["tumor"]], [])
    wb = WindowBuilder(ref, WindowParams())
    wb.add_whole_reference()
    wb.sort_input_regions()
    windows = wb.build_windows()
    params = BuilderParams(graph=GraphParams(num_samples=len(samples)),
                           collector=CollectorParams(ref_path=fx["fasta"]),
                           aligner_backend="evidence")
    ctx = mp.get_context("spawn")
    work_q, result_q = ctx.Queue(), ctx.Queue()
    t0 = time.monotonic()
    proc = ctx.Process(target=coordinator_main, args=(
        work_q, result_q, params, ref.path, samples, 96, 4, _TARGET_BUCKETS,
        _QUERY_BUCKETS, workers))
    proc.start()
    for seq, w in enumerate(windows):
        work_q.put((seq, w))
    first = None
    for _ in windows:
        _seq, kind, payload = result_q.get()
        if kind in ("error", "fatal"):
            raise RuntimeError(payload)
        first = first if first is not None else time.monotonic() - t0
        pairs = getattr(payload, "pairs", None)
        if pairs and "shm" in pairs:
            from multiprocessing import shared_memory
            seg = shared_memory.SharedMemory(name=pairs["shm"])
            seg.close()
            seg.unlink()
    last = time.monotonic() - t0
    for _ in range(workers):
        work_q.put(None)
    proc.join(60)
    print(f"windows {len(windows)} workers {workers}: first {first:.2f} s, "
          f"last {last:.2f} s")

if __name__ == "__main__":
    main()
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=["pipeline", "coordinator"])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--cache", default=os.path.join(ROOT, ".smoke_cache"))
    ap.add_argument("--kb", type=int, default=150,
                    help="coordinator mode: fixture size in kb")
    ap.add_argument("--workers", type=int, default=6,
                    help="coordinator mode: prep workers")
    args = ap.parse_args()
    os.makedirs(args.cache, exist_ok=True)
    cache = os.path.abspath(args.cache)
    for spec in args.trees:
        tree, _, tag = spec.partition(":")
        tree = os.path.abspath(tree)
        if args.mode == "pipeline":
            cmd = [sys.executable, "-c", _PIPELINE, cache,
                   tag or os.path.basename(tree)]
        else:
            cmd = [sys.executable, "-c", _COORDINATOR, cache, str(args.kb),
                   str(args.workers)]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(json.dumps({"tree": spec, "process_s": round(time.monotonic() - t0, 1)}),
              proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
