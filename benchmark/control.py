"""Readings that set the limits of the correctness check, on the card.

    python benchmark/control.py --workload <cell> --seconds <s> --seeds 1,2,3
        [--traffic <mix>] [--threads <n>]

One process, one set-up, then for each seed one whole job at the cell's
size through the port, as `run.py` runs it, and from that job's VCF:

- the sound readings: the numbers `run.py` compares (planted variants
  missed, extra calls, likelihood fields off their float64 recomputation)
  and `run.py`'s verdict on them;
- the control: the reference put in the program's place one precision
  lower, i.e. every likelihood field of the job recomputed from the same AD
  in float32, counted against the float64 recomputation;
- faults planted in the job's answers: "half": the records of every other
  800-bp step of the contig dropped; "shift": every record moved one base
  to the right; "dup": every record written twice.

`--traffic` runs another traffic mix of `traffic/` in the cell's place, and
`--threads` sets `-T` (default: the cores the process may use), for
readings of a cell not yet in BENCHMARK.json or of the job's spread under
fewer prep workers. Prints one JSON line per seed. The benchmark's own runs
do not run this.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def readings(cell: dict, fx: dict, out_vcf: str) -> dict:
    import torch

    import reference as ref

    with open(fx["fasta"]) as fh:
        seq = "".join(fh.read().split("\n", 1)[1].split())
    _names, records = ref.read_vcf(out_vcf)
    cfg = cell["cfg"]
    step = cfg["cli"]["window"] * (100 - cfg["cli"]["overlap_pct"]) // 100
    faults = {
        "half": [r for r in records if ((r["pos"] - 1) // step) % 2 == 0],
        "shift": [{**r, "pos": r["pos"] + 1} for r in records],
        "dup": records + records,
    }
    sound = ref.against_truth(records, fx["truth"], cfg, seq)
    out = {
        "records": len(records),
        **{k: v for k, v in sound.items() if k != "extra_sites"},
        "extra_sites": [[p + 1, r, a] for p, r, a in sound["extra_sites"][:20]],
        "likelihood_mismatches": ref.likelihood_mismatches(
            records, cfg)["mismatches"],
        "control_float32_mismatches": ref.likelihood_mismatches(
            records, cfg, torch.float32)["mismatches"],
    }
    for name, recs in faults.items():
        t = ref.against_truth(recs, fx["truth"], cfg, seq)
        out[f"fault_{name}_missed_share"] = t["missed_share"]
        out[f"fault_{name}_extra_share"] = t["extra_share"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--traffic")
    ap.add_argument("--threads", type=int)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(HERE))
    import torch

    import run as R

    cell = R.load_cell(args.workload, traffic=args.traffic)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    threads = args.threads or len(os.sched_getaffinity(0))
    n = R.job_windows(cell, args.seconds)
    warm = R.prepare_inputs(cell, "warm", cell["cell"]["warm_windows"], 0,
                            threads, keep_others=True)
    R.run_job(cell, warm, os.path.join(warm["dir"], "job.vcf.gz"), "cuda",
              threads)
    print(f"set-up {time.monotonic() - T_START:.1f} s", file=sys.stderr)
    for seed in (int(s) for s in args.seeds.split(",")):
        fx = R.prepare_inputs(cell, str(seed), n, seed, threads)
        out = os.path.join(fx["dir"], "job.vcf.gz")
        run = R.run_job(cell, fx, out, "cuda", threads)
        checks = R.judge(cell, fx, out, run.windows)
        print(json.dumps({"workload": args.workload,
                          "traffic": args.traffic, "threads": threads,
                          "seed": seed, "windows": run.windows,
                          "windows_per_s": run.windows / run.job_s,
                          "correct": R.verdict(checks),
                          **readings(cell, fx, out)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
