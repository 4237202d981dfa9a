"""CLI: `python -m lancet2_tpu_torch pipeline ...` on a torch device.

The JAX package's CLI (`lancet2_tpu/cli/main.py`) with its flag surface,
without the jax configuration block. `--device` takes {cpu, cuda}. The
port's defaults are `--device cuda --executor batch --aligner-backend
evidence` (the JAX package's: cpu, threads, jax); the threads executor runs
with every backend. `--graph-backend device` builds the k-mer graphs with
the tape-packed torch pass (ops/graph_tape.py): under `--executor threads`
on `--device`, under `--executor batch` on the CPU, because phase A's prep
workers (forked processes, or threads that never touch the device) build
the graphs. `index` and `cram` run through the port's own hts modules.

This module does not import torch at import time: the prep coordinator is
spawned, and a spawned process re-imports the main module.
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time

from lancet2_tpu_torch.cbdg.graph import GraphParams
from lancet2_tpu_torch.cli.vcf_header import build_vcf_header
from lancet2_tpu_torch.core.active_region import has_md_tag
from lancet2_tpu_torch.core.read_collector import CollectorParams
from lancet2_tpu_torch.core.sample_info import make_sample_list
from lancet2_tpu_torch.core.variant_builder import BuilderParams
from lancet2_tpu_torch.core.window_builder import WindowBuilder, WindowParams
from lancet2_tpu_torch.hts.bgzf import BgzfWriter
from lancet2_tpu_torch.hts.fasta import Reference
from lancet2_tpu_torch.utils.logging import configure, get_logger

LOG = get_logger("cli")

# pairs per kernel launch (span and evidence alike)
PAIR_CHUNK = 8192


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="lancet2-tpu-torch",
        description="PyTorch/CUDA port of the microassembly "
                    "somatic/germline variant caller",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    ix = sub.add_parser("index", help="build a .bai/.csi index for a BAM, or "
                                      "a .crai for a CRAM (htslib-compatible; "
                                      "see hts/bai.py, hts/csi.py, hts/crai.py)")
    ix.add_argument("bam", help="coordinate-sorted BAM or CRAM file")
    ix.add_argument("-o", "--output", default=None, help="output index path "
                                                         "(default: <bam>.bai/.csi)")
    ix.add_argument("--csi", action="store_true",
                    help="CSI binning (contigs >= 2^29 bp) instead of BAI")
    ix.add_argument("--min-shift", type=int, default=14,
                    help="CSI minimum interval shift (default 14)")
    ix.add_argument("--depth", type=int, default=5,
                    help="CSI binning depth (default 5; 6 covers 4 Gbp contigs)")

    cv = sub.add_parser("cram", help="convert BAM <-> CRAM 3.0 (native codec; "
                                     "see hts/cram.py)")
    cv.add_argument("input", help="input BAM or CRAM")
    cv.add_argument("-r", "--reference", required=True,
                    help="reference FASTA (CRAM is reference-based)")
    cv.add_argument("-o", "--output", required=True, help="output .cram or .bam")
    cv.add_argument("--codec", choices=["gzip", "rans4x8"], default="gzip",
                    help="CRAM block compression (default gzip)")

    pl = sub.add_parser("pipeline", help="run the variant calling pipeline")

    # sample inputs
    pl.add_argument("-n", "--normal", action="append", default=[], help="normal/control BAM")
    pl.add_argument("-t", "--tumor", action="append", default=[], help="tumor/case BAM")
    pl.add_argument(
        "-s", "--sample", action="append", default=[],
        help="unified sample spec '<path>:<role>' (role: control|case)",
    )
    pl.add_argument("-r", "--reference", required=True, help="indexed reference FASTA")
    pl.add_argument("-o", "--out-vcfgz", required=True, help="output bgzip VCF path")

    # regions
    pl.add_argument("-R", "--region", action="append", default=[], help="region spec(s)")
    pl.add_argument("-b", "--bed-file", default=None, help="BED file of regions")
    pl.add_argument("-P", "--padding", type=int, default=500)
    pl.add_argument("-p", "--pct-overlap", type=int, default=20, choices=range(10, 91),
                    metavar="[10-90]")
    pl.add_argument("-w", "--window-size", type=int, default=1000)

    # execution
    pl.add_argument("-T", "--num-threads", type=int, default=2)
    pl.add_argument("--host-index", type=int, default=0,
                    help="this host's index for multi-host window sharding")
    pl.add_argument("--num-hosts", type=int, default=1,
                    help="total hosts; the window manifest is block-sharded "
                         "and each host writes its own VCF shard (merge with "
                         "lancet2_tpu_torch.parallel.manifest."
                         "merge_vcf_shards)")
    pl.add_argument("--aligner-backend", choices=["numpy", "jax", "evidence"],
                    default="evidence",
                    help="evidence (default): traceback-free evidence DP, the "
                         "hand-written kernels on cuda (what --executor batch "
                         "uses); jax: the bucketed dirs engine "
                         "(ops/affine_dp_torch.py, plain PyTorch on --device; "
                         "the JAX package's name, record-identical) and a "
                         "host CIGAR traceback; numpy: reference-parity "
                         "baseline on the host")
    pl.add_argument("--executor", choices=["threads", "batch"], default="batch",
                    help="batch (default) = two-phase executor with fused "
                         "cross-window evidence-DP dispatches (implies the "
                         "evidence backend); threads = each worker thread "
                         "genotypes one window at a time")
    pl.add_argument("--prep-mode", choices=["auto", "processes", "threads"],
                    default="auto",
                    help="batch-executor phase-A workers: fork processes "
                         "(GIL-free scaling, default on posix) or threads "
                         "(byte-identical results either way)")
    pl.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="where the genotyper's engine runs: cuda launches "
                         "the hand-written kernels on the current CUDA "
                         "device; cpu runs their plain PyTorch versions "
                         "(pair best with --executor batch so launches are "
                         "large and fused)")

    # graph params
    pl.add_argument("--graph-backend",
                    choices=["auto", "native", "numpy", "device"],
                    default="auto",
                    help="k-mer graph construction engine (bit-exact twins; "
                         "cbdg/graph.py): native C++ single-pass or numpy "
                         "vectorized; auto = native with numpy fallback; "
                         "device = the tape-packed torch pass, on --device "
                         "under --executor threads and on the CPU under "
                         "--executor batch (its prep workers never touch "
                         "the device)")
    pl.add_argument("-k", "--min-kmer", type=int, default=13)
    pl.add_argument("-K", "--max-kmer", type=int, default=127)
    pl.add_argument("--kmer-step", type=int, default=6)
    pl.add_argument("--min-anchor-cov", type=int, default=5)
    pl.add_argument("--min-node-cov", type=int, default=2)
    pl.add_argument("--max-sample-cov", type=float, default=1000.0)

    # toggles
    pl.add_argument("--verbose", action="store_true")
    pl.add_argument("--extract-pairs", action="store_true")
    pl.add_argument("--read-filter", default=None, metavar="EXPR",
                    help="samtools filter expression applied to collected "
                         "reads, e.g. 'mapq >= 30 && !flag.dup && [NM] <= 4' "
                         "(hts/filter_expr.py; reference: htslib hts_filter)")
    pl.add_argument("--stream-bam", action="store_true",
                    help="BAI-indexed streaming BAM access (bounded memory "
                         "for multi-GB inputs; builds the .bai when missing). "
                         "Auto-enabled when any input exceeds "
                         "LANCET2_STREAM_BAM_THRESHOLD_GB (default 2); "
                         "--no-stream-bam forces whole-file decode")
    pl.add_argument("--no-stream-bam", action="store_true",
                    help="force in-memory whole-file decode regardless of size")
    pl.add_argument("--no-active-region", action="store_true")
    pl.add_argument("--no-contig-check", action="store_true")
    pl.add_argument("--stream-windows", choices=["auto", "on", "off"], default="auto",
                    help="stream the window manifest instead of materializing "
                         "it (WGS memory bound; auto streams when the expected "
                         "count exceeds 131072, reference "
                         "pipeline_executor.cpp:137-150)")
    pl.add_argument("--genome-gc-bias", type=float, default=0.41)

    # diagnostics
    pl.add_argument("--probe-variants", default=None,
                    help="truth VCF/TSV of variants to trace through the pipeline")
    pl.add_argument("--probe-results", default=None, help="probe forensics TSV output")
    pl.add_argument("--out-graphs-tgz", default=None,
                    help="merged tar.gz of per-window graph snapshots (DOT)")
    pl.add_argument("--graph-snapshots", choices=["final", "verbose"], default="final",
                    help="verbose adds per-prune-stage snapshots (needs --out-graphs-tgz)")
    pl.add_argument("--checkpoint", action="store_true",
                    help="write a window-cursor checkpoint next to the VCF and "
                         "resume from it when present")
    pl.add_argument("--append-history", action="store_true",
                    help="append this run's stats + stage profile to "
                         "profiling/history.jsonl (the committed trend file; "
                         "analyze with scripts/analyze_profile.py)")
    return parser


def graph_build_device(args) -> str:
    """Where `--graph-backend device` builds: the run's device under the
    threads executor; the CPU under the batch executor, whose phase A runs
    in forked processes (or threads) that never touch the device."""
    return args.device if args.executor == "threads" else "cpu"


def run_pipeline(args, command_line: str, devices: list | None = None
                 ) -> dict:
    """Run the `pipeline` command. `devices` (Python callers only, no flag,
    as in the JAX package) hands the batch executor a device list: None
    takes every visible CUDA device under --device cuda."""
    configure(args.verbose)
    t0 = time.monotonic()

    from lancet2_tpu_torch.core.sample_info import parse_sample_spec
    from lancet2_tpu_torch.hts.uri import validate_cloud_access

    validate_cloud_access(
        args.normal + args.tumor + [parse_sample_spec(s)[0] for s in args.sample]
        + [args.reference], mode="read")
    validate_cloud_access([args.out_vcfgz], mode="write")

    import faulthandler

    faulthandler.enable(all_threads=True)

    if args.executor == "batch":
        args.aligner_backend = "evidence"
    elif args.device == "cuda" and args.aligner_backend != "numpy":
        LOG.warning(
            "--device cuda with --executor threads dispatches per-window; "
            "use --executor batch for fused device batches"
        )

    if not args.normal and not args.tumor and not args.sample:
        raise SystemExit("at least one of --normal/--tumor/--sample is required")

    if args.read_filter:
        from lancet2_tpu_torch.hts.filter_expr import FilterExprError, compile_filter

        try:
            compile_filter(args.read_filter)
        except FilterExprError as exc:
            raise SystemExit(f"invalid --read-filter expression: {exc}")

    ref = Reference(args.reference)
    samples = make_sample_list(args.normal, args.tumor, args.sample)
    LOG.info("loaded %d sample(s): %s", len(samples), ", ".join(
        f"{s.sample_name}({'case' if s.tag == 4 else 'ctrl'})" for s in samples))

    if not args.no_contig_check:
        from lancet2_tpu_torch.hts.bam import read_bam_header

        ref_lens = {c.name: c.length for c in ref.list_chroms()}
        for s in samples:
            _hdr, bam_refs = read_bam_header(s.path)
            for name, length in bam_refs:
                if name not in ref_lens:
                    raise SystemExit(
                        f"contig check failed: {s.path} has contig '{name}' "
                        f"absent from {args.reference} "
                        "(use --no-contig-check to bypass)")
                if ref_lens[name] != length:
                    raise SystemExit(
                        f"contig check failed: {s.path} contig '{name}' length "
                        f"{length} != reference {ref_lens[name]} "
                        "(use --no-contig-check to bypass)")

    if not args.stream_bam and not args.no_stream_bam:
        thresh_gb = float(os.environ.get("LANCET2_STREAM_BAM_THRESHOLD_GB", "2"))
        big = [s.path for s in samples if os.path.exists(s.path)
               and os.path.getsize(s.path) > thresh_gb * (1 << 30)]
        if big:
            LOG.info("input(s) over %.1f GB (%s): streaming BAM access "
                     "auto-enabled (--no-stream-bam to override)",
                     thresh_gb, ", ".join(os.path.basename(p) for p in big))
            args.stream_bam = True
    if args.no_stream_bam:
        args.stream_bam = False

    skip_active = args.no_active_region
    if not skip_active:
        from lancet2_tpu_torch.hts.bam import open_bam

        if not has_md_tag(open_bam(samples[0].path, stream=args.stream_bam,
                                   ref=args.reference)):
            LOG.warning("no MD tags found; disabling active-region prescan")
            skip_active = True

    wb = WindowBuilder(ref, WindowParams(
        window_length=args.window_size, pct_overlap=args.pct_overlap,
        region_padding=args.padding))
    for spec in args.region:
        wb.add_region_spec(spec)
    if args.bed_file:
        wb.add_bed_file(args.bed_file)
    if not args.region and not args.bed_file:
        wb.add_whole_reference()
    wb.sort_input_regions()
    expected_windows = wb.expected_target_windows()
    stream_windows = args.stream_windows == "on" or (
        args.stream_windows == "auto" and expected_windows > 131_072)
    if stream_windows and (args.num_hosts > 1 or args.checkpoint):
        if args.stream_windows == "on":
            LOG.warning("--stream-windows on is incompatible with "
                        "--num-hosts/--checkpoint; materializing windows")
        stream_windows = False
    if stream_windows:
        windows = wb.iter_windows()
        LOG.info("streaming ~%d windows (manifest not materialized)",
                 expected_windows)
    else:
        windows = wb.build_windows()
        LOG.info("built %d windows (expected ~%d)", len(windows),
                 expected_windows)

    if args.num_hosts > 1:
        from lancet2_tpu_torch.parallel.manifest import windows_for_host

        windows = windows_for_host(windows, args.host_index, args.num_hosts)
        for i, w in enumerate(windows):
            w.genome_index = i
        LOG.info("host %d/%d processes %d windows", args.host_index,
                 args.num_hosts, len(windows))

    from lancet2_tpu_torch.core.checkpoint import (
        CheckpointFile,
        recover_prefix_records,
        split_windows_for_resume,
    )

    ckpt = CheckpointFile(args.out_vcfgz + ".ckpt") if args.checkpoint else None
    prefix_records: list[str] = []
    min_emit_pos = None
    if ckpt is not None:
        cursor = ckpt.load()
        if cursor and os.path.exists(args.out_vcfgz):
            remaining, cpos = split_windows_for_resume(windows, cursor)
            prefix_records = recover_prefix_records(args.out_vcfgz, cpos)
            LOG.info("resuming at cursor %s: %d/%d windows remain, %d records "
                     "recovered", cpos, len(remaining), len(windows),
                     len(prefix_records))
            windows = remaining
            for i, w in enumerate(windows):
                w.genome_index = i
            min_emit_pos = cpos

    graph_params = GraphParams(
        min_kmer_len=args.min_kmer,
        max_kmer_len=args.max_kmer,
        kmer_step_len=args.kmer_step,
        min_node_cov=args.min_node_cov,
        min_anchor_cov=args.min_anchor_cov,
        num_samples=len(samples),
        snapshot_mode=args.graph_snapshots,
        build_backend=args.graph_backend,
        build_device=graph_build_device(args),
    )
    if args.graph_backend == "device":
        LOG.info("graph build: the tape-packed torch pass on %s%s",
                 graph_params.build_device,
                 "" if args.executor == "threads" else
                 " (--executor batch: phase A's prep workers never touch "
                 "the device)")
    shards_dir = None
    if args.out_graphs_tgz:
        import tempfile

        shards_dir = tempfile.mkdtemp(prefix="lancet2_graph_shards_")
    params = BuilderParams(
        graph=graph_params,
        collector=CollectorParams(
            max_sample_cov=args.max_sample_cov, extract_pairs=args.extract_pairs,
            stream_bam=args.stream_bam, ref_path=args.reference,
            filter_expr=args.read_filter,
        ),
        skip_active_region=skip_active,
        gc_fraction=args.genome_gc_bias,
        aligner_backend=args.aligner_backend,
        graphs_shards_dir=shards_dir,
        device=args.device,
    )

    probe_factory = None
    probe_writer = None
    if args.probe_variants:
        from lancet2_tpu_torch.utils.probe import (
            ProbeIndex,
            ProbeResultsWriter,
            ProbeTracker,
        )

        probe_index = ProbeIndex.from_file(args.probe_variants, graph_params, ref)
        probe_writer = ProbeResultsWriter(
            args.probe_results or args.probe_variants + ".probe.tsv")
        probe_factory = lambda wid: ProbeTracker(probe_index, probe_writer)

    case_ctrl = (any(s.tag == 4 for s in samples)
                 and any(s.tag == 2 for s in samples))
    header = build_vcf_header(ref, [s.sample_name for s in samples],
                              command_line, case_ctrl)

    if args.executor == "batch":
        from lancet2_tpu_torch.core.batch_pipeline import (
            TorchBatchPipelineExecutor,
        )

        executor = TorchBatchPipelineExecutor(
            params, ref, samples, windows, num_workers=args.num_threads,
            pair_chunk=PAIR_CHUNK,
            checkpoint=ckpt,
            min_emit_pos=min_emit_pos,
            total_hint=expected_windows if stream_windows else None,
            prep_mode=args.prep_mode,
            device=args.device,
            devices=devices,
        )
    else:
        from lancet2_tpu_torch.core.pipeline import PipelineExecutor

        executor = PipelineExecutor(
            params, ref, samples, windows,
            num_workers=args.num_threads,
            probe_tracker_factory=probe_factory,
            checkpoint=ckpt,
            min_emit_pos=min_emit_pos,
            total_hint=expected_windows if stream_windows else None,
            device=args.device,
        )

    out = BgzfWriter(args.out_vcfgz)
    if ckpt is not None:
        ckpt.sync = out.sync  # each cursor only after the records it covers
    try:
        out.write(header.encode())
        for rec in prefix_records:
            out.write(rec.encode())

        class _TextShim:
            def write(self, text: str):
                out.write(text.encode())

        stats = executor.execute(_TextShim())
    finally:
        out.close()
        if probe_writer is not None:
            probe_writer.close()

    if args.out_graphs_tgz and not getattr(executor, "shard_paths", None):
        LOG.warning("--out-graphs-tgz: no graph shards produced "
                    "(the batch executor does not emit graph snapshots)")
    if args.out_graphs_tgz and getattr(executor, "shard_paths", None):
        from lancet2_tpu_torch.utils.targz import merge_shards

        n_entries = merge_shards(executor.shard_paths, args.out_graphs_tgz)
        LOG.info("merged %d graph snapshots into %s", n_entries,
                 args.out_graphs_tgz)

    if ckpt is not None:
        ckpt.clear()  # run completed; the VCF is whole

    runtime = time.monotonic() - t0
    peak_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    LOG.info("done in %.2fs | peak RSS %.1f MB | windows=%s", runtime,
             peak_rss_mb, stats.get("status_counts"))
    stats["total_runtime_s"] = runtime
    stats["peak_rss_mb"] = peak_rss_mb
    if args.append_history:
        from lancet2_tpu_torch.utils.profiling import append_history

        append_history({
            "kind": "pipeline",
            "executor": args.executor,
            "backend": args.aligner_backend,
            "device": args.device,
            "num_threads": args.num_threads,
            **stats,
        })
    return stats


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(argv)
    if args.command == "pipeline":
        run_pipeline(args, "lancet2-tpu-torch " + " ".join(argv))
        return 0
    if args.command == "index":
        from lancet2_tpu_torch.hts.bai import build_bai
        from lancet2_tpu_torch.hts.bam import _is_cram
        from lancet2_tpu_torch.hts.bgzf import BgzfError
        from lancet2_tpu_torch.hts.csi import build_csi

        try:
            if _is_cram(args.bam):
                from lancet2_tpu_torch.hts.crai import build_crai

                build_crai(args.bam, args.output)
                print(args.output or args.bam + ".crai")
                return 0
            if args.csi:
                out = build_csi(args.bam, args.output,
                                min_shift=args.min_shift, depth=args.depth)
            else:
                out = build_bai(args.bam, args.output)
        except FileNotFoundError:
            print(f"error: no such file: {args.bam}", file=sys.stderr)
            return 1
        except (BgzfError, ValueError) as exc:
            print(f"error: {args.bam}: not a BAM file ({exc})", file=sys.stderr)
            return 1
        print(out)
        return 0
    if args.command == "cram":
        from lancet2_tpu_torch.hts.bam import BamWriter, _is_cram
        from lancet2_tpu_torch.hts.cram import CramReader, M_GZIP, M_RANS4x8, bam_to_cram

        method = M_RANS4x8 if args.codec == "rans4x8" else M_GZIP
        if _is_cram(args.input):
            reader = CramReader(args.input, args.reference)
            sample = reader.sample_name
            w = BamWriter(args.output, reader.references, sample_name=sample)
            n = 0
            for rec in reader.all_records():
                w.add(rec)
                n += 1
            w.close()
        else:
            n = bam_to_cram(args.input, args.output, args.reference, method=method)
        print(f"{args.output}: {n} records")
        return 0
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
