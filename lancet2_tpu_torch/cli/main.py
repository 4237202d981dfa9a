"""CLI: `python -m lancet2_tpu_torch pipeline ...` on a torch device.

Reuses the JAX package's argument parser (`lancet2_tpu.cli.main.
build_parser`) and the host half of its `run_pipeline` (reference
`:164-463`), without the jax configuration block (`:186-214`). The port runs
the batch executor only; `--device` takes {cpu, cuda} (default cuda). An
option the port does not support yet raises a clear error instead of being
ignored.

This module imports neither torch nor jax at import time: the prep
coordinator is spawned, and a spawned process re-imports the main module.
"""

from __future__ import annotations

import os
import resource
import sys
import time

from lancet2_tpu.cli.main import build_parser as _build_reference_parser
from lancet2_tpu.cli.vcf_header import build_vcf_header
from lancet2_tpu.cbdg.graph import GraphParams
from lancet2_tpu.core.active_region import has_md_tag
from lancet2_tpu.core.read_collector import CollectorParams
from lancet2_tpu.core.sample_info import make_sample_list
from lancet2_tpu.core.variant_builder import BuilderParams
from lancet2_tpu.core.window_builder import WindowBuilder, WindowParams
from lancet2_tpu.hts.bgzf import BgzfWriter
from lancet2_tpu.hts.fasta import Reference
from lancet2_tpu.utils.logging import configure, get_logger

LOG = get_logger("cli")

# pairs per kernel launch (span and evidence alike)
PAIR_CHUNK = 8192


def build_parser():
    parser = _build_reference_parser()
    parser.prog = "lancet2-tpu-torch"
    parser.description = ("PyTorch/CUDA port of the microassembly "
                          "somatic/germline variant caller")
    pipeline = next(a for a in parser._subparsers._group_actions
                    if a.dest == "command").choices["pipeline"]
    pipeline.set_defaults(executor="batch", aligner_backend="evidence",
                          device="cuda")
    for action in pipeline._actions:
        if action.dest == "device":
            action.choices = ["cpu", "cuda"]
            action.help = ("where the evidence DP runs: cuda launches the "
                           "hand-written kernels on the current CUDA device; "
                           "cpu runs their plain PyTorch versions")
    return parser


def _reject_unsupported(args) -> None:
    unsupported = []
    if args.executor != "batch":
        unsupported.append("--executor threads (the port runs the batch "
                           "executor only)")
    if args.aligner_backend != "evidence":
        unsupported.append(f"--aligner-backend {args.aligner_backend} (the "
                           "batch executor uses the evidence DP)")
    if args.prep_mode == "threads":
        unsupported.append("--prep-mode threads")
    if args.graph_backend == "device":
        unsupported.append("--graph-backend device (the XLA graph build is "
                           "not ported)")
    if args.probe_variants or args.probe_results:
        unsupported.append("--probe-variants/--probe-results")
    if args.out_graphs_tgz:
        unsupported.append("--out-graphs-tgz")
    if args.append_history:
        unsupported.append("--append-history")
    if unsupported:
        raise SystemExit("not supported by lancet2_tpu_torch yet: "
                         + "; ".join(unsupported))


def run_pipeline(args, command_line: str) -> dict:
    configure(args.verbose)
    t0 = time.monotonic()
    _reject_unsupported(args)

    from lancet2_tpu.core.sample_info import parse_sample_spec
    from lancet2_tpu.hts.uri import validate_cloud_access

    validate_cloud_access(
        args.normal + args.tumor + [parse_sample_spec(s)[0] for s in args.sample]
        + [args.reference], mode="read")
    validate_cloud_access([args.out_vcfgz], mode="write")

    import faulthandler

    faulthandler.enable(all_threads=True)

    if not args.normal and not args.tumor and not args.sample:
        raise SystemExit("at least one of --normal/--tumor/--sample is required")

    if args.read_filter:
        from lancet2_tpu.hts.filter_expr import FilterExprError, compile_filter

        try:
            compile_filter(args.read_filter)
        except FilterExprError as exc:
            raise SystemExit(f"invalid --read-filter expression: {exc}")

    ref = Reference(args.reference)
    samples = make_sample_list(args.normal, args.tumor, args.sample)
    LOG.info("loaded %d sample(s): %s", len(samples), ", ".join(
        f"{s.sample_name}({'case' if s.tag == 4 else 'ctrl'})" for s in samples))

    if not args.no_contig_check:
        from lancet2_tpu.hts.bam import read_bam_header

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
        from lancet2_tpu.hts.bam import open_bam

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
        from lancet2_tpu.parallel.manifest import windows_for_host

        windows = windows_for_host(windows, args.host_index, args.num_hosts)
        for i, w in enumerate(windows):
            w.genome_index = i
        LOG.info("host %d/%d processes %d windows", args.host_index,
                 args.num_hosts, len(windows))

    from lancet2_tpu.core.checkpoint import (
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
    )
    params = BuilderParams(
        graph=graph_params,
        collector=CollectorParams(
            max_sample_cov=args.max_sample_cov, extract_pairs=args.extract_pairs,
            stream_bam=args.stream_bam, ref_path=args.reference,
            filter_expr=args.read_filter,
        ),
        skip_active_region=skip_active,
        gc_fraction=args.genome_gc_bias,
        aligner_backend="evidence",
        graphs_shards_dir=None,
    )

    case_ctrl = (any(s.tag == 4 for s in samples)
                 and any(s.tag == 2 for s in samples))
    header = build_vcf_header(ref, [s.sample_name for s in samples],
                              command_line, case_ctrl)

    import torch

    from lancet2_tpu_torch.core.batch_pipeline import TorchBatchPipelineExecutor

    executor = TorchBatchPipelineExecutor(
        params, ref, samples, windows, num_workers=args.num_threads,
        pair_chunk=PAIR_CHUNK,
        checkpoint=ckpt,
        min_emit_pos=min_emit_pos,
        total_hint=expected_windows if stream_windows else None,
        prep_mode=args.prep_mode,
        device=torch.device(args.device),
    )

    out = BgzfWriter(args.out_vcfgz)
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

    if ckpt is not None:
        ckpt.clear()  # run completed; the VCF is whole

    runtime = time.monotonic() - t0
    peak_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    LOG.info("done in %.2fs | peak RSS %.1f MB | windows=%s", runtime,
             peak_rss_mb, stats.get("status_counts"))
    stats["total_runtime_s"] = runtime
    stats["peak_rss_mb"] = peak_rss_mb
    return stats


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(argv)
    if args.command != "pipeline":
        # index / cram are host-only and shared with the JAX package
        from lancet2_tpu.cli.main import main as reference_main

        return reference_main(argv)
    run_pipeline(args, "lancet2-tpu-torch " + " ".join(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
