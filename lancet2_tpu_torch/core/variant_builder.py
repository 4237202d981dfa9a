"""Per-window driver: skip gates -> collect -> assemble -> extract -> genotype.

Reference: src/lancet/core/variant_builder.{h,cpp}. One VariantBuilder per
worker; zero shared mutable state during processing. Eight status codes
mirror the reference's per-window outcome histogram.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from lancet2_tpu_torch.base.dna import encode
from lancet2_tpu_torch.base.repeat import has_exact_repeat
from lancet2_tpu_torch.base.sequence_complexity import SequenceComplexityScorer
from lancet2_tpu_torch.caller.extractor import extract_component_variants
from lancet2_tpu_torch.caller.genotyper import Genotyper
from lancet2_tpu_torch.caller.variant import RawVariant
from lancet2_tpu_torch.caller.variant_call import SampleSummary, VariantCall
from lancet2_tpu_torch.cbdg.graph import Graph, GraphParams
from lancet2_tpu_torch.core.active_region import is_active_region
from lancet2_tpu_torch.core.read_collector import CollectorParams, ReadCollector
from lancet2_tpu_torch.core.sample_info import SampleInfo, cross_sample_mean_coverage
from lancet2_tpu_torch.core.window_builder import Window
from lancet2_tpu_torch.hts.fasta import Reference
from lancet2_tpu_torch.utils.profiling import StageTimer


class StatusCode(enum.Enum):
    UNKNOWN = 0
    SKIPPED_NONLY_REF_BASES = 1
    SKIPPED_REF_REPEAT_SEEN = 2
    SKIPPED_INACTIVE_REGION = 3
    SKIPPED_ANCHOR_COVERAGE = 4
    SKIPPED_NOASM_HAPLOTYPE = 5
    MISSING_NO_MSA_VARIANTS = 6
    FOUND_GENOTYPED_VARIANT = 7


@dataclass
class BuilderParams:
    graph: GraphParams = field(default_factory=GraphParams)
    collector: CollectorParams = field(default_factory=CollectorParams)
    skip_active_region: bool = False
    gc_fraction: float = 0.41
    aligner_backend: str = "numpy"
    graphs_shards_dir: str | None = None  # per-worker graph snapshot shards
    # torch device of the genotyper's engines (jax, evidence), by name: the
    # params cross into the spawned prep coordinator, which loads no torch
    device: str = "cuda"


@dataclass
class PreparedComponent:
    hap_seqs: list
    variants: list
    anchor_pos1: int = 0  # 1-based genomic position of the haplotypes' start


@dataclass
class PreparedWindow:
    window: object
    reads: list
    components: list  # list[PreparedComponent]
    sample_summaries: list


class VariantBuilder:
    def __init__(self, params: BuilderParams, ref: Reference, samples: list[SampleInfo],
                 probe_tracker=None, shard_writer=None, reader_pool: dict | None = None):
        self.shard_writer = shard_writer
        self.params = params
        self.ref = ref
        self.samples = samples
        self.graph = Graph(params.graph, probe_tracker=probe_tracker,
                           shard_writer=shard_writer)
        self.collector = ReadCollector(params.collector, samples,
                                       reader_pool=reader_pool)
        self.genotyper = Genotyper(backend=params.aligner_backend,
                                   device=params.device)
        self.seq_cx_scorer = SequenceComplexityScorer(params.gc_fraction)
        self.current_code = StatusCode.UNKNOWN
        self.probe_tracker = probe_tracker
        self.timer = StageTimer()

    # ------------------------------------------------------------------
    def should_skip_window(self, window: Window) -> bool:
        seq = window.seq(self.ref)
        if all(b == "N" for b in seq):
            self.current_code = StatusCode.SKIPPED_NONLY_REF_BASES
            return True
        max_k = self.params.graph.max_kmer_len
        if has_exact_repeat(encode(seq), max_k):
            self.current_code = StatusCode.SKIPPED_REF_REPEAT_SEEN
            return True
        if not self.params.skip_active_region:
            readers = [self.collector.readers[s.path] for s in self.samples]
            if not is_active_region(readers, window.chrom, window.start1, window.end1):
                self.current_code = StatusCode.SKIPPED_INACTIVE_REGION
                return True
        return False

    # ------------------------------------------------------------------
    def process_window(self, window: Window) -> list[VariantCall]:
        try:
            prepared = self._process_window_impl(window)
            if not isinstance(prepared, PreparedWindow):
                return prepared if isinstance(prepared, list) else []
            geno_results = []
            for pc in prepared.components:
                with self.timer.stage("genotype"):
                    geno_results.append(
                        self.genotyper.genotype(pc.hap_seqs, prepared.reads, pc.variants)
                    )
            return self.finalize_window(prepared, geno_results)
        finally:
            # probe flags must flush under THIS window's label on every exit
            # path — after finalize's genotyper checks (early skips included)
            if self.probe_tracker is not None:
                self.probe_tracker.submit_completed()

    def _process_window_impl(self, window: Window) -> list[VariantCall]:
        self.current_code = StatusCode.UNKNOWN
        if self.probe_tracker is not None:
            self.probe_tracker.begin_window(window.to_samtools())
        with self.timer.stage("gate"):
            if self.should_skip_window(window):
                return []

        with self.timer.stage("collect"):
            reads = self.collector.collect(window.chrom, window.start1, window.end1)
        cross_cov = cross_sample_mean_coverage(self.samples, window.length)
        if cross_cov < self.params.graph.min_anchor_cov:
            self.current_code = StatusCode.SKIPPED_ANCHOR_COVERAGE
            return []

        ref_codes = encode(window.seq(self.ref))
        window_name = f"{window.chrom}_{window.start1}_{window.end1}"
        with self.timer.stage("assemble"):
            components = self.graph.build_component_results(ref_codes, reads, window_name)
        if sum(c.num_alt_haplotypes for c in components) == 0:
            self.current_code = StatusCode.SKIPPED_NOASM_HAPLOTYPE
            return []

        sample_summaries = [
            SampleSummary(
                name=s.sample_name,
                tag=s.tag,
                sampled_bases=s.num_sampled_bases,
                window_length=window.length,
            )
            for s in self.samples
        ]

        prepared = PreparedWindow(window, reads, [], sample_summaries)
        for comp_index, comp in enumerate(components):
            hap_seqs = comp.haplotype_sequences()
            anchor_pos1 = window.start1 + comp.anchor_start_offset
            with self.timer.stage("extract"):
                from lancet2_tpu_torch.caller.extractor import build_pseudo_msa

                msa_rows = build_pseudo_msa(hap_seqs[0], list(hap_seqs[1:]))
                from lancet2_tpu_torch.caller.extractor import extract_variants

                variants = extract_variants(
                    msa_rows, window.chrom_index, window.chrom, anchor_pos1
                )
            if self.shard_writer is not None:
                # per-component MSA + haplotype FASTA into the worker shard
                # (reference: SerializeSpoaState writes GFA+FASTA per comp)
                prefix = f"{window.chrom}_{window.start1}_{window.end1}"
                comp_id = comp_index
                msa_fa = "".join(
                    f">msa_{'ref' if i == 0 else f'hap{i}'}\n{row}\n"
                    for i, row in enumerate(msa_rows)
                )
                hap_fa = "".join(
                    f">{'ref_anchor' if i == 0 else f'hap{i}'}\n{seq}\n"
                    for i, seq in enumerate(hap_seqs)
                )
                self.shard_writer.add_file(
                    f"poa_graph/{prefix}/msa__{prefix}__c{comp_id}.fasta", msa_fa.encode()
                )
                self.shard_writer.add_file(
                    f"poa_graph/{prefix}/haps__{prefix}__c{comp_id}.fasta", hap_fa.encode()
                )
            if not variants:
                continue
            with self.timer.stage("annotate"):
                self._annotate(variants, hap_seqs, comp)
            if self.probe_tracker is not None:
                self.probe_tracker.check_msa_extraction(variants, window)

            prepared.components.append(
                PreparedComponent(hap_seqs, variants, anchor_pos1)
            )

        if not prepared.components:
            self.current_code = StatusCode.MISSING_NO_MSA_VARIANTS
            return []
        # stash for two-phase executors; inline path genotypes immediately
        self._last_prepared = prepared
        return prepared

    def prepare_window(self, window: Window):
        """Phases 1-3 + extraction/annotation; genotyping deferred.

        Returns a PreparedWindow (with components to genotype) or [] when the
        window terminated early (status code records why).
        """
        try:
            out = self._process_window_impl(window)
        finally:
            if self.probe_tracker is not None:
                self.probe_tracker.submit_completed()
        return out if isinstance(out, PreparedWindow) else None

    def finalize_window(self, prepared: "PreparedWindow", geno_results: list) -> list[VariantCall]:
        """Assemble VariantCalls from per-component genotyping results."""
        calls: list[VariantCall] = []
        for pc, geno in zip(prepared.components, geno_results):
            if self.probe_tracker is not None:
                self.probe_tracker.check_genotyper_result(geno, pc.variants)
            for vi, variant in enumerate(pc.variants):
                supports = geno.get(vi)
                if not supports:
                    continue
                if not any(s.total_alt_cov() > 0 for s in supports.values()):
                    continue
                calls.append(
                    VariantCall(variant, supports, prepared.sample_summaries,
                                prepared.window.length,
                                window_index=prepared.window.genome_index)
                )
        if not calls:
            self.current_code = StatusCode.MISSING_NO_MSA_VARIANTS
            return []
        self.current_code = StatusCode.FOUND_GENOTYPED_VARIANT
        return calls

    # ------------------------------------------------------------------
    def _annotate(self, variants: list[RawVariant], hap_seqs: list[str], comp) -> None:
        """Attach SEQ_CX (max-merged across carrying haplotypes), GRAPH_CX,
        and path metrics (reference: core/variant_annotator.cpp)."""
        metrics = comp.metrics
        max_alt_cv = comp.max_alt_path_cv()
        for var in variants:
            gm = var.graph_metrics
            gm.gei = metrics.graph_entanglement_index()
            gm.tip_to_path_cov_ratio = metrics.tip_to_path_cov_ratio
            gm.max_single_dir_degree = metrics.max_single_dir_degree
            var.num_total_haps = comp.num_paths
            var.max_path_cv = max_alt_cv

            merged = None
            ref_hap = hap_seqs[0]
            for alt in var.alts:
                for hap_idx, start in alt.local_hap_starts.items():
                    cplx = self.seq_cx_scorer.score(
                        ref_hap, var.local_ref_start0, len(var.ref_allele),
                        hap_seqs[hap_idx], start, len(alt.sequence),
                    )
                    if merged is None:
                        merged = cplx
                    else:
                        merged.merge_max(cplx)
            var.seq_cx = merged
