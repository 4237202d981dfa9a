"""Probe forensics: trace truth variants through every pipeline stage.

Reference: src/lancet/cbdg/probe_tracker.cpp, probe_index.cpp,
probe_results_writer.cpp, core/probe_diagnostics.cpp and the attribution
workflow in scripts/analyze_probe_results.py — given a list of (missed)
truth variants, precompute ALT-unique k-mer identities per k, tag them in
every graph, and record at which pipeline stage the variant's signal died
(build / lowcov / compress / tips / anchor / cycle / complexity /
traversal-limit / path / extraction / genotyper).

Output: one TSV row per (probe variant, window attempt) with per-stage
presence flags; scripts/analyze_probe_results.py computes the bottom-up
lost_at_stage attribution.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from lancet2_tpu_torch.base.dna import encode
from lancet2_tpu_torch.cbdg.kmer import canonicalize_batch, kmer_ids

STAGES = [
    "build", "lowcov1", "compress1", "lowcov2", "compress2", "tips",
    "path", "extracted", "genotyped",
]
EVENTS = ["no_anchor", "short_anchor", "cycle", "complex", "traversal_limit"]


@dataclass
class ProbeVariant:
    chrom: str
    pos1: int
    ref: str
    alt: str
    # per-k ALT-unique canonical kmer ids
    alt_kmers_by_k: dict[int, set[int]] = field(default_factory=dict)
    # flanked ALT haplotype context (for the path-presence check; the bare
    # alt allele is degenerate — a 1bp SNV allele is a substring of anything)
    alt_context: str = ""
    # reference context of the same window (for shift-equivalence matching)
    ref_context: str = ""
    ctx_start1: int = 0  # 1-based genomic position of ref_context[0]

    @property
    def key(self) -> str:
        return f"{self.chrom}:{self.pos1}:{self.ref}>{self.alt}"


def _context_kmer_ids(seq: str, k: int) -> set[int]:
    codes = encode(seq)
    if len(codes) < k:
        return set()
    kmers = np.lib.stride_tricks.sliding_window_view(codes, k)
    canonical, _ = canonicalize_batch(kmers)
    return set(int(i) for i in kmer_ids(canonical))


class ProbeIndex:
    """Per-k ALT-unique k-mer identities for each truth variant."""

    def __init__(self, variants: list[ProbeVariant]):
        self.variants = variants

    @classmethod
    def from_file(cls, path: str, graph_params, ref) -> "ProbeIndex":
        """Load variants from a VCF(.gz) or TSV (chrom pos ref alt) file and
        build per-k ALT-unique kmer indices against the reference."""
        raw: list[tuple[str, int, str, str]] = []
        import gzip

        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fh:
            for line in fh:
                if line.startswith("#") or not line.strip():
                    continue
                fields = line.rstrip("\n").split("\t")
                chrom, pos1, ref_a = fields[0], int(fields[1]), None
                if len(fields) >= 5 and not fields[2].replace(".", "").isdigit():
                    # VCF: CHROM POS ID REF ALT
                    ref_a, alts = fields[3], fields[4]
                else:
                    ref_a, alts = fields[2], fields[3]
                for alt_a in alts.split(","):
                    raw.append((chrom, pos1, ref_a, alt_a))

        ks = list(
            range(
                graph_params.min_kmer_len,
                graph_params.max_kmer_len + 1,
                graph_params.kmer_step_len,
            )
        )
        variants = []
        for chrom, pos1, ref_a, alt_a in raw:
            pv = ProbeVariant(chrom, pos1, ref_a, alt_a)
            ctx_flank = 15
            left = ref.fetch(chrom, pos1 - ctx_flank, pos1 - 1)
            right = ref.fetch(chrom, pos1 + len(ref_a), pos1 + len(ref_a) + ctx_flank - 1)
            pv.alt_context = left + alt_a + right
            pv.ref_context = left + ref_a + right
            pv.ctx_start1 = pos1 - len(left)
            for k in ks:
                flank = k
                left = ref.fetch(chrom, pos1 - flank, pos1 - 1)
                right = ref.fetch(chrom, pos1 + len(ref_a), pos1 + len(ref_a) + flank - 1)
                alt_ctx = left + alt_a + right
                ref_ctx = left + ref_a + right
                pv.alt_kmers_by_k[k] = _context_kmer_ids(alt_ctx, k) - _context_kmer_ids(
                    ref_ctx, k
                )
            variants.append(pv)
        return cls(variants)


class ProbeResultsWriter:
    """Thread-safe TSV sink shared by all workers."""

    def __init__(self, path: str):
        self._lock = threading.Lock()
        self._fh = open(path, "w")
        cols = ["probe", "window", "k"] + STAGES + EVENTS
        self._fh.write("\t".join(cols) + "\n")

    def write_row(self, probe_key: str, window: str, k: int, flags: dict) -> None:
        with self._lock:
            vals = [probe_key, window, str(k)]
            vals += [str(int(bool(flags.get(s, False)))) for s in STAGES + EVENTS]
            self._fh.write("\t".join(vals) + "\n")
            self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class ProbeTracker:
    """Per-worker tracker wired into Graph + VariantBuilder stage hooks."""

    def __init__(self, index: ProbeIndex, writer: ProbeResultsWriter):
        self.index = index
        self.writer = writer
        self._k = 0
        self._window = ""
        # probe key -> set of node ids currently carrying its ALT-unique kmers
        self._tagged: dict[str, set[int]] = {}
        self._flags: dict[str, dict] = {}

    # ---- lifecycle hooks (called by Graph) -------------------------------
    def begin_window(self, window_str: str) -> None:
        self._window = window_str

    def on_graph_built(self, graph, k: int) -> None:
        self._flush_rows()
        self._k = k
        self._tagged = {}
        self._flags = {}
        # 'build' reflects the pre-prune graph (the construction pass now
        # pre-prunes vectorized; all_built_ids preserves the raw kmer set)
        built_ids = getattr(graph, "all_built_ids", None) or set(graph.nodes.keys())
        node_ids = set(graph.nodes.keys())
        for pv in self.index.variants:
            probe_ids = pv.alt_kmers_by_k.get(k, set())
            self._tagged[pv.key] = probe_ids & node_ids
            self._flags[pv.key] = {"build": bool(probe_ids & built_ids)}

    def log_stage(self, stage: str, graph, k: int) -> None:
        for key, nodes in self._tagged.items():
            self._flags.setdefault(key, {})[stage] = bool(nodes)

    def on_node_remove(self, nid: int) -> None:
        for nodes in self._tagged.values():
            nodes.discard(nid)

    def on_node_merge(self, absorbed_id: int, surviving_id: int) -> None:
        for nodes in self._tagged.values():
            if absorbed_id in nodes:
                nodes.discard(absorbed_id)
                nodes.add(surviving_id)

    def set_status(self, comp_id: int, status: str) -> None:
        for key in self._flags:
            self._flags[key][status] = True

    def check_paths(self, haps, comp_id: int, k: int) -> None:
        for pv in self.index.variants:
            flags = self._flags.setdefault(pv.key, {})
            for hap in haps[1:] if haps else []:
                if pv.alt_context and pv.alt_context in hap.path.sequence:
                    flags["path"] = True
                    break

    # ---- caller-side hooks (called by VariantBuilder) --------------------
    @staticmethod
    def _matches_probe(pv: ProbeVariant, chrom: str, pos1: int, ref_a: str, alt_a: str) -> bool:
        """Exact or shift-equivalent match: applying the candidate edit to the
        probe's reference context must reproduce the probe's ALT context."""
        if chrom != pv.chrom:
            return False
        if pos1 == pv.pos1 and ref_a == pv.ref and alt_a == pv.alt:
            return True
        off = pos1 - pv.ctx_start1
        if off < 0 or off + len(ref_a) > len(pv.ref_context):
            return False
        if pv.ref_context[off : off + len(ref_a)] != ref_a:
            return False
        applied = pv.ref_context[:off] + alt_a + pv.ref_context[off + len(ref_a):]
        return applied == pv.alt_context

    def check_msa_extraction(self, variants, window) -> None:
        for pv in self.index.variants:
            flags = self._flags.setdefault(pv.key, {})
            for var in variants:
                if any(
                    self._matches_probe(pv, var.chrom_name, var.genome_pos1,
                                        var.ref_allele, a.sequence)
                    for a in var.alts
                ):
                    flags["extracted"] = True

    def check_genotyper_result(self, geno_result, variants) -> None:
        for pv in self.index.variants:
            flags = self._flags.setdefault(pv.key, {})
            for vi, var in enumerate(variants):
                if not any(
                    self._matches_probe(pv, var.chrom_name, var.genome_pos1,
                                        var.ref_allele, a.sequence)
                    for a in var.alts
                ):
                    continue
                supports = geno_result.get(vi, {})
                if any(s.total_alt_cov() > 0 for s in supports.values()):
                    flags["genotyped"] = True

    def submit_completed(self) -> None:
        self._flush_rows()

    def _flush_rows(self) -> None:
        for key, flags in self._flags.items():
            if flags:
                self.writer.write_row(key, self._window, self._k, flags)
        self._flags = {}
