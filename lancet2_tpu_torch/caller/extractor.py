"""Variant extraction from haplotype/reference alignments.

The reference builds a weighted SPOA partial-order MSA of all haplotypes and
walks the POA graph with one pointer per haplotype, eating "topological
bubbles" (reference: src/lancet/caller/msa_builder.{h,cpp},
variant_extractor.cpp). A POA graph is a poor fit for accelerator-side
batching, so this framework follows the TPU-first formulation documented in
SURVEY.md §7 step 5: align every ALT haplotype to the REF anchor with the
same batched convex dual-affine DP (SPOA's forgiving parameters), project
all alignments into a common gapped column space (a pseudo-MSA), and run the
multi-pointer bubble walk over the columns. Observable behavior preserved:
anchor-base prepending, VCF-parsimony normalization, multiallelic grouping
by identical normalized ALT, per-haplotype local start bookkeeping, and the
deterministic lexicographic ALT sort (reference: variant_extractor.cpp:22-233,
variant_bubble.cpp).

On per-base path weights (cbdg.Path.per_base_weights, the reference's
Path::PerBaseWeights): the pseudo-MSA deliberately does NOT consume them,
and this is observationally equivalent to the reference, provable from its
source. In the reference the weights flow into exactly one call —
spoa::Graph::AddAlignment(alignment, seq, len, weights)
(caller/msa_builder.cpp:39) — where SPOA stores them on graph nodes/edges.
Nothing downstream reads them back: the alignment of each haplotype is
computed BEFORE AddAlignment by spoa::AlignmentEngine::Align, whose DP
scores by node characters only (weights never enter the scoring);
VariantExtractor walks the POA graph topology with per-haplotype pointers
and reads no weights (variant_extractor.cpp has no weight access); and
spoa's only weight consumer, Graph::GenerateConsensus, is never called
anywhere in the reference pipeline. The weights therefore cannot change
which variants are extracted or how they are placed — the MSA row content
is a pure function of sequences + alignment parameters, which this module
reproduces. Invariants that the POA formulation would otherwise protect
(shared-indel placement/grouping inside tandem repeats) are pinned by
tests/test_divergence_contracts.py.
"""

from __future__ import annotations

import numpy as np

from lancet2_tpu_torch.base.dna import encode
from lancet2_tpu_torch.caller.variant import (
    AltAllele,
    RawVariant,
    calculate_variant_length,
    classify_variant,
)
from lancet2_tpu_torch.ops.affine_dp import HAP_TO_REF, OP_D, OP_I, OP_M, align_and_traceback

GAP = "-"


def _pad_batch(seqs):
    width = max(len(s) for s in seqs)
    out = np.full((len(seqs), width), 5, dtype=np.uint8)
    lens = np.zeros(len(seqs), dtype=np.int64)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
        lens[i] = len(s)
    return out, lens


def build_pseudo_msa(ref_seq: str, alt_seqs: list[str]) -> list[str]:
    """Project pairwise ALT->REF alignments into common gapped rows.

    Returns [ref_row, alt_row_0, ...] — all strings of equal length. Each
    reference position may be preceded by insertion columns sized to the
    longest insertion any haplotype places there.
    """
    if not alt_seqs:
        return [ref_seq]
    qs, qlens = _pad_batch([encode(s) for s in alt_seqs])
    ts, tlens = _pad_batch([encode(ref_seq)] * len(alt_seqs))
    alns = align_and_traceback(qs, qlens, ts, tlens, HAP_TO_REF)

    n_ref = len(ref_seq)
    # ins_len[p] = max insertion length placed immediately before ref pos p
    ins_len = np.zeros(n_ref + 1, dtype=np.int64)
    per_hap = []
    for hap_seq, res in zip(alt_seqs, alns):
        qpos = tpos = 0
        events = []  # (ref_pos, kind, hap_substring/len)
        for op, length in res["cigar"]:
            if op == OP_M:
                events.append((tpos, "M", hap_seq[qpos : qpos + length]))
                qpos += length
                tpos += length
            elif op == OP_I:
                events.append((tpos, "I", hap_seq[qpos : qpos + length]))
                ins_len[tpos] = max(ins_len[tpos], length)
                qpos += length
            elif op == OP_D:
                events.append((tpos, "D", length))
                tpos += length
        per_hap.append(events)

    # column layout: for each ref pos p: ins_len[p] insertion columns, then
    # one match column; trailing insertions after the last ref base.
    col_of_ref = np.zeros(n_ref, dtype=np.int64)
    col = 0
    ins_col_start = np.zeros(n_ref + 1, dtype=np.int64)
    for p in range(n_ref):
        ins_col_start[p] = col
        col += int(ins_len[p])
        col_of_ref[p] = col
        col += 1
    ins_col_start[n_ref] = col
    total_cols = col + int(ins_len[n_ref])

    ref_row = [GAP] * total_cols
    for p in range(n_ref):
        ref_row[col_of_ref[p]] = ref_seq[p]
    rows = ["".join(ref_row)]

    for hap_seq, events in zip(alt_seqs, per_hap):
        row = [GAP] * total_cols
        for ref_pos, kind, payload in events:
            if kind == "M":
                for i, ch in enumerate(payload):
                    row[col_of_ref[ref_pos + i]] = ch
            elif kind == "I":
                # right-align insertions against the following match column so
                # every haplotype's insertion occupies a consistent column slot
                start = ins_col_start[ref_pos] + int(ins_len[ref_pos]) - len(payload)
                for i, ch in enumerate(payload):
                    row[start + i] = ch
            # deletions leave gap chars
        rows.append("".join(row))
    return rows


def _normalize_parsimony(ref_allele: str, alt_map: dict[str, list[int]], pos1: int):
    """VCF parsimony: right-trim then left-trim shared boundary bases across
    ALL alleles simultaneously (reference: VariantBubble::NormalizeVcfParsimony).
    Returns (ref_allele, alt_map, pos1)."""
    # right trim
    while len(ref_allele) > 1:
        if all(len(a) > 1 and a[-1] == ref_allele[-1] for a in alt_map):
            ref_allele = ref_allele[:-1]
            alt_map = {a[:-1]: h for a, h in alt_map.items()}
        else:
            break
    # left trim
    initial_len = len(ref_allele)
    while len(ref_allele) > 1:
        if all(len(a) > 1 and a[0] == ref_allele[0] for a in alt_map):
            ref_allele = ref_allele[1:]
            alt_map = {a[1:]: h for a, h in alt_map.items()}
        else:
            break
    pos1 += initial_len - len(ref_allele)
    return ref_allele, alt_map, pos1


def extract_variants(
    rows: list[str],
    chrom_index: int,
    chrom_name: str,
    anchor_genome_pos1: int,
) -> list[RawVariant]:
    """Multi-pointer bubble walk over pseudo-MSA rows.

    rows[0] is the reference; rows[1:] are ALT haplotypes (haplotype index i
    corresponds to rows[i]). anchor_genome_pos1 is the 1-based genomic
    position of the first reference-row base.
    """
    n_rows = len(rows)
    if n_rows < 2:
        return []
    width = len(rows[0])

    # per-row cursor over non-gap characters (haplotype-local positions)
    hap_pos = [0] * n_rows
    ref_pos = 0  # reference-local position (0-based within anchor)
    variants: list[RawVariant] = []

    col = 0
    prev_match: tuple[str, int, list[int]] | None = None  # (base, ref_pos, hap_positions)
    while col < width:
        column = [rows[r][col] for r in range(n_rows)]
        ref_ch = column[0]
        converged = ref_ch != GAP and all(ch == ref_ch for ch in column)
        if converged:
            prev_match = (ref_ch, ref_pos, list(hap_pos))
            for r in range(n_rows):
                hap_pos[r] += 1
            ref_pos += 1
            col += 1
            continue

        # bubble: consume columns until a converged column (or row end)
        has_anchor = prev_match is not None
        bubble_ref_pos = (prev_match[1] if has_anchor else ref_pos)
        bubble_hap_starts = list(prev_match[2]) if has_anchor else list(hap_pos)
        alleles = [prev_match[0] if has_anchor else "" for _ in range(n_rows)]
        while col < width:
            column = [rows[r][col] for r in range(n_rows)]
            ref_ch = column[0]
            if ref_ch != GAP and all(ch == ref_ch for ch in column):
                break
            for r in range(n_rows):
                if column[r] != GAP:
                    alleles[r] += column[r]
                    hap_pos[r] += 1
            if ref_ch != GAP:
                ref_pos += 1
            col += 1

        ref_allele = alleles[0]
        if not ref_allele:
            # bubble at the very start with a pure insertion and no anchor
            # base: cannot be VCF-represented without an anchor; skip.
            prev_match = None
            continue
        alt_map: dict[str, list[int]] = {}
        for r in range(1, n_rows):
            if alleles[r] != ref_allele:
                alt_map.setdefault(alleles[r], []).append(r)
        if not alt_map:
            prev_match = None
            continue

        pos1 = anchor_genome_pos1 + bubble_ref_pos
        norm_ref, norm_alt_map, pos1 = _normalize_parsimony(ref_allele, alt_map, pos1)
        left_shift = pos1 - (anchor_genome_pos1 + bubble_ref_pos)

        var = RawVariant(
            chrom_index=chrom_index,
            chrom_name=chrom_name,
            genome_pos1=pos1,
            local_ref_start0=bubble_ref_pos + left_shift,
            ref_allele=norm_ref,
        )
        for alt_seq, hap_rows in sorted(norm_alt_map.items()):
            alt = AltAllele(sequence=alt_seq)
            alt.vtype = classify_variant(norm_ref, alt_seq)
            alt.length = calculate_variant_length(norm_ref, alt_seq, alt.vtype)
            for r in hap_rows:
                alt.local_hap_starts[r] = bubble_hap_starts[r] + left_shift
            var.alts.append(alt)
        variants.append(var)
        prev_match = None

    variants.sort(key=lambda v: v.sort_key())
    return variants


def extract_component_variants(
    hap_seqs: list[str], chrom_index: int, chrom_name: str, anchor_genome_pos1: int
) -> list[RawVariant]:
    """hap_seqs[0] is the REF anchor; the rest are ALT haplotypes."""
    rows = build_pseudo_msa(hap_seqs[0], list(hap_seqs[1:]))
    return extract_variants(rows, chrom_index, chrom_name, anchor_genome_pos1)
