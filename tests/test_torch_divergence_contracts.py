"""tests/test_divergence_contracts.py's cases, held by the port on the CPU
against the JAX package on the same inputs, with the JAX tests' assertions
beside the comparison:

  * pseudo-MSA placement: the port's build_pseudo_msa and extract_variants
    give the JAX package's alignment rows and variant list (position, REF,
    each ALT with its type, length and per-haplotype local starts), and a
    shared repeat indel extracts as one variant from every carrying
    haplotype;
  * the mapability-gate sweep over min_score_frac: the port's
    Genotyper(backend="evidence", device="cpu") gives the JAX package's
    Genotyper(backend="evidence") per-read allele tables (every per-allele
    field, for every variant and sample), and garbage reads never
    contribute, clean assignments do not depend on the gate and a
    half-clipped read never flips its allele.

Torch is held to two intra-op threads.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lancet2_tpu.base.dna import encode as jax_encode
from lancet2_tpu.caller.extractor import build_pseudo_msa as jax_msa
from lancet2_tpu.caller.extractor import extract_variants as jax_extract
from lancet2_tpu.caller.genotyper import Genotyper as JaxGenotyper
from lancet2_tpu.cbdg.read import Read as JaxRead
from lancet2_tpu_torch.base.dna import encode
from lancet2_tpu_torch.base.hashing import hash_str64
from lancet2_tpu_torch.caller.extractor import build_pseudo_msa, extract_variants
from lancet2_tpu_torch.caller.genotyper import Genotyper
from lancet2_tpu_torch.cbdg.read import Read
from lancet2_tpu_torch.utils.simulate import random_reference


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _variants_view(variants) -> list:
    return [(v.chrom_index, v.chrom_name, v.genome_pos1, v.local_ref_start0,
             v.ref_allele,
             [(a.sequence, a.vtype, a.length, sorted(a.local_hap_starts.items()))
              for a in v.alts])
            for v in variants]


def _extract(ref_hap, haps, chrom, pos1):
    """The port's variants for `haps` against `ref_hap`, after holding its
    MSA rows and variant list equal to the JAX package's."""
    msa = build_pseudo_msa(ref_hap, haps)
    assert msa == jax_msa(ref_hap, haps)
    variants = extract_variants(msa, 0, chrom, pos1)
    assert _variants_view(variants) == _variants_view(
        jax_extract(msa, 0, chrom, pos1))
    return variants


def _flanks(seed_l, seed_r, n, unit):
    left = random_reference(n, seed=seed_l)
    right = random_reference(n, seed=seed_r)
    if left[-1] == unit[0]:  # keep the repeat boundary unambiguous
        left = left[:-1] + ("G" if unit[0] != "G" else "C")
    if right[0] == unit[-1]:
        right = ("G" if unit[-1] != "G" else "C") + right[1:]
    return left, right


class TestRepeatAdjacentMsaPlacement:
    @pytest.mark.parametrize("unit,copies", [("T", 8), ("AC", 5), ("CAG", 4)])
    def test_shared_deletion_extracts_once_across_haplotypes(self, unit,
                                                             copies):
        left, right = _flanks(31, 32, 80, unit)
        ref_hap = left + unit * copies + right
        del_hap = left + unit * (copies - 1) + right
        snv_pos = 20
        snv_base = "A" if left[snv_pos] != "A" else "G"
        del_snv_hap = (left[:snv_pos] + snv_base + left[snv_pos + 1:]
                       + unit * (copies - 1) + right)
        variants = _extract(ref_hap, [del_hap, del_snv_hap], "chrT", 5001)
        dels = [v for v in variants
                if any(len(a.sequence) < len(v.ref_allele) for a in v.alts)]
        assert len(dels) == 1, f"{unit}x{copies}: {len(dels)} deletions"
        d = dels[0]
        assert len(d.alts) == 1, "both haplotypes must group into one ALT"
        assert set(d.alts[0].local_hap_starts) == {1, 2}
        assert len(d.ref_allele) - len(d.alts[0].sequence) == len(unit)
        snvs = [v for v in variants
                if all(len(a.sequence) == len(v.ref_allele) == 1
                       for a in v.alts)]
        assert len(snvs) == 1
        assert set(snvs[0].alts[0].local_hap_starts) == {2}

    @pytest.mark.parametrize("unit,copies", [("T", 6), ("AC", 4)])
    def test_shared_insertion_placement_consistent(self, unit, copies):
        left, right = _flanks(41, 42, 70, unit)
        ref_hap = left + unit * copies + right
        ins_hap = left + unit * (copies + 1) + right
        snv_pos = 15
        snv_base = "T" if left[snv_pos] != "T" else "A"
        ins_snv_hap = (left[:snv_pos] + snv_base + left[snv_pos + 1:]
                       + unit * (copies + 1) + right)
        variants = _extract(ref_hap, [ins_hap, ins_snv_hap], "chrT", 9001)
        inss = [v for v in variants
                if any(len(a.sequence) > len(v.ref_allele) for a in v.alts)]
        assert len(inss) == 1, f"{unit}x{copies}: {len(inss)} insertions"
        ins = inss[0]
        assert len(ins.alts) == 1
        assert set(ins.alts[0].local_hap_starts) == {1, 2}
        assert len(ins.alts[0].sequence) - len(ins.ref_allele) == len(unit)

    def test_equivalent_gap_positions_normalize_identically(self):
        left = random_reference(60, seed=51)
        right = random_reference(60, seed=52)
        if left[-1] == "A":
            left = left[:-1] + "G"
        if right[0] == "A":
            right = "C" + right[1:]
        ref_hap = left + "A" * 9 + right
        hap = left + "A" * 7 + right  # 2 bp deletion in the homopolymer
        v1 = _extract(ref_hap, [hap], "c", 100)
        v2 = _extract(ref_hap, [hap, hap], "c", 100)
        assert len(v1) == 1 and len(v2) == 1
        assert (v1[0].genome_pos1, v1[0].ref_allele,
                [a.sequence for a in v1[0].alts]) == (
            v2[0].genome_pos1, v2[0].ref_allele,
            [a.sequence for a in v2[0].alts])


# ---------------------------------------------------------------------------
# the mapability gate
# ---------------------------------------------------------------------------

def _reads(spec) -> tuple[list, list]:
    """The same reads for both packages from (name, seq, start0) triples:
    (the port's, the JAX package's)."""
    def make(cls, enc, name, seq, start0):
        return cls(
            qname=name, seq=seq, qual=np.full(len(seq), 35, dtype=np.uint8),
            sample_name="TUMOR", sample_index=0, tag=4, chrom_index=0,
            start0=start0, mapq=60, sam_flag=0, insert_size=150,
            is_soft_clipped=False, passes_aln_filters=True, codes=enc(seq),
            qname_hash=hash_str64(name))
    return ([make(Read, encode, *s) for s in spec],
            [make(JaxRead, jax_encode, *s) for s in spec])


def _support_view(geno) -> dict:
    """{variant: {sample: [every per-allele field, allele by allele]}}."""
    slots = ("name_hashes", "fwd_base_quals", "rev_base_quals", "map_quals",
             "aln_scores", "soft_clip_count", "proper_pair_isizes",
             "folded_read_positions", "ref_nm_values", "alignment_starts",
             "own_hap_nm_values", "haplotype_ids")
    return {vi: {sample: [{s: getattr(d, s) for s in slots}
                          for d in sup.allele_data]
                 for sample, sup in supports.items()}
            for vi, supports in geno.items()}


@pytest.fixture(scope="module")
def snv_component():
    """REF anchor + one ALT haplotype with a SNV at offset 150, and the
    memo of _genotype."""
    ref_hap = random_reference(300, seed=21)
    alt_base = "A" if ref_hap[150] != "A" else "C"
    alt_hap = ref_hap[:150] + alt_base + ref_hap[151:]
    variants = _extract(ref_hap, [alt_hap], "chrT", 1001)
    assert len(variants) == 1
    jax_variants = jax_extract(jax_msa(ref_hap, [alt_hap]), 0, "chrT", 1001)
    return ref_hap, alt_hap, variants, jax_variants, {}


class TestMapabilityGateSweep:
    GATES = (0.15, 0.25, 0.40)

    def _genotype(self, fixture, spec, gate):
        """The port's genotype of the reads in `spec` at `gate`, held equal
        to the JAX package's (each (reads, gate) computed once)."""
        ref_hap, alt_hap, variants, jax_variants, memo = fixture
        key = (tuple(spec), gate)
        if key not in memo:
            reads, jax_reads = _reads(spec)
            got = Genotyper(backend="evidence", min_score_frac=gate,
                            device="cpu").genotype([ref_hap, alt_hap], reads,
                                                   variants)
            want = JaxGenotyper(backend="evidence", min_score_frac=gate
                                ).genotype([ref_hap, alt_hap], jax_reads,
                                           jax_variants)
            assert _support_view(got) == _support_view(want), (
                f"the port's evidence differs from the JAX package's at "
                f"gate {gate}")
            memo[key] = got
        return memo[key]

    def _clean_reads(self, fixture):
        ref_hap, alt_hap = fixture[:2]
        spec = []
        for i, off in enumerate((60, 100, 130, 149)):
            spec.append((f"ref{i}", ref_hap[off:off + 101], off))
            spec.append((f"alt{i}", alt_hap[off:off + 101], off))
        return spec

    def test_garbage_reads_never_contribute(self, snv_component):
        clean = self._clean_reads(snv_component)
        garbage = [(f"junk{i}", random_reference(101, seed=500 + i), 100)
                   for i in range(4)]
        for gate in self.GATES:
            with_junk = self._genotype(snv_component, clean + garbage, gate)
            without = self._genotype(snv_component, clean, gate)
            assert set(with_junk) == set(without)
            for vi in without:
                for sample in without[vi]:
                    a = without[vi][sample]
                    b = with_junk[vi][sample]
                    assert [d.name_hashes for d in a.allele_data] == [
                        d.name_hashes for d in b.allele_data
                    ], f"garbage read leaked evidence at gate {gate}"

    def test_clean_assignments_invariant_to_gate(self, snv_component):
        clean = self._clean_reads(snv_component)
        tables = []
        for gate in self.GATES:
            geno = self._genotype(snv_component, clean, gate)
            table = {}
            for vi, supports in geno.items():
                for sample, sup in supports.items():
                    for allele, d in enumerate(sup.allele_data):
                        for h in d.name_hashes:
                            table[h] = allele
            tables.append(table)
        assert tables[0], "clean reads must produce evidence"
        assert tables[0] == tables[1] == tables[2]
        for i in range(4):
            assert tables[0][hash_str64(f"ref{i}") & 0xFFFFFFFF] == 0
            assert tables[0][hash_str64(f"alt{i}") & 0xFFFFFFFF] == 1

    def test_half_clipped_read_never_flips_allele(self, snv_component):
        alt_hap = snv_component[1]
        true_half = alt_hap[100:151]  # 51 bp ending at the SNV
        clipped = ("clip0", true_half + random_reference(50, seed=901), 100)
        clean = self._clean_reads(snv_component)
        h_clip = hash_str64("clip0") & 0xFFFFFFFF
        seen = {}
        for gate in self.GATES:
            geno = self._genotype(snv_component, clean + [clipped], gate)
            for vi, supports in geno.items():
                for sample, sup in supports.items():
                    for allele, d in enumerate(sup.allele_data):
                        if h_clip in d.name_hashes:
                            seen[gate] = allele
        assert set(seen.values()) <= {1}, (
            f"clipped ALT read mis-assigned across gates: {seen}")
