"""The generator: deterministic by seed, the same sizes on every seed, and
the BAMs carry the truth it plants."""

import filecmp
import json
import os

import numpy as np
import pytest

import bench_helpers as H
import simulate as S

with open(os.path.join(H.BENCH, "configs", "somatic_hcc1395.json")) as fh:
    SOMATIC = json.load(fh)
DEPTHS = {"normal": 40.0, "tumor": 60.0}


def make(tmp, seed, n=12):
    return S.make_job_inputs(str(tmp), SOMATIC, DEPTHS, n, seed, threads=2)


def test_same_seed_same_bytes_other_seed_other_bytes(tmp_path):
    a = make(tmp_path / "a", 2**31 + 5)
    b = make(tmp_path / "b", 2**31 + 5)
    c = make(tmp_path / "c", 17)
    for f in ("ref.fa", "normal.bam", "tumor.bam"):
        assert filecmp.cmp(tmp_path / "a" / f, tmp_path / "b" / f, shallow=False)
        assert not filecmp.cmp(tmp_path / "a" / f, tmp_path / "c" / f,
                               shallow=False)
    assert a["truth"] == b["truth"] != c["truth"]


def test_every_seed_gets_the_same_sizes(tmp_path):
    a, b = make(tmp_path / "a", 1), make(tmp_path / "b", 2)
    assert a["ref_len"] == b["ref_len"] == S.contig_length(12, 1000, 20)
    for origin in ("germline", "somatic"):
        assert (sum(v.origin == origin for v in a["truth"])
                == sum(v.origin == origin for v in b["truth"]) > 0)
    na = len(H.read_bam(a["bams"]["normal"]))
    nb = len(H.read_bam(b["bams"]["normal"]))
    assert abs(na - nb) <= 0.01 * na
    # the same sizes in another order: spacings, kinds, zygosities and
    # indel lengths as multisets, and the fragment lengths
    def sizes(fx):
        return (sorted((v.origin, v.zygosity, len(v.haps), len(v.ref),
                        len(v.alt)) for v in fx["truth"]))

    assert sizes(a) == sizes(b) and a["truth"] != b["truth"]
    ra = S.simulate_sample(np.frombuffer(b"ACGT" * 500, np.uint8), [
        (np.frombuffer(b"ACGT" * 500, np.uint8), np.arange(2000))], [1.0],
        10.0, SOMATIC["reads"], S.rng_for(1, 10))
    rb = S.simulate_sample(np.frombuffer(b"ACGT" * 500, np.uint8), [
        (np.frombuffer(b"ACGT" * 500, np.uint8), np.arange(2000))], [1.0],
        10.0, SOMATIC["reads"], S.rng_for(2, 10))
    assert sorted(ra.tlen.tolist()) == sorted(rb.tlen.tolist())
    err = SOMATIC["reads"]["error_base_quality"]
    assert (ra.qual == err).sum() == (rb.qual == err).sum() > 0


def test_contig_length_gives_the_cli_its_window_count():
    for n in (1, 3, 1249):
        L = S.contig_length(n, 1000, 20)
        assert 1 + (n - 1) * 800 + 1000 <= L < 1 + n * 800 + 1000


def test_planted_variants_are_spaced_and_match_the_reference(tmp_path):
    fx = make(tmp_path, 99, n=40)
    seq = "".join(open(fx["fasta"]).read().split("\n", 1)[1].split())
    pos = np.array([v.pos0 for v in fx["truth"]])
    assert (np.diff(pos) >= SOMATIC["germline"]["min_gap_bp"]).all()
    for v in fx["truth"]:
        assert seq[v.pos0:v.pos0 + len(v.ref)] == v.ref
        assert v.alt[0] == v.ref[0] or len(v.ref) == len(v.alt) == 1
    som = [v.pos0 for v in fx["truth"] if v.origin == "somatic"]
    assert [v.alt for v in fx["truth"] if v.origin == "somatic"]
    gaps = np.diff(som)
    assert gaps.min() >= 1700 and gaps.max() <= 2100


def test_reads_carry_the_planted_alleles(tmp_path):
    fx = make(tmp_path, 7, n=40)
    seq = "".join(open(fx["fasta"]).read().split("\n", 1)[1].split())
    snvs = [v for v in fx["truth"] if len(v.ref) == len(v.alt) == 1]
    for role in ("normal", "tumor"):
        recs = H.read_bam(fx["bams"][role])
        starts = np.array([r["pos0"] for r in recs])
        for v in snvs:
            cov = [b for r in recs[np.searchsorted(starts, v.pos0 - 160):
                                   np.searchsorted(starts, v.pos0 + 1)]
                   if (b := H.base_at(r, v.pos0)) is not None]
            frac = np.mean([b == v.alt for b in cov])
            want = {"hom": 1.0, "het": 0.5}.get(
                v.zygosity, 0.35 if role == "tumor" else 0.0)
            assert abs(frac - want) < 0.3, (role, v, frac, len(cov))
    # NM and MD agree with the reference for every read
    for r in H.read_bam(fx["bams"]["tumor"]):
        q, t, mm = 0, r["pos0"], 0
        for op, n in r["cigar"]:
            if op == 0:
                mm += sum(r["seq"][q + k] != seq[t + k] for k in range(n))
                q, t = q + n, t + n
            elif op == 1:
                q, mm = q + n, mm + n
            else:
                t, mm = t + n, mm + n
        assert mm == r["nm"]
        assert sum(c.isalpha() for c in r["md"].replace("^", "")) >= mm - sum(
            n for op, n in r["cigar"] if op == 1)


def test_bams_are_coordinate_sorted(tmp_path):
    fx = make(tmp_path, 3)
    pos = [r["pos0"] for r in H.read_bam(fx["bams"]["tumor"])]
    assert pos == sorted(pos)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40])
def test_large_seeds(seed):
    assert S.rng_for(seed, 1).integers(0, 4, 8).shape == (8,)


def test_reads_at_200x_match_the_truth_but_for_sequencing_errors(tmp_path):
    """At the depth of `traffic/deep.json` every read, decoded from the BAM
    by the standard library and walked along its CIGAR, differs from the
    reference only at planted variants and at the error rate, with no
    base of the contig wrong in more than a few reads; each planted SNV's
    alt share is its genotype's."""
    fx = S.make_job_inputs(str(tmp_path), SOMATIC, {"normal": 200.0,
                                                    "tumor": 200.0}, 6, 303,
                           threads=2)
    seq = "".join(open(fx["fasta"]).read().split("\n", 1)[1].split())
    near = set()
    for v in fx["truth"]:
        near.update(range(v.pos0, v.pos0 + max(len(v.ref), len(v.alt)) + 1))
    snvs = {v.pos0: v for v in fx["truth"] if len(v.ref) == len(v.alt) == 1}
    for role in ("normal", "tumor"):
        off = np.zeros(len(seq), np.int64)
        alt = {p: [0, 0] for p in snvs}
        recs = H.read_bam(fx["bams"][role])
        for r in recs:
            q, t, mm = 0, r["pos0"], 0
            for op, n in r["cigar"]:
                if op == 0:
                    for k in range(n):
                        b, p = r["seq"][q + k], t + k
                        if p in alt:
                            alt[p][0] += b == snvs[p].alt
                            alt[p][1] += 1
                        if b != seq[p]:
                            mm += 1
                            off[p] += p not in near
                    q, t = q + n, t + n
                elif op == 1:
                    q, mm = q + n, mm + n
                else:
                    t, mm = t + n, mm + n
            assert mm == r["nm"]
        assert 0.001 < off.sum() / (150 * len(recs)) < 0.003
        assert off.max() <= 8
        for p, (a, n) in alt.items():
            v = snvs[p]
            want = {"hom": 1.0, "het": 0.5}.get(
                v.zygosity, 0.35 if role == "tumor" else 0.0)
            assert n > 120 and abs(a / n - want) < 0.15, (role, v, a, n)
