"""The plain reference and its control: float64 recomputation matches the
DM formula written out term by term; the float32 control departs from it;
truth matching normalises indels."""

import json
import math
import os

import numpy as np
import torch

import bench_helpers as H
import reference as ref

with open(os.path.join(H.BENCH, "configs", "somatic_hcc1395.json")) as fh:
    SOMATIC = json.load(fh)
# one sample called as germline, as a `-n`-only run is
GERMLINE = {**SOMATIC, "samples": [{**SOMATIC["samples"][0],
                                    "name": "NA12878"}]}
GERMLINE.pop("somatic")


def loop_pls(counts):
    """The DM genotype likelihoods written out with math.lgamma."""
    k = len(counts)
    out = []
    for b in range(k):
        for a in range(b + 1):
            mu = [0.005 / k] * k
            if a == b:
                mu[a] += 0.995
            else:
                mu[a] += 0.995 / 2
                mu[b] += 0.995 / 2
            al = [max(1e-6, m * 99.0) for m in mu]
            lp = sum(math.lgamma(c + x) - math.lgamma(x)
                     for c, x in zip(counts, al))
            out.append(lp + math.lgamma(sum(al))
                       - math.lgamma(sum(c + x for c, x in zip(counts, al))))
    best = max(out)
    return [round(-10.0 * (v - best) / math.log(10.0)) for v in out]


def test_float64_pls_match_the_formula_term_by_term():
    rng = np.random.default_rng(0)
    for k in (2, 3):
        counts = rng.integers(0, 400, (300, k))
        got = ref.genotype_pls(counts)
        for c, g in zip(counts.tolist(), got.tolist()):
            assert g == loop_pls(c)


def synthetic_records(cfg, depth, n, seed):
    """Records as the caller prints them, every field from float64."""
    rng = np.random.default_rng(seed)
    names = [s["name"] for s in cfg["samples"]]
    recs = []
    for _ in range(n):
        rec = {"pos": 1000, "ref": "A", "alts": ["C"], "info": [],
               "samples": {}}
        for s in names:
            d = int(rng.poisson(depth))
            alt = int(rng.binomial(d, rng.choice([0.0, 0.03, 0.35, 0.5, 1.0])))
            rec["samples"][s] = {"AD": f"{d - alt},{alt}"}
        recs.append(rec)
    # fill PL, GT, GQ, PRAD, PANG, QUAL and the state from float64
    for rec in recs:
        for s in names:
            ad = [int(x) for x in rec["samples"][s]["AD"].split(",")]
            p = ref.genotype_pls(np.array([ad]))[0]
            a, b = ref._pl_index_to_gt(int(np.argmin(p)))
            srt = np.sort(p)
            rec["samples"][s].update(
                PL=",".join(map(str, p)), GT=f"{a}/{b}",
                GQ=str(min(int(srt[1] - srt[0]), 99)),
                **ref._polar(rec, s, torch.float64))
    case = [s["name"] for s in cfg["samples"] if s["carries_somatic"]]
    ctrl = [s["name"] for s in cfg["samples"] if not s["carries_somatic"]]
    for rec in recs:
        if case and ctrl:
            q = max([0.0] + [ref._solor(rec, s, ctrl) for s in case])
            rec["info"] = [ref._state(rec, case, ctrl)]
        else:
            q = max(float(rec["samples"][s]["PL"].split(",")[0])
                    for s in names)
        rec["qual"] = f"{q:.2f}"
    return recs


def test_control_in_float32_fails_where_float64_passes():
    recs = synthetic_records(SOMATIC, 60, 10000, 1)
    assert ref.likelihood_mismatches(recs, SOMATIC)["mismatches"] == 0
    ctrl = ref.likelihood_mismatches(recs, SOMATIC, torch.float32)
    assert ctrl["mismatches"] > 0
    assert ctrl["compared"] == 10000 * (2 * 5 + 2)


def test_an_altered_answer_is_a_mismatch():
    recs = synthetic_records(GERMLINE, 30, 50, 2)
    s = GERMLINE["samples"][0]["name"]
    pl = recs[7]["samples"][s]["PL"].split(",")
    pl[1] = str(int(pl[1]) + 1)
    recs[7]["samples"][s]["PL"] = ",".join(pl)
    assert ref.likelihood_mismatches(recs, GERMLINE)["mismatches"] == 1


def test_normalize_left_aligns_and_trims():
    seq = "GATTACACACAG"
    # deleting the last CA of ACACACA left-aligns to deleting its first
    # AC, anchored on the T before the run
    assert ref.normalize(8, "ACA", "A", seq) == (3, "TAC", "T")
    assert ref.normalize(8, "A", "ACA", seq) == (3, "T", "TAC")
    assert ref.normalize(1, "ATT", "AGT", seq) == (2, "T", "G")


def test_truth_misses_count_genotype_and_allele():
    from simulate import Planted

    seq = "ACGTACGTACGTACGTACGT"
    truth = [Planted(2, "G", "T", "germline", "het", (0,)),
             Planted(6, "G", "C", "somatic", "somatic", ()),
             Planted(10, "G", "A", "germline", "hom", (0, 1))]
    rec = lambda pos, alt, gts: {"pos": pos + 1, "ref": "G", "alts": [alt],
                                 "samples": {"HCC1395BL": {"GT": gts[0]},
                                             "HCC1395": {"GT": gts[1]}}}
    recs = [rec(2, "T", ("0/1", "0/1")), rec(6, "C", ("0/0", "0/1")),
            rec(10, "A", ("0/1", "1/1"))]
    m = ref.against_truth(recs, truth, SOMATIC, seq)
    assert (m["missed"], m["missed_germline"], m["missed_somatic"]) == (1, 1, 0)
    assert m["extra"] == 0


def test_extra_calls_are_carried_alleles_beyond_the_planted():
    from simulate import Planted

    seq = "ACGTACGTACGTACGTACGT"
    truth = [Planted(2, "G", "T", "germline", "het", (0,)),
             Planted(6, "G", "C", "somatic", "somatic", ())]
    rec = lambda pos, alt, gts: {"pos": pos + 1, "ref": seq[pos],
                                 "alts": [alt],
                                 "samples": {"HCC1395BL": {"GT": gts[0]},
                                             "HCC1395": {"GT": gts[1]}}}
    sound = [rec(2, "T", ("0/1", "0/1")), rec(6, "C", ("0/0", "0/1")),
             # an allele no genotype carries is no call
             rec(12, "A", ("0/0", "0/0"))]
    m = ref.against_truth(sound, truth, SOMATIC, seq)
    assert (m["missed"], m["extra"]) == (0, 0)
    # a call where nothing was planted, and a planted variant called twice
    m = ref.against_truth(sound + [rec(9, "T", ("0/0", "0/1")), sound[0]],
                          truth, SOMATIC, seq)
    assert (m["missed"], m["extra"], m["extra_share"]) == (0, 2, 1.0)
    assert m["extra_sites"] == [(2, "G", "T"), (9, "C", "T")]
    # every record moved a base: all missed, all extra
    m = ref.against_truth([{**r, "pos": r["pos"] + 1} for r in sound[:2]],
                          truth, SOMATIC, seq)
    assert (m["missed"], m["extra"]) == (2, 2)
