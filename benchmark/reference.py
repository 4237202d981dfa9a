"""The plain reference that decides `correct`: NumPy and plain PyTorch on
the CPU. It imports nothing of the program and takes nothing the program
made except the VCF it judges.

Two layers are held:

- calls against the planted truth: each planted variant called at its
  allele (indels left-normalised on both sides), with the planted genotype
  in every sample: 0/a or a/a in each sample for germline, 0/0 in the
  normal and 0/a in the tumor for somatic; and what else was called: each
  allele that some sample's genotype carries, beyond one call per planted
  variant of that allele, is an extra call;
- the genotype likelihoods and what follows from them: each record's PL,
  GT, GQ, PRAD, PANG, QUAL and, for a case/control pair, its state (CASE,
  CTRL, SHARED by which samples hold alt reads) worked out again from the
  record's own allele depths (AD), read only to judge them,
  by the Dirichlet-multinomial model of upstream Lancet2
  (caller/genotype_likelihood.cpp: background error 0.005, overdispersion
  0.01, alpha floor 1e-6) in float64, the precision the caller states.
  `likelihood_mismatches(..., dtype=torch.float32)` is the control: the
  same arithmetic one precision lower.
"""

from __future__ import annotations

import gzip
import math
from collections import Counter

import numpy as np
import torch

DM_BACKGROUND_ERROR = 0.005
DM_OVERDISPERSION = 0.01
DM_ALPHA_FLOOR = 1e-6
MAX_GQ = 99
PL_CAP = float(np.iinfo(np.uint32).max) / 2.0


def read_vcf(path: str) -> tuple[list[str], list[dict]]:
    """(sample names, records) of a bgzip VCF; each record holds pos (1-based),
    ref, alts, qual (the text), info flags and per-sample FORMAT dicts."""
    samples, records = [], []
    with gzip.open(path, "rt") as fh:
        for line in fh:
            if line.startswith("##"):
                continue
            f = line.rstrip("\n").split("\t")
            if line.startswith("#"):
                samples = f[9:]
                continue
            keys = f[8].split(":")
            records.append({
                "pos": int(f[1]), "ref": f[3], "alts": f[4].split(","),
                "qual": f[5], "info": f[7].split(";"),
                "samples": {s: dict(zip(keys, col.split(":")))
                            for s, col in zip(samples, f[9:])},
            })
    return samples, records


def normalize(pos0: int, ref: str, alt: str, seq: str) -> tuple[int, str, str]:
    """Left-align and trim an allele against the contig (vt's algorithm)."""
    while True:
        if ref and alt and ref[-1] == alt[-1] and (len(ref) > 1 or len(alt) > 1):
            ref, alt = ref[:-1], alt[:-1]
            if (not ref or not alt) and pos0 > 0:
                pos0 -= 1
                ref, alt = seq[pos0] + ref, seq[pos0] + alt
            continue
        break
    while len(ref) > 1 and len(alt) > 1 and ref[0] == alt[0]:
        ref, alt, pos0 = ref[1:], alt[1:], pos0 + 1
    return pos0, ref, alt


def _gt(field: str) -> tuple[int, ...] | None:
    parts = field.replace("|", "/").split("/")
    if any(p == "." for p in parts):
        return None
    return tuple(sorted(int(p) for p in parts))


def against_truth(records: list[dict], truth: list, cfg: dict,
                  seq: str) -> dict:
    """Planted variants not called right, by origin, and extra calls.
    `truth` items carry pos0, ref, alt, origin, zygosity; `cfg["samples"]`
    names each sample and whether it carries the somatic variants.

    An extra call is a called allele (a non-reference genotype in some
    sample) with no planted variant of that normalised allele, or a second
    call of one: a planted variant takes at most one call."""
    called: dict = {}
    carried: Counter = Counter()
    for rec in records:
        for ai, alt in enumerate(rec["alts"], 1):
            key = normalize(rec["pos"] - 1, rec["ref"], alt, seq)
            called.setdefault(key, []).append((rec, ai))
            carried[key] += any(ai in (_gt(s.get("GT", "./.")) or ())
                                for s in rec["samples"].values())
    n = {"germline": 0, "somatic": 0}
    missed = {"germline": 0, "somatic": 0}
    planted: Counter = Counter()
    for v in truth:
        key = normalize(v.pos0, v.ref, v.alt, seq)
        planted[key] += 1
        n[v.origin] += 1
        missed[v.origin] += not any(_genotypes_right(rec, ai, v, cfg)
                                    for rec, ai in called.get(key, ()))
    extra = sum(max(c - planted[k], 0) for k, c in carried.items())
    total = sum(n.values())
    return {"planted": total, "missed": sum(missed.values()),
            "missed_share": sum(missed.values()) / max(total, 1),
            **{f"missed_{k}": missed[k] for k in missed},
            **{f"planted_{k}": n[k] for k in n},
            "extra": extra, "extra_share": extra / max(total, 1),
            "extra_sites": sorted(k for k, c in carried.items()
                                  if c > planted[k])}


def _genotypes_right(rec: dict, ai: int, v, cfg: dict) -> bool:
    for smp in cfg["samples"]:
        gt = _gt(rec["samples"][smp["name"]].get("GT", "./."))
        if gt is None:
            return False
        if v.origin == "somatic":
            want = (0, ai) if smp["carries_somatic"] else (0, 0)
        else:
            want = (ai, ai) if v.zygosity == "hom" else (0, ai)
        if gt != want:
            return False
    return True


def _alphas(k: int) -> np.ndarray:
    precision = (1.0 - DM_OVERDISPERSION) / DM_OVERDISPERSION
    rows = []
    for b in range(k):
        for a in range(b + 1):
            mu = np.full(k, DM_BACKGROUND_ERROR / k)
            main = 1.0 - DM_BACKGROUND_ERROR
            if a == b:
                mu[a] += main
            else:
                mu[a] += main / 2.0
                mu[b] += main / 2.0
            rows.append(np.maximum(DM_ALPHA_FLOOR, mu * precision))
    return np.array(rows)


def genotype_pls(counts: np.ndarray, dtype=torch.float64) -> np.ndarray:
    """[n, G] phred-scaled DM genotype likelihoods of [n, K] allele counts,
    best genotype 0, in `dtype` throughout."""
    c = torch.as_tensor(np.asarray(counts, np.float64), dtype=dtype)
    a = torch.as_tensor(_alphas(c.shape[1]), dtype=dtype)  # [G, K]
    ca = c[:, None, :] + a[None]  # [n, G, K]
    lp = (torch.lgamma(ca) - torch.lgamma(a)[None]).sum(-1)
    ll = lp + torch.lgamma(a.sum(-1))[None] - torch.lgamma(ca.sum(-1))
    best = ll.max(dim=1, keepdim=True).values
    raw = -10.0 * (ll - best) / torch.tensor(math.log(10.0), dtype=dtype)
    raw = torch.minimum(raw, torch.tensor(PL_CAP, dtype=dtype))
    return torch.round(raw).to(torch.float64).numpy().astype(np.int64)


def _pl_index_to_gt(idx: int) -> tuple[int, int]:
    klen, dk = 0, 1
    while klen < idx:
        dk += 1
        klen += dk
    b = dk - 1
    return idx - klen + b, b


def likelihood_mismatches(records: list[dict], cfg: dict,
                          dtype=torch.float64) -> dict:
    """PL, GT, GQ, PRAD, PANG, QUAL and the case/control state of every
    record against their recomputation from the record's AD in `dtype`;
    returns the values compared and how many differ."""
    names = [s["name"] for s in cfg["samples"]]
    case = [s["name"] for s in cfg["samples"] if s["carries_somatic"]]
    ctrl = [s["name"] for s in cfg["samples"] if not s["carries_somatic"]]
    case_ctrl = bool(case) and bool(ctrl)
    by_k: dict[int, list] = {}
    for ri, rec in enumerate(records):
        for s in names:
            ad = rec["samples"][s].get("AD", ".")
            if ad != ".":
                by_k.setdefault(len(rec["alts"]) + 1, []).append(
                    (ri, s, [int(x) for x in ad.split(",")]))
    pls: dict = {}
    for k, rows in by_k.items():
        got = genotype_pls(np.array([r[2] for r in rows]), dtype)
        for (ri, s, _), p in zip(rows, got):
            pls[(ri, s)] = p
    compared = differ = 0
    for ri, rec in enumerate(records):
        quals = [0.0]
        for s in names:
            fmt = rec["samples"][s]
            p = pls.get((ri, s))
            if p is None:
                continue
            a, b = _pl_index_to_gt(int(np.argmin(p)))
            srt = np.sort(p)
            gq = min(int(srt[1] - srt[0]), MAX_GQ) if p.size > 1 else 0
            want = {"PL": ",".join(str(int(x)) for x in p), "GT": f"{a}/{b}",
                    "GQ": str(gq), **_polar(rec, s, dtype)}
            for key, val in want.items():
                compared += 1
                differ += fmt.get(key) != val
            if not case_ctrl:
                quals.append(float(p[0]))
        if case_ctrl:
            quals += [_solor(rec, s, ctrl) for s in case]
            compared += 1
            differ += _state(rec, case, ctrl) not in rec["info"]
        compared += 1
        differ += rec["qual"] != f"{max(quals):.2f}"
    return {"compared": compared, "mismatches": differ}


def _polar(rec: dict, s: str, dtype) -> dict:
    """PRAD = log10(1 + hypot(AD_ref, AD_alt)) and PANG = atan2(AD_alt,
    AD_ref), as the VCF prints them (4 decimals), in `dtype`."""
    ad = [int(x) for x in rec["samples"][s]["AD"].split(",")]
    r = torch.tensor(float(ad[0]), dtype=dtype)
    a = torch.tensor(float(sum(ad[1:])), dtype=dtype)
    prad = torch.log10(1.0 + torch.hypot(r, a))
    pang = torch.atan2(a, r)
    return {"PRAD": f"{float(prad):.4f}", "PANG": f"{float(pang):.4f}"}


def _state(rec: dict, case: list[str], ctrl: list[str]) -> str:
    """NONE, CTRL, CASE or SHARED: which roles hold alt reads."""
    def has_alt(names):
        return any(sum(int(x) for x in rec["samples"][s]["AD"].split(",")[1:]) > 0
                   for s in names if rec["samples"][s].get("AD", ".") != ".")

    return ("NONE", "CTRL", "CASE", "SHARED")[
        (has_alt(case) << 1) | has_alt(ctrl)]


def _solor(rec: dict, case: str, ctrl: list[str]) -> float:
    """Somatic log-odds of a case sample against the mean of the controls
    (upstream caller/variant_call.cpp:289-345), from AD."""
    def ref_alt(s):
        ad = [int(x) for x in rec["samples"][s]["AD"].split(",")]
        return ad[0], sum(ad[1:])

    c_ref, c_alt = ref_alt(case)
    sr = sa = 0.0
    for s in ctrl:
        r, a = ref_alt(s)
        sr, sa = sr + r, sa + a
    n = max(len(ctrl), 1)
    return math.log(((c_alt + 1.0) * (sr / n + 1.0))
                    / ((c_ref + 1.0) * (sa / n + 1.0)))
