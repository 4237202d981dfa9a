"""Synthetic tumor/normal read simulator for end-to-end tests and benches.

The reference validates against multi-GB GCS fixtures (HCC1395 chr4 BAMs);
this environment has no network, so the framework carries its own seeded
simulator: plant SNV/INS/DEL variants on a random reference, sample paired
reads from ref/alt haplotypes with Phred-calibrated errors, and emit
coordinate-sorted BAMs (with MD tags) + an indexed FASTA.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lancet2_tpu_torch.hts.bam import (
    BamRecord,
    BamWriter,
    FLAG_PAIRED,
    FLAG_PROPER_PAIR,
    FLAG_REVERSE,
    FLAG_MATE_REVERSE,
    FLAG_READ1,
    FLAG_READ2,
)
from lancet2_tpu_torch.hts.cigar import Cigar, M, I, D
from lancet2_tpu_torch.hts.fasta import write_fasta

_BASES = "ACGT"


@dataclass(frozen=True)
class Variant:
    """Planted truth variant. pos0 is 0-based on the reference contig.

    SNV: ref/alt are single bases.  INS: ref is the anchor base, alt is
    anchor+inserted.  DEL: ref is anchor+deleted, alt is the anchor base.
    (Standard VCF left-anchored convention.)
    """

    pos0: int
    ref: str
    alt: str
    vaf: float = 0.5

    @property
    def kind(self) -> str:
        if len(self.ref) == 1 and len(self.alt) == 1:
            return "SNV"
        return "INS" if len(self.alt) > len(self.ref) else "DEL"


def random_reference(length: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    return "".join(_BASES[i] for i in rng.integers(0, 4, size=length))


def structured_reference(length: int, features: list[tuple] | None = None,
                         seed: int = 0) -> str:
    """Random reference with low-complexity tracts planted at fixed positions.

    features: list of (pos0, kind, *args) where kind is one of
      ("homopolymer", base, run_len)     e.g. (2000, "homopolymer", "A", 14)
      ("str", unit, copies)              e.g. (4000, "str", "CAG", 12)
      ("vntr", unit_len, copies)         random unit of unit_len, repeated

    The tract overwrites the random sequence in place (length unchanged),
    mirroring the GIAB LowComplexity stratification regions the reference
    calibrates longdust against (tests/data/base/longdust_calibration_*.tsv).
    """
    seq = list(random_reference(length, seed=seed))
    rng = np.random.default_rng(seed + 7919)
    for feat in features or []:
        pos, kind = feat[0], feat[1]
        if kind == "homopolymer":
            base, run = feat[2], feat[3]
            tract = base * run
        elif kind == "str":
            unit, copies = feat[2], feat[3]
            tract = unit * copies
        elif kind == "vntr":
            unit_len, copies = feat[2], feat[3]
            unit = "".join(_BASES[i] for i in rng.integers(0, 4, size=unit_len))
            tract = unit * copies
        else:
            raise ValueError(f"unknown feature kind {kind!r}")
        end = min(pos + len(tract), length)
        seq[pos:end] = tract[: end - pos]
    return "".join(seq)


def _md_tag(read_seq: str, ref_slice: str, cigar: Cigar) -> str:
    """Build an MD aux tag for an alignment (matches/mismatches/deletions)."""
    md = []
    run = 0
    qpos = 0
    tpos = 0
    for op, length in cigar:
        if op == M:
            for _ in range(length):
                if qpos < len(read_seq) and tpos < len(ref_slice) and read_seq[qpos] == ref_slice[tpos]:
                    run += 1
                else:
                    md.append(str(run))
                    md.append(ref_slice[tpos] if tpos < len(ref_slice) else "N")
                    run = 0
                qpos += 1
                tpos += 1
        elif op == I:
            qpos += length
        elif op == D:
            md.append(str(run))
            run = 0
            md.append("^" + ref_slice[tpos : tpos + length])
            tpos += length
    md.append(str(run))
    return "".join(md)


def _apply_variant(hap: str, var: Variant, offset_map: list[int]) -> tuple[str, list[int]]:
    """Apply one variant to a haplotype string carrying a per-base ref-pos map."""
    p = var.pos0
    # find index in offset_map of ref position p
    try:
        idx = offset_map.index(p)
    except ValueError:
        return hap, offset_map
    new_hap = hap[: idx] + var.alt + hap[idx + len(var.ref) :]
    # positions of alt bases: anchor keeps p; inserted bases get -1 (no ref pos)
    alt_positions = [p] + [-1] * (len(var.alt) - 1)
    new_map = offset_map[:idx] + alt_positions + offset_map[idx + len(var.ref) :]
    return new_hap, new_map


class ReadSimulator:
    def __init__(
        self,
        ref_seq: str,
        chrom: str = "chrS",
        read_len: int = 125,
        frag_mean: float = 320.0,
        frag_sd: float = 40.0,
        error_rate: float = 0.002,
        base_qual: int = 35,
        seed: int = 7,
    ):
        self.ref_seq = ref_seq
        self.chrom = chrom
        self.read_len = read_len
        self.frag_mean = frag_mean
        self.frag_sd = frag_sd
        self.error_rate = error_rate
        self.base_qual = base_qual
        self.rng = np.random.default_rng(seed)

    def _haplotypes(self, variants: list[Variant]) -> list[tuple[str, list[int], list[Variant]]]:
        """Return (hap_seq, per-base ref-pos map, carried variants) for ref + alt."""
        ref_map = list(range(len(self.ref_seq)))
        haps = [(self.ref_seq, ref_map, [])]
        if variants:
            hap, hmap = self.ref_seq, ref_map
            for var in sorted(variants, key=lambda v: -v.pos0):
                hap, hmap = _apply_variant(hap, var, hmap)
            haps.append((hap, hmap, list(variants)))
        return haps

    def _local_haplotype(self, lo: int, hi: int, carried: list[Variant]):
        """Apply `carried` variants to the reference slice [lo, hi);
        returns (hap_seq, per-base GLOBAL ref-pos map)."""
        hap = self.ref_seq[lo:hi]
        hmap = list(range(lo, hi))
        for var in sorted(carried, key=lambda v: -v.pos0):
            hap, hmap = _apply_variant(hap, var, hmap)
        return hap, hmap

    def _read_record(
        self, qname: str, hap: str, hmap: list[int], hstart: int, rev: bool, flags: int,
        mate_pos0: int, tlen: int, ref_id: int,
    ) -> BamRecord | None:
        L = self.read_len
        sub = hap[hstart : hstart + L]
        if len(sub) < L:
            return None
        sub_map = hmap[hstart : hstart + L]
        # alignment start = first base with a real ref position
        ref_positions = [p for p in sub_map if p >= 0]
        if not ref_positions:
            return None
        pos0 = ref_positions[0]

        # Build CIGAR from the ref-pos map: -1 runs are insertions; jumps are deletions.
        cigar: Cigar = []
        ref_cursor = pos0
        for p in sub_map:
            if p < 0:
                if cigar and cigar[-1][0] == I:
                    cigar[-1] = (I, cigar[-1][1] + 1)
                else:
                    cigar.append((I, 1))
            else:
                if p > ref_cursor:
                    cigar.append((D, p - ref_cursor))
                if cigar and cigar[-1][0] == M:
                    cigar[-1] = (M, cigar[-1][1] + 1)
                else:
                    cigar.append((M, 1))
                ref_cursor = p + 1
        # leading insertions have no anchor: convert to soft-clip-free by dropping
        while cigar and cigar[0][0] in (I, D):
            if cigar[0][0] == D:
                cigar.pop(0)
            else:
                # treat leading insertion bases as mismatch-free M at pos0-? — rare; drop read
                return None

        # sequencing errors
        seq = np.frombuffer(sub.encode(), dtype=np.uint8).copy()
        errs = self.rng.random(L) < self.error_rate
        if errs.any():
            for i in np.nonzero(errs)[0]:
                orig = chr(seq[i])
                choices = [b for b in _BASES if b != orig]
                seq[i] = ord(choices[self.rng.integers(0, 3)])
        read_seq = seq.tobytes().decode()
        qual = np.full(L, self.base_qual, dtype=np.uint8)
        qual[errs] = np.minimum(qual[errs], 11)  # low-qual errors: below the BQ>=20 activity gate, and the expected-error kmer filter absorbs them

        ref_end = ref_cursor
        ref_slice = self.ref_seq[pos0:ref_end]
        md = _md_tag(read_seq, ref_slice, cigar)
        flag = flags | (FLAG_REVERSE if rev else 0)
        return BamRecord(
            qname=qname, flag=flag, ref_id=ref_id, pos0=pos0, mapq=60, cigar=cigar,
            next_ref_id=ref_id, next_pos0=mate_pos0, tlen=tlen, seq=read_seq, qual=qual,
            tags={"MD": md, "NM": 0},
        )

    def simulate(
        self, variants: list[Variant], coverage: float, writer: BamWriter, qname_prefix: str = "rd",
    ) -> int:
        """Sample paired reads to the target mean coverage; returns #reads written.

        Each fragment decides carriage per overlapping variant independently
        with probability `var.vaf` (so low-VAF somatic and per-variant VAFs
        coexist), then reads are sampled from a fragment-local haplotype —
        scales to chromosome-length references without building genome-wide
        alt haplotypes.
        """
        import bisect

        svars = sorted(variants, key=lambda v: v.pos0)
        vpos = [v.pos0 for v in svars]
        n_frags = int(coverage * len(self.ref_seq) / (2 * self.read_len))
        ref_id = 0
        written = 0
        pad = 80  # local slack for deletions shrinking the haplotype
        for i in range(n_frags):
            frag_len = max(int(self.rng.normal(self.frag_mean, self.frag_sd)), 2 * self.read_len + 10)
            start = int(self.rng.integers(0, max(len(self.ref_seq) - frag_len, 1)))
            # variants whose span intersects the fragment's local slice
            lo_i = bisect.bisect_left(vpos, start - pad)
            hi_i = bisect.bisect_right(vpos, start + frag_len + pad)
            carried = [v for v in svars[lo_i:hi_i] if self.rng.random() < v.vaf]
            if carried:
                s_lo = max(start - pad // 2, 0)
                s_hi = min(start + frag_len + pad, len(self.ref_seq))
                carried = [v for v in carried
                           if v.pos0 >= s_lo and v.pos0 + len(v.ref) <= s_hi]
                hap, hmap = self._local_haplotype(s_lo, s_hi, carried)
                h_start = start - s_lo
            else:
                hap, hmap, h_start = self.ref_seq, None, start
            r1_start = h_start
            r2_start = h_start + frag_len - self.read_len
            if r2_start + self.read_len > len(hap):
                r2_start = len(hap) - self.read_len
            qname = f"{qname_prefix}{i}"
            flags1 = FLAG_PAIRED | FLAG_PROPER_PAIR | FLAG_READ1 | FLAG_MATE_REVERSE
            flags2 = FLAG_PAIRED | FLAG_PROPER_PAIR | FLAG_READ2
            if hmap is None:
                rec1 = self._ref_read_record(qname, r1_start, False, flags1, 0, frag_len, ref_id)
                rec2 = self._ref_read_record(qname, r2_start, True, flags2, 0, -frag_len, ref_id)
            else:
                rec1 = self._read_record(qname, hap, hmap, r1_start, False, flags1, 0, frag_len, ref_id)
                rec2 = self._read_record(qname, hap, hmap, r2_start, True, flags2, 0, -frag_len, ref_id)
            if rec1 is None or rec2 is None:
                continue
            rec1.next_pos0 = rec2.pos0
            rec2.next_pos0 = rec1.pos0
            writer.add(rec1)
            writer.add(rec2)
            written += 2
        return written

    def _ref_read_record(
        self, qname: str, hstart: int, rev: bool, flags: int,
        mate_pos0: int, tlen: int, ref_id: int,
    ) -> BamRecord | None:
        """Fast path for reads with no variants: pure-match CIGAR, no map walk."""
        L = self.read_len
        sub = self.ref_seq[hstart : hstart + L]
        if len(sub) < L:
            return None
        seq = np.frombuffer(sub.encode(), dtype=np.uint8).copy()
        errs = self.rng.random(L) < self.error_rate
        if errs.any():
            for i in np.nonzero(errs)[0]:
                orig = chr(seq[i])
                choices = [b for b in _BASES if b != orig]
                seq[i] = ord(choices[self.rng.integers(0, 3)])
        read_seq = seq.tobytes().decode()
        qual = np.full(L, self.base_qual, dtype=np.uint8)
        qual[errs] = np.minimum(qual[errs], 11)
        cigar: Cigar = [(M, L)]
        md = _md_tag(read_seq, sub, cigar)
        flag = flags | (FLAG_REVERSE if rev else 0)
        return BamRecord(
            qname=qname, flag=flag, ref_id=ref_id, pos0=hstart, mapq=60, cigar=cigar,
            next_ref_id=ref_id, next_pos0=mate_pos0, tlen=tlen, seq=read_seq, qual=qual,
            tags={"MD": md, "NM": 0},
        )


def make_tumor_normal_fixture(
    tmpdir: str,
    ref_len: int = 6000,
    somatic: list[Variant] | None = None,
    germline: list[Variant] | None = None,
    normal_cov: float = 40.0,
    tumor_cov: float = 60.0,
    seed: int = 11,
    read_len: int = 125,
    frag_mean: float = 320.0,
    frag_sd: float = 40.0,
) -> dict:
    """Write ref.fa + normal.bam + tumor.bam with planted variants."""
    import os

    ref_seq = random_reference(ref_len, seed=seed)
    chrom = "chrS"
    fasta_path = os.path.join(tmpdir, "ref.fa")
    write_fasta(fasta_path, {chrom: ref_seq})

    germline = germline or []
    somatic = somatic or []

    refs = [(chrom, ref_len)]
    normal_path = os.path.join(tmpdir, "normal.bam")
    wn = BamWriter(normal_path, refs, sample_name="NORMAL")
    sim_n = ReadSimulator(ref_seq, chrom, read_len=read_len,
                          frag_mean=frag_mean, frag_sd=frag_sd, seed=seed + 1)
    sim_n.simulate(germline, normal_cov, wn, qname_prefix="n")
    wn.close()

    tumor_path = os.path.join(tmpdir, "tumor.bam")
    wt = BamWriter(tumor_path, refs, sample_name="TUMOR")
    sim_t = ReadSimulator(ref_seq, chrom, read_len=read_len,
                          frag_mean=frag_mean, frag_sd=frag_sd, seed=seed + 2)
    sim_t.simulate(germline + somatic, tumor_cov, wt, qname_prefix="t")
    wt.close()

    return {
        "fasta": fasta_path,
        "normal": normal_path,
        "tumor": tumor_path,
        "chrom": chrom,
        "ref_seq": ref_seq,
        "somatic": somatic,
        "germline": germline,
    }


def make_chr_scale_fixture(ref_kb: int, cache_dir: str, seed: int = 11,
                           normal_cov: float = 40.0, tumor_cov: float = 60.0) -> dict:
    """Chr-scale cached tumor/normal fixture: somatic SNV/INS/DEL planted
    round-robin every ~1.7 kb so most 1 kb windows are active. Shared by
    scripts/profile_e2e.py and the driver-facing bench.py; cached on disk
    keyed by content so repeat runs cost nothing."""
    import hashlib
    import json
    import os

    import numpy as np

    key = f"e2e_r{ref_kb}kb_s{seed}_n{normal_cov}_t{tumor_cov}_v3"
    fixdir = os.path.join(cache_dir, hashlib.sha1(key.encode()).hexdigest()[:16])
    meta_path = os.path.join(fixdir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)

    os.makedirs(fixdir, exist_ok=True)
    ref_len = ref_kb * 1000
    rng = np.random.default_rng(seed)
    somatic = []
    kinds = ["SNV", "INS", "DEL"]
    pos = 900
    i = 0
    while pos < ref_len - 1200:
        kind = kinds[i % 3]
        if kind == "SNV":
            somatic.append(Variant(pos, "A", "G", vaf=0.35))
        elif kind == "INS":
            ins = "".join("ACGT"[j] for j in rng.integers(0, 4, size=4))
            somatic.append(Variant(pos, "A", "A" + ins, vaf=0.35))
        else:
            somatic.append(Variant(pos, "ACGTA"[: 1 + int(rng.integers(2, 5))], "A", vaf=0.35))
        pos += 1700 + int(rng.integers(0, 400))
        i += 1
    # planted alleles must match the actual reference bases: rewrite the
    # variant list against the reference make_tumor_normal_fixture builds
    ref_seq = random_reference(ref_len, seed=seed)
    fixed = []
    for v in somatic:
        if v.kind == "SNV":
            ref_b = ref_seq[v.pos0]
            alt_b = "G" if ref_b != "G" else "T"
            fixed.append(Variant(v.pos0, ref_b, alt_b, vaf=v.vaf))
        elif v.kind == "INS":
            anchor = ref_seq[v.pos0]
            fixed.append(Variant(v.pos0, anchor, anchor + v.alt[1:], vaf=v.vaf))
        else:
            span = len(v.ref)
            fixed.append(Variant(v.pos0, ref_seq[v.pos0 : v.pos0 + span],
                                 ref_seq[v.pos0], vaf=v.vaf))
    fx = make_tumor_normal_fixture(
        fixdir, ref_len=ref_len, somatic=fixed, germline=[],
        normal_cov=normal_cov, tumor_cov=tumor_cov, seed=seed,
    )
    meta = {
        "fasta": fx["fasta"], "normal": fx["normal"], "tumor": fx["tumor"],
        "chrom": fx["chrom"], "ref_len": ref_len,
        "truth": [(v.pos0, v.ref, v.alt) for v in fixed],
    }
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return meta
