"""Seeded inputs of a calling job: a reference contig, planted variants and
coordinate-sorted BAMs of paired 150 bp reads, written in a few seconds.

A frozen, vectorised copy of the port's `utils/simulate.py`
(`ReadSimulator`, `make_tumor_normal_fixture`, the BAM and FASTA writers):
the same read model (uniform fragment starts, normal fragment lengths, a
0.2% substitution rate at base quality 11 against 35 elsewhere, MD tags),
with whole haplotypes built once per sample and the reads cut from them as
arrays. Only reads that cross an indel walk their CIGAR in Python.

Every seed gets the same sizes, in another order: the contig length, the
number of fragments per sample and per haplotype, the fragment lengths,
the number of sequencing errors, and the variants' spacings, kinds,
zygosities and indel lengths are drawn once from a generator that no seed
moves, and each seed permutes them; the seed alone draws the bases, the
alleles, the fragment starts and where the errors fall. So seeds differ in
what the work holds, not in how much of it there is. Imports nothing of
the program.
"""

from __future__ import annotations

import concurrent.futures
import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
# BAM 4-bit base codes for A C G T (N = 15)
_NIBBLE = np.full(256, 15, np.uint8)
for _b, _c in zip(b"ACGTN", (1, 2, 4, 8, 15)):
    _NIBBLE[_b] = _c

FLAG_PAIRED, FLAG_PROPER, FLAG_REVERSE, FLAG_MREVERSE = 0x1, 0x2, 0x10, 0x20
FLAG_READ1, FLAG_READ2 = 0x40, 0x80
BGZF_BLOCK = 65280
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
CHROM = "chrS"


@dataclass(frozen=True)
class Planted:
    """A planted variant, VCF-style: 0-based pos, left-anchored indels."""

    pos0: int
    ref: str
    alt: str
    origin: str  # "germline" or "somatic"
    zygosity: str  # "het", "hom" (germline) or "somatic"
    haps: tuple  # haplotypes that carry it (0, 1); somatic: ()


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """Independent generator per purpose; any integer seed, however large."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


# the generator of the sizes every seed shares (`shared(stream)`)
SIZES_SEED = 0x5EED


def shared(stream: int) -> np.random.Generator:
    return rng_for(SIZES_SEED, 1000 + stream)


def contig_length(n_windows: int, window: int, overlap_pct: int) -> int:
    """Length of a contig that the CLI cuts into exactly n_windows windows
    (step = window - window * overlap / 100; windows start at 1 and end at
    most at the contig's last base)."""
    step = window - window * overlap_pct // 100
    return (max(n_windows, 1) - 1) * step + window + 1


def spaced_gaps(n: int, span: int, min_gap: int) -> np.ndarray:
    """n gaps, each at least min_gap, that sum to at most `span`: the
    distances before each of n sites spread over `span` bp, drawn by the
    shared generator, so the same multiset on every seed; in any order
    their running sums are sites min_gap apart."""
    slack = span - n * min_gap
    if slack < 0:
        raise ValueError(f"{n} sites {min_gap} bp apart do not fit in "
                         f"{span} bp")
    u = np.sort(shared(1).integers(0, slack + 1, n))
    return np.diff(np.concatenate([[0], u])) + min_gap


def plant_variants(ref: np.ndarray, cfg: dict, seed: int) -> list[Planted]:
    """Germline sites at the configuration's density, and, where the
    configuration has them, somatic SNV/INS/DEL round-robin. The spacings,
    kinds, zygosities and indel lengths are the shared multisets, in the
    seed's order; the alleles' bases are the seed's."""
    L = ref.size
    g = cfg["germline"]
    s = cfg.get("somatic")
    rng = rng_for(seed, 2)
    somatic: list[Planted] = []
    if s:
        lo_s, hi_s = s["spacing_bp"]
        mid = (lo_s + hi_s) // 2
        n_s = max((L - 2 * s["first_bp"]) // mid + 1, 0)
        jitter = shared(2).integers(-(mid - lo_s) // 2, (hi_s - mid) // 2 + 1,
                                    n_s)
        pos = np.minimum(s["first_bp"] + np.arange(n_s) * mid
                         + rng.permutation(jitter), L - s["first_bp"])
        # kinds round-robin with their lengths, in the seed's order
        table = np.stack([np.arange(n_s) % 3,
                          _lengths(shared(3), n_s, s["indel_len"])], 1)
        for p, (k, n) in zip(pos.tolist(),
                             table[rng.permutation(n_s)].tolist()):
            somatic.append(_make_allele(ref, p, ("SNV", "INS", "DEL")[k], n,
                                        rng, "somatic", ()))
    # germline sites on the contig with the somatic neighbourhoods cut out,
    # so that their number is the same on every seed
    guard = g["somatic_guard_bp"]
    n_g = int(round(L * g["sites_per_kb"] / 1000.0))
    cut = np.array(sorted(v.pos0 for v in somatic), np.int64)
    span = (L - 2 * g["margin_bp"]) - cut.size * (2 * guard + 1)
    gaps = spaced_gaps(n_g, span, g["min_gap_bp"])
    gpos = np.cumsum(rng.permutation(gaps)) + g["margin_bp"]
    # map the compressed coordinate back past each cut-out block
    for c in cut:
        gpos = np.where(gpos >= c - guard, gpos + 2 * guard + 1, gpos)
    # one table of (kind, hom, haplotype, indel length) rows, its counts
    # from the configuration's shares and its pairing fixed by the shared
    # generator; the seed orders its rows
    sh = shared(4)
    n_snv = int(round(n_g * g["snv_share"]))
    table = np.stack([
        np.r_[np.zeros(n_snv, np.int64), np.arange(n_g - n_snv) % 2 + 1],
        sh.permutation(np.arange(n_g) >= int(round(n_g * g["het_share"]))),
        sh.permutation(np.arange(n_g) % 2),
        _lengths(sh, n_g, g["indel_len"])], 1)
    germline = []
    for p, (k, h, hp, n) in zip(gpos.tolist(),
                                table[rng.permutation(n_g)].tolist()):
        haps = (0, 1) if h else (hp,)
        germline.append(_make_allele(ref, p, ("SNV", "INS", "DEL")[k], n,
                                     rng, "germline", haps,
                                     "hom" if h else "het"))
    return sorted(somatic + germline, key=lambda v: v.pos0)


def _lengths(sh, n: int, span) -> np.ndarray:
    return sh.integers(span[0], span[1] + 1, n)


def _make_allele(ref, p, kind, n, rng, origin, haps, zyg="somatic"):
    """The allele of `kind` at p; an indel of n bases."""
    rb = chr(ref[p])
    if kind == "SNV":
        alt = chr(BASES[(int(np.flatnonzero(BASES == ref[p])[0])
                         + int(rng.integers(1, 4))) % 4])
        return Planted(p, rb, alt, origin, zyg, haps)
    if kind == "INS":
        ins = BASES[rng.integers(0, 4, n)].tobytes().decode()
        return Planted(p, rb, rb + ins, origin, zyg, haps)
    return Planted(p, ref[p:p + 1 + n].tobytes().decode(), rb, origin, zyg,
                   haps)


def build_haplotype(ref: np.ndarray, variants: list[Planted]):
    """(sequence, per-base reference position, -1 for inserted bases)."""
    seq_parts, map_parts = [], []
    cur = 0
    for v in sorted(variants, key=lambda v: v.pos0):
        seq_parts.append(ref[cur:v.pos0])
        map_parts.append(np.arange(cur, v.pos0, dtype=np.int64))
        alt = np.frombuffer(v.alt.encode(), np.uint8)
        seq_parts.append(alt)
        m = np.full(alt.size, -1, np.int64)
        m[0] = v.pos0
        map_parts.append(m)
        cur = v.pos0 + len(v.ref)
    seq_parts.append(ref[cur:])
    map_parts.append(np.arange(cur, ref.size, dtype=np.int64))
    return np.concatenate(seq_parts), np.concatenate(map_parts)


@dataclass
class Reads:
    """Read arrays of one sample, in fragment order."""

    pos0: np.ndarray  # int64 [n]
    seq: np.ndarray  # uint8 [n, L] ASCII
    qual: np.ndarray  # uint8 [n, L]
    flag: np.ndarray  # int64 [n]
    mate_pos0: np.ndarray
    tlen: np.ndarray
    frag: np.ndarray  # fragment index (qname)
    cigars: list  # None for L M, else [(op, len), ...]
    md: np.ndarray  # MD strings (object array)
    nm: np.ndarray


_CODE = np.zeros(256, np.int64)
_CODE[BASES] = np.arange(4)


def simulate_sample(ref: np.ndarray, haps: list, weights: list, depth: float,
                    cfg: dict, rng) -> Reads:
    """Paired reads at `depth` from haplotypes `haps` ((seq, map) pairs),
    each fragment drawn from one of them with probability `weights`."""
    rl = cfg["read_length"]
    L = ref.size
    n_frags = int(depth * L / (2 * rl))
    # fragments per haplotype and their lengths: shared sizes, seed's order
    w = np.asarray(weights, np.float64) / sum(weights)
    per = np.floor(w * n_frags).astype(np.int64)
    per[: n_frags - per.sum()] += 1
    which = rng.permutation(np.repeat(np.arange(len(haps)), per))
    flen = rng.permutation(np.maximum(shared(5).normal(
        cfg["fragment_mean"], cfg["fragment_sd"], n_frags).astype(np.int64),
        2 * rl + 10))
    u = rng.random(n_frags)
    # reads in fragment order: read 1 of fragment f at 2f, read 2 at 2f + 1
    n = 2 * n_frags
    frag = np.repeat(np.arange(n_frags), 2)
    is_r2 = np.tile(np.array([False, True]), n_frags)
    hap = which[frag]
    fl = flen[frag]
    tlen = np.where(is_r2, -fl, fl)
    flag = np.where(is_r2, FLAG_PAIRED | FLAG_PROPER | FLAG_READ2 | FLAG_REVERSE,
                    FLAG_PAIRED | FLAG_PROPER | FLAG_READ1 | FLAG_MREVERSE)
    seq = np.empty((n, rl), np.uint8)
    pos0 = np.empty(n, np.int64)
    hstart = np.empty(n, np.int64)
    plain = np.ones(n, bool)
    ok = np.ones(n, bool)
    hap_maps = []
    for h, (hseq, hmap) in enumerate(haps):
        sel = np.flatnonzero(hap == h)
        hap_maps.append(hmap)
        if not sel.size:
            continue
        f = fl[sel]
        start = (u[frag[sel]] * np.maximum(hseq.size - f, 1)).astype(np.int64)
        hs = np.where(is_r2[sel], np.minimum(start + f - rl, hseq.size - rl),
                      start)
        hstart[sel] = hs
        seq[sel] = np.lib.stride_tricks.sliding_window_view(hseq, rl)[hs]
        pos0[sel] = hmap[hs]
        ok[sel] = hmap[hs] >= 0
        # an event: an inserted base, or a base whose reference position
        # does not follow its predecessor's (after an insertion or deletion)
        ev = np.ones(hmap.size, np.int64)
        ev[1:] = ((hmap[1:] < 0) | (hmap[1:] != hmap[:-1] + 1))
        cum = np.cumsum(ev)
        plain[sel] = cum[hs + rl - 1] == cum[hs]
    # sequencing errors at base_error_rate: a different base, at low quality
    n_err = int(round(n * rl * cfg["base_error_rate"]))
    flat = rng.choice(n * rl, n_err, replace=False)
    shift = rng.integers(1, 4, flat.size)
    sflat = seq.reshape(-1)
    sflat[flat] = BASES[(_CODE[sflat[flat]] + shift) % 4]
    qual = np.full((n, rl), cfg["base_quality"], np.uint8)
    qual.reshape(-1)[flat] = cfg["error_base_quality"]
    # a fragment whose read starts on an inserted base is dropped whole
    keep = np.repeat(ok[0::2] & ok[1::2], 2)
    cigars: list = [None] * n
    md = np.empty(n, object)
    nm = np.zeros(n, np.int64)
    # plain reads: L M; mismatches against the reference give MD and NM
    pl = np.flatnonzero(plain & keep)
    refw = np.lib.stride_tricks.sliding_window_view(ref, rl)[pos0[pl]]
    mism = seq[pl] != refw
    k = mism.sum(axis=1)
    nm[pl] = k
    md[pl[k == 0]] = str(rl)
    one = np.flatnonzero(k == 1)
    if one.size:
        col = np.argmax(mism[one], axis=1)
        base = refw[one, col].view("S1").astype(str)
        md[pl[one]] = np.strings.add(np.strings.add(
            col.astype(str), base), (rl - 1 - col).astype(str)).astype(object)
    for j in np.flatnonzero(k > 1).tolist():
        md[pl[j]] = _md_plain(mism[j], refw[j])
    for i in np.flatnonzero(~plain & keep).tolist():
        hmap = hap_maps[hap[i]]
        cig, p0, m, e = _cigar_md(seq[i], hmap[hstart[i]:hstart[i] + rl], ref)
        if cig is None:
            keep[i] = False
            continue
        cigars[i], pos0[i], md[i], nm[i] = cig, p0, m, e
    # a pair loses both reads when one is dropped
    keep = np.repeat(keep[0::2] & keep[1::2], 2)
    mate = pos0.reshape(-1, 2)[:, ::-1].reshape(-1)
    k = np.flatnonzero(keep)
    return Reads(pos0=pos0[k], seq=seq[k], qual=qual[k], flag=flag[k],
                 mate_pos0=mate[k], tlen=tlen[k], frag=frag[k],
                 cigars=[cigars[i] for i in k.tolist()], md=md[k], nm=nm[k])


def _md_plain(mism: np.ndarray, refw: np.ndarray) -> str:
    parts, prev = [], 0
    for p in np.flatnonzero(mism).tolist():
        parts.append(str(p - prev))
        parts.append(chr(refw[p]))
        prev = p + 1
    parts.append(str(mism.size - prev))
    return "".join(parts)


def _cigar_md(seq, smap, ref):
    """CIGAR, start, MD and NM of a read that crosses an indel, from its
    per-base reference positions (the port simulator's walk)."""
    cig: list = []
    cursor = int(smap[0])
    p0 = cursor
    md, run, nm = [], 0, 0
    for qi, p in enumerate(smap.tolist()):
        if p < 0:
            if cig and cig[-1][0] == 1:
                cig[-1] = (1, cig[-1][1] + 1)
            else:
                cig.append((1, 1))
            nm += 1
            continue
        if p > cursor:
            cig.append((2, p - cursor))
            md.append(str(run))
            md.append("^" + ref[cursor:p].tobytes().decode())
            run = 0
            nm += p - cursor
        if cig and cig[-1][0] == 0:
            cig[-1] = (0, cig[-1][1] + 1)
        else:
            cig.append((0, 1))
        if seq[qi] == ref[p]:
            run += 1
        else:
            md.append(str(run))
            md.append(chr(ref[p]))
            run = 0
            nm += 1
        cursor = p + 1
    md.append(str(run))
    if cig[0][0] != 0:
        return None, 0, "", 0
    return cig, p0, "".join(md), nm


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    end = end - 1
    out = np.zeros(beg.size, np.int64)
    done = np.zeros(beg.size, bool)
    for shift, off in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = off + (beg[hit] >> shift)
        done |= hit
    return out


_CORE = np.dtype([("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
                  ("l_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                  ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                  ("next_ref_id", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4")])
_CHUNK = 1 << 16  # records packed at a time


def write_bam(path: str, reads: Reads, ref_len: int, sample: str,
              qprefix: str, threads: int) -> int:
    """A coordinate-sorted BGZF BAM of `reads`; returns the record count.
    Each record's aux is NM:i then MD:Z, so that every byte before the MD
    string sits at a fixed offset in a read whose CIGAR is L M."""
    n = reads.pos0.size
    rl = reads.seq.shape[1]
    order = np.lexsort((reads.flag & FLAG_READ2, reads.frag, reads.pos0))
    width = max(len(str(int(reads.frag.max(initial=0)))), 9)
    header = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{CHROM}\tLN:{ref_len}\n"
              f"@RG\tID:{sample}\tSM:{sample}\n").encode()
    name = CHROM.encode() + b"\x00"
    out = [b"BAM\x01" + struct.pack("<i", len(header)) + header
           + struct.pack("<i", 1) + struct.pack("<i", len(name)) + name
           + struct.pack("<i", ref_len)]
    l_name = len(qprefix) + width + 1
    ref_len_of = np.array([rl if c is None else sum(l for op, l in c if op in (0, 2))
                           for c in reads.cigars], np.int64)
    n_cig = np.array([1 if c is None else len(c) for c in reads.cigars], np.int64)
    md_len = np.fromiter((len(m) for m in reads.md), np.int64, n)
    sl = (rl + 1) // 2
    fixed = 36 + l_name + sl + rl + 7 + 3  # core, name, seq, qual, NM, "MDZ"
    rec_len = fixed + 4 * n_cig + md_len + 1
    for lo in range(0, n, _CHUNK):
        idx = order[lo:lo + _CHUNK]
        m = idx.size
        core = np.zeros(m, _CORE)
        core["block_size"] = rec_len[idx] - 4
        core["pos"] = reads.pos0[idx]
        core["l_name"] = l_name
        core["mapq"] = 60
        core["bin"] = _reg2bin(reads.pos0[idx], reads.pos0[idx] + ref_len_of[idx])
        core["n_cigar"] = n_cig[idx]
        core["flag"] = reads.flag[idx]
        core["l_seq"] = rl
        core["next_pos"] = reads.mate_pos0[idx]
        core["tlen"] = reads.tlen[idx]
        P = np.zeros((m, int(rec_len[idx].max())), np.uint8)
        P[:, :36] = core.view(np.uint8).reshape(m, 36)
        qn = np.strings.add(qprefix, np.strings.zfill(
            reads.frag[idx].astype(str), width)).astype(f"S{l_name - 1}")
        P[:, 36:36 + l_name - 1] = qn.view(np.uint8).reshape(m, l_name - 1)
        c = 36 + l_name
        s = _NIBBLE[reads.seq[idx]]
        if rl % 2:
            s = np.pad(s, ((0, 0), (0, 1)))
        packed = (s[:, 0::2] << 4) | s[:, 1::2]
        nm = np.zeros((m, 7), np.uint8)
        nm[:, :3] = np.frombuffer(b"NMi", np.uint8)
        nm[:, 3:] = reads.nm[idx].astype("<i4").view(np.uint8).reshape(m, 4)
        plain = n_cig[idx] == 1
        P[plain, c:c + 4] = np.frombuffer(struct.pack("<I", rl << 4), np.uint8)
        t = c + 4
        P[plain, t:t + sl] = packed[plain]
        P[plain, t + sl:t + sl + rl] = reads.qual[idx][plain]
        P[plain, t + sl + rl:t + sl + rl + 7] = nm[plain]
        P[plain, t + sl + rl + 7:t + sl + rl + 10] = np.frombuffer(b"MDZ", np.uint8)
        mstart = t + sl + rl + 10
        mds = reads.md[idx]
        ml = md_len[idx]
        for length in np.unique(ml[plain]).tolist():
            rows = np.flatnonzero(plain & (ml == length))
            P[rows, mstart:mstart + length] = np.array(
                mds[rows].tolist(), f"S{length}").view(np.uint8).reshape(-1, length)
        for r in np.flatnonzero(~plain).tolist():
            i = idx[r]
            b = (b"".join(struct.pack("<I", (l << 4) | op)
                          for op, l in reads.cigars[i])
                 + packed[r].tobytes() + reads.qual[i].tobytes()
                 + nm[r].tobytes() + b"MDZ" + reads.md[i].encode() + b"\x00")
            P[r, c:c + len(b)] = np.frombuffer(b, np.uint8)
        mask = np.arange(P.shape[1]) < rec_len[idx][:, None]
        out.append(P[mask].tobytes())
    data = b"".join(out)
    blocks = [data[o:o + BGZF_BLOCK] for o in range(0, len(data), BGZF_BLOCK)]
    with concurrent.futures.ThreadPoolExecutor(max(threads, 1)) as ex:
        comp = list(ex.map(_bgzf_block, blocks))
    with open(path, "wb") as fh:
        for c in comp:
            fh.write(c)
        fh.write(BGZF_EOF)
    return n


def _bgzf_block(payload: bytes) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = c.compress(payload) + c.flush()
    head = struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                       0x42, 0x43, 2, len(cdata) + 25)
    return head + cdata + struct.pack("<II", zlib.crc32(payload), len(payload))


def write_fasta(path: str, ref: np.ndarray, line: int = 60) -> None:
    """FASTA of one contig, and its samtools .fai."""
    body = ref.tobytes()
    lines = b"\n".join(body[o:o + line] for o in range(0, len(body), line))
    head = f">{CHROM}\n".encode()
    with open(path, "wb") as fh:
        fh.write(head + lines + b"\n")
    with open(path + ".fai", "w") as fh:
        fh.write(f"{CHROM}\t{ref.size}\t{len(head)}\t{line}\t{line + 1}\n")


def make_job_inputs(out_dir: str, cfg: dict, depths: dict, n_windows: int,
                    seed: int, threads: int = 4) -> dict:
    """Write ref.fa(.fai) and one BAM per sample of the configuration into
    out_dir; returns the paths and the planted truth."""
    os.makedirs(out_dir, exist_ok=True)
    cli = cfg["cli"]
    L = contig_length(n_windows, cli["window"], cli["overlap_pct"])
    ref = BASES[rng_for(seed, 1).integers(0, 4, L)]
    truth = plant_variants(ref, cfg, seed)
    germ = [v for v in truth if v.origin == "germline"]
    som = [v for v in truth if v.origin == "somatic"]
    h0 = [v for v in germ if 0 in v.haps]
    h1 = [v for v in germ if 1 in v.haps]
    write_fasta(os.path.join(out_dir, "ref.fa"), ref)

    def sample(k: int, smp: dict) -> tuple[str, str]:
        haps = [build_haplotype(ref, h0), build_haplotype(ref, h1)]
        weights = [0.5, 0.5]
        if smp["carries_somatic"] and som:
            vaf = cfg["somatic"]["vaf"]
            haps += [build_haplotype(ref, h0 + som),
                     build_haplotype(ref, h1 + som)]
            weights = [0.5 * (1 - vaf)] * 2 + [0.5 * vaf] * 2
        reads = simulate_sample(ref, haps, weights, depths[smp["role"]],
                                cfg["reads"], rng_for(seed, 10 + k))
        path = os.path.join(out_dir, f"{smp['role']}.bam")
        write_bam(path, reads, L, smp["name"], smp["role"][0], threads)
        return smp["role"], path

    # samples in parallel: each has its own generator, so the bytes do not
    # depend on the order
    with concurrent.futures.ThreadPoolExecutor(len(cfg["samples"])) as ex:
        bams = dict(ex.map(sample, range(len(cfg["samples"])), cfg["samples"]))
    return {"fasta": os.path.join(out_dir, "ref.fa"), "bams": bams,
            "ref_len": L, "truth": truth}
