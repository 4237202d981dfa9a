"""The port's native BAM decoder (`csrc/bam_decoder.cpp` through
`lancet2_tpu_torch/hts/native.py`), held to the Python route
(`BamReader(path, use_native=False)`, the correctness baseline).

The library is built with g++ alone and needs no third-party library.
`bgzf_inflate` (Python's zlib on threads) gives `bgzf.decompress_file`'s
bytes and refuses what `_read_block` refuses. The columnar records, the
event scan and the qname hashes equal the Python route's. A whole batch
executor job writes the same VCF with the decoder loaded and forced off,
and its counters put every record on the route that was taken.

Fixtures: the JAX tests' simulator on a 2 kb tumor/normal pair (seed 5),
and a BAM of seeded edge records (every CIGAR op, soft clips at both ends,
skipped flags, MAPQ 0, MD deletions and lowercase bases, reads without MD,
unmapped reads, odd lengths, long names). Torch is held to two threads.
"""

from __future__ import annotations

import gzip
import os
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

from lancet2_tpu.utils.simulate import Variant, make_tumor_normal_fixture, random_reference
from lancet2_tpu_torch.base.hashing import hash_str64
from lancet2_tpu_torch.cli.main import build_parser, run_pipeline
from lancet2_tpu_torch.core.active_region import _event_index, _record_events
from lancet2_tpu_torch.hts import bgzf, native
from lancet2_tpu_torch.hts.bam import BamReader, BamRecord, BamWriter
from lancet2_tpu_torch.utils.native_build import build_library

BAMS = ("tumor", "normal", "edge")


def _edge_bam(path: str, n: int = 400, seed: int = 7) -> None:
    rng = np.random.default_rng(seed)
    refs = [("chrE", 20000), ("chrF", 9000)]
    w = BamWriter(path, refs, sample_name="edge")
    for i in range(n):
        cigar = []
        if rng.random() < 0.4:
            cigar.append((4, int(rng.integers(1, 20))))                 # S
        for _ in range(int(rng.integers(1, 5))):
            cigar.append((int(rng.choice([0, 1, 2, 3, 7, 8])),       # M I D N = X
                          int(rng.integers(1, 40))))
        if rng.random() < 0.4:
            cigar.append((4, int(rng.integers(1, 20))))
        l_seq = sum(length for op, length in cigar if op in (0, 1, 4, 7, 8))
        seq = "".join(rng.choice(list("ACGTNRY"), l_seq))
        md_parts = []
        for _ in range(int(rng.integers(1, 6))):
            md_parts.append(str(int(rng.integers(0, 30))))
            md_parts.append(str(rng.choice(list("ACGTNacgt")))
                            if rng.random() < 0.7
                            else "^" + "".join(rng.choice(list("ACGT"),
                                                          int(rng.integers(1, 4)))))
        md_parts.append(str(int(rng.integers(0, 30))))
        tags = {"RG": "edge", "NM": int(rng.integers(0, 9)),
                "XF": float(rng.random()), "XB": [1, -2, 3]}
        if rng.random() < 0.85:
            tags["MD"] = "".join(md_parts)
        unmapped = rng.random() < 0.03
        w.add(BamRecord(
            qname=f"edge{i}:" + "q" * int(rng.integers(0, 180)),
            flag=int(rng.choice([0x1 | 0x2 | 0x40, 0x10 | 0x80, 0x200, 0x400, 0x800, 0x100]))
            | (0x4 if unmapped else 0),
            ref_id=-1 if unmapped else int(rng.integers(0, 2)),
            pos0=-1 if unmapped else int(rng.integers(0, 8000)),
            mapq=int(rng.choice([0, 1, 20, 60])), cigar=cigar,
            next_ref_id=int(rng.integers(-1, 2)), next_pos0=int(rng.integers(-1, 8000)),
            tlen=int(rng.integers(-500, 500)), seq=seq,
            qual=rng.integers(0, 42, l_seq).astype(np.uint8), tags=tags))
    w.close()


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("torch_bam_decoder")
    ref = random_reference(2000, seed=5)
    alt = "C" if ref[1000] != "C" else "G"
    out = make_tumor_normal_fixture(
        str(tmp), ref_len=2000,
        somatic=[Variant(pos0=1000, ref=ref[1000], alt=alt, vaf=0.4)],
        germline=[Variant(pos0=500, ref=ref[500:504], alt=ref[500], vaf=0.5)],
        normal_cov=16, tumor_cov=24, seed=5)
    out["edge"] = str(tmp / "edge.bam")
    _edge_bam(out["edge"])
    out["tmp"] = tmp
    yield out
    torch.set_num_threads(threads)


def test_library_builds_from_csrc_and_links_no_library():
    assert native.available(), native.build_error()
    assert native.build_route() == native.ROUTE and native.build_error() is None
    so = build_library("bam_decoder.cpp", native._CSRC)
    assert os.path.dirname(os.path.dirname(so)).endswith(
        os.path.join("_build", "native"))
    dyn = subprocess.run([shutil.which("readelf") or "readelf", "-d", so],
                         check=True, capture_output=True, text=True).stdout
    needed = [l.split("[")[1].rstrip("]") for l in dyn.splitlines() if "(NEEDED)" in l]
    assert needed and not [n for n in needed if "deflate" in n or n.startswith("libz")], needed


@pytest.mark.parametrize("bam", BAMS)
def test_inflate_gives_decompress_files_bytes(fx, bam):
    with open(fx[bam], "rb") as fh:
        raw = fh.read()
    data = native.bgzf_inflate(raw)
    assert data == bgzf.decompress_file(fx[bam])
    assert len(bgzf.block_spans(raw)) >= 2 and data[:4] == b"BAM\x01"


def _corrupt(raw: bytes, how: str) -> bytes:
    start, end = bgzf.block_spans(raw)[0]
    buf = bytearray(raw)
    if how == "crc":
        buf[end] ^= 0xFF
    elif how == "isize":
        struct.pack_into("<I", buf, end + 4, struct.unpack_from("<I", buf, end + 4)[0] + 1)
    elif how == "truncated":
        return bytes(buf[: end + 4])
    elif how == "magic":
        buf[0] = 0x1E
    return bytes(buf)


@pytest.mark.parametrize("how,message", [
    ("crc", "BGZF CRC mismatch"), ("isize", "BGZF ISIZE mismatch"),
    ("truncated", "truncated BGZF block"),
    ("magic", "not a BGZF block (bad gzip magic/flags)"),
])
def test_inflate_refuses_what_read_block_refuses(fx, tmp_path, how, message):
    with open(fx["normal"], "rb") as fh:
        bad = _corrupt(fh.read(), how)
    path = tmp_path / f"{how}.bam"
    path.write_bytes(bad)
    with pytest.raises(bgzf.BgzfError) as python_err:
        bgzf.decompress_file(str(path))
    with pytest.raises(bgzf.BgzfError) as native_err:
        native.bgzf_inflate(bad)
    assert str(python_err.value) == str(native_err.value) == message
    with pytest.raises(bgzf.BgzfError, match=message.replace("(", r"\(").replace(")", r"\)")):
        BamReader(str(path))


def _fields(rec: BamRecord) -> tuple:
    return (rec.qname, rec.flag, rec.ref_id, rec.pos0, rec.mapq, list(rec.cigar),
            rec.next_ref_id, rec.next_pos0, rec.tlen, rec.seq,
            np.asarray(rec.qual).tobytes(), dict(rec.tags.items()))


@pytest.fixture(scope="module")
def readers(fx):
    return {bam: (BamReader(fx[bam]), BamReader(fx[bam], use_native=False))
            for bam in BAMS}


@pytest.mark.parametrize("bam", BAMS)
def test_columnar_records_equal_the_python_routes(readers, bam):
    nat, py = readers[bam]
    assert nat._cols is not None and py._cols is None
    assert (nat.header_text, nat.references) == (py.header_text, py.references)
    got, want = nat.all_records(), py.all_records()
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert _fields(a) == _fields(b)
    assert [r.reference_end0() for r in want] == nat._ref_ends.tolist()


@pytest.mark.parametrize("bam", BAMS)
def test_event_scan_equals_the_python_events(readers, bam):
    nat, py = readers[bam]
    ev_pos, ev_kind, ev_off = native.event_scan(nat._cols)
    events = 0
    for i, rec in enumerate(py.all_records()):
        lo, hi = ev_off[i], ev_off[i + 1]
        want = _record_events(rec)
        assert list(zip(ev_pos[lo:hi].tolist(), ev_kind[lo:hi].tolist())) == want, i
        events += len(want)
    assert events > 0
    got, want = _event_index(nat), _event_index(py)
    assert set(got) == set(want)
    for rid in want:
        for a, b in zip(got[rid], want[rid]):
            np.testing.assert_array_equal(a, b)


def test_hash_batch_equals_hash_str64(readers):
    cols = readers["edge"][0]._cols
    got = native.hash_batch(cols["qname_pool"], cols["qname_off"], cols["qname_len"])
    want = [hash_str64(r.qname) for r in readers["edge"][1].all_records()]
    assert got.tolist() == want
    pool = np.frombuffer(b"ab\x00\xff" * 64, dtype=np.uint8)
    offs, lens = np.array([0, 1, 3, 0]), np.array([0, 2, 1, 256])
    assert native.hash_batch(pool, offs, lens).tolist() == [
        hash_str64(pool[o : o + n].tobytes()) for o, n in zip(offs, lens)]


def _job(fx, name: str) -> tuple[list[str], dict]:
    vcf = str(fx["tmp"] / f"{name}.vcf.gz")
    args = build_parser().parse_args([
        "pipeline", "-n", fx["normal"], "-t", fx["tumor"], "-r", fx["fasta"],
        "-T", "2", "--device", "cpu", "--prep-mode", "threads", "-o", vcf])
    stats = run_pipeline(args, "t")
    with gzip.open(vcf, "rt") as fh:
        lines = [l for l in fh.read().splitlines() if not l.startswith("##fileDate")]
    return lines, stats["trace"]["counters"]


def test_job_writes_the_same_vcf_with_the_decoder_forced_off(fx, monkeypatch):
    n_records = sum(len(BamReader(fx[s], use_native=False).all_records())
                    for s in ("tumor", "normal"))
    loaded, counters = _job(fx, "loaded")
    assert counters["prep.records_native"] == n_records
    assert counters["prep.records_python"] == 0
    assert [l for l in loaded if not l.startswith("#")], "the job calls nothing"

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_err", "forced off")
    assert native.build_route() is None and not native.available()
    forced_off, counters = _job(fx, "forced_off")
    assert counters["prep.records_native"] == 0
    assert counters["prep.records_python"] == n_records
    assert forced_off == loaded
