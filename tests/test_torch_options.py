"""The port's pipeline options, held against the JAX package on the CPU.

Each option runs through the port's CLI (the batch executor on `--device
cpu`, so the plain K1/K2; forked prep workers unless named) and through the
JAX package's CLI (`--aligner-backend numpy`, threads executor: records are
identical across its backends and executors). Record lines must be
byte-equal, and window status counts equal where compared:

  * --checkpoint: the batch executor built with window_batch=2 saves a
    cursor after each batch; the VCF as it stood on disk at the first
    cursor, resumed, gives the uninterrupted run's records, which are the
    JAX package's; the .ckpt file is removed when a run completes;
  * CRAM: inputs converted (gzip, rans4x8) and indexed by the port's `cram`
    and `index`, byte-equal to the JAX converter's output for the same
    input and output path; their records equal the BAM run's and the JAX
    package's CRAM run's;
  * --stream-bam (indexed readers in forked prep workers; the .bai files
    appear) and --stream-windows on (the manifest streamed): the in-memory
    run's records; a soak of 20000 all-N windows through the batch
    executor's stream, every one SKIPPED_NONLY_REF_BASES, within the JAX
    soak's bound on peak RSS growth;
  * three samples (-s path:case twice): a mosaic SNV in one case only and a
    multiallelic locus, records and sample columns equal to the JAX
    package's;
  * --read-filter: records differ from the unfiltered run and equal the JAX
    package's; a bad expression exits before any window runs;
  * --extract-pairs: ReadCollector's read lists equal the JAX collector's on
    tests/test_mate_recapture.py's pairs, with and without recapture; a CLI
    run over discordant pairs whose mates carry the SNV allele differs from
    the run without the flag and equals the JAX package's;
  * --no-active-region (records and status counts), --no-contig-check
    (a mismatched reference rejected, then accepted), -b/--bed-file (equal
    to the same regions as -R), and --graph-snapshots verbose with
    --out-graphs-tgz under the threads executor (archive members and bytes).

The port's runs go through tests/torch_options_jobs.py in two processes,
started before the JAX runs and awaited after, with two intra-op threads
each; neither may load jax or lancet2_tpu. Fixture: 3 kb, somatic SNV at
1500, germline 5 bp deletion at 750, 14x/20x, seed 5, 600 bp windows.
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
import subprocess
import sys
import tarfile
import types

import numpy as np
import pytest

from lancet2_tpu.cli.main import build_parser as jax_parser
from lancet2_tpu.cli.main import main as jax_main
from lancet2_tpu.cli.main import run_pipeline as jax_run_pipeline
from lancet2_tpu.core.read_collector import CollectorParams as JaxCollectorParams
from lancet2_tpu.core.read_collector import ReadCollector as JaxReadCollector
from lancet2_tpu.core.sample_info import SampleInfo as JaxSampleInfo
from lancet2_tpu.hts.bam import (
    FLAG_MATE_REVERSE,
    FLAG_PAIRED,
    FLAG_PROPER_PAIR,
    FLAG_READ1,
    FLAG_READ2,
    FLAG_REVERSE,
    BamReader,
    BamRecord,
    BamWriter,
)
from lancet2_tpu.hts.fasta import write_fasta
from lancet2_tpu.utils.simulate import (
    ReadSimulator,
    Variant,
    make_tumor_normal_fixture,
    random_reference,
)
from lancet2_tpu_torch.core.read_collector import CollectorParams, ReadCollector
from lancet2_tpu_torch.core.sample_info import SampleInfo
from lancet2_tpu_torch.core.window_builder import WindowBuilder, WindowParams
from lancet2_tpu_torch.hts.fasta import Reference
from torch_options_jobs import FROZEN_CLOCK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(ROOT, "tests", "torch_options_jobs.py")
REF_LEN, SNV, DEL = 3000, 1500, 750
MOSAIC, MULTI = 1000, 2000  # three-sample fixture
READ_FILTER = "!flag.reverse && mapq >= 30 && [NM] <= 4"
SOAK_WINDOWS = 20_000
CODECS = ("gzip", "rans4x8")


def _records(path) -> list[str]:
    with gzip.open(path, "rt") as fh:
        return [l for l in fh.read().splitlines() if l and not l.startswith("#")]


def _columns(path) -> list[str]:
    with gzip.open(path, "rt") as fh:
        return next(l for l in fh if l.startswith("#CHROM")).split("\t")


def _pair_read(qname, pos0, seq, flag, next_pos0, tags=None):
    return BamRecord(
        qname=qname, flag=flag, ref_id=0, pos0=pos0, mapq=60,
        cigar=[(0, len(seq))], next_ref_id=0, next_pos0=next_pos0, tlen=0,
        seq=seq, qual=np.full(len(seq), 35, np.uint8), tags=tags or {})


def _three_samples(tmp) -> dict:
    """Normal and two cases over 3 kb: a mosaic SNV in case A only, and a
    multiallelic locus where each case carries its own ALT."""
    ref = random_reference(REF_LEN, seed=401)
    fasta = str(tmp / "ref.fa")
    write_fasta(fasta, {"chrS": ref})
    mosaic = Variant(MOSAIC, ref[MOSAIC], "C" if ref[MOSAIC] != "C" else "G",
                     vaf=0.5)
    alts = [b for b in "ACGT" if b != ref[MULTI]]
    paths = {}
    for name, variants, cov, seed in (
            ("NORMAL", [], 20, 402),
            ("TUMA", [mosaic, Variant(MULTI, ref[MULTI], alts[0], 0.99)], 25,
             403),
            ("TUMB", [Variant(MULTI, ref[MULTI], alts[1], 0.99)], 25, 404)):
        paths[name] = str(tmp / f"{name}.bam")
        w = BamWriter(paths[name], [("chrS", REF_LEN)], sample_name=name)
        ReadSimulator(ref, seed=seed).simulate(variants, cov, w,
                                               qname_prefix=name.lower())
        w.close()
    return {"fasta": fasta, "alts": alts[:2], **paths}


def _with_discordant_pairs(fx, path) -> None:
    """The fixture's tumor reads plus 8 discordant pairs: one read inside
    the SNV's window on the reference, its mate mapped 1.2 kb away but
    carrying the SNV's allele, so only recapture brings it to the SNV."""
    ref = fx["ref_seq"]
    alt = fx["somatic"][0].alt
    hap = ref[:SNV] + alt + ref[SNV + 1:]
    w = BamWriter(path, [("chrS", REF_LEN)], sample_name="TUMOR")
    for rec in BamReader(fx["tumor"], use_native=False).all_records():
        w.add(rec)
    for i in range(8):
        pos, mate = 1300 + 10 * i, 2700 + 10 * i
        w.add(_pair_read(f"disc{i}", pos, ref[pos:pos + 100],
                         FLAG_PAIRED | FLAG_READ1, mate))
        lo = SNV - 60 + 5 * i
        w.add(_pair_read(f"disc{i}", mate, hap[lo:lo + 100],
                         FLAG_PAIRED | FLAG_READ2 | FLAG_REVERSE, pos))
    w.close()


def _start_port(jobs: list[dict], cwd) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, JOBS, json.dumps(jobs)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(cwd))


def _finish_port(proc: subprocess.Popen, names: list[str]) -> dict:
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-4000:]
    out = json.loads(stdout.strip().splitlines()[-1])
    assert out["loaded"] == [], out["loaded"]
    return dict(zip(names, out["results"]))


def _jax_run(argv) -> dict:
    return jax_run_pipeline(jax_parser().parse_args(argv),
                            "lancet2-tpu " + " ".join(argv))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_options")
    ref = random_reference(REF_LEN, seed=5)
    alt = "C" if ref[SNV] != "C" else "G"
    fx = make_tumor_normal_fixture(
        str(tmp), ref_len=REF_LEN,
        somatic=[Variant(pos0=SNV, ref=ref[SNV], alt=alt, vaf=0.45)],
        germline=[Variant(pos0=DEL, ref=ref[DEL:DEL + 6], alt=ref[DEL],
                          vaf=0.5)],
        normal_cov=14, tumor_cov=20, seed=5)
    (tmp / "three").mkdir()
    ms = _three_samples(tmp / "three")
    pairs_bam = str(tmp / "tumor_pairs.bam")
    _with_discordant_pairs(fx, pairs_bam)
    stream = tmp / "stream"
    stream.mkdir()
    for s in ("normal", "tumor"):
        shutil.copy(fx[s], stream / f"{s}.bam")
    wrong = str(tmp / "wrong.fa")
    write_fasta(wrong, {"chrS": random_reference(2100, seed=9)})
    bed = str(tmp / "regions.bed")
    with open(bed, "w") as fh:
        fh.write("chrS\t1000\t1600\nchrS\t2000\t2400\n")

    fasta = fx["fasta"]
    inputs = ["-n", fx["normal"], "-t", fx["tumor"]]
    port = ["pipeline", "-r", fasta, "-T", "2", "-w", "600", "--device",
            "cpu"]
    jax = ["pipeline", "-r", fasta, "-T", "2", "-w", "600",
           "--aligner-backend", "numpy"]
    graphs = ["-R", "chrS:1301-1700", "-P", "0", "--graph-snapshots",
              "verbose"]

    def cli(argv):
        return {"kind": "cli", "argv": argv}

    # process A: CRAM, streamed readers and windows, checkpoint resume
    a_dir, b_dir = tmp / "port_a", tmp / "port_b"
    a_dir.mkdir()
    b_dir.mkdir()
    jobs_a, names_a = [], []
    for s in ("normal", "tumor"):
        for codec in CODECS:
            cram = f"{s}.{codec}.cram"
            jobs_a += [{"kind": "cram", "argv": ["cram", fx[s], "-r", fasta,
                                                 "-o", cram, "--codec",
                                                 codec]},
                       {"kind": "cram", "argv": ["index", cram]}]
            names_a += [f"convert_{s}_{codec}", f"index_{s}_{codec}"]
    for name, argv in (
            ("base", inputs + ["-o", "base.vcf.gz", "--prep-mode",
                               "processes"]),
            ("cram_gzip", ["-n", "normal.gzip.cram", "-t", "tumor.gzip.cram",
                           "-o", "cram_gzip.vcf.gz", "--prep-mode",
                           "processes"]),
            ("cram_rans4x8", ["-n", "normal.rans4x8.cram", "-t",
                              "tumor.rans4x8.cram", "-o",
                              "cram_rans4x8.vcf.gz", "--prep-mode",
                              "processes"]),
            ("stream_bam", ["-n", str(stream / "normal.bam"), "-t",
                            str(stream / "tumor.bam"), "-o",
                            "stream_bam.vcf.gz", "--stream-bam",
                            "--prep-mode", "processes"]),
            ("stream_windows", inputs + ["-o", "stream_windows.vcf.gz",
                                         "--stream-windows", "on"])):
        jobs_a.append(cli(port + argv))
        names_a.append(name)
    jobs_a.append({"kind": "checkpoint", "window_batch": 2,
                   "snapshots": str(a_dir / "saves"),
                   "argv": port + inputs + ["-o", "ckpt.vcf.gz",
                                            "--checkpoint"],
                   "resume_argv": port + inputs + ["-o", "resume.vcf.gz",
                                                   "--checkpoint"]})
    names_a.append("checkpoint")

    # process B: the soak first (peak RSS), then the other options
    jobs_b = [{"kind": "soak", "windows": SOAK_WINDOWS,
               "workdir": str(b_dir)}]
    names_b = ["soak"]
    for name, argv in (
            ("filter", inputs + ["-o", "filter.vcf.gz", "--read-filter",
                                 READ_FILTER]),
            ("filter_bad", inputs + ["-o", "filter_bad.vcf.gz",
                                     "--read-filter", "mapq >="]),
            ("no_active", inputs + ["-o", "no_active.vcf.gz",
                                    "--no-active-region"]),
            ("pairs", ["-n", fx["normal"], "-t", pairs_bam, "-o",
                       "pairs.vcf.gz", "--extract-pairs"]),
            ("pairs_off", ["-n", fx["normal"], "-t", pairs_bam, "-o",
                           "pairs_off.vcf.gz"]),
            ("three", ["-n", ms["NORMAL"], "-s", f"{ms['TUMA']}:case", "-s",
                       f"{ms['TUMB']}:case", "-r", ms["fasta"], "-o",
                       "three.vcf.gz"]),
            ("graphs", inputs + graphs + [
                "-o", "graphs.vcf.gz", "--executor", "threads",
                "--aligner-backend", "numpy", "--out-graphs-tgz",
                "graphs.tgz"]),
            ("bed", inputs + ["-o", "bed.vcf.gz", "-b", bed, "-P", "0"]),
            ("region", inputs + ["-o", "region.vcf.gz", "-R",
                                 "chrS:1001-1600", "-R", "chrS:2001-2400",
                                 "-P", "0"]),
            ("contig_reject", inputs + ["-o", "contig_reject.vcf.gz", "-r",
                                        wrong]),
            ("contig_bypass", inputs + ["-o", "contig_bypass.vcf.gz", "-r",
                                        wrong, "--no-contig-check", "-R",
                                        "chrS:1001-1600"])):
        jobs_b.append(cli(port + argv))
        names_b.append(name)

    procs = [_start_port(jobs_a, a_dir), _start_port(jobs_b, b_dir)]
    try:
        j_dir = tmp / "jax"
        j_dir.mkdir()
        cwd = os.getcwd()
        clock = gzip.time
        os.chdir(j_dir)  # the CRAM file ID holds the output path as given
        gzip.time = types.SimpleNamespace(time=lambda: FROZEN_CLOCK)
        try:
            for s in ("normal", "tumor"):
                for codec in CODECS:
                    cram = f"{s}.{codec}.cram"
                    assert jax_main(["cram", fx[s], "-r", fasta, "-o", cram,
                                     "--codec", codec]) == 0
                    assert jax_main(["index", cram]) == 0
        finally:
            gzip.time = clock
            os.chdir(cwd)
        jax_runs = {}
        for name, argv in (
                ("base", inputs + ["-o", str(j_dir / "base.vcf.gz")]),
                ("cram", ["-n", str(j_dir / "normal.gzip.cram"), "-t",
                          str(j_dir / "tumor.gzip.cram"), "-o",
                          str(j_dir / "cram.vcf.gz")]),
                ("filter", inputs + ["-o", str(j_dir / "filter.vcf.gz"),
                                     "--read-filter", READ_FILTER]),
                ("no_active", inputs + ["-o", str(j_dir / "no_active.vcf.gz"),
                                        "--no-active-region"]),
                ("pairs", ["-n", fx["normal"], "-t", pairs_bam, "-o",
                           str(j_dir / "pairs.vcf.gz"), "--extract-pairs"]),
                ("three", ["-n", ms["NORMAL"], "-s", f"{ms['TUMA']}:case",
                           "-s", f"{ms['TUMB']}:case", "-r", ms["fasta"],
                           "-o", str(j_dir / "three.vcf.gz")]),
                ("graphs", inputs + graphs + [
                    "-o", str(j_dir / "graphs.vcf.gz"), "--out-graphs-tgz",
                    str(j_dir / "graphs.tgz")])):
            jax_runs[name] = _jax_run(jax + argv)
        port_runs = _finish_port(procs[0], names_a)
        port_runs.update(_finish_port(procs[1], names_b))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return types.SimpleNamespace(tmp=tmp, fx=fx, ms=ms, a=a_dir, b=b_dir,
                                 j=j_dir, port=port_runs, jax=jax_runs,
                                 stream=stream, inputs=inputs, port_argv=port)


def test_base_run_matches_jax(runs):
    got = _records(runs.a / "base.vcf.gz")
    assert got and got == _records(runs.j / "base.vcf.gz")
    assert runs.port["base"]["status_counts"] == runs.jax["base"][
        "status_counts"]


def _windows(fasta):
    wb = WindowBuilder(Reference(fasta), WindowParams(window_length=600))
    wb.add_whole_reference()
    wb.sort_input_regions()
    return wb.build_windows()


def test_checkpoint_saves_cursors_mid_run(runs):
    ck = runs.port["checkpoint"]
    assert ck["exit"] == 0
    windows = _windows(runs.fx["fasta"])
    assert len(windows) == 5
    # batches of 2 windows: a cursor at the next batch's first window after
    # each batch but the last, with the windows done so far
    want = [[0, windows[k].start1, k] for k in (2, 4)]
    assert [s["cursor"] for s in ck["saves"]] == want
    assert [s["file"] for s in ck["saves"]] == [
        {"cursor_chrom_index": c, "cursor_pos1": p, "done": d}
        for c, p, d in want]
    assert not os.path.exists(runs.a / "ckpt.vcf.gz.ckpt")
    assert _records(runs.a / "ckpt.vcf.gz") == _records(runs.j / "base.vcf.gz")


def test_checkpoint_resume_from_the_flushed_vcf(runs):
    """Resumed from the first cursor, with the VCF as it stood on disk when
    that cursor was saved: the records before the cursor come from the file,
    the rest from the windows that remain."""
    ck = runs.port["checkpoint"]
    first = ck["saves"][0]
    cursor_pos1 = first["cursor"][1]
    full = _records(runs.j / "base.vcf.gz")
    resume = ck["resume"]
    assert resume["exit"] == 0
    assert _records(runs.a / "resume.vcf.gz") == full
    assert any(m.startswith(f"resuming at cursor (0, {cursor_pos1})")
               for m in resume["log"])
    assert resume["windows"] < 5  # the windows before the cursor are done
    assert not os.path.exists(runs.a / "resume.vcf.gz.ckpt")
    flushed = _records(first["vcf"])
    assert flushed  # the germline deletion lies before the cursor
    assert flushed == [r for r in full if int(r.split("\t")[1]) < cursor_pos1]


@pytest.mark.parametrize("s", ["normal", "tumor"])
@pytest.mark.parametrize("codec", CODECS)
def test_cram_conversion_bytes_match_jax(runs, s, codec):
    name = f"{s}.{codec}.cram"
    assert runs.port[f"convert_{s}_{codec}"]["exit"] == 0
    assert runs.port[f"index_{s}_{codec}"]["exit"] == 0
    for suffix in ("", ".crai"):
        with open(runs.a / (name + suffix), "rb") as fh:
            got = fh.read()
        with open(runs.j / (name + suffix), "rb") as fh:
            want = fh.read()
        assert got and got == want, name + suffix


@pytest.mark.parametrize("codec", CODECS)
def test_cram_inputs_match_bam_and_jax(runs, codec):
    got = _records(runs.a / f"cram_{codec}.vcf.gz")
    assert got == _records(runs.a / "base.vcf.gz")
    assert got == _records(runs.j / "cram.vcf.gz")
    assert runs.port[f"cram_{codec}"]["status_counts"] == runs.port["base"][
        "status_counts"]


def test_stream_bam_matches_in_memory(runs):
    assert _records(runs.a / "stream_bam.vcf.gz") == _records(
        runs.a / "base.vcf.gz")
    for s in ("normal", "tumor"):  # built by the streamed readers
        assert os.path.exists(runs.stream / f"{s}.bam.bai")
        assert not os.path.exists(runs.fx[s] + ".bai")


def test_stream_windows_matches_materialized(runs):
    st = runs.port["stream_windows"]
    assert any(m.startswith("streaming ~") for m in st["log"])
    assert not any(m.startswith("streaming ~")
                   for m in runs.port["base"]["log"])
    assert st["windows"] == runs.port["base"]["windows"]
    assert _records(runs.a / "stream_windows.vcf.gz") == _records(
        runs.a / "base.vcf.gz")


def test_streamed_manifest_soak_bounded(runs):
    soak = runs.port["soak"]
    assert soak["streaming"] and soak["expected"] >= SOAK_WINDOWS
    assert soak["windows"] >= SOAK_WINDOWS - 1  # the tail may merge
    assert soak["status_counts"] == {"SKIPPED_NONLY_REF_BASES":
                                     soak["windows"]}
    assert soak["rss_growth_mb"] < 400  # tests/test_streaming_soak.py's bound


def test_three_samples_match_jax(runs):
    got = _records(runs.b / "three.vcf.gz")
    assert got == _records(runs.j / "three.vcf.gz")
    cols = _columns(runs.b / "three.vcf.gz")
    assert cols == _columns(runs.j / "three.vcf.gz")
    assert [c.strip() for c in cols[9:]] == ["NORMAL", "TUMA", "TUMB"]
    assert runs.port["three"]["status_counts"] == runs.jax["three"][
        "status_counts"]
    by_pos = {int(r.split("\t")[1]): r.split("\t") for r in got}
    mosaic = by_pos[MOSAIC + 1]
    assert "CASE" in mosaic[7]
    assert [c.split(":")[0] for c in mosaic[9:]][0::2] == ["0/0", "0/0"]
    assert int(mosaic[10].split(":")[1].split(",")[1]) > 5
    multi = by_pos[MULTI + 1]
    assert sorted(multi[4].split(",")) == sorted(runs.ms["alts"])
    assert "MULTIALLELIC" in multi[7]
    assert len(dict(zip(multi[8].split(":"), multi[9].split(":")))[
        "PL"].split(",")) == 6


def test_read_filter_matches_jax_and_drops_reads(runs):
    got = _records(runs.b / "filter.vcf.gz")
    assert got and got == _records(runs.j / "filter.vcf.gz")
    assert got != _records(runs.a / "base.vcf.gz")
    assert runs.port["filter"]["status_counts"] == runs.jax["filter"][
        "status_counts"]


def test_bad_read_filter_exits_before_any_window(runs):
    bad = runs.port["filter_bad"]
    assert isinstance(bad["exit"], str)
    assert bad["exit"].startswith("invalid --read-filter expression")
    assert not any(m.startswith("built ") for m in bad["log"])
    assert not os.path.exists(runs.b / "filter_bad.vcf.gz")


def test_no_active_region_matches_jax(runs):
    got = runs.port["no_active"]
    assert got["status_counts"] == runs.jax["no_active"]["status_counts"]
    assert got["status_counts"] != runs.port["base"]["status_counts"]
    assert _records(runs.b / "no_active.vcf.gz") == _records(
        runs.j / "no_active.vcf.gz")


def _collect_mates(make_collector, make_sample, bam, extract_pairs):
    sinfo = make_sample(path=bam, sample_name="S1", tag=4, sample_index=0)
    return [(r.qname, r.start0, r.sam_flag, r.seq, r.qual.tobytes())
            for r in make_collector(extract_pairs, sinfo).collect(
                "chrM", 1001, 2000)]


def test_read_collector_recapture_matches_jax(tmp_path):
    """tests/test_mate_recapture.py's pairs: background proper pairs, three
    discordant pairs with mates far outside the window, an SA-tagged proper
    pair and a proper pair without SA."""
    ref = random_reference(6000, seed=8)
    L = 100
    recs = []
    for i, off in enumerate(range(1050, 1750, 80)):
        recs.append(_pair_read(
            f"bg{i}", off, ref[off:off + L],
            FLAG_PAIRED | FLAG_PROPER_PAIR | FLAG_READ1 | FLAG_MATE_REVERSE,
            off + 120))
        recs.append(_pair_read(
            f"bg{i}", off + 120, ref[off + 120:off + 120 + L],
            FLAG_PAIRED | FLAG_PROPER_PAIR | FLAG_READ2 | FLAG_REVERSE, off))
    for q, pos, mate, flag_in, tags in (
            ("da", 1100, 4200, FLAG_PAIRED | FLAG_READ1, None),
            ("db", 1300, 3500, FLAG_PAIRED | FLAG_READ1, None),
            ("dc", 1500, 5100, FLAG_PAIRED | FLAG_READ1, None),
            ("sa1", 1650, 4600, FLAG_PAIRED | FLAG_PROPER_PAIR | FLAG_READ1,
             {"SA": "chrM,4601,+,100M,60,0;"}),
            ("pp1", 1200, 3900, FLAG_PAIRED | FLAG_PROPER_PAIR | FLAG_READ1,
             None)):
        recs.append(_pair_read(q, pos, ref[pos:pos + L], flag_in, mate, tags))
        recs.append(_pair_read(q, mate, ref[mate:mate + L],
                               (flag_in & FLAG_PROPER_PAIR) | FLAG_PAIRED
                               | FLAG_READ2 | FLAG_REVERSE, pos))
    recs.sort(key=lambda r: r.pos0)
    bam = str(tmp_path / "s.bam")
    w = BamWriter(bam, [("chrM", 6000)], sample_name="S1")
    for r in recs:
        w.add(r)
    w.close()

    def port(extract_pairs, sinfo):
        return ReadCollector(CollectorParams(extract_pairs=extract_pairs),
                             [sinfo])

    def jax(extract_pairs, sinfo):
        return JaxReadCollector(
            JaxCollectorParams(extract_pairs=extract_pairs), [sinfo])

    lists = {}
    for extract_pairs in (False, True):
        got = _collect_mates(port, SampleInfo, bam, extract_pairs)
        assert got == _collect_mates(jax, JaxSampleInfo, bam, extract_pairs)
        lists[extract_pairs] = got
    added = ({(q, s) for q, s, *_ in lists[True]}
             - {(q, s) for q, s, *_ in lists[False]})
    assert added == {(b"da", 4200), (b"db", 3500), (b"dc", 5100),
                     (b"sa1", 4600)}


def test_extract_pairs_cli_matches_jax(runs):
    got = _records(runs.b / "pairs.vcf.gz")
    assert got and got == _records(runs.j / "pairs.vcf.gz")
    assert got != _records(runs.b / "pairs_off.vcf.gz")
    assert runs.port["pairs"]["status_counts"] == runs.jax["pairs"][
        "status_counts"]


def test_no_contig_check(runs):
    assert runs.port["contig_reject"]["exit"].startswith(
        "contig check failed")
    assert not os.path.exists(runs.b / "contig_reject.vcf.gz")
    bypass = runs.port["contig_bypass"]
    assert bypass["exit"] == 0 and bypass["windows"] >= 1
    assert os.path.exists(runs.b / "contig_bypass.vcf.gz")


def test_bed_file_equals_region_flags(runs):
    bed, region = runs.port["bed"], runs.port["region"]
    assert bed["windows"] == region["windows"] == 2
    assert bed["status_counts"] == region["status_counts"]
    got = _records(runs.b / "bed.vcf.gz")
    assert got and got == _records(runs.b / "region.vcf.gz")
    assert got != _records(runs.a / "base.vcf.gz")


def test_graph_snapshots_verbose_match_jax(runs):
    def members(path):
        with tarfile.open(path) as tf:
            return [(m.name, tf.extractfile(m).read()) for m in tf.getmembers()
                    if m.isfile()]

    got = members(runs.b / "graphs.tgz")
    assert got and got == members(runs.j / "graphs.tgz")
    assert any("__compression1__" in name for name, _ in got)  # verbose
    assert _records(runs.b / "graphs.vcf.gz") == _records(
        runs.j / "graphs.vcf.gz")
