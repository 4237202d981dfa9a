"""The port's cloud inputs and outputs, with tests/test_cloud_transport.py's
cases, on the CPU:

  * the port's default command (batch executor) with s3:// inputs and an
    s3:// output: the transport lives in this process, so `auto` preps in
    threads and says so in one log line; its records equal, byte for byte,
    the JAX package's default command (threads executor) on the same s3
    objects; with --prep-mode processes it refuses the s3 inputs before
    spawning, naming the scheme and --prep-mode threads;
  * the port's CLI over http with forked prep workers (the spawned
    coordinator builds its own http transport): its records equal the
    port's local-path run and the JAX package's s3 run;
  * the transports in this process: the zero-byte preflight, the ranged
    reader and writer, a BAM read and a bgzip VCF written through an
    in-memory s3 transport, and ranged reads over a loopback http server.

The port's CLI runs go through tests/torch_cloud_jobs.py in two processes,
started before the JAX run and awaited after, with two intra-op threads
each; neither may load jax or lancet2_tpu. Fixture: 4 kb, a somatic SNV at
2000, 25x/35x, seed 5; the runs take -R chrS:1500-2500 (2 windows).
"""

from __future__ import annotations

import gzip
import os

import pytest

from lancet2_tpu.cli.main import build_parser as jax_parser
from lancet2_tpu.cli.main import run_pipeline as jax_run_pipeline
from lancet2_tpu.hts import uri as jax_uri
from lancet2_tpu_torch.hts import uri
from torch_cloud_jobs import (
    CLOUD_SNV,
    THREADS_FOR_LOCAL_TRANSPORT,
    PortProcess,
    RangeServer,
    cloud_fixture,
)

REGION = "chrS:1500-2500"


def _records(path) -> list[str]:
    with gzip.open(path, "rt") as fh:
        return [l for l in fh.read().splitlines() if l and not l.startswith("#")]


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return cloud_fixture(str(tmp_path_factory.mktemp("torch_cloud")))


@pytest.fixture(scope="module")
def cli_runs(fx, tmp_path_factory):
    """The port's CLI runs (two processes) beside the JAX package's s3 run
    (this process). Returns (port results by name, JAX records, the
    directory of the port's outputs)."""
    tmp = tmp_path_factory.mktemp("torch_cloud_cli")
    objects = {"s3://bkt/normal.bam": fx["normal"],
               "s3://bkt/tumor.bam": fx["tumor"]}
    s3_argv = ["pipeline", "-n", "s3://bkt/normal.bam", "-t",
               "s3://bkt/tumor.bam", "-r", fx["fasta"], "-o",
               "s3://bkt/out.vcf.gz", "-R", REGION, "-T", "1", "--device",
               "cpu"]
    jobs_a = [
        {"kind": "s3", "argv": s3_argv, "objects": objects,
         "vcf": str(tmp / "s3.vcf.gz")},
        {"kind": "s3", "argv": s3_argv + ["--prep-mode", "processes"],
         "objects": objects, "vcf": str(tmp / "s3_processes.vcf.gz")},
    ]
    local = ["-r", fx["fasta"], "-R", REGION, "-T", "1", "--device", "cpu"]
    jobs_b = [
        {"kind": "http", "argv": ["pipeline", "-n", "{base}/normal.bam",
                                  "-t", "{base}/tumor.bam", "-o",
                                  str(tmp / "http.vcf.gz"), *local],
         "files": {"normal.bam": fx["normal"], "tumor.bam": fx["tumor"]}},
        {"kind": "cli", "argv": ["pipeline", "-n", fx["normal"], "-t",
                                 fx["tumor"], "-o", str(tmp / "local.vcf.gz"),
                                 *local]},
    ]
    procs = [PortProcess(jobs_a, ["s3", "s3_processes"], tmp),
             PortProcess(jobs_b, ["http", "local"], tmp)]
    try:
        jax_s3 = jax_uri.MemTransport()
        for key, path in objects.items():
            with open(path, "rb") as fh:
                jax_s3.blobs[key] = fh.read()
        jax_uri.register_transport("s3", jax_s3)
        try:
            argv = s3_argv[:-2]  # the JAX CLI has no --device
            stats = jax_run_pipeline(jax_parser().parse_args(argv),
                                     "lancet2-tpu " + " ".join(argv))
        finally:
            jax_uri.unregister_transport("s3")
        assert stats["windows"] == 2
        assert "s3://bkt/out.vcf.gz.preflight" in jax_s3.blobs
        jax_records = [
            l for l in gzip.decompress(jax_s3.blobs["s3://bkt/out.vcf.gz"])
            .decode().splitlines() if l and not l.startswith("#")]
        port = {**procs[0].results(), **procs[1].results()}
    finally:
        for p in procs:
            p.stop()
    return port, jax_records, tmp


def test_cli_pipeline_cloud_inputs_and_output(cli_runs):
    """s3:// BAMs in, an s3:// VCF out, on the port's default command: the
    JAX package's records for the same command, byte for byte."""
    port, jax_records, tmp = cli_runs
    run = port["s3"]
    assert run["exit"] == 0 and run["windows"] == 2, run
    assert "s3://bkt/out.vcf.gz.preflight" in run["objects"]
    assert any(m.startswith(THREADS_FOR_LOCAL_TRANSPORT)
               for m in run["log"]), run["log"]
    records = _records(tmp / "s3.vcf.gz")
    assert any(l.split("\t")[1] == str(CLOUD_SNV + 1) for l in records), records
    assert records == jax_records


def test_cli_prep_processes_refuses_local_transport(cli_runs):
    port, _jax, tmp = cli_runs
    err = port["s3_processes"].get("error", "")
    assert err.startswith("ValueError('--prep-mode processes: the s3:// "
                          "inputs"), port["s3_processes"]
    assert "use --prep-mode threads" in err
    assert not os.path.exists(tmp / "s3_processes.vcf.gz")


def test_cli_pipeline_http_inputs(cli_runs):
    """BAMs streamed over a loopback socket to forked prep workers: the
    local-path run's records."""
    port, jax_records, tmp = cli_runs
    run = port["http"]
    assert run["exit"] == 0 and run["windows"] == 2, run
    assert any(m.startswith("prep: spawned coordinator + ")
               for m in run["log"]), run["log"]
    records = _records(tmp / "http.vcf.gz")
    assert any(l.split("\t")[1] == str(CLOUD_SNV + 1) for l in records), records
    assert records == _records(tmp / "local.vcf.gz") == jax_records


# ---------------------------------------------------------------------------
# the transports, in this process (the port's modules only)
# ---------------------------------------------------------------------------

@pytest.fixture
def mem_s3():
    t = uri.MemTransport()
    uri.register_transport("s3", t)
    yield t
    uri.unregister_transport("s3")


def test_preflight_read_and_write(mem_s3):
    mem_s3.blobs["s3://bkt/in.bam"] = b"x" * 10
    uri.validate_cloud_access(["s3://bkt/in.bam"], mode="read")
    with pytest.raises(SystemExit, match="preflight failed"):
        uri.validate_cloud_access(["s3://bkt/missing.bam"], mode="read")
    uri.validate_cloud_access(["s3://bkt/out.vcf.gz"], mode="write")
    assert "s3://bkt/out.vcf.gz.preflight" in mem_s3.blobs
    with pytest.raises(SystemExit, match="no transport is registered"):
        uri.validate_cloud_access(["gs://bkt/in.bam"], mode="read")


def test_ranged_reader_and_writer_roundtrip(mem_s3):
    payload = os.urandom(9_000_000)  # more than two 4 MB ranged reads
    mem_s3.blobs["s3://bkt/blob"] = payload
    with uri.hts_open("s3://bkt/blob", "rb") as fh:
        assert fh.read(100) == payload[:100]
        fh.seek(8_000_000)
        assert fh.read() == payload[8_000_000:]
    assert len(mem_s3.range_requests) >= 2

    with uri.hts_open("s3://bkt/out", "wb") as fh:
        fh.write(b"hello ")
        fh.write(b"world")
    assert mem_s3.blobs["s3://bkt/out"] == b"hello world"


def test_bam_read_through_transport(fx, mem_s3):
    from lancet2_tpu_torch.hts.bam import open_bam, read_bam_header

    with open(fx["tumor"], "rb") as fh:
        mem_s3.blobs["s3://bkt/tumor.bam"] = fh.read()
    assert read_bam_header("s3://bkt/tumor.bam") == read_bam_header(
        fx["tumor"])
    cloud = list(open_bam("s3://bkt/tumor.bam").fetch("chrS", 1900, 2100))
    local = list(open_bam(fx["tumor"]).fetch("chrS", 1900, 2100))
    assert len(cloud) == len(local) > 0
    assert all(a.qname == b.qname and a.pos0 == b.pos0
               for a, b in zip(cloud, local))


def test_vcf_write_through_transport(mem_s3):
    from lancet2_tpu_torch.hts.bgzf import BgzfWriter

    w = BgzfWriter("s3://bkt/out.vcf.gz")
    w.write(b"##fileformat=VCFv4.5\n")
    w.write(b"chrS\t100\t.\tA\tT\t10\t.\t.\n")
    w.close()
    blob = mem_s3.blobs["s3://bkt/out.vcf.gz"]
    assert gzip.decompress(blob).startswith(b"##fileformat")
    assert blob.endswith(bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000"))


def test_http_transport_ranged_reads():
    payload = os.urandom(6_000_000)
    with RangeServer({"blob.bin": payload}) as server:
        url = f"{server.base}/blob.bin"
        uri.validate_cloud_access([url], mode="read")
        with uri.hts_open(url, "rb") as fh:
            assert fh.read(100) == payload[:100]
            fh.seek(5_000_000)
            assert fh.read() == payload[5_000_000:]
