"""Entry points of the port's window step and multi-device path, as
`__graft_entry__.py` is the JAX package's.

    from lancet2_tpu_torch.graft_entry import entry, dryrun_multichip
    step, args = entry("cuda")       # or entry("cpu")
    out = step(*args)
    dryrun_multichip(2)              # [cuda:0] * 2; dryrun_multichip(2, "cpu")

`entry(device)` returns the batched window step (fitting DP over all read x
haplotype pairs through K3, allele counting, DM genotyping) and its example
arguments on `device`, at `__graft_entry__.py`'s shapes: 2 windows, 16 reads
of 64 bases, 2 haplotypes of 192 bases, 2 samples, 2 alleles, seed 0.

`dryrun_multichip(n, device)` runs the JAX version's three dry runs on the
device list `[device] * n` (on a one-card host the same card n times, each
entry on its own stream; `[cpu] * n` on the CPU):
  1. the window step sharded over an n-entry mesh (banded DP engaged);
  2. the tuple-form evidence path with its launch chunks taking the devices
     in turn, against the one-pass plain version, and the sharded span
     dispatch (`span_arrays_sharded`) against one device's;
  3. the batch executor over the device list on a simulated tumor/normal
     fixture, its records against the threads executor's, with every span
     and evidence dispatch sharded (SPMD_STATS grow, plain_span_with_mesh
     stays 0).
Each raises AssertionError on a mismatch.
"""

from __future__ import annotations

import numpy as np
import torch

from lancet2_tpu_torch.ops.window_step import make_window_step, synth_window_batch

NUM_SAMPLES = 2
NUM_ALLELES = 2
STEP_KEYS = ("reads", "read_lens", "read_sample", "read_valid", "haps",
             "hap_lens", "hap_allele")


def _example_batch(num_windows: int, reads_per_window: int = 16,
                   read_len: int = 64, num_haps: int = 2, hap_len: int = 192):
    return synth_window_batch(
        np.random.default_rng(0), num_windows=num_windows,
        reads_per_window=reads_per_window, read_len=read_len,
        num_haps=num_haps, hap_len=hap_len, num_samples=NUM_SAMPLES)


def entry(device: torch.device | str = "cuda"):
    """(step, example_args) on `device`, a CUDA device unless the caller
    asks for the CPU."""
    step = make_window_step(NUM_SAMPLES, NUM_ALLELES, device=device)
    batch = _example_batch(num_windows=2)
    args = tuple(batch[k].to(device) for k in STEP_KEYS)
    return step, args


def _device_list(n_devices: int, device) -> list[torch.device]:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return [dev] * n_devices


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda"
                     ) -> None:
    """The three multi-device dry runs on `[device] * n_devices`."""
    devices = _device_list(n_devices, device)
    _dryrun_sharded_step(devices)
    _dryrun_evidence_multidevice(devices)
    _dryrun_batch_executor_multidevice(devices)


def _dryrun_sharded_step(devices) -> None:
    """One sharded window step over an n-entry mesh, against the same step
    on the first device alone."""
    from lancet2_tpu_torch.parallel.mesh import make_mesh, make_sharded_window_step

    n = len(devices)
    mesh = make_mesh(devices)
    # banded DP engaged: hap_len 384 > band width 192 (64-base reads + 2x64)
    fn, shard_inputs = make_sharded_window_step(
        mesh, NUM_SAMPLES, NUM_ALLELES, band_margin=64)
    batch = _example_batch(num_windows=2 * n, hap_len=384)
    out = fn(*shard_inputs(batch))
    assert out["pls"].shape == (2 * n, NUM_SAMPLES, 3)
    assert int(out["total_windows"]) == 2 * n
    # het windows must produce non-zero ALT depth across the mesh
    assert float(out["total_alt_depth"]) > 0.0
    one = make_window_step(NUM_SAMPLES, NUM_ALLELES, device=devices[0],
                           band_margin=64)(
        *(batch[k] for k in STEP_KEYS), read_offset=batch["read_offset"])
    for k, v in one.items():
        assert torch.equal(out[k].cpu(), v.cpu()), (
            f"sharded window step differs from one device on {k}")


def _dryrun_evidence_multidevice(devices) -> None:
    """The tuple-form evidence path with its chunks taking the devices in
    turn (simulator reads against a REF and an ALT haplotype), against the
    one-pass plain version on the CPU."""
    from lancet2_tpu_torch.base.dna import encode
    from lancet2_tpu_torch.caller import genotyper as gmod
    from lancet2_tpu_torch.ops.evidence_layout import R_MAX
    from lancet2_tpu_torch.utils.simulate import (
        ReadSimulator,
        Variant,
        random_reference,
    )

    ref = random_reference(400, seed=3)
    alt = "A" if ref[200] != "A" else "G"
    sim = ReadSimulator(ref, read_len=48, frag_mean=120, frag_sd=10, seed=3)

    class _Collect:
        def __init__(self):
            self.recs = []

        def add(self, rec):
            self.recs.append(rec)

    w = _Collect()
    sim.simulate([Variant(pos0=200, ref=ref[200], alt=alt, vaf=0.5)],
                 coverage=10.0, writer=w)
    hap_ref = ref[150:250]
    hap_alt = hap_ref[:50] + alt + hap_ref[51:]
    hap_codes = [encode(hap_ref), encode(hap_alt)]
    reads = [r for r in w.recs if 150 <= r.pos0 and r.pos0 + 48 <= 250][:16]
    assert len(reads) >= 4, "simulator must yield window-overlapping reads"

    pair_q, pair_qu, pair_t, pair_meta = [], [], [], []
    for ri, rec in enumerate(reads):
        for h, hap in enumerate(hap_codes):
            regions = np.zeros((R_MAX, 2), np.int32)
            regions[0] = (50, 51)
            pair_q.append(encode(rec.seq))
            pair_qu.append(np.asarray(rec.qual, np.uint8))
            pair_t.append(hap)
            pair_meta.append((ri, h, regions, [(0, h)]))

    saved = gmod._DEVICE_PAIR_CHUNK
    gmod._DEVICE_PAIR_CHUNK = 8  # several chunks, so every device launches
    try:
        got = gmod.Genotyper(backend="evidence", devices=list(devices)
                             ).run_evidence_pairs(pair_q, pair_qu, pair_t,
                                                  pair_meta)
    finally:
        gmod._DEVICE_PAIR_CHUNK = saved
    want = gmod.Genotyper(backend="evidence", device="cpu").run_evidence_pairs(
        pair_q, pair_qu, pair_t, pair_meta)
    for k in ("score", "t_end", "t_start", "nm", "qv", "aligned",
              "min_bq", "raw", "pbq", "matches"):
        assert np.array_equal(np.asarray(want[k]), np.asarray(got[k])), (
            f"multi-device evidence mismatch on {k}")

    _dryrun_evidence_spmd(devices)


def _dryrun_evidence_spmd(devices) -> None:
    """The sharded span dispatch over the whole mesh against one launch on
    the first device, on pair arrays whose count is no multiple of it."""
    from lancet2_tpu_torch.ops.evidence_cuda import (
        span_pairs_finalize,
        span_pairs_submit,
    )
    from lancet2_tpu_torch.parallel.evidence_spmd import span_arrays_sharded
    from lancet2_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(17)
    n, Lq, Lt = 70, 48, 128
    qs = rng.integers(0, 4, (n, Lq)).astype(np.uint8)
    qus = rng.integers(10, 40, (n, Lq)).astype(np.uint8)
    ts = rng.integers(0, 4, (n, Lt)).astype(np.uint8)
    qlens = rng.integers(Lq // 2, Lq + 1, n).astype(np.int64)
    tlens = rng.integers(Lt // 2, Lt + 1, n).astype(np.int64)

    got = span_arrays_sharded(make_mesh(devices), qs, qus, qlens, ts, tlens)
    dev = devices[0]

    def put(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)

    want = span_pairs_finalize(span_pairs_submit(
        put(qs, np.uint8), put(qlens, np.int32), put(ts, np.uint8),
        put(tlens, np.int32)))
    for k in want:
        assert np.array_equal(want[k], got[k]), f"sharded span mismatch on {k}"


def _dryrun_batch_executor_multidevice(devices) -> None:
    """A simulated tumor/normal fixture through the batch executor over the
    device list (prep threads, window batches of one, every span and
    evidence dispatch sharded), its records against the threads
    executor's on the first device."""
    import io
    import tempfile

    from lancet2_tpu_torch.caller import genotyper as gmod
    from lancet2_tpu_torch.cbdg.graph import GraphParams
    from lancet2_tpu_torch.core.batch_pipeline import TorchBatchPipelineExecutor
    from lancet2_tpu_torch.core.pipeline import PipelineExecutor
    from lancet2_tpu_torch.core.read_collector import CollectorParams
    from lancet2_tpu_torch.core.sample_info import make_sample_list
    from lancet2_tpu_torch.core.variant_builder import BuilderParams
    from lancet2_tpu_torch.core.window_builder import WindowBuilder, WindowParams
    from lancet2_tpu_torch.hts.fasta import Reference
    from lancet2_tpu_torch.parallel import evidence_spmd as spmd
    from lancet2_tpu_torch.utils.simulate import (
        Variant,
        make_tumor_normal_fixture,
    )

    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(ref_len=1200, normal_cov=10.0, tumor_cov=12.0, seed=5,
                  read_len=56, frag_mean=130.0, frag_sd=12.0)
        fx = make_tumor_normal_fixture(tmp, **kw)
        ref_seq = fx["ref_seq"]
        alt = "C" if ref_seq[650] != "C" else "G"
        fx = make_tumor_normal_fixture(
            tmp,
            somatic=[Variant(pos0=650, ref=ref_seq[650], alt=alt, vaf=0.5)],
            germline=[Variant(pos0=420, ref=ref_seq[420:424],
                              alt=ref_seq[420], vaf=0.5)],
            **kw,
        )
        ref = Reference(fx["fasta"])
        samples = make_sample_list([fx["normal"]], [fx["tumor"]], [])
        wb = WindowBuilder(ref, WindowParams())
        wb.add_whole_reference()
        wb.sort_input_regions()
        windows = wb.build_windows()
        params = BuilderParams(
            graph=GraphParams(num_samples=len(samples), min_anchor_cov=3),
            collector=CollectorParams(),
            aligner_backend="evidence",
            device=str(devices[0]),
        )

        def records(executor) -> list[str]:
            out = io.StringIO()
            executor.execute(out)
            return [l for l in out.getvalue().splitlines() if l]

        saved = gmod.SPMD_MIN_ROWS_PER_DEVICE
        # the fixture's small batches would fall below the production
        # threshold; shard every device phase so the contract is exercised
        gmod.SPMD_MIN_ROWS_PER_DEVICE = 1
        for k in gmod.MESH_FALLBACK_STATS:
            gmod.MESH_FALLBACK_STATS[k] = 0
        spmd_before = dict(spmd.SPMD_STATS)
        try:
            # prep threads: a spawned coordinator would re-import the
            # caller's __main__; the packed payloads are the same either way
            batch_recs = records(TorchBatchPipelineExecutor(
                params, ref, samples, list(windows), num_workers=2,
                window_batch=1, pair_chunk=256, prep_mode="threads",
                device=devices[0], devices=list(devices)))
        finally:
            gmod.SPMD_MIN_ROWS_PER_DEVICE = saved
        thread_recs = records(PipelineExecutor(
            params, ref, samples, list(windows), num_workers=1,
            device=devices[0]))
        assert batch_recs, "dryrun fixture must call variants"
        assert batch_recs == thread_recs, (
            "multi-device batch executor records diverge from the threads "
            "executor")
        assert spmd.SPMD_STATS["span_sharded"] > spmd_before["span_sharded"], (
            "mesh executor ran without any sharded span dispatch")
        assert spmd.SPMD_STATS["evidence_sharded"] > spmd_before[
            "evidence_sharded"], (
            "mesh executor ran without any sharded evidence dispatch")
        assert gmod.MESH_FALLBACK_STATS["plain_span_with_mesh"] == 0, (
            "mesh executor fell back to plain span dispatch")
