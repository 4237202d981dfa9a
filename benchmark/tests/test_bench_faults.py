"""A run with the timed path broken underneath comes out not correct.

Each test drives the harness on the CPU (the port's plain versions; the
look for a card is skipped) over a few windows of the somatic cell: the
inputs from the seed, one job through `run_pipeline`, the reference's
judgement, at half the cell's depths so that the CPU holds it. The
faults a one-chip calling job can have: half of the
windows' answers left out, every answer written twice, an answer altered
where it is produced, and the evidence step returning its state
unchanged. The exchange between
chips does not exist on one chip.
"""

import os

import numpy as np
import pytest

import bench_helpers as H  # noqa: F401
import run as R

WINDOWS = 16
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    cache = tmp_path_factory.mktemp("cache")
    R.CACHE = str(cache)
    cell = R.load_cell("somatic.wgs")
    cell["depths"] = {k: v / 2 for k, v in cell["depths"].items()}
    fx = R.prepare_inputs(cell, str(SEED), WINDOWS, SEED, 4)
    return cell, fx


def judged(cell, fx, name):
    out = os.path.join(fx["dir"], name + ".vcf.gz")
    run = R.run_job(cell, fx, out, "cpu", 4)
    checks = R.judge(cell, fx, out, run.windows)
    return checks, R.verdict(checks)


def test_sound_run(job):
    checks, _ = judged(*job, "sound")
    assert checks["windows_missing"]["value"] == 0
    assert checks["likelihood_mismatches"]["value"] == 0
    assert checks["missed_share"]["value"] < 0.5
    assert R.forbidden_modules() == []


@pytest.mark.parametrize("inputs", ["cram", "s3"])
def test_inputs_served_another_way_give_a_sound_run(job, inputs):
    """A traffic mix that serves the reads as CRAM or over the s3
    transport runs the same job and is judged alike."""
    cell, base = job
    cell = {**cell, "name": f"{cell['name']}.{inputs}", "inputs": inputs}
    fx = R.prepare_inputs(cell, str(SEED), WINDOWS, SEED, 4)
    assert fx["bams"] != fx["inputs"] and fx["truth"] == base["truth"]
    assert all(p.endswith(".cram") if inputs == "cram" else
               p.startswith("s3://") for p in fx["inputs"].values())
    checks, ok = judged(cell, fx, inputs)
    assert ok, checks


def test_half_of_the_windows_left_out(job, monkeypatch):
    from lancet2_tpu_torch.core.variant_store import VariantStore

    # the calls of every other 800-bp step of the contig (a window's step)
    add = VariantStore.add_variants
    monkeypatch.setattr(VariantStore, "add_variants", lambda self, calls: add(
        self, [c for c in calls if ((c.pos1 - 1) // 800) % 2 == 0]))
    checks, ok = judged(*job, "half")
    assert not ok and checks["missed_share"]["value"] > \
        checks["missed_share"]["limit"]


def test_every_call_written_twice(job, monkeypatch):
    from lancet2_tpu_torch.core.variant_store import VariantStore

    # where the records are written: the store keeps one call per identity
    flush = VariantStore._flush
    monkeypatch.setattr(VariantStore, "_flush", staticmethod(
        lambda calls, out: flush([c for c in calls for _ in (0, 1)], out)))
    checks, ok = judged(*job, "twice")
    assert not ok and checks["extra_share"]["value"] > \
        checks["extra_share"]["limit"]
    assert checks["missed_share"]["value"] <= checks["missed_share"]["limit"]


def test_an_answer_altered_where_it_is_produced(job, monkeypatch):
    from lancet2_tpu_torch.caller.variant_call import VariantCall

    as_record = VariantCall.as_vcf_record
    seen = []

    def altered(self):
        line = as_record(self)
        if seen:
            return line
        seen.append(1)
        cols = line.split("\t")
        fmt = cols[10].split(":")  # the tumor's column
        fmt[23] = str(int(fmt[23]) - 1 if int(fmt[23]) > 0 else 1)  # GQ
        cols[10] = ":".join(fmt)
        return "\t".join(cols)

    monkeypatch.setattr(VariantCall, "as_vcf_record", altered)
    checks, ok = judged(*job, "altered")
    assert seen and not ok
    assert checks["likelihood_mismatches"]["value"] == 1


def test_the_evidence_step_returns_its_state_unchanged(job, monkeypatch):
    from lancet2_tpu_torch.caller.genotyper import TorchGenotyper
    from lancet2_tpu_torch.ops.evidence_layout import (
        R_MAX,
        REGION_FILL,
        SPAN_KEYS,
    )

    def unchanged(self, st):
        n = st["n"]
        outs = {k: np.zeros(n, np.int64) for k in SPAN_KEYS}
        for k, fill in REGION_FILL.items():
            dt = np.float64 if isinstance(fill, float) else np.int64
            outs[k] = np.full((n, R_MAX), fill, dt)
        return outs

    monkeypatch.setattr(TorchGenotyper, "finish_evidence_indexed", unchanged)
    checks, ok = judged(*job, "unchanged")
    assert not ok and checks["missed_share"]["value"] > \
        checks["missed_share"]["limit"]
