"""The port's prep-process faults, with tests/test_prep_fault_injection.py's
assertions, against TorchBatchPipelineExecutor(device="cpu",
prep_mode="processes"):

  * a fork prep worker SIGKILLed once a payload has arrived: the
    coordinator's fatal names the window seq, the executor raises within
    the deadline, and every /dev/shm segment of the run is reclaimed;
  * the coordinator SIGKILLed: detected, same reclaim;
  * an exception in the prep loop (prep threads, so that the monkeypatch
    reaches it): surfaced with its traceback;
  * a prep process or thread whose setup fails, before its loop: the
    coordinator's reader warm-up over s3:// inputs with no transport in the
    spawned process (SystemExit from hts_open), and a VariantBuilder that
    raises in each forked worker and in each prep thread. Each surfaces as
    "prepare failed" with the original exception and its traceback within
    30 s; the JAX package's prep processes exit 0 on the first two and the
    executor can only report a silent death;
  * the coordinator's own faults: windows still queued when every worker
    has exited are reported; a worker orphaned by a SIGKILLed coordinator
    reclaims the segment it holds instead of handing it over, and the
    executor then raises within the deadline with no segment of the run
    left.

The worker pids come from /proc/N/stat (tests/torch_cloud_jobs.child_pids),
as on the card's gVisor host. Fixture: the JAX tests' 30 kb, 20x/28x, seed
11, with the port's simulator; torch held to two intra-op threads.
"""

from __future__ import annotations

import os

import pytest
import torch

from torch_cloud_jobs import (
    fault_setup,
    make_executor,
    run_and_kill,
    setup_failures,
)

pytestmark = pytest.mark.skipif(
    not hasattr(os, "fork"), reason="fork prep workers need posix"
)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield fault_setup(str(tmp_path_factory.mktemp("torch_fault")))
    torch.set_num_threads(threads)


def _kill(setup, target):
    out = run_and_kill(make_executor(*setup, "cpu"), target)
    assert out["killed"] is not None, f"the killer never found its {target}"
    assert out["err"] is not None, f"the run completed despite a killed {target}"
    assert out["seconds"] < 60, out["seconds"]
    assert out["leaked"] in (None, set()), f"leaked shm segments: {out['leaked']}"
    return str(out["err"])


def test_worker_killed_mid_batch_fails_fast(setup):
    msg = _kill(setup, "worker")
    assert "died with exitcode" in msg and "window seq" in msg, msg


def test_coordinator_killed_detected(setup):
    msg = _kill(setup, "coordinator")
    assert ("coordinator died" in msg) or ("died with exitcode" in msg), msg


def test_worker_exception_surfaces_with_traceback(setup, monkeypatch):
    import io

    import lancet2_tpu_torch.core.batch_pipeline as bp

    real = bp.prepare_and_pack
    calls = {"n": 0}

    def poisoned(builder, genotyper, window, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise ValueError(f"injected fault at window {window.genome_index}")
        return real(builder, genotyper, window, *a, **kw)

    monkeypatch.setattr(bp, "prepare_and_pack", poisoned)
    ex = make_executor(*setup, "cpu", prep_mode="threads")
    with pytest.raises(RuntimeError) as ei:
        ex.execute(io.StringIO())
    msg = str(ei.value)
    assert "injected fault at window" in msg
    assert "ValueError" in msg


@pytest.fixture(scope="module")
def failed_setups(setup):
    return setup_failures(*setup, "cpu")


@pytest.mark.parametrize("where,error,origin", [
    ("coordinator", "SystemExit(\"no transport registered for cloud URI "
     "'s3://bkt/", "hts_open"),
    ("worker", "TypeError(", "LongdustQScorer"),
    ("thread", "TypeError(", "LongdustQScorer"),
])
def test_setup_failure_surfaces_with_traceback(failed_setups, where, error,
                                               origin):
    err, seconds = failed_setups[where]
    assert err is not None, f"the run completed despite a failing {where}"
    msg = str(err)
    assert msg.startswith("prepare failed: " + error), msg
    assert "Traceback (most recent call last)" in msg and origin in msg, msg
    assert "without reporting" not in msg, msg
    assert seconds < 30, seconds


# ---------------------------------------------------------------------------
# the coordinator's own faults
# ---------------------------------------------------------------------------

def test_coordinator_reports_windows_left_behind():
    """Every worker gone with windows still queued is a fatal naming them
    (each worker exits 0 only after a shutdown sentinel); sentinels alone
    left behind are a normal shutdown."""
    import multiprocessing as mp
    import types

    from lancet2_tpu_torch.core.prep_worker import _check_queue_drained

    workers = [types.SimpleNamespace(pid=101, exitcode=0),
               types.SimpleNamespace(pid=102, exitcode=0)]
    q = mp.get_context("spawn").Queue()
    for item in (None, (7, "window 7"), None, (8, "window 8")):
        q.put(item)
    with pytest.raises(RuntimeError, match=r"every prep worker exited "
                       r"\(pid 101 exitcode 0, pid 102 exitcode 0\) while "
                       r"windows \(seq\) \[7, 8\] were still queued"):
        _check_queue_drained(q, workers)
    for item in (None, None):
        q.put(item)
    _check_queue_drained(q, workers)
    q.close()
    q.join_thread()


def test_coordinator_killed_mid_batch_leaves_no_segment(setup):
    out = run_and_kill(make_executor(*setup, "cpu"), "coordinator mid-batch")
    assert out["killed"] == out["coordinator"] is not None, out
    assert out["err"] is not None, "the run completed without its coordinator"
    assert "coordinator died" in str(out["err"]), out["err"]
    assert out["seconds"] < 60, out["seconds"]
    assert out["leaked"] in (None, set()), f"leaked: {out['leaked']}"


# run in a fresh interpreter: it forks, and the test process has threads
ORPHAN_RUN = r"""
import json, multiprocessing as mp, os, queue, signal, time, types

import lancet2_tpu_torch.caller.genotyper as genotyper
import lancet2_tpu_torch.core.variant_builder as variant_builder
from lancet2_tpu_torch.core import prep_worker


def holding_prepare(*_a, shm_prefix=None, shm_notify=None, **_kw):
    _arrays, shm = prep_worker._alloc_pair_arrays(1, 1, 1, 1, 1, shm_prefix)
    shm_notify(shm.name)
    shm.close()
    coordinator = os.getppid()
    while os.getppid() == coordinator:
        time.sleep(0.01)
    return types.SimpleNamespace(pairs={"shm": shm.name})


variant_builder.VariantBuilder = lambda *a, **kw: None
genotyper.Genotyper = lambda *a, **kw: None
prep_worker.prepare_and_pack = holding_prepare
ctx = mp.get_context("fork")
work_q, result_q = ctx.Queue(), ctx.Queue()
# the coordinator's table of in-flight segment names, as coordinator_main
# gives its workers: the worker's watchdog reclaims from it too
shm_slots = ctx.Array("B", prep_worker._SHM_SLOT_W, lock=False)


def coordinator_main():
    ctx.Process(target=prep_worker.process_worker_main,
                args=(work_q, result_q, None, None, [], {}, 0, 0, (), ()),
                kwargs={"shm_slots": shm_slots}).start()
    time.sleep(60)


coord = ctx.Process(target=coordinator_main)
coord.start()
work_q.put((0, "window"))
prefix = f"{prep_worker.SHM_PREFIX}{coord.pid}_"


def segments():
    return sorted(e for e in os.listdir("/dev/shm") if e.startswith(prefix))


stop = time.monotonic() + 30
while not segments() and time.monotonic() < stop:
    time.sleep(0.01)
held = segments()
os.kill(coord.pid, signal.SIGKILL)
coord.join()
stop = time.monotonic() + 5
while segments() and time.monotonic() < stop:
    time.sleep(0.05)
left = segments()
for name in left:
    prep_worker.unlink_segment(name)
try:
    handed = result_q.get(timeout=0.5) is not None
except queue.Empty:
    handed = False
print(json.dumps({"held": held, "left": left, "handed": handed}))
"""


def test_orphaned_worker_hands_over_no_segment():
    """A stand-in coordinator forks one prep worker and is SIGKILLed while
    the worker holds its window's segment (a stand-in prepare that returns
    once its coordinator is gone); the segment must be gone and nothing
    handed over."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", ORPHAN_RUN],
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["held"]) == 1, out
    assert out["left"] == [], f"the orphaned worker left {out['left']}"
    assert not out["handed"], "the orphaned worker handed its payload over"
