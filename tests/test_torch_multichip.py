"""The port's multi-device dry run on the CPU: `graft_entry.dryrun_multichip`
on `[cpu] * 2` runs the JAX version's three dry runs (the sharded window
step, the multi-device evidence paths, the batch executor over the device
list against the threads executor) and asserts, as the JAX version does,
that the batch executor's span and evidence dispatches were sharded and
that no span dispatch fell back to one device. The card runs the same dry
run on `[cuda:0] * 2` (chip_smoke.py phase 11)."""

from __future__ import annotations

import pytest
import torch

from lancet2_tpu_torch import graft_entry
from lancet2_tpu_torch.caller import genotyper as gmod
from lancet2_tpu_torch.parallel import evidence_spmd as spmd


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_dryrun_multichip_on_two_cpu_entries():
    before = dict(spmd.SPMD_STATS)
    graft_entry.dryrun_multichip(2, "cpu")
    assert spmd.SPMD_STATS["span_sharded"] > before["span_sharded"]
    assert spmd.SPMD_STATS["evidence_sharded"] > before["evidence_sharded"]
    assert gmod.MESH_FALLBACK_STATS["plain_span_with_mesh"] == 0
    # the dry run restores the production sharding threshold
    assert gmod.SPMD_MIN_ROWS_PER_DEVICE == 128
