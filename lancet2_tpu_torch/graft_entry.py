"""Entry point of the port's window step, as `__graft_entry__.py` is the JAX
package's.

    from lancet2_tpu_torch.graft_entry import entry
    step, args = entry("cuda")       # or entry("cpu")
    out = step(*args)

`entry(device)` returns the batched window step (fitting DP over all read x
haplotype pairs through K3, allele counting, DM genotyping) and its example
arguments on `device`, at `__graft_entry__.py`'s shapes: 2 windows, 16 reads
of 64 bases, 2 haplotypes of 192 bases, 2 samples, 2 alleles, seed 0. The
multi-device dry run (`dryrun_multichip`) belongs to the multi-GPU path and
is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from lancet2_tpu_torch.ops.window_step import make_window_step, synth_window_batch

NUM_SAMPLES = 2
NUM_ALLELES = 2


def entry(device: torch.device | str = "cuda"):
    """(step, example_args) on `device`, a CUDA device unless the caller
    asks for the CPU."""
    step = make_window_step(NUM_SAMPLES, NUM_ALLELES, device=device)
    batch = synth_window_batch(
        np.random.default_rng(0), num_windows=2, reads_per_window=16,
        read_len=64, num_haps=2, hap_len=192, num_samples=NUM_SAMPLES)
    args = tuple(batch[k].to(device) for k in (
        "reads", "read_lens", "read_sample", "read_valid", "haps",
        "hap_lens", "hap_allele"))
    return step, args
