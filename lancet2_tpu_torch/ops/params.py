"""Kernel parameters carried across from the JAX package.

The caller has no weights. Its "parameters" are the read->haplotype scoring
(`READ_TO_HAP`, ops/affine_dp.py) and the Phred->confidence table
(`PHRED_TO_CONFIDENCE`, base/phred.py). This package keeps its own copies of
both modules; `from_jax` turns the values into the ints and the float32 table
that the plain versions and the CUDA kernels take. It reads only the
dataclass fields and the table's values, so it takes the JAX package's
objects as well (the tests hold the two copies equal).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lancet2_tpu_torch.base.phred import PHRED_TO_CONFIDENCE
from lancet2_tpu_torch.ops.affine_dp import READ_TO_HAP, AlignParams


@dataclass(frozen=True)
class KernelParams:
    match: int
    mismatch: int
    gap_open: int
    gap_extend: int
    conf: torch.Tensor  # [256] float32: confidence of each Phred value

    def to(self, device: torch.device) -> "KernelParams":
        if self.conf.device == device:
            return self
        return KernelParams(self.match, self.mismatch, self.gap_open,
                            self.gap_extend, self.conf.to(device))


def kernel_fits(align_params: AlignParams) -> bool:
    """The kernels run the fitting single-affine mode only."""
    return not align_params.dual and align_params.free_target_ends


def from_jax(align_params: AlignParams = READ_TO_HAP,
             conf_table=PHRED_TO_CONFIDENCE) -> KernelParams:
    """Turn a scoring dataclass (the fields match, mismatch, gap_open1,
    gap_extend1, dual, free_target_ends) and a 256-entry confidence table
    into KernelParams. Only the fitting single-affine mode is ported."""
    if not kernel_fits(align_params):
        raise NotImplementedError(
            "the evidence DP covers the fitting single-affine mode only")
    conf = np.asarray(conf_table, np.float32)
    if conf.shape != (256,):
        raise ValueError(f"confidence table must have 256 entries, got {conf.shape}")
    return KernelParams(
        match=int(align_params.match),
        mismatch=int(align_params.mismatch),
        gap_open=int(align_params.gap_open1),
        gap_extend=int(align_params.gap_extend1),
        conf=torch.from_numpy(conf.copy()),
    )


READ_TO_HAP_PARAMS = from_jax()
