"""lancet2_tpu_torch — the PyTorch/CUDA port of the lancet2_tpu caller.

The JAX package (`lancet2_tpu`) stays the reference. This package imports
nothing of it: its host layers (BAM/FASTA IO, windowing, read collection,
assembly, variant extraction, pair-index building, evidence assembly,
VariantCall and the VCF store) are copies at the same subpackage paths, and
it ports what touched JAX:

    ops      - the evidence DP (K1 span, K2 evidence) and the score-only
               fitting DP (K3): plain PyTorch versions and hand-written CUDA
               kernels (csrc/), the pool gathers, the DM PLs and the batched
               window step
    caller   - TorchGenotyper: the two-pass span -> gate -> crop -> evidence
               device half of the genotyper
    core     - TorchBatchPipelineExecutor: the batch executor on one device
    cli      - `python -m lancet2_tpu_torch pipeline --device {cpu,cuda}`
    graft_entry - entry(device): the window step and its example inputs

The package imports torch and never jax. The device is always explicit: a
`torch.device` is passed down from the CLI or the caller.
"""

__version__ = "0.1.0"
