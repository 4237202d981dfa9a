"""lancet2_tpu_torch — the PyTorch/CUDA port of the lancet2_tpu caller.

The JAX package (`lancet2_tpu`) stays the reference. This package reuses its
jax-free host layers (BAM/FASTA IO, windowing, read collection, assembly,
variant extraction, pair-index building, evidence assembly, VariantCall and
the VCF store) as they are, and ports what touched JAX:

    ops      - the evidence DP: a plain PyTorch version and a hand-written
               CUDA kernel (csrc/evidence_dp.cu) for the span (R=0) and
               evidence (R in {1, 2, 4}) passes, plus the pool gathers
    caller   - TorchGenotyper: the two-pass span -> gate -> crop -> evidence
               device half of the genotyper
    core     - TorchBatchPipelineExecutor: the batch executor on one device
    cli      - `python -m lancet2_tpu_torch pipeline --device {cpu,cuda}`

The package imports torch and never jax. The device is always explicit: a
`torch.device` is passed down from the CLI.
"""

__version__ = "0.1.0"
