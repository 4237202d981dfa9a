"""Seeded tumor/normal fixtures for the port's runs.

The simulator of the JAX package (`lancet2_tpu/utils/simulate.py`) is host
code that imports no jax; the port reuses it as it is. Scripts that drive the
port (chip_smoke.py) take their inputs from here, so that they import the
port alone.
"""

from lancet2_tpu.utils.simulate import make_chr_scale_fixture

__all__ = ["make_chr_scale_fixture"]
