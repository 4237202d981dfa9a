"""Spawn target of the port's phase-A prep coordinator.

Phase A is the JAX package's own host code (`lancet2_tpu.core.prep_worker`),
run as it is. One snag: `Genotyper.build_pair_indices` imports
`lancet2_tpu.ops.evidence_dp` for the constant R_MAX, and that module imports
jax at its top. So before the reference coordinator starts, this process
registers a stand-in for that module that holds R_MAX alone. The coordinator
is a fresh spawned process that runs phase A only, so nothing in it needs
the engine itself; an attribute it lacked would fail loudly.

This module imports neither torch nor jax: the spawned coordinator and the
prep workers it forks stay free of both.
"""

from __future__ import annotations

import sys
import types

R_MAX = 4  # lancet2_tpu.ops.evidence_dp.R_MAX (held equal by the tests)
_ENGINE = "lancet2_tpu.ops.evidence_dp"


def install_engine_constants() -> None:
    """Register the R_MAX-only stand-in for the reference engine module,
    unless the real module is already loaded."""
    if _ENGINE not in sys.modules:
        import lancet2_tpu.ops  # noqa: F401  (the parent package)

        stand_in = types.ModuleType(_ENGINE, "R_MAX of the evidence engine")
        stand_in.R_MAX = R_MAX
        sys.modules[_ENGINE] = stand_in


def coordinator_main(*args) -> None:
    install_engine_constants()
    from lancet2_tpu.core.prep_worker import coordinator_main as run

    run(*args)
