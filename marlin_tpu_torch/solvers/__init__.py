"""Time integration solvers — the ported subset of marlin_tpu/solvers.

Importing this package registers the solver types with
marlin_tpu_torch.registry.solvers.  A timestep runs eagerly: the substep
loop is a Python loop over torch operations.
"""

from . import abm, base, lbm_stream  # noqa: F401
