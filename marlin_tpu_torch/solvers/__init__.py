"""Time integration solvers (marlin_tpu/solvers).

Importing this package registers the solver types with
marlin_tpu_torch.registry.solvers, and the predictors with
registry.predictors.  A timestep runs eagerly: the substep loop, and an
iterative solver's iterations, are Python loops over torch operations.
"""

from . import abm, abm_coupled, base, broyden, etdrk4, forward_euler  # noqa: F401
from . import lbm_stream, predictors, secant  # noqa: F401
