"""Tensor compute library (the ops layer) — the ported subset.

Importing this package registers the compute types with
marlin_tpu_torch.registry.computes.  The rest of marlin_tpu/computes
(mechanics, NN, NEML2, the remaining core and LBM types) is not ported yet;
a deck naming one of them fails at build with the registry's named error.
"""

from . import base, core, lbm, lbm_bc  # noqa: F401
