"""Tensor compute library (the ops layer) — the ported subset.

Importing this package registers the compute types with
marlin_tpu_torch.registry.computes.  What marlin_tpu/computes holds beyond
it, the NN surrogate (``LibtorchGibbsEnergy``, nn.py) and NEML2
(``NEML2TensorCompute``, neml2.py), is not ported yet; a deck naming one of
them fails at build with the registry's named error.
"""

from . import base, core, lbm, lbm_bc, mechanics  # noqa: F401
