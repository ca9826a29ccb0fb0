"""Tensor compute library (the ops layer).

Importing this package registers the compute types with
marlin_tpu_torch.registry.computes: the core spectral computes, lattice
Boltzmann, FFT micromechanics, the NN surrogate (``LibtorchGibbsEnergy``,
nn.py) and NEML2 (``NEML2TensorCompute`` and its 56 model types, neml2.py).
"""

from . import base, core, lbm, lbm_bc, mechanics, neml2, nn  # noqa: F401
