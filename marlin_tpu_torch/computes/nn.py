"""Neural-network constitutive models (the port of marlin_tpu/computes/nn.py).

LibtorchGibbsEnergy (reference src/tensor_computes/LibtorchGibbsEnergy.C:
28-115): a TorchScript Gibbs-energy surrogate G(eta..., c...) whose autograd
jacobian supplies chemical potentials and Allen-Cahn driving forces.

The model runs as itself: ``torch.jit.load`` onto the compute's device, cast
to the domain's dtype, and its jacobian from ``torch.autograd.grad``, as the
reference does.  The JAX package's ``torchscript_to_jax`` (the graph lifter
that rebuilds a TorchScript graph from jnp ops, and its host fallback) has
no counterpart here: it is how the JAX package gets a TorchScript graph onto
its device, and this package's device runs the graph directly.

The cast follows the JAX package's lifted rule (weights in the domain's
dtype).  Where the JAX package cannot lift a graph it evaluates it on the
host in the model's own dtype; there the two packages differ by that
dtype's rounding (ROADMAP §3).

The graph runs under ``torch.jit.optimized_execution(False)``: TorchScript's
profiling executor otherwise re-specialises a graph after its first calls
and may fuse it, so that call 1 and call 3 on one input round differently;
without it every call runs the same kernels and a repeated evaluation is
bit-identical.  Matmuls run with TF32 off (``marlin_tpu_torch/__init__.py``).
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import torch

from ..params import Params
from ..registry import computes
from .base import ComputeError, Spec, TensorCompute

#: search roots for MOOSE-style `app:relative/path` data files; none yet:
#: the reference's data files are not in the repository (ROADMAP §1 item 6)
DATA_ROOTS: list = []


def resolve_data_file(path: str, deck_dir=None) -> str:
    """A deck's data file: ``app:relative/path`` under the data roots; an
    absolute path as is; else relative to the deck, the working directory
    or a data root, or a bare file name anywhere under a data root."""
    if ":" in path and not os.path.isabs(path):
        _app, rel = path.split(":", 1)
        for root in DATA_ROOTS:
            candidate = os.path.join(root, rel)
            if os.path.exists(candidate):
                return candidate
        raise ComputeError(f"Data file '{path}' not found under {DATA_ROOTS}")
    if os.path.isabs(path):
        return path
    for base in filter(None, [deck_dir, "."] + DATA_ROOTS):
        candidate = os.path.join(base, path)
        if os.path.exists(candidate):
            return candidate
    # MOOSE's installed-data search: a bare filename resolves anywhere
    # under the registered data roots
    for root in DATA_ROOTS:
        hits = glob.glob(os.path.join(root, "**", os.path.basename(path)), recursive=True)
        if hits:
            return sorted(hits)[0]  # deterministic across filesystems
    raise ComputeError(f"Data file '{path}' not found")


def gibbs_and_jacobian(model, X: torch.Tensor):
    """G (N,) and dG/dX (N, n_in) of a Gibbs module at the rows of X
    (N, n_in): rows are independent, so the gradient of ΣG is the per-row
    jacobian.  Detached: no autograd graph leaves the call."""
    with torch.enable_grad(), torch.jit.optimized_execution(False):
        x = X.detach().requires_grad_(True)
        G = model(x).squeeze()
        (jac,) = torch.autograd.grad(G.sum(), x)
    return G.detach().reshape(X.shape[0]), jac.detach()


@computes.register("LibtorchGibbsEnergy")
class LibtorchGibbsEnergy(TensorCompute):
    """G = model(X) on X = (phase fractions..., concentrations...) stacked
    per point, and its jacobian split into ``domega_detas`` (one a phase)
    and ``chem_pots`` (one a concentration).  Returns detached tensors: no
    autograd graph reaches the state."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.phase_fractions = params.get_str_vector("phase_fractions", required=True)
        self.concentrations = params.get_str_vector("concentrations", required=True)
        self.domega_detas = params.get_str_vector("domega_detas", required=True)
        self.chem_pots = params.get_str_vector("chem_pots", required=True)
        if len(self.phase_fractions) != len(self.domega_detas):
            params.error(
                "domega_detas", "Number of phases must match number of domega_deta buffers."
            )
        if len(self.concentrations) != len(self.chem_pots):
            params.error(
                "chem_pots",
                "Number of concentrations must match number of chemical potential buffers.",
            )
        for n in self.phase_fractions + self.concentrations:
            if n not in self.inputs:
                self.inputs.append(n)
        self.G_buffer = self.out  # the `buffer` param names the Gibbs buffer
        self.outputs = [self.G_buffer] + self.domega_detas + self.chem_pots

        model_path = resolve_data_file(
            params.get_str("libtorch_model_file", required=True),
            getattr(problem, "deck_dir", None),
        )
        self.model = torch.jit.load(model_path, map_location=self.domain.device)
        self.model.eval()
        self.model.to(self.domain.dtype)

    def evaluate(self, X: torch.Tensor):
        """G (N,) and dG/dX (N, n_in) at the rows of X (N, n_in)."""
        return gibbs_and_jacobian(self.model, X)

    def apply(self, state, ctx):
        names = self.phase_fractions + self.concentrations
        X = torch.stack([state[n] for n in names], -1)
        batch_shape = X.shape[:-1]
        G, jac = self.evaluate(X.reshape(-1, X.shape[-1]))
        out: Dict[str, torch.Tensor] = {self.G_buffer: G.reshape(batch_shape)}
        for k, name in enumerate(self.domega_detas + self.chem_pots):
            out[name] = jac[:, k].reshape(batch_shape)
        return out

    def output_specs(self, specs):
        names = self.phase_fractions + self.concentrations
        shape = torch.broadcast_shapes(*[specs[n].shape for n in names])
        dtype = specs[names[0]].dtype
        return {name: Spec(tuple(shape), dtype) for name in self.outputs}
