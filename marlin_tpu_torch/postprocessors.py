"""Postprocessors: scalar reductions over tensor buffers, reported to CSV.

The ported subset of marlin_tpu/postprocessors.py (reference
src/postprocessors/).  A tensor postprocessor is a function
``(state, ctx) -> 0-d tensor``; the problem fetches every tensor value of
an output point to the host in one transfer.  A postprocessor with
``depends_on_pps`` (``ParsedPostprocessor``) is evaluated after that
transfer, on the host, from the values fetched (``compute_host``).
"""

from __future__ import annotations

import math

import torch

from .expression import CompiledExpression
from .params import Params
from .registry import postprocessors


class Postprocessor:
    default_execute_on = ["TIMESTEP_END"]

    def __init__(self, name: str, params: Params, problem):
        self.name = name
        self.params = params
        self.problem = problem
        self.domain = problem.domain
        self.execute_on = set(
            x.upper()
            for x in params.get_str_vector("execute_on", default=self.default_execute_on)
        )

    def history_requests(self):
        return {}

    def check(self, problem):
        """Cross-postprocessor validation; runs after ALL pps are built
        (deck declaration order must not matter)."""

    def compute(self, state, ctx):
        raise NotImplementedError


class TensorPostprocessor(Postprocessor):
    """Base for buffer-reading PPs (reference TensorPostprocessor.C:1-26)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.buffer = params.get_str("buffer", required=True)


@postprocessors.register("TensorAveragePostprocessor")
class TensorAveragePostprocessor(TensorPostprocessor):
    """Mean over the grid (reference TensorAveragePostprocessor.C)."""

    def compute(self, state, ctx):
        u = state["buffers"][self.buffer]
        return torch.sum(u) / u.numel()


@postprocessors.register("TensorIntegralPostprocessor")
class TensorIntegralPostprocessor(TensorAveragePostprocessor):
    """Mean · domain volume (reference TensorIntegralPostprocessor.C:29-45)."""

    def compute(self, state, ctx):
        return super().compute(state, ctx) * self.domain.volume_global


def _n_old(state, buffer) -> int:
    """Valid old states of ``buffer`` (a host int: n_advances is one)."""
    return min(state["n_advances"], state["old"][buffer].shape[0])


@postprocessors.register("TensorIntegralChangePostprocessor")
class TensorIntegralChangePostprocessor(TensorPostprocessor):
    """Σ|u − u_old| · Π h_d, or Σ|u| · Π h_d before the first advance
    (reference TensorIntegralChangePostprocessor.C).  u_old is the depth-1
    history slot, so on a solver with substeps it is the start of the last
    substep, as in the JAX package."""

    def history_requests(self):
        return {self.buffer: 1}

    def compute(self, state, ctx):
        u = state["buffers"][self.buffer]
        if _n_old(state, self.buffer) > 0:
            integral = torch.sum(torch.abs(u - state["old"][self.buffer][0]))
        else:
            integral = torch.sum(torch.abs(u))
        return integral * math.prod(self.domain.grid_spacing)


@postprocessors.register("TensorExtremeValuePostprocessor")
class TensorExtremeValuePostprocessor(TensorPostprocessor):
    """MIN/MAX over the grid (reference TensorExtremeValuePostprocessor.C)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.value_type = params.get_enum("value_type", ["MIN", "MAX"], "MAX")

    def compute(self, state, ctx):
        u = state["buffers"][self.buffer]
        return torch.min(u) if self.value_type == "MIN" else torch.max(u)


@postprocessors.register("ReciprocalIntegral")
class ReciprocalIntegral(TensorPostprocessor):
    """k=0 component / N · V (reference ReciprocalIntegral.C).  Slot 0 holds
    k = 0 under both backends: the PALLAS kernels' permuted order keeps the
    zero frequency first (``unordered_fft.true_k_order(n)[0] == 0``)."""

    def compute(self, state, ctx):
        u = state["buffers"][self.buffer]
        zero = u[(0,) * self.domain.dim]
        n = self.domain.n_cells_global
        return torch.real(zero) / n * self.domain.volume_global


@postprocessors.register("SemiImplicitCriticalTimeStep")
class SemiImplicitCriticalTimeStep(TensorPostprocessor):
    """dt_crit = 1/max|L̄|, or 1e30 where L̄ ≡ 0
    (reference SemiImplicitCriticalTimeStep.C:30-46)."""

    def compute(self, state, ctx):
        u = state["buffers"][self.buffer]
        max_norm_k = torch.sqrt(torch.max(torch.real(u * torch.conj(u))))
        return torch.where(max_norm_k > 0.0, 1.0 / max_norm_k,
                           torch.full_like(max_norm_k, 1e30))


@postprocessors.register("TensorInterfaceVelocityPostprocessor")
class TensorInterfaceVelocityPostprocessor(TensorPostprocessor):
    """Interface velocity max|du/dt / ∇u|, 0 before the first advance
    (reference TensorInterfaceVelocityPostprocessor.C)."""

    def history_requests(self):
        return {self.buffer: 1}

    def compute(self, state, ctx):
        dom = self.domain
        u = state["buffers"][self.buffer]
        if _n_old(state, self.buffer) == 0:
            return torch.zeros((), dtype=u.dtype, device=u.device)
        du = (u - state["old"][self.buffer][0]) / ctx["dt"]
        ubar = dom.fft(u)
        vsquare = None
        for d in range(dom.dim):
            grad = dom.ifft(ubar * dom.reciprocal_axis(d) * 1j)
            v = torch.where(torch.abs(grad) > 1e-3, du / grad, torch.zeros_like(du))
            vsquare = v * v if vsquare is None else vsquare + v * v
        return torch.sqrt(torch.max(vsquare))


@postprocessors.register("ParsedPostprocessor")
class ParsedPostprocessor(Postprocessor):
    """Expression over other postprocessor values (MOOSE built-in used by
    reference test/tests/solvers/etdrk4_diffusion.i), evaluated on the host
    after the tensor postprocessors' values are fetched."""

    depends_on_pps = True

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.pp_names = params.get_str_vector("pp_names")
        self.pp_symbols = params.get_str_vector("pp_symbols", default=self.pp_names)
        if len(self.pp_symbols) != len(self.pp_names):
            params.error(
                "pp_symbols",
                f"pp_symbols (size {len(self.pp_symbols)}) and pp_names "
                f"(size {len(self.pp_names)}) must have equal length.")
        # parsed at build, so syntax errors surface at once; pi and e are
        # FParser built-ins
        self._expr = CompiledExpression(
            params.get_str("expression", required=True),
            list(self.pp_symbols) + ["t"],
            constants={"pi": math.pi, "e": math.e})

    def check(self, problem):
        # after every pp is built: a forward reference is legal, a
        # misspelled name is an error (never a silent 0)
        known = {pp.name for pp in problem.postprocessors}
        for n in self.pp_names:
            if n not in known:
                self.params.error("pp_names", f"postprocessor '{n}' does not exist")

    def compute_host(self, pp_values, t):
        env = {"t": t}
        for sym, name in zip(self.pp_symbols, self.pp_names):
            # a pp that did not run on the current flag reads as its
            # initial 0 (MOOSE: the pp's current value)
            env[sym] = pp_values.get(name, 0.0)
        return self._expr.evaluate_host(env)
