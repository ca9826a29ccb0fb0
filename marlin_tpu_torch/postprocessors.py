"""Postprocessors: scalar reductions over tensor buffers, reported to CSV.

The ported subset of marlin_tpu/postprocessors.py (reference
src/postprocessors/).  A tensor postprocessor is a function
``(state, ctx) -> 0-d tensor``; the problem fetches every tensor value of
an output point to the host in one transfer.  A postprocessor with
``depends_on_pps`` (``ParsedPostprocessor``, ``ComputeGroupExecutionCount``)
is evaluated after that transfer, on the host, from the values fetched
(``compute_host``).  On a mesh each rank reduces its block and the
partial results are reduced over the group (``Domain.reduce``), so every
rank holds the whole grid's values; a reduction over a spectrum leaves a
pencil's pad rows out (``Domain.spectrum``).  The aux-variable
postprocessors reduce the buffer an
aux variable reads on the device, inside the same transfer.  A vector
postprocessor (``TensorHistogram``) returns columns of host arrays, written
as one CSV a step by the executioner.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import parallel
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
        u = self.domain.spectrum(state["buffers"][self.buffer])
        return self.domain.reduce(torch.sum(u)) / self.domain.numel(u)


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
        dom = self.domain
        u = dom.spectrum(state["buffers"][self.buffer])
        if _n_old(state, self.buffer) > 0:
            integral = torch.sum(torch.abs(u - dom.spectrum(state["old"][self.buffer][0])))
        else:
            integral = torch.sum(torch.abs(u))
        return self.domain.reduce(integral) * math.prod(self.domain.grid_spacing)


@postprocessors.register("TensorExtremeValuePostprocessor")
class TensorExtremeValuePostprocessor(TensorPostprocessor):
    """MIN/MAX over the grid (reference TensorExtremeValuePostprocessor.C)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.value_type = params.get_enum("value_type", ["MIN", "MAX"], "MAX")

    def compute(self, state, ctx):
        u = self.domain.spectrum(state["buffers"][self.buffer])
        if self.value_type == "MIN":
            return _extreme(self.domain, u, "min")
        return _extreme(self.domain, u, "max")


@postprocessors.register("ReciprocalIntegral")
class ReciprocalIntegral(TensorPostprocessor):
    """k=0 component / N · V (reference ReciprocalIntegral.C).  Slot 0 holds
    k = 0 under both backends: the PALLAS kernels' permuted order keeps the
    zero frequency first (``unordered_fft.true_k_order(n)[0] == 0``); on a
    mesh the rank whose block starts the spectrum holds it."""

    def compute(self, state, ctx):
        dom = self.domain
        u = state["buffers"][self.buffer]
        zero = torch.real(u[(0,) * dom.dim])
        if dom.mesh is not None:
            holds = all(s.start == 0 for s in dom.reciprocal_slice)
            zero = dom.reduce(zero if holds else torch.zeros_like(zero))
        n = dom.n_cells_global
        return zero / n * dom.volume_global


@postprocessors.register("SemiImplicitCriticalTimeStep")
class SemiImplicitCriticalTimeStep(TensorPostprocessor):
    """dt_crit = 1/max|L̄|, or 1e30 where L̄ ≡ 0
    (reference SemiImplicitCriticalTimeStep.C:30-46)."""

    def compute(self, state, ctx):
        u = self.domain.spectrum(state["buffers"][self.buffer])
        sq = torch.real(u * torch.conj(u))
        # a pencil block may hold pad rows alone: 0 is the max's neutral here
        local = torch.max(sq) if sq.numel() else sq.new_zeros(())
        max_norm_k = torch.sqrt(self.domain.reduce(local, "max"))
        return torch.where(max_norm_k > 0.0, 1.0 / max_norm_k,
                           torch.full_like(max_norm_k, 1e30))


@postprocessors.register("FunctionElementIntegral")
class FunctionElementIntegral(Postprocessor):
    """Integral of a deck function (``[Functions]``) over the grid by
    2-point Gauss quadrature an element (the MOOSE built-in the reference's
    test/tests/misc/shiftedfunction.i uses), evaluated on the host in
    float64 (marlin_tpu/postprocessors.py:242-276).  The value is a 0-d
    CPU tensor; the problem fetches it with the others."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.function = problem.get_function(params.get_str("function", required=True))

    def compute(self, state, ctx):
        dom = self.domain
        g = 1.0 / np.sqrt(3.0)
        axes = []
        for d in range(dom.dim):
            h = dom.grid_spacing[d]
            centers = dom._np_axes[d]
            axes.append(np.sort(np.concatenate([centers - g * h / 2.0,
                                                centers + g * h / 2.0])))
        while len(axes) < 3:
            axes.append(np.zeros(1))
        shape = [len(a) for a in axes]
        env = {k: torch.from_numpy(np.ascontiguousarray(a.reshape(s)))
               for k, a, s in zip("xyz", axes, ((-1, 1, 1), (1, -1, 1), (1, 1, -1)))}
        env["t"] = float(ctx["t"])
        vals = torch.as_tensor(self.function(env)).expand(shape)
        weight = 1.0
        for d in range(dom.dim):
            weight *= dom.grid_spacing[d] / 2.0
        total = torch.sum(vals)
        if dom.mesh is not None:
            total = dom.reduce(total.to(dom.device)).cpu()
        return total * weight


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
        return torch.sqrt(dom.reduce(torch.max(vsquare), "max"))


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


@postprocessors.register("ComputeGroupExecutionCount")
class ComputeGroupExecutionCount(Postprocessor):
    """Execution count of the solver's compute group (reference
    ComputeGroupExecutionCount.C): the static count the problem keeps,
    ``group_evals_per_step`` a step, plus ``device_group_evals``, the
    evaluations an iterative solver's iterations made (its state's
    ``group_evals``, as of the last step)."""

    depends_on_pps = True

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.compute_group = params.get_str("compute_group", None)

    def compute_host(self, pp_values, t):
        return float(self.problem.compute_count + self.problem.device_group_evals)


@postprocessors.register("IterationPostprocessor", "TensorSolverIterations")
class TensorSolverIterations(Postprocessor):
    """Iteration count of the iterative tensor solver's last substep, 0
    for other solvers (marlin_tpu/postprocessors.py:188)."""

    def compute(self, state, ctx):
        return state["solver"].get("iterations", 0)


@postprocessors.register("ComputeReynoldsNumber")
class ComputeReynoldsNumber(TensorPostprocessor):
    """LBM Reynolds number (reference ComputeReynoldsNumber.C)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.tau = problem.get_constant(params.get_str("tau", required=True))
        self.D = problem.get_constant(params.get_str("diameter", required=True))

    def compute(self, state, ctx):
        u = state["buffers"][self.buffer]
        # the reference uses nu = (tau - 0.5)/sqrt(3), c_s and not the
        # textbook c_s² = 1/3 (ComputeReynoldsNumber.C:34); kept for parity
        kinematic_viscosity = 1.0 / math.sqrt(3.0) * (self.tau - 0.5)
        avg_speed = self.domain.reduce(torch.sum(u)) / self.domain.numel(u)
        return avg_speed * self.D / kinematic_viscosity


class AuxVariablePostprocessor(Postprocessor):
    """Base for MOOSE postprocessors that read an aux variable fed from a
    tensor buffer (the reference couples through MOOSE's FE aux system,
    src/problems/TensorProblem.C:312-379; here the mapped buffer IS the
    variable, so these reductions run on the device with the other tensor
    postprocessors)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.variable = params.get_str("variable", required=True)
        if self.variable not in problem.aux.variables:
            params.error("variable", f"unknown aux variable '{self.variable}'")

    def _field(self, state):
        buf = self.problem.aux.source_buffer(self.variable)
        if buf is None:
            return torch.zeros(self.domain.shape, dtype=self.domain.dtype,
                               device=self.domain.device)
        return state["buffers"][buf]


@postprocessors.register("ElementExtremeValue", "NodalExtremeValue")
class ElementExtremeValue(AuxVariablePostprocessor):
    """MIN/MAX of an aux variable.  On the conforming mesh both the nodal
    and elemental samplings take values from the buffer itself, so the
    extremum equals the buffer extremum (MOOSE samples at quadrature points,
    which for a multilinear variable is an interior bound)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.value_type = params.get_enum("value_type", ["MIN", "MAX"], "MAX")

    def compute(self, state, ctx):
        u = self._field(state)
        if self.value_type == "MIN":
            return _extreme(self.domain, u, "min")
        return _extreme(self.domain, u, "max")


@postprocessors.register("ElementAverageValue")
class ElementAverageValue(AuxVariablePostprocessor):
    """Volume-average of an aux variable.  On the periodic conforming mesh
    the exact FE integral of either a constant-monomial or multilinear
    variable reduces to the plain cell mean."""

    def compute(self, state, ctx):
        u = self._field(state)
        return self.domain.reduce(torch.sum(u)) / self.domain.numel(u)


@postprocessors.register("ElementIntegralVariablePostprocessor")
class ElementIntegralVariablePostprocessor(ElementAverageValue):
    def compute(self, state, ctx):
        return super().compute(state, ctx) * self.domain.volume_global


def _extreme(domain, u, kind: str):
    """The min or max of ``u`` over the mesh; a rank's empty block (the
    ceil-division layout's last) gives the reduction's identity."""
    if u.numel():
        local = torch.min(u) if kind == "min" else torch.max(u)
    else:
        local = torch.tensor(math.inf if kind == "min" else -math.inf, dtype=u.dtype,
                             device=u.device)
    return domain.reduce(local, kind)


class VectorPostprocessor:
    """Base for vector postprocessors (per-step CSV series)."""

    def __init__(self, name, params: Params, problem):
        self.name = name
        self.params = params
        self.problem = problem
        self.domain = problem.domain
        self.execute_on = set(
            x.upper()
            for x in params.get_str_vector("execute_on", default=["TIMESTEP_END"])
        )

    def compute(self, state, ctx):
        """Return dict column -> 1-D host array."""
        raise NotImplementedError


@postprocessors.register("TensorHistogram")
class TensorHistogram(VectorPostprocessor):
    """Histogram of buffer values (reference
    src/vectorpostprocessors/TensorHistogram.C): `bins` equal-width bins on
    [min, max], columns `bin` (centers) and `count`.  The buffer is fetched
    to the host and binned by numpy, as the JAX package bins it
    (``torch.histc`` places its edges differently).  On a mesh each rank
    bins its own block over the same range and bins and the integer counts
    are summed by one ``all_reduce``: numpy bins each value on its own, so
    the sum over the blocks is the whole field's histogram, exactly, and
    nothing is gathered.  A buffer that every rank holds whole is binned
    once."""

    is_vector = True

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.buffer = params.get_str("buffer", required=True)
        self.min = params.get_float("min", required=True)
        self.max = params.get_float("max", required=True)
        self.bins = params.get_int("bins", required=True)
        if self.min > self.max:
            params.error("min", "max must be greater than min")

    def compute(self, state, ctx):
        u = state["buffers"][self.buffer].detach().cpu().numpy().reshape(-1)
        counts, _edges = np.histogram(u, bins=self.bins, range=(self.min, self.max))
        dom = self.domain
        if dom.mesh is not None and \
                self.problem.buffer_layouts().get(self.buffer, parallel.REAL) is not None:
            counts = dom.reduce(torch.from_numpy(counts).to(dom.device)).cpu().numpy()
        step = (self.max - self.min) / self.bins
        centers = self.min + step / 2.0 + step * np.arange(self.bins)
        return {"bin": centers, "count": counts.astype(float)}
