"""Core spectral / phase-field / utility computes (the port of
marlin_tpu/computes/core.py).

Eager PyTorch re-designs of the reference compute classes in
src/tensor_computes/ (each class docstring names its counterpart).  The
spectral computes read the reciprocal axes from ``domain.reciprocal_axis``
and never build a k-grid of their own, so under ``fft_backend = PALLAS``
they see the kernels' permuted spectrum order.  Host-side initial
conditions (SmoothRectangleCompute, MooseFunctionTensor) evaluate in
numpy or float64 CPU tensors and copy to the device once a call.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict

import numpy as np
import torch

from .. import parallel
from ..expression import CompiledExpression, fparse
from ..params import Params
from ..registry import computes
from .base import ComputeError, Spec, TensorCompute


@computes.register("ParsedCompute")
class ParsedCompute(TensorCompute):
    """Runtime expression over named buffers
    (reference: src/tensor_computes/ParsedCompute.C:20-271).

    Supports `inputs`, symbolic `derivatives=`, `constant_names/expressions`
    (evaluated sequentially, earlier constants usable in later expressions),
    `extra_symbols` (i, x, y, z, kx, ky, kz, k2, t, pi, e),
    `expand=REAL|RECIPROCAL`, and `is_integer`.
    """

    RESERVED = ["i", "x", "kx", "y", "ky", "z", "kz", "k2", "t", "pi", "e"]

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.extra_symbols = params.get_bool("extra_symbols", False)
        self.expand = params.get_enum("expand", ["REAL", "RECIPROCAL", "NONE"], "NONE")
        self.is_integer = params.get_bool("is_integer", False)

        names = self.input_buffers("inputs")
        if len(set(names)) != len(names):
            params.error("inputs", "Duplicate buffer name.")

        constant_names = params.get_str_vector("constant_names")
        constant_exprs = params.get_str_vector("constant_expressions")
        if len(set(constant_names)) != len(constant_names):
            params.error("constant_names", "Duplicate constant name.")
        if len(constant_names) != len(constant_exprs):
            params.error(
                "constant_names",
                f"constant_names (size {len(constant_names)}) and "
                f"constant_expressions (size {len(constant_exprs)}) must have "
                "equal length.",
            )
        if self.extra_symbols:
            for n in list(constant_names) + list(names):
                if n in self.RESERVED:
                    params.error(
                        "constant_names", f"Cannot use reserved name '{n}'."
                    )

        # constants may be expressions referencing earlier constants and
        # problem-level constants (reference ParsedCompute.C:104-126)
        const_env: Dict[str, float] = dict(problem.constants)
        constants: Dict[str, object] = {}
        for cname, cexpr in zip(constant_names, constant_exprs):
            value = fparse(cexpr, const_env)
            const_env[cname] = value
            constants[cname] = value

        variables = list(names)
        if self.extra_symbols:
            constants["pi"] = math.pi
            constants["e"] = math.e
            constants["i"] = 1j
            variables += ["x", "kx", "y", "ky", "z", "kz", "k2", "t"]

        self.expr = CompiledExpression(
            params.get_str("expression", required=True),
            variables,
            constants=constants,
            simplify=params.get_bool("enable_fpoptimizer", True),
        )
        for d in params.get_str_vector("derivatives"):
            if d not in names:
                params.error(
                    "derivatives",
                    f"Derivative w.r.t `{d}` was requested, but it is not "
                    "listed in `inputs`.",
                )
            self.expr.differentiate(d)
        self.expr.compile()

    def _symbols(self) -> Dict[str, torch.Tensor]:
        """The extra symbols' domain tensors (t comes from the context)."""
        dom = self.domain
        zero = torch.zeros([1] * dom.dim, dtype=dom.dtype, device=dom.device)
        return {
            "x": dom.axis(0),
            "y": dom.axis(1) if dom.dim > 1 else zero,
            "z": dom.axis(2) if dom.dim > 2 else zero,
            "kx": dom.reciprocal_axis(0),
            "ky": dom.reciprocal_axis(1),
            "kz": dom.reciprocal_axis(2),
            "k2": dom.k_square,
        }

    def _finish(self, u):
        """The value's final dtype and shape (is_integer, expand)."""
        dom = self.domain
        if not isinstance(u, torch.Tensor):
            dtype = dom.cdtype if isinstance(u, complex) else dom.dtype
            u = torch.as_tensor(u, dtype=dtype, device=dom.device)
        if self.is_integer:
            u = u.to(torch.int64)
        if self.expand == "REAL":
            u = u.expand(dom.shape)
        elif self.expand == "RECIPROCAL":
            u = u.expand(dom.reciprocal_shape)
        return u

    def apply(self, state, ctx):
        env = {n: state[n] for n in self.inputs}
        if self.extra_symbols:
            env.update(self._symbols())
            env["t"] = ctx["t"]
        return {self.out: self._finish(self.expr(env))}

    def output_specs(self, specs):
        """The expression is elementwise: its shape broadcasts those of the
        variables it uses, and its dtype is what it gives on one-element
        stand-ins of the same dtypes."""
        dom = self.domain
        scope = {n: specs[n] for n in self.inputs}
        if self.extra_symbols:
            # the shapes _symbols() gives, without building k²
            one = (1,) * dom.dim
            for d, (x, k) in enumerate(zip("xyz", ("kx", "ky", "kz"))):
                ax = tuple(dom.axis(d).shape) if d < dom.dim else one
                scope[x] = Spec(ax, dom.dtype)
                scope[k] = Spec(tuple(dom.reciprocal_axis(d).shape), dom.dtype,
                                parallel.RECIPROCAL)
            scope["k2"] = Spec(dom.reciprocal_shape, dom.dtype, parallel.RECIPROCAL)
        env = {n: torch.zeros((1,) * len(sp.shape), dtype=sp.dtype)
               for n, sp in scope.items()}
        env["t"] = 0.0
        used = self.expr.ast.free_variables()
        # numpy's rule is torch's; torch.broadcast_shapes imports sympy
        shape = np.broadcast_shapes(
            *[scope[n].shape for n in sorted(used) if n in scope])
        u = self._finish(self.expr(env))
        if self.expand == "NONE":
            u = u.expand(shape)
        return {self.out: Spec(tuple(u.shape), u.dtype, self._layout(
            [scope[n].layout for n in sorted(used) if n in scope]))}

    def _layout(self, used):
        """The output's layout: the expansion's, else that of the fields
        the expression reads (a spectrum's where it reads one), else one
        value on every rank (an expression of constants and t)."""
        if self.expand != "NONE":
            return parallel.REAL if self.expand == "REAL" else parallel.RECIPROCAL
        for layout in (parallel.FULL, parallel.RECIPROCAL, parallel.REAL):
            if layout in used:
                return layout
        return None


@computes.register("ConstantTensor")
class ConstantTensor(TensorCompute):
    """Constant real-space tensor
    (reference: src/tensor_computes/ConstantTensor.C)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.real = self.constant("real", 0.0)
        # declared-but-unused upstream too (ConstantTensor.C:30,44-52)
        self.full = params.get_bool("full", False)

    def _shape(self):
        return self.problem.declared_buffer_shape(self.out) or self.domain.shape

    def apply(self, state, ctx):
        dom = self.domain
        return {self.out: torch.full(self._shape(), self.real, dtype=dom.dtype,
                                     device=dom.device)}

    def output_specs(self, specs):
        return {self.out: Spec(tuple(self._shape()), self.domain.dtype)}


@computes.register("ConstantReciprocalTensor")
class ConstantReciprocalTensor(TensorCompute):
    """Constant reciprocal-space tensor (complex)
    (reference: src/tensor_computes/ConstantTensor.C, reciprocal variant)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.real = self.constant("real", 0.0)
        self.imaginary = self.constant("imaginary", 0.0)

    def apply(self, state, ctx):
        dom = self.domain
        return {self.out: torch.full(dom.reciprocal_shape,
                                     complex(self.real, self.imaginary),
                                     dtype=dom.cdtype, device=dom.device)}

    def output_specs(self, specs):
        return {self.out: Spec(self.domain.reciprocal_shape, self.domain.cdtype, parallel.RECIPROCAL)}


@computes.register("RandomTensor")
class RandomTensor(TensorCompute):
    """Uniform random field between min and max
    (reference: src/tensor_computes/RandomTensor.C:17-55).

    Every draw comes from a generator of this compute, never from torch's
    global one.  ``generate_on_cpu = true`` (the default, as the
    reference) draws float64 on the CPU, seeded with ``seed`` at each
    draw, then casts to the buffer's dtype and moves to the device: the
    stream of ``torch.manual_seed(seed); torch.rand(..., float64)``, so a
    seeded float64 field equals the JAX package's (and the reference's)
    bit for bit, and a float32 buffer holds the same field rounded (a
    float32 draw would be another field).  ``generate_on_cpu = false``
    draws on the device from a generator seeded with ``seed``, or with
    crc32 of the compute's name; that stream is the device's own and
    matches neither the CPU stream nor the JAX package's ``jax.random``.
    Unseeded, the compute's generator is seeded once from fresh entropy
    (CPU) or from its name (device), so two unseeded computes draw
    independent noise.
    """

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.min = params.get_float("min", required=True)
        self.max = params.get_float("max", required=True)
        self.seed = params.get_int("seed") if params.has("seed") else None
        self.generate_on_cpu = params.get_bool("generate_on_cpu", True)
        self._generator = None  # the unseeded compute's own stream

    def _draw(self, shape) -> torch.Tensor:
        dom = self.domain
        if self.generate_on_cpu:
            if self.seed is not None:
                g = torch.Generator().manual_seed(self.seed)
            else:
                if self._generator is None:
                    self._generator = torch.Generator()
                    self._generator.seed()
                g = self._generator
            return torch.rand(shape, dtype=torch.float64, generator=g).to(
                dtype=dom.dtype, device=dom.device)
        if self.seed is not None:
            g = torch.Generator(dom.device).manual_seed(self.seed)
        else:
            if self._generator is None:
                self._generator = torch.Generator(dom.device).manual_seed(
                    zlib.crc32(self.name.encode()))
            g = self._generator
        return torch.rand(shape, dtype=dom.dtype, generator=g, device=dom.device)

    def apply(self, state, ctx):
        dom = self.domain
        if dom.mesh is not None and self.seed is not None:
            # every rank seeds and draws its own block's shape, so the
            # global field is that block tiled in rank order, as the
            # reference's MPI ranks draw it (RandomTensor.C:42-53) and the
            # JAX package does (marlin_tpu/computes/core.py:248-260)
            u = self._draw(list(dom.shape))
        else:
            u = self._draw(list(dom.n_global))
            if dom.mesh is not None:
                u = dom.local(u).contiguous()
        return {self.out: u * (self.max - self.min) + self.min}

    def output_specs(self, specs):
        return {self.out: Spec(self.domain.shape, self.domain.dtype)}


@computes.register("ParsedTensor")
class ParsedTensor(ParsedCompute):
    """Legacy spelling used by reference test/tests/tensor_ics/sineic.i:
    the expression lives in `function =` and coordinate symbols are on."""

    def __init__(self, name, params: Params, problem):
        if params.has("function") and not params.has("expression"):
            params.node.set_param("expression", params.node.get("function"))
        if not params.has("extra_symbols"):
            params.node.set_param("extra_symbols", "true")
        super().__init__(name, params, problem)


@computes.register("RunningMaximum")
class RunningMaximum(TensorCompute):
    """out = max(out, input): a monotone envelope, the history variable
    H(x) = max_t ψ(x, t) of phase-field fracture (marlin_tpu extension,
    marlin_tpu/computes/core.py:284-328).  The output buffer carries the
    envelope between substeps and steps, so its own initial condition
    seeds it; reading its previous value is old-state access, not a graph
    dependency.  Solvers that evaluate the graph on trial iterates are
    refused in ``check``, since a rejected iterate would stay in the
    envelope."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.input = self.input_buffer("input")

    def check(self):
        solver = getattr(self.problem, "solver", None)
        if getattr(solver, "iterative", False):
            raise ComputeError(
                f"RunningMaximum '{self.name}': iterative solvers evaluate "
                "the compute graph on trial iterates, which would be "
                "absorbed into the envelope permanently — use a "
                "non-iterative solver (ABM/ForwardEuler) for "
                "history-tracked decks")

    def apply(self, state, ctx):
        # an undeclared output buffer is created from this compute's result
        # like any other output
        prev = state.get(self.out)
        cur = state[self.input]
        if prev is None:
            return {self.out: cur}
        return {self.out: torch.maximum(prev, cur)}

    def output_specs(self, specs):
        cur = specs[self.input]
        prev = specs.get(self.out)
        if prev is None:
            return {self.out: cur}
        shape = tuple(np.broadcast_shapes(prev.shape, cur.shape))
        return {self.out: Spec(shape, torch.promote_types(prev.dtype, cur.dtype),
                               cur.layout)}


@computes.register("ForwardFFT")
class ForwardFFT(TensorCompute):
    """ū = fft(u) (reference: src/tensor_computes/PerformFFT.C, forward)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.input = self.input_buffer("input")

    def apply(self, state, ctx):
        return {self.out: self.domain.fft(state[self.input])}

    def output_specs(self, specs):
        return {self.out: Spec(*self.domain.fft_spec(*specs[self.input]))}


@computes.register("InverseFFT")
class InverseFFT(TensorCompute):
    """u = ifft(ū) (reference: src/tensor_computes/PerformFFT.C, inverse)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.input = self.input_buffer("input")

    def apply(self, state, ctx):
        return {self.out: self.domain.ifft(state[self.input])}

    def output_specs(self, specs):
        return {self.out: Spec(*self.domain.ifft_spec(*specs[self.input]))}


class BatchedFFT(TensorCompute):
    """Several independent same-direction FFT computes evaluated as one
    batched transform: fields stacked on a trailing value axis, which the
    Domain transforms natively (marlin_tpu/computes/core.py:355-388;
    ``[Problem] batch_fft = true``).  Built by ComputeGroup.fuse_ffts,
    never from a deck block.  Fields group by shape and complexness at
    each call; a field alone in its group takes the plain path."""

    def __init__(self, members, problem, inverse: bool):
        params = Params(None, problem.global_params)
        name = ("batch_ifft(" if inverse else "batch_fft(") + \
            ",".join(m.name for m in members) + ")"
        super().__init__(name, params, problem)
        self.members = list(members)
        self.inverse = inverse
        self.inputs = sorted({m.input for m in self.members})
        self.outputs = sorted({m.out for m in self.members})

    def apply(self, state, ctx):
        from ..domain import batched_transform

        op = self.domain.ifft if self.inverse else self.domain.fft
        return batched_transform(op, [(m.out, state[m.input]) for m in self.members])

    def output_specs(self, specs):
        out = {}
        for m in self.members:
            out.update(m.output_specs(specs))
        return out


@computes.register("ReciprocalLaplacianFactor")
class ReciprocalLaplacianFactor(TensorCompute):
    """-k² · factor (reference: src/tensor_computes/ReciprocalLaplacianFactor.C:28-31)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.factor = self.constant("factor", 1.0)

    def apply(self, state, ctx):
        return {self.out: -self.domain.k_square * self.factor}

    def output_specs(self, specs):
        return {self.out: Spec(self.domain.reciprocal_shape, self.domain.dtype, parallel.RECIPROCAL)}


@computes.register("ReciprocalLaplacianSquareFactor")
class ReciprocalLaplacianSquareFactor(TensorCompute):
    """k⁴ · factor — sign convention per reference
    (src/tensor_computes/ReciprocalLaplacianSquareFactor.C: 'ignore the minus
    which would drop in the next step anyways')."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.factor = self.constant("factor", 1.0)

    def apply(self, state, ctx):
        k2 = self.domain.k_square
        return {self.out: k2 * k2 * self.factor}

    def output_specs(self, specs):
        return {self.out: Spec(self.domain.reciprocal_shape, self.domain.dtype, parallel.RECIPROCAL)}


@computes.register("SwiftHohenbergLinear")
class SwiftHohenbergLinear(TensorCompute):
    """r − α²(1−k²)² (reference: src/tensor_computes/SwiftHohenbergLinear.C:31-36)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.r = self.constant("r", -0.5)
        self.alpha = self.constant("alpha", 1.0)

    def apply(self, state, ctx):
        k2 = self.domain.k_square
        return {self.out: self.r - self.alpha * self.alpha * (1.0 - k2) * (1.0 - k2)}

    def output_specs(self, specs):
        return {self.out: Spec(self.domain.reciprocal_shape, self.domain.dtype, parallel.RECIPROCAL)}


class _SpectralGradient(TensorCompute):
    """Shared input handling of the spectral gradients: ``input`` is a real
    field, transformed here, or with ``input_is_reciprocal`` already its
    spectrum.  Under ``fft_backend = PALLAS`` both transforms run through
    the domain's unordered-FFT kernels, with the permuted reciprocal axes."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.input = self.input_buffer("input")
        self.input_is_reciprocal = params.get_bool("input_is_reciprocal", False)

    def _spectrum(self, state):
        u = state[self.input]
        return u if self.input_is_reciprocal else self.domain.fft(u)

    def _derivative(self, r, d):
        dom = self.domain
        return dom.ifft(r * dom.reciprocal_axis(d) * 1j)

    def output_specs(self, specs):
        sp = specs[self.input]
        if not self.input_is_reciprocal:
            sp = Spec(*self.domain.fft_spec(*sp))
        return {self.out: Spec(*self.domain.ifft_spec(*sp))}


@computes.register("FFTGradient")
class FFTGradient(_SpectralGradient):
    """∂u/∂x_d = ifft(i·k_d·ū) (reference: src/tensor_computes/FFTGradient.C:26-40)."""

    DIRS = {"X": 0, "Y": 1, "Z": 2}

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.direction = self.DIRS[params.get_enum("direction", ["X", "Y", "Z"], "X")]

    def apply(self, state, ctx):
        return {self.out: self._derivative(self._spectrum(state), self.direction)}


@computes.register("FFTGradientSquare")
class FFTGradientSquare(_SpectralGradient):
    """factor · Σ_d (∂u/∂x_d)²
    (reference: src/tensor_computes/FFTGradientSquare.C)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.factor = self.constant("factor", 1.0)

    def apply(self, state, ctx):
        r = self._spectrum(state)
        u = None
        for d in range(self.domain.dim):
            g = self._derivative(r, d)
            u = g * g if u is None else u + g * g
        if self.factor != 1.0:
            u = u * self.factor
        return {self.out: u}


@computes.register("DeAliasingTensor")
class DeAliasingTensor(TensorCompute):
    """De-aliasing filter: the SHARP 2/3 rule or the Hou-Li exponential
    (reference: src/tensor_computes/DeAliasingTensor.C:31-56), from the
    domain's reciprocal axes.  The filter depends on the grid only: it is
    computed on the host once, from the axes in the domain's dtype, and
    uploaded once."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.method = params.get_enum("method", ["SHARP", "HOULI"], None)
        if self.method is None:
            params.error("method", "is required")
        self.p = params.get_float("p", 16.0)
        self.alpha = params.get_float("alpha", 36.0)
        self._filter = None

    def _build(self):
        dom = self.domain
        axes = [np.abs(dom.reciprocal_axis(d).cpu().numpy()) for d in range(3)]
        # the whole grid's largest |k| an axis, whatever block this rank holds
        maxima = [float(np.abs(dom._np_raxes_global[d]).max())
                  if d < dom.dim and dom._np_raxes_global[d].size else 0.0
                  for d in range(3)]
        if self.method == "SHARP":
            mask = None
            for a, m in zip(axes, maxima):
                cond = a > 2.0 * m / 3.0
                mask = cond if mask is None else mask | cond
            u = np.where(mask, 0.0, 1.0)
        else:
            acc = None
            for a, m in zip(axes, maxima):
                term = np.power(a / (m if m else 1.0), self.p)
                acc = term if acc is None else acc + term
            u = np.exp(-self.alpha * acc)
        return torch.as_tensor(u).to(dtype=dom.dtype, device=dom.device)

    def apply(self, state, ctx):
        if self._filter is None:
            self._filter = self._build()
        return {self.out: self._filter.expand(self.domain.reciprocal_shape)}

    def output_specs(self, specs):
        return {self.out: Spec(self.domain.reciprocal_shape, self.domain.dtype, parallel.RECIPROCAL)}


@computes.register("ReciprocalAllenCahn")
class ReciprocalAllenCahn(TensorCompute):
    """fft of −L·dF/dη masked by ψ > 0 (smoothed-boundary no-flux)
    (reference: src/tensor_computes/ReciprocalAllenCahn.C:38-50)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.dF = self.input_buffer("dF_chem_deta")
        self.L = self.input_buffer("L")
        self.psi = self.input_buffer("psi")
        self.always_update_psi = params.get_bool("always_update_psi", False)

    def apply(self, state, ctx):
        rate = torch.where(state[self.psi] > 0.0,
                           -1.0 * state[self.L] * state[self.dF], 0.0)
        return {self.out: self.domain.fft(rate)}

    def output_specs(self, specs):
        shape = tuple(np.broadcast_shapes(*[specs[b].shape for b in
                                            (self.psi, self.L, self.dF)]))
        return {self.out: Spec(*self.domain.fft_spec(shape, self.domain.dtype))}


@computes.register("ReciprocalMatDiffusion")
class ReciprocalMatDiffusion(TensorCompute):
    """Variable-mobility div(M∇µ) in k-space, with the smoothed-boundary
    no-flux term when ``psi`` is given
    (reference: src/tensor_computes/ReciprocalMatDiffusion.C:37-66).  The
    flux loops over the grid's dimensions only: with ψ that is 3 + 3·dim
    transforms a call (3 + dim forward, 2·dim inverse)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.chem_pot = self.input_buffer("chemical_potential")
        self.M = self.input_buffer("mobility")
        self.psi = self.input_buffer("psi", required=False)
        self.always_update_psi = params.get_bool("always_update_psi", False)

    def apply(self, state, ctx):
        dom = self.domain
        dims = range(dom.dim)
        k = [dom.reciprocal_axis(d) for d in dims]
        M = state[self.M]
        grad_psi_by_psi = None
        psi_M = M
        if self.psi is not None:
            psi = state[self.psi]
            psi_thresh = psi > 0.0
            psibar = dom.fft(psi)
            grad_psi_by_psi = [torch.where(psi_thresh, dom.ifft(k[d] * psibar * 1j) / psi, 0.0)
                               for d in dims]
            psi_M = M * psi_thresh
        mubar = dom.fft(state[self.chem_pot])
        J = [psi_M * dom.ifft(k[d] * mubar * 1j) for d in dims]
        div_J_hat = 1j * sum(k[d] * dom.fft(J[d]) for d in dims)
        if grad_psi_by_psi is None:
            return {self.out: div_J_hat}
        no_flux_hat = dom.fft(sum(grad_psi_by_psi[d] * J[d] for d in dims))
        return {self.out: div_J_hat + no_flux_hat}

    def output_specs(self, specs):
        return {self.out: Spec(self.domain.reciprocal_shape, self.domain.cdtype, parallel.RECIPROCAL)}


@computes.register("SmoothRectangleCompute")
class SmoothRectangleCompute(TensorCompute):
    """Smoothed rectangle indicator
    (reference: src/tensor_computes/SmoothRectangleCompute.C: a sharp box;
    COS, 0.5 + 0.5·sin(π·m/w) of the clamped edge distance m; TANH,
    0.5 + 0.5·tanh(4·m/w)), computed in numpy on the host as the JAX
    package computes it, then uploaded."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.x1 = params.get_float("x1", required=True)
        self.x2 = params.get_float("x2", required=True)
        self.y1 = params.get_float("y1", required=True)
        self.y2 = params.get_float("y2", required=True)
        self.z1 = params.get_float("z1", 0.0)
        self.z2 = params.get_float("z2", 0.0)
        self.interpolation = params.get_enum("profile", ["COS", "TANH"], "COS")
        self.int_width = params.get_float("int_width", 0.0)
        self.inside = params.get_float("inside", 1.0)
        self.outside = params.get_float("outside", 0.0)

    def _profile(self):
        dom = self.domain
        dim = dom.dim
        w = self.int_width
        x = dom._np_axes[0]
        y = dom._np_axes[1] if dim >= 2 else np.zeros(1)
        z = dom._np_axes[2] if dim == 3 else np.zeros(1)
        if w <= 0.0:
            hx = (x >= self.x1) & (x <= self.x2)
            hy = (y >= self.y1) & (y <= self.y2) if dim >= 2 else np.ones_like(y, bool)
            hz = (z >= self.z1) & (z <= self.z2) if dim == 3 else np.ones_like(z, bool)
            return (hx.reshape(-1, 1, 1) & hy.reshape(1, -1, 1)
                    & hz.reshape(1, 1, -1)).astype(np.float64)
        if self.interpolation == "COS":
            def edge(a, lo, hi):
                return np.clip(np.minimum(a - lo, hi - a), -w / 2, w / 2)
            my = edge(y, self.y1, self.y2) if dim >= 2 else np.full_like(y, w / 2)
            mz = edge(z, self.z1, self.z2) if dim == 3 else np.full_like(z, w / 2)
            hx, hy, hz = (0.5 + 0.5 * np.sin(math.pi * m / w)
                          for m in (edge(x, self.x1, self.x2), my, mz))
        else:  # TANH
            my = (np.minimum(y - self.y1, self.y2 - y) if dim >= 2
                  else np.full_like(y, 10 * w))
            mz = (np.minimum(z - self.z1, self.z2 - z) if dim == 3
                  else np.full_like(z, 10 * w / 2.0))
            hx, hy, hz = (0.5 + 0.5 * np.tanh(4 * m / w)
                          for m in (np.minimum(x - self.x1, self.x2 - x), my, mz))
        return hx.reshape(-1, 1, 1) * hy.reshape(1, -1, 1) * hz.reshape(1, 1, -1)

    def apply(self, state, ctx):
        dom = self.domain
        h_box = self._profile()
        u = np.squeeze(h_box * self.inside + (1 - h_box) * self.outside)
        return {self.out: torch.as_tensor(u.reshape(dom.shape)).to(
            dtype=dom.dtype, device=dom.device)}

    def output_specs(self, specs):
        return {self.out: Spec(self.domain.shape, self.domain.dtype)}


@computes.register("FiniteDifferenceLaplacian")
class FiniteDifferenceLaplacian(TensorCompute):
    """3- or 5-point finite-difference Laplacian on the periodic grid
    (reference: src/tensor_computes/FiniteDifferenceLaplacian.C:19-110;
    marlin_tpu/computes/core.py:637), by torch.roll over the spatial axes.
    On a REAL_SPACE mesh the block is padded with its neighbours' planes,
    as many as the stencil reaches, on every cut axis (``Domain.padded``),
    and the roll along a cut axis is a slice of that."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.input = self.input_buffer("input")
        self.factor = params.get_float("factor", 1.0)
        self.stencil = int(params.get_enum("stencil_width", ["3", "5"], "3"))

    def apply(self, state, ctx):
        dom = self.domain
        u = state[self.input]
        width = self.stencil // 2
        halo = dom.halo_dims()
        src = dom.padded(u, width=width) if halo else u

        def roll(k, d):
            if not halo:
                return torch.roll(u, k, d)
            return parallel.shifted(src, (k,), (d,), halo, width)

        centre = roll(0, 0) if halo else u
        out = torch.zeros_like(u)
        for d in range(dom.dim):
            h2 = dom.grid_spacing[d] ** 2
            if self.stencil == 3:
                out = out + (roll(1, d) - 2.0 * centre + roll(-1, d)) / h2
            else:
                out = out + (
                    -roll(2, d)
                    + 16.0 * roll(1, d)
                    - 30.0 * centre
                    + 16.0 * roll(-1, d)
                    - roll(-2, d)
                ) / (12.0 * h2)
        return {self.out: out * self.factor}

    def output_specs(self, specs):
        return {self.out: specs[self.input]}


@computes.register("MooseFunctionTensor")
class MooseFunctionTensor(TensorCompute):
    """A deck function (``[Functions]``) sampled onto the grid (reference
    src/tensor_computes/MooseFunctionTensor.C).  The samples sit at
    i·dx + dx/2 measured from zero, not from the domain minimum, as the
    reference samples.  The function is evaluated on the host in float64
    and the field copied to the device once a call."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.function = problem.get_function(params.get_str("function", required=True))

    def apply(self, state, ctx):
        dom = self.domain

        def axis(d):
            h = dom.grid_spacing[d]
            a = np.arange(dom.n_global[d])[dom.real_slice[d]] * h + h / 2.0
            return torch.from_numpy(dom._np_align(a, d))

        zero = torch.zeros([1] * dom.dim, dtype=torch.float64)
        env = {
            "x": axis(0),
            "y": axis(1) if dom.dim > 1 else zero,
            "z": axis(2) if dom.dim > 2 else zero,
            "t": float(ctx["t"]),
        }
        u = torch.as_tensor(self.function(env), dtype=torch.float64)
        return {self.out: u.expand(dom.shape).to(dtype=dom.dtype).to(dom.device)}

    def output_specs(self, specs):
        return {self.out: Spec(self.domain.shape, self.domain.dtype)}


@computes.register("GradientTensor")
class GradientTensor(TensorCompute):
    """The FFT gradient stacked into a 3-vector field: always 3 components,
    zeros past the grid's dimension (reference
    src/tensor_computes/GradientTensor.C:28-53, a NEML2 Vec there, a plain
    (..., 3) tensor here)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.input = self.input_buffer("input")
        self.input_is_reciprocal = params.get_bool("input_is_reciprocal", False)

    def apply(self, state, ctx):
        dom = self.domain
        u = state[self.input]
        r = (u if self.input_is_reciprocal else dom.fft(u)) * 1j
        comps = [dom.ifft(r * dom.reciprocal_axis(d)) if d < dom.dim
                 else torch.zeros(dom.shape, dtype=dom.dtype, device=dom.device)
                 for d in range(3)]
        return {self.out: torch.stack(comps, -1)}

    def output_specs(self, specs):
        return {self.out: Spec(self.domain.shape + (3,), self.domain.dtype)}
