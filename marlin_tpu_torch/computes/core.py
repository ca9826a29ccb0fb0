"""Core spectral / phase-field computes (the ported subset of
marlin_tpu/computes/core.py).

Eager PyTorch re-designs of the reference compute classes in
src/tensor_computes/ (each class docstring names its counterpart).
"""

from __future__ import annotations

import math
import zlib
from typing import Dict

import numpy as np
import torch

from ..expression import CompiledExpression, fparse
from ..params import Params
from ..registry import computes
from .base import Spec, TensorCompute


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
                scope[k] = Spec(tuple(dom.reciprocal_axis(d).shape), dom.dtype)
            scope["k2"] = Spec(dom.reciprocal_shape, dom.dtype)
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
        return {self.out: Spec(tuple(u.shape), u.dtype)}


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
        return {self.out: Spec(self.domain.reciprocal_shape, self.domain.cdtype)}


@computes.register("RandomTensor")
class RandomTensor(TensorCompute):
    """Uniform random field between min and max
    (reference: src/tensor_computes/RandomTensor.C:17-55), serial mode.

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
        u = self._draw(list(self.domain.shape))
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


@computes.register("ReciprocalLaplacianFactor")
class ReciprocalLaplacianFactor(TensorCompute):
    """-k² · factor (reference: src/tensor_computes/ReciprocalLaplacianFactor.C:28-31)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.factor = self.constant("factor", 1.0)

    def apply(self, state, ctx):
        return {self.out: -self.domain.k_square * self.factor}

    def output_specs(self, specs):
        return {self.out: Spec(self.domain.reciprocal_shape, self.domain.dtype)}


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
        return {self.out: Spec(self.domain.reciprocal_shape, self.domain.dtype)}


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
        return {self.out: Spec(self.domain.reciprocal_shape, self.domain.dtype)}


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
