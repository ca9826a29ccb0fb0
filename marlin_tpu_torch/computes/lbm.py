"""Lattice Boltzmann computes: equilibrium, BGK collision, moments.

The ported subset of marlin_tpu/computes/lbm.py (reference
src/tensor_computes/LBM*.C; each class names its counterpart).  All LBM
buffers carry the reference layout (nx, ny, nz, [q|dim]) with nz = 1 in 2-D
(reference LBMTensorBuffer.C:96-125).  Each compute runs eagerly on torch
tensors; this chain is the default (``lbm_backend = JNP``) path and the
anchor of the fused kernel (``lbm_fused.py``).

Distributions are (nx, ny, nz, q) tensors stored direction-major: views of
contiguous (q, nx, ny, nz) storage, as the stream, the equilibrium and the
bounce-back build them, so that every elementwise pass runs over
contiguous planes and no pass transposes (the fused path's layout too).

The kernel computes, cell by cell, exactly the operations of this chain in
the same order, so the two backends give the same bits in float32 as in
float64.  Two choices here serve that and change nothing else (the chain
stays within a few ulps of the JAX package's): the sums over directions
run one direction at a time in index order (``_direction_sum``) instead of
a library reduction of unspecified order, and the divisions by constants
are multiplications by their reciprocals (torch's CUDA division by a
Python scalar already multiplies by the reciprocal; its CPU division does
not).

Not ported yet, and so unregistered (a deck naming one fails with the
registry's named error): LBMPhaseEquilibrium, LBMMRTCollision,
LBMSmagorinskyCollision, LBMSmagorinskyMRTCollision,
LBMTensorUnitConverter, LBMComputeForces, LBMApplyForces,
LBMComputeSurfaceForces, LBMComputeChemicalPotential,
LBMIsotropicGradient and LBMIsotropicLaplacian; Hermite regularization
(``projection = true``) is a named error.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..params import Params
from ..registry import computes
from .base import ComputeError, Spec, TensorCompute

CS = 1.0 / math.sqrt(3.0)  # reference include/problems/LatticeBoltzmannProblem.h:106-109
CS2 = CS * CS
CS4 = CS2 * CS2
INV_CS2 = 1.0 / CS2
INV_CS4 = 1.0 / CS4


class LatticeBoltzmannOperator(TensorCompute):
    """Base: stencil + binary-media access
    (reference src/tensor_computes/LatticeBoltzmannOperator.C)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.stencil = problem.lbm_stencil()
        self._tables = {}

    def table(self, attr: str) -> torch.Tensor:
        """A stencil table (``ex``, ``weights``, ...) as a tensor of the
        domain's float dtype on its device, uploaded once."""
        t = self._tables.get(attr)
        if t is None:
            dom = self.domain
            t = torch.as_tensor(np.asarray(getattr(self.stencil, attr)),
                                dtype=dom.dtype, device=dom.device)
            self._tables[attr] = t
        return t

    def masked_fill_solids(self, t, value=0.0):
        """Zero out solid cells (reference LatticeBoltzmannProblem::
        maskedFillSolids :165-182; only active with binary media)."""
        mask = self.problem.lbm_solid_mask()
        if mask is None:
            return t
        if t.ndim == mask.ndim:
            return torch.where(mask, value, t)
        return torch.where(mask[..., None], value, t)


def _ensure3d(a):
    """Reference LBM ops unsqueeze bare-grid (2-D) fields in place
    (`if (_rho.dim() < 3) _rho.unsqueeze_(2)`, LBMEquilibrium.C)."""
    while a.ndim < 3:
        a = a[..., None]
    return a


def _direction_sum(fq, coef=None):
    """Σ_q coef_q·fq[q] over the leading direction axis of a q-major
    distribution (coef_q in {-1, 0, 1}; all ones when None), one direction
    at a time in index order, zero coefficients skipped."""
    acc = None
    for qi in range(fq.shape[0]):
        c = 1 if coef is None else int(coef[qi])
        if c == 0:
            continue
        t = fq[qi] if c > 0 else -fq[qi]
        acc = t if acc is None else acc + t
    return acc


def _q_major(f):
    """The (q, nx, ny, nz) contiguous planes of a (nx, ny, nz, q)
    distribution: a view when it is stored direction-major, else a copy."""
    return f.movedim(-1, 0).contiguous()


def _unsqueeze_velocity(velocity, dim):
    """The velocity components as (nx, ny, nz) fields (uz = 0 in 2-D)."""
    ux = _ensure3d(velocity[..., 0])
    uy = _ensure3d(velocity[..., 1])
    uz = _ensure3d(velocity[..., 2]) if dim == 3 else torch.zeros_like(ux)
    return ux, uy, uz


def _equilibrium(op: LatticeBoltzmannOperator, rho, velocity, dim):
    """feq = w·rho·(1 + e·u/cs² + (e·u)²/(2cs⁴) − u²/(2cs²))
    (reference LBMEquilibrium.C:42-66), direction-major, as the
    (nx, ny, nz, q) view of (q, nx, ny, nz) planes."""
    ux, uy, uz = _unsqueeze_velocity(velocity, dim)
    col = lambda name: op.table(name)[:, None, None, None]
    edotu = col("ex") * ux + col("ey") * uy + col("ez") * uz
    usqr = ux * ux + uy * uy + uz * uz
    second_order = edotu * INV_CS2 + 0.5 * edotu * edotu * INV_CS4
    third_order = 0.5 * usqr * INV_CS2
    feq = col("weights") * rho * (1.0 + second_order - third_order)
    return feq.movedim(0, -1)


def _broadcast_spec(*specs: Spec) -> tuple:
    return tuple(np.broadcast_shapes(*[s.shape for s in specs]))


@computes.register("LBMEquilibrium")
class LBMEquilibrium(LatticeBoltzmannOperator):
    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.rho = self.input_buffer("bulk")
        self.velocity = self.input_buffer("velocity")

    def apply(self, state, ctx):
        rho = _ensure3d(state[self.rho])
        u = _equilibrium(self, rho, state[self.velocity], self.domain.dim)
        return {self.out: self.masked_fill_solids(u)}

    def output_specs(self, specs):
        rho = specs[self.rho].shape
        rho = rho + (1,) * max(0, 3 - len(rho))
        vel = specs[self.velocity].shape[:-1] + (1,)
        shape = np.broadcast_shapes(rho + (1,), vel, (self.stencil.q,))
        return {self.out: Spec(tuple(shape), self.domain.dtype)}


class _CollisionBase(LatticeBoltzmannOperator):
    """Template base for collisions (reference LBMCollisionDynamics.C:1-319),
    without the Hermite projection, which is not ported yet."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.f = self.input_buffer("f")
        self.feq = self.input_buffer("feq")
        self.tau_0 = problem.get_constant(params.get_str("tau0", required=True))
        self.C_s = problem.get_constant(params.get_str("Cs", "0.1"))
        self.delta_x = 1.0
        self.projection = params.get_bool("projection", False)
        if self.projection:
            params.error("projection", "projection = true (Hermite "
                         "regularization) is not ported to marlin_tpu_torch yet")

    def fneq(self, state):
        return state[self.f] - state[self.feq]

    def output_specs(self, specs):
        return {self.out: Spec(_broadcast_spec(specs[self.f], specs[self.feq]),
                               specs[self.f].dtype)}


@computes.register("LBMBGKCollision")
class LBMBGKCollision(_CollisionBase):
    def apply(self, state, ctx):
        fneq = self.fneq(state)
        u = state[self.feq] + fneq - fneq * (1.0 / self.tau_0)
        u = self.masked_fill_solids(u)
        return {self.out: self.masked_fill_solids(u)}


@computes.register("LBMComputeDensity")
class LBMComputeDensity(LatticeBoltzmannOperator):
    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.f = self.input_buffer("f")

    def apply(self, state, ctx):
        u = _direction_sum(_q_major(state[self.f]))
        return {self.out: self.masked_fill_solids(u)}

    def output_specs(self, specs):
        s = specs[self.f]
        return {self.out: Spec(s.shape[:3] + s.shape[4:], s.dtype)}


@computes.register("LBMComputeVelocity")
class LBMComputeVelocity(LatticeBoltzmannOperator):
    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.f = self.input_buffer("f")
        self.rho = self.input_buffer("rho")
        self.enable_forces = params.get_bool("enable_forces", False)
        self.add_body_force = params.get_bool("add_body_force", False)
        self.forces = params.get_str("forces", "forces")
        if self.enable_forces and self.forces not in self.inputs:
            self.inputs.append(self.forces)
        self.body_force = [
            self.constant("body_force_x", 0.0),
            self.constant("body_force_y", 0.0),
            self.constant("body_force_z", 0.0),
        ]

    def apply(self, state, ctx):
        dim = self.domain.dim
        st = self.stencil
        fq, rho = _q_major(state[self.f]), state[self.rho]
        u = torch.stack([_direction_sum(fq, e) / rho
                         for e in (st.ex, st.ey, st.ez)[:dim]], -1)
        if self.enable_forces:
            u = u + state[self.forces] / (2.0 * rho[..., None])
        if self.add_body_force:
            bf = torch.as_tensor(self.body_force[:dim], dtype=u.dtype,
                                 device=u.device)
            u = u + bf / (2.0 * rho[..., None])
        return {self.out: self.masked_fill_solids(u)}

    def output_specs(self, specs):
        s = specs[self.f]
        shape = np.broadcast_shapes(s.shape[:3], specs[self.rho].shape)
        return {self.out: Spec(tuple(shape) + (self.domain.dim,), s.dtype)}


@computes.register("LBMComputeVelocityMagnitude")
class LBMComputeVelocityMagnitude(LatticeBoltzmannOperator):
    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.velocity = self.input_buffer("velocity")

    def apply(self, state, ctx):
        v = state[self.velocity]
        usqr = v[..., 0] * v[..., 0]
        for i in range(1, v.shape[-1]):
            usqr = usqr + v[..., i] * v[..., i]
        u = torch.sqrt(usqr)
        return {self.out: self.masked_fill_solids(u)}

    def output_specs(self, specs):
        s = specs[self.velocity]
        return {self.out: Spec(s.shape[:-1], s.dtype)}


@computes.register("LBMComputeResidual")
class LBMComputeResidual(LatticeBoltzmannOperator):
    """Convergence residual -> solver state
    (reference LBMComputeResidual.C; feeds the problem's early stop).  The
    residual stays on the device as a 0-d tensor; the executioner fetches
    it with the step's postprocessor values."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.speed = self.input_buffer("speed")
        self.outputs = []  # writes solver residual, not a buffer

    def history_requests(self):
        return {self.speed: 1}

    def apply(self, state, ctx):
        speed = state[self.speed]
        old = ctx.get("old", {}).get(self.speed)
        if old is None:
            return {"__residual__": torch.ones((), dtype=speed.dtype,
                                               device=speed.device)}
        num = torch.sum(torch.abs(speed - old[0]))
        den = torch.sum(speed)
        residual = torch.where((den == 0) | (num == 0), 1.0, num / den)
        n_old = ctx.get("n_advances")
        if n_old is not None and not n_old > 0:
            residual = torch.ones_like(residual)
        return {"__residual__": residual}

    def output_specs(self, specs):
        return {}


@computes.register("LBMConstantTensor")
class LBMConstantTensor(LatticeBoltzmannOperator):
    """Fill buffer (or its components) with named constants
    (reference LBMConstantTensor.C)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.values = [
            problem.get_constant(c)
            for c in params.get_str_vector("constants", required=True)
        ]

    def apply(self, state, ctx):
        u = state[self.out]
        if u.ndim > 3:
            if u.shape[3] != len(self.values):
                raise ComputeError(
                    "The number of constants must match the number of "
                    "components in the buffer."
                )
            vals = torch.as_tensor(self.values, dtype=u.dtype, device=u.device)
            return {self.out: vals.expand(u.shape)}
        if len(self.values) != 1:
            raise ComputeError("For scalar buffers only one constant can be passed.")
        return {self.out: torch.full(u.shape, self.values[0], dtype=u.dtype,
                                     device=u.device)}

    def output_specs(self, specs):
        return {self.out: specs[self.out]}


@computes.register("LBMStackTensors")
class LBMStackTensors(LatticeBoltzmannOperator):
    """Stack scalar buffers into a vector buffer (reference LBMStackTensors.C)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.stack_inputs = self.input_buffers("inputs")
        if len(set(self.stack_inputs)) != len(self.stack_inputs):
            params.error("inputs", "Duplicate buffer name.")

    def apply(self, state, ctx):
        # inputs may be lazily broadcast axis shapes (e.g. ParsedCompute of
        # a single coordinate); align them before stacking
        comps = torch.broadcast_tensors(*[state[n] for n in self.stack_inputs])
        return {self.out: torch.stack(comps, -1)}

    def output_specs(self, specs):
        ins = [specs[n] for n in self.stack_inputs]
        shape = _broadcast_spec(*ins) + (len(ins),)
        dtype = functools.reduce(torch.promote_types, [s.dtype for s in ins])
        return {self.out: Spec(shape, dtype)}
