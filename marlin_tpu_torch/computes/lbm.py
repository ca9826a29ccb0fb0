"""Lattice Boltzmann computes: equilibrium, collisions, moments, forces.

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

The MRT collision, the Hermite projection (``projection = true``), the
Smagorinsky collision and the force chain (``LBMComputeForces``,
``LBMApplyForces``, the velocity's ``enable_forces``) take their
coefficients from ``mrt_matrix``, ``hermite_tables``,
``smagorinsky_constants`` and ``guo_prefactors``, which the fused kernel's
plan shares, and run their sums in the kernel's order.  The Smagorinsky
τ needs the grid's mean density, which ``tree_mean`` sums by a fixed
pairwise tree that the kernel's two reduction passes reproduce.

Not ported yet, and so unregistered (a deck naming one fails with the
registry's named error): LBMPhaseEquilibrium, LBMTensorUnitConverter,
LBMComputeSurfaceForces, LBMComputeChemicalPotential,
LBMIsotropicGradient and LBMIsotropicLaplacian.
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
    distribution, or a list of direction planes (coef_q in {-1, 0, 1}; all
    ones when None), one direction at a time in index order, zero
    coefficients skipped."""
    acc = None
    for qi in range(len(fq)):
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


def mrt_matrix(stencil, tau: float) -> np.ndarray:
    """MSM = M⁻¹·S′·M in float64, S′ the stencil's S with the
    kinematic-viscosity diagonal at 1/τ, entries under 1e-14 set to 0
    (reference LBMMRTCollision; marlin_tpu/pallas_lbm.py match_chain
    ``msm_of``).  The eager collision and the kernel's plan use it alike."""
    S = stencil.S.copy()
    S[stencil.id_kinematic_visc, stencil.id_kinematic_visc] = 1.0 / float(tau)
    m = stencil.M_inv @ S @ stencil.M
    m[np.abs(m) < 1e-14] = 0.0
    return m


def hermite_tables(e, weights):
    """The Hermite projection's coefficients (reference
    LBMCollisionDynamics::_hermite_regularization) for the velocity set
    ``e`` (q rows of (ex, ey, ez)): ccr (q, 9) = e⊗e, H2 (q, 9) =
    e⊗e/c_s² − I, and the prefactors w_i/(2c_s²)."""
    e = np.asarray(e, dtype=np.float64).T
    ee = np.einsum("ai,bi->iab", e, e)
    ccr = ee.reshape(e.shape[1], 9)
    h2 = (ee / CS2 - np.eye(3)[None, :, :]).reshape(e.shape[1], 9)
    pref = [float(w) * (1.0 / (2.0 * CS2)) for w in weights]
    return ccr, h2, pref


def guo_prefactors(weights, tau: float):
    """(1 − 1/(2τ))·w_i/c_s² a direction, the Guo source's constant
    (reference LBMApplyForces.C), each one double."""
    return [(1.0 - 0.5 / float(tau)) * float(w) / CS2 for w in weights]


def signed_sum(coefs, comps):
    """Σ_k c_k·comps[k] for c_k in {-1, 0, 1}, zeros skipped, in index
    order; None when every c_k is 0."""
    acc = None
    for c, v in zip(coefs, comps):
        if c:
            t = v if c > 0 else -v
            acc = t if acc is None else acc + t
    return acc


def hermite(fneq, tables):
    """Project the non-equilibrium planes onto the second-order Hermite
    space: cc_j = Σ_i ccr_ij·fneq_i, then fneq_i ← pref_i·Σ_j H2_ij·cc_j,
    each sum in index order with zero coefficients skipped (the kernel's
    order, marlin_tpu/pallas_lbm.py ``hermite``)."""
    ccr, h2, pref = tables
    cc = []
    for j in range(9):
        acc = None
        for i, a in enumerate(fneq):
            c = float(ccr[i, j])
            if c != 0.0:
                t = a * c
                acc = t if acc is None else acc + t
        cc.append(acc)
    out = []
    for i, a in enumerate(fneq):
        acc = None
        for j in range(9):
            h = float(h2[i, j])
            if h != 0.0 and cc[j] is not None:
                t = cc[j] * h
                acc = t if acc is None else acc + t
        out.append(pref[i] * acc if acc is not None else torch.zeros_like(a))
    return out


def tree_mean(a):
    """The mean of every element of ``a`` as a 0-d tensor: ``a`` flattened
    in index order, zero-padded to a power of two and summed pairwise
    (``a[0::2] + a[1::2]`` until one element is left), times 1/n.  Adding
    zeros is exact, so the CUDA passes (a block tree over each aligned
    chunk of 256 cells, then one block over the chunks, csrc/lbm_substep.cu)
    give the same bits."""
    a = a.reshape(-1)
    n = a.numel()
    pad = (1 << (n - 1).bit_length()) - n
    if pad:
        a = torch.cat([a, a.new_zeros(pad)])
    while a.numel() > 1:
        a = a[0::2] + a[1::2]
    return a[0] * (1.0 / n)


def smagorinsky_constants(C_s: float, tau0: float):
    """The Smagorinsky τ's constants in double (reference
    LBMCollisionDynamics::computeRelaxationParameter, δx = 1): η = τ₀/t_sgs
    with t_sgs = √C_s/c_s, η², 1/(2 t_sgs) and C_s/c_s²."""
    t_sgs = math.sqrt(float(C_s)) / CS
    eta = float(tau0) / t_sgs
    return {"eta": eta, "eta2": eta * eta, "inv_2tsgs": 1.0 / (2.0 * t_sgs),
            "cs_over_cs2": float(C_s) / CS2}


def _smagorinsky_rows(e, nz_is_one: bool):
    """The coefficients of the non-equilibrium momentum flux components
    Q_kab = Σ_i ez2_ki·ex2_ai·ey2_bi·fneq_i (reference
    computeRelaxationParameter), in (k, a, b) order, the components whose
    coefficients are all zero left out: ex2 = [ex, 0, 0], ey2 = [0, ey, 0]
    and ez2 = [0, 0, ez], or [1, 0, ez] when nz = 1 (the reference's 2-D
    quirk)."""
    e = np.asarray(e).T  # (3, q)
    zeros, ones = np.zeros(e.shape[1], np.int64), np.ones(e.shape[1], np.int64)
    ex2 = np.stack([e[0], zeros, zeros])
    ey2 = np.stack([zeros, e[1], zeros])
    ez2 = np.stack([ones if nz_is_one else zeros, zeros, e[2]])
    rows = []
    for k in range(3):
        for a in range(3):
            for b in range(3):
                c = ez2[k] * ex2[a] * ey2[b]
                if c.any():
                    rows.append(tuple(int(x) for x in c))
    return rows


def smagorinsky_inv_tau(fneq, e, mean, C_s: float, tau0: float, nz_is_one: bool):
    """The per-cell 1/τ of the Smagorinsky collision from the
    non-equilibrium planes and the grid's mean density (a 0-d tensor):
    |Q|/(ρ̄ c_s²) → S = (√(η² + 4 Q̄) − η)/(2 t_sgs) → τ = τ₀ + C_s S/c_s².
    Each component a signed sum in index order, |Q|² summed in (k, a, b)
    order; the fused kernel does the same operations."""
    k = smagorinsky_constants(C_s, tau0)
    q2 = None
    for row in _smagorinsky_rows(e, nz_is_one):
        comp = signed_sum(row, fneq)
        t = comp * comp
        q2 = t if q2 is None else q2 + t
    if q2 is None:
        q2 = torch.zeros_like(fneq[0])
    q_mean = torch.sqrt(q2) / (mean * CS2)
    s = (torch.sqrt(k["eta2"] + 4.0 * q_mean) - k["eta"]) * k["inv_2tsgs"]
    return torch.reciprocal(float(tau0) + k["cs_over_cs2"] * s)


def mrt_relax(fneq, msm, i):
    """Row i of MSM·fneq: Σ_j msm[i][j]·fneq_j over every entry, in index
    order (the kernel's order; the MSM of D2Q9, D3Q19 and D3Q27 has no
    zero entry, so this is also the JAX kernel's zero-skipping sum)."""
    relax = fneq[0] * float(msm[i][0])
    for j in range(1, len(fneq)):
        relax = relax + fneq[j] * float(msm[i][j])
    return relax


class _CollisionBase(LatticeBoltzmannOperator):
    """Template base for collisions (reference LBMCollisionDynamics.C:1-319),
    with the Hermite projection of ``projection = true``."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.f = self.input_buffer("f")
        self.feq = self.input_buffer("feq")
        self.tau_0 = problem.get_constant(params.get_str("tau0", required=True))
        self.C_s = problem.get_constant(params.get_str("Cs", "0.1"))
        self.delta_x = 1.0
        self.projection = params.get_bool("projection", False)

    def planes(self, state):
        """(feq, fneq) as lists of direction planes; fneq projected when
        ``projection = true``."""
        f, feq = _q_major(state[self.f]), list(_q_major(state[self.feq]))
        fneq = [f[i] - feq[i] for i in range(f.shape[0])]
        if self.projection:
            st = self.stencil
            fneq = hermite(fneq, hermite_tables(np.stack([st.ex, st.ey, st.ez], 1),
                                                st.weights))
        return feq, fneq

    def finish(self, planes):
        u = torch.stack(planes, 0).movedim(0, -1)
        u = self.masked_fill_solids(u)
        return {self.out: self.masked_fill_solids(u)}

    def output_specs(self, specs):
        return {self.out: Spec(_broadcast_spec(specs[self.f], specs[self.feq]),
                               specs[self.f].dtype)}


@computes.register("LBMBGKCollision")
class LBMBGKCollision(_CollisionBase):
    def apply(self, state, ctx):
        inv_tau = 1.0 / self.tau_0
        if not self.projection:
            fneq = state[self.f] - state[self.feq]
            u = state[self.feq] + fneq - fneq * inv_tau
            u = self.masked_fill_solids(u)
            return {self.out: self.masked_fill_solids(u)}
        feq, fneq = self.planes(state)
        return self.finish([e + n - n * inv_tau for e, n in zip(feq, fneq)])


@computes.register("LBMMRTCollision")
class LBMMRTCollision(_CollisionBase):
    """u = feq + fneq − MSM·fneq (reference LBMMRTCollision.C), each row of
    the contraction a sum over directions in index order (``mrt_relax``)."""

    def apply(self, state, ctx):
        msm = mrt_matrix(self.stencil, self.tau_0)
        feq, fneq = self.planes(state)
        out = []
        return self.finish([feq[i] + fneq[i] - mrt_relax(fneq, msm, i)
                            for i in range(len(fneq))])


class _SmagorinskyBase(_CollisionBase):
    def inv_tau(self, state, fneq):
        """1/τ a cell from the projected (where asked) non-equilibrium
        planes and the mean over the grid of Σ_q f, solids (zero) included,
        as the reference's ``mean(sum(f, 3))``."""
        st = self.stencil
        f = state[self.f]
        mean = tree_mean(_direction_sum(_q_major(f)))
        return smagorinsky_inv_tau(fneq, np.stack([st.ex, st.ey, st.ez], 1), mean,
                                   self.C_s, self.tau_0, f.shape[2] == 1)


@computes.register("LBMSmagorinskyCollision")
class LBMSmagorinskyCollision(_SmagorinskyBase):
    """BGK with a per-cell τ (reference LBMSmagorinskyCollision.C):
    u = feq + fneq − fneq/τ, by the reciprocal ``smagorinsky_inv_tau``."""

    def apply(self, state, ctx):
        feq, fneq = self.planes(state)
        inv_tau = self.inv_tau(state, fneq)
        return self.finish([e + n - n * inv_tau for e, n in zip(feq, fneq)])


@computes.register("LBMSmagorinskyMRTCollision")
class LBMSmagorinskyMRTCollision(_SmagorinskyBase):
    """MRT with the per-cell τ on the kinematic-viscosity moments
    (reference LBMSmagorinskyMRTCollision.C, computeLocalRelaxationMatrix):
    m = M·fneq, the stencil's S on every moment but those, 1/τ on those,
    u = feq + fneq − M⁻¹·m′.  Eager only: the fused kernel does not take
    it (the JAX package does not fuse it either)."""

    def apply(self, state, ctx):
        st = self.stencil
        feq, fneq = self.planes(state)
        inv_tau = self.inv_tau(state, fneq)
        visc = {int(i) for i in st.id_kinematic_visc}
        q = len(fneq)

        def row_times(mat, i, vecs):
            acc = None
            for j in range(q):
                c = float(mat[i, j])
                if c != 0.0:
                    t = vecs[j] * c
                    acc = t if acc is None else acc + t
            return acc if acc is not None else torch.zeros_like(vecs[0])

        m_neq = [row_times(st.M, i, fneq) for i in range(q)]
        relaxed = [inv_tau * m_neq[i] if i in visc else row_times(st.S, i, m_neq)
                   for i in range(q)]
        return self.finish([feq[i] + fneq[i] - row_times(st.M_inv, i, relaxed)
                            for i in range(q)])


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


@computes.register("LBMComputeForces")
class LBMComputeForces(LatticeBoltzmannOperator):
    """Gravity/buoyancy force field (reference LBMComputeForces.C):
    F_d = g·ρ (gravity) + g·ρ₀·(T − T₀) (Boussinesq buoyancy) along
    ``gravity_direction`` d, zero along the other axes and at solids."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.rho = params.get_str("rho", "rho")
        self.temperature = params.get_str("temperature", "T")
        self.enable_gravity = params.get_bool("enable_gravity", False)
        self.enable_buoyancy = params.get_bool("enable_buoyancy", False)
        if self.enable_gravity and self.rho not in self.inputs:
            self.inputs.append(self.rho)
        if self.enable_buoyancy:
            for b in (self.rho, self.temperature):
                if b not in self.inputs:
                    self.inputs.append(b)
        self.rho0 = problem.get_constant(params.get_str("rho0", "1.0"))
        self.T0 = problem.get_constant(params.get_str("T0", "1.0"))
        self.g = problem.get_constant(params.get_str("gravity", "0.001"))
        self.gravity_direction = int(params.get_float("gravity_direction", 1))

    def apply(self, state, ctx):
        shape = state[self.out].shape
        fd = None
        if self.enable_gravity:
            fd = self.g * _ensure3d(state[self.rho])
        if self.enable_buoyancy:
            t = self.g * self.rho0 * (_ensure3d(state[self.temperature]) - self.T0)
            fd = t if fd is None else fd + t
        zero = torch.zeros(shape[:-1], dtype=self.domain.dtype,
                           device=state[self.out].device)
        comps = [zero] * shape[-1]
        if fd is not None:
            comps[self.gravity_direction] = fd.expand(shape[:-1]).to(zero.dtype)
        return {self.out: self.masked_fill_solids(torch.stack(comps, -1))}

    def output_specs(self, specs):
        return {self.out: Spec(specs[self.out].shape, self.domain.dtype)}


@computes.register("LBMApplyForces")
class LBMApplyForces(LatticeBoltzmannOperator):
    """Guo forcing source added onto the collision's output (reference
    LBMApplyForces.C): f_i += pref_i·ρ·(e_i·F), pref_i = (1 − 1/(2τ))·w_i/c_s²
    (``guo_prefactors``), e_i·F summed over the non-zero components of e_i
    in axis order, as the kernel does."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        # the reference declares a velocity input but its use is commented
        # out (LBMApplyForces.C); not requesting it avoids an implicit buffer
        self.rho = self.input_buffer("rho")
        self.forces = self.input_buffer("forces")
        self.tau = problem.get_constant(params.get_str("tau0", required=True))
        # accumulates onto its own output buffer: depends on the collision
        # that produced it
        if self.out not in self.inputs:
            self.inputs.append(self.out)

    def apply(self, state, ctx):
        st = self.stencil
        rho = _ensure3d(state[self.rho])
        F = state[self.forces]
        comps = [F[..., k] for k in range(F.shape[-1])]
        pref = guo_prefactors(st.weights, self.tau)
        fq = _q_major(state[self.out])
        out = []
        for i in range(st.q):
            e = (int(st.ex[i]), int(st.ey[i]), int(st.ez[i]))[:len(comps)]
            edotf = signed_sum(e, comps)
            out.append(fq[i] if edotf is None else fq[i] + pref[i] * rho * edotf)
        u = torch.stack(out, 0).movedim(0, -1)
        return {self.out: self.masked_fill_solids(u)}

    def output_specs(self, specs):
        return {self.out: specs[self.out]}


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
