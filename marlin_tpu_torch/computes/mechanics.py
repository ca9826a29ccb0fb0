"""FFT micromechanics computes (deGeus-style Galerkin FFT solver).

The PyTorch counterpart of marlin_tpu/computes/mechanics.py (reference
src/tensor_computes/FFTMechanics.C:76-163, HyperElasticIsotropic.C:42-52,
ComputeDisplacements.C, ComputeVonMisesStress.C,
FFTQuasistaticElasticity.C:96-160, FFTElasticChemicalPotential.C,
RankTwoIdentity.C, the test computes MacroscopicShearTensor and
PhaseMechanicsTest, and the CG of include/utils/MarlinUtils.h:55-131).

The JAX package runs the Newton and CG loops as ``lax.while_loop``s; here
they are host loops, as the reference's are, and as the port's secant and
Broyden solvers are.  A CG iteration gathers its done flag and residual
norm into one small tensor and fetches it once; a Newton iteration after
the first fetches its done flag once.  ``FFTMechanics.counts`` keeps what
the loops saw (``MechanicsCounts``).  On a mesh (FFT_SLAB or FFT_PENCIL)
every dot product and norm is a rank's partial sum reduced over the group
(``Domain.reduce``) before anything decides on it, so every rank takes the
same branch of the breakdown guard and runs the same iterations.

The rank-4 Green operator is never built: the projection is applied
factorized per k-point.  Above 8192 cells (``analytic_tangent = auto``)
the rank-4 tangent is not built either: ``tangent_apply`` contracts it
from F, S and B with batched 3×3 products.  Those products run in full
float32 (the package turns TF32 off at import): bf16-class contractions
floor the Newton residual above the deck tolerances
(marlin_tpu/computes/mechanics.py:34-45).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import parallel, perf, unordered_fft
from ..params import Params
from ..registry import computes
from .base import ComputeError, Spec, TensorCompute

# -- contraction helpers (reference MarlinUtils.C:139-186) ------------------


def trans2(A2):
    return A2.transpose(-1, -2)


def ddot42(A4, B2):
    return torch.einsum("...ijkl,...lk->...ij", A4, B2)


def ddot44(A4, B4):
    return torch.einsum("...ijkl,...lkmn->...ijmn", A4, B4)


def dot22(A2, B2):
    return torch.einsum("...ij,...jk->...ik", A2, B2)


def dot24(A2, B4):
    return torch.einsum("...ij,...jkmn->...ikmn", A2, B4)


def dot42(A4, B2):
    return torch.einsum("...ijkl,...lm->...ijkm", A4, B2)


def dyad22(A2, B2):
    return torch.einsum("...ij,...kl->...ijkl", A2, B2)


def _norm(x, dom=None):
    """|x| over the whole grid: on a mesh, the ranks' Σx² summed over it."""
    if dom is None or dom.mesh is None:
        return torch.linalg.vector_norm(x)
    return dom.reduce(x.square().sum()).sqrt()


def _dot(a, b, dom=None):
    """a·b over the whole grid: on a mesh, the ranks' sums summed over it."""
    local = (a * b).sum()
    return local if dom is None else dom.reduce(local)


@dataclass
class CGResult:
    """What ``conjugate_gradient`` returns: the iterate, the JAX loop's
    iteration count, the residual norm, the iterations that ran on the
    device (one more than ``iterations`` where the right-hand side was
    zero: that one is discarded) and the host fetches made."""

    x: torch.Tensor
    iterations: int
    residual: float
    device_iterations: int
    fetches: int


def conjugate_gradient(A, b, x0, tol, maxiter, Minv=None, dom=None) -> CGResult:
    """Matrix-free CG with convergence relative to |b| (reference
    conjugateGradientSolve, include/utils/MarlinUtils.h:55-131); ``Minv``
    left-preconditions (z = M⁻¹r), None is plain CG
    (marlin_tpu/computes/mechanics.py:conjugate_gradient).

    The breakdown guard of the JAX version: an update is skipped where
    p·Ap ≤ 0 or r·z ≤ 0, the loop stops on NaN or on a residual grown 100×
    past max(|b|, |r0|), and only a solve that blew up returns the best
    iterate seen.  A host loop: each iteration fetches p·Ap, r·z and the new
    residual norm in one transfer (the first also |b| and |r0|) and decides
    on the host, so the guard costs no device work: a skipped update keeps
    the previous iterate, as the JAX loop's zero step does.  Where b is
    zero the JAX loop runs no iteration: x0 is returned with a count of 0
    (the iteration this ran is discarded).  ``x0 = None`` starts from zero
    without applying A to it (r = b − A(0) = b exactly).  With ``dom``
    every dot product and norm is taken over its mesh."""
    apply_Minv = Minv if Minv is not None else (lambda r: r)
    b_norm = _norm(b, dom)
    if x0 is None:
        x0, r = torch.zeros_like(b), b
    else:
        r = b - A(x0)
    z = apply_Minv(r)
    p = z
    rz_old = _dot(r, z, dom)
    r0_norm = _norm(r, dom)
    x = x_best = x0
    k = fetches = 0
    blown = False
    res = res_best = None
    while k < maxiter:
        Ap = A(p)
        pAp = _dot(p, Ap, dom)
        alpha = rz_old / pAp
        # products and sums apart, as the JAX loop computes them (a fused
        # multiply-add parts from it on ill-conditioned systems)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        extra = [b_norm, r0_norm] if k == 0 else []
        host = torch.stack([pAp, rz_old, _norm(r_new, dom)] + extra).tolist()
        fetches += 1
        perf.count("fetches")
        pAp_h, rz_h, res_new = host[:3]
        if k == 0:
            b_norm_h, r0_h = host[3:]
            if b_norm_h == 0.0:
                return CGResult(x0, 0, r0_h, 1, fetches)
            cap = 100.0 * max(b_norm_h, r0_h)
            res = res_best = r0_h
        k += 1
        broke = pAp_h <= 0.0 or rz_h <= 0.0
        if not broke:
            x, r, res = x_new, r_new, res_new
        if res < res_best:
            x_best, res_best = x, res
        diverged = broke or math.isnan(res) or res > cap
        blown = blown or diverged
        if res <= tol * b_norm_h or diverged:
            break
        z = apply_Minv(r)
        rz_new = _dot(r, z, dom)
        p = z + rz_new / (rz_h if rz_h != 0.0 else 1.0) * p
        rz_old = rz_new
    if k == 0:
        return CGResult(x0, 0, float(r0_norm), 0, fetches)
    # only a blown solve substitutes the best iterate
    return CGResult(x_best if blown else x, k, res_best if blown else res, k, fetches)


def preconditioned_conjugate_gradient(A, Minv, b, x0, tol, maxiter) -> CGResult:
    """Left-preconditioned CG: ``conjugate_gradient`` with Minv bound."""
    return conjugate_gradient(A, b, x0, tol, maxiter, Minv=Minv)


def _identity_tensors(dim, dtype, device=None):
    ti = torch.eye(dim, dtype=dtype, device=device)
    tI4 = torch.einsum("il,jk->ijkl", ti, ti)
    tI4rt = torch.einsum("ik,jl->ijkl", ti, ti)
    tI4s = (tI4 + tI4rt) / 2.0
    tII = dyad22(ti, ti)
    return ti, tI4, tI4rt, tI4s, tII


def _vf(t):
    """A (…, d, d) field with its value axes in front, (d, d, …): a view."""
    return t.movedim((-2, -1), (0, 1))


def _vl(t):
    """The inverse of ``_vf``: (d, d, …) to (…, d, d), a view."""
    return t.movedim((0, 1), (-2, -1))


def value_major(t):
    """t (…, d, d) stored value-first, each component one contiguous plane,
    as the domain's transforms and the products below read it best; no
    copy where it is so already."""
    v = _vf(t)
    return t if v.is_contiguous() else _vl(v.contiguous())


def _mm(A, B):
    """Σ_k A_ik B_kj of value-first (d, d, …) fields: one broadcast product
    over the d³ planes and one sum (batched 3×3 matrix products run far
    slower on the card: PERF.md §6)."""
    return (A[:, :, None] * B[None]).sum(1)


def _eye_vf(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device).reshape(
        (d, d) + (1,) * (like.ndim - 2))


def tangent_apply_components(fields, dF):
    """``HyperElasticIsotropic.tangent_apply`` as the JAX file writes it:
    sums over tensor components, each a scalar field (about 260 eager
    operations in 3-D), held and timed against the port's form."""
    F, S, B, c, mu = fields
    d = F.shape[0]
    dFv = _vf(dF)
    FdF = sum(F[i, j] * dFv[i, j] for i in range(d) for j in range(d))
    T = [[sum(dFv[k, l] * F[j, l] for l in range(d)) for j in range(d)] for k in range(d)]
    out = [[
        sum(S[i, l] * dFv[j, l] for l in range(d))
        + c * F[j, i] * FdF
        + mu * sum(B[j, k] * dFv[k, i] for k in range(d))
        + mu * sum(F[k, i] * T[k][j] for k in range(d))
        for j in range(d)] for i in range(d)]
    return torch.stack([torch.stack([out[j][i] for j in range(d)], dim=-1)
                        for i in range(d)], dim=-2)


def tangent_apply_matmul(fields, dF):
    """``HyperElasticIsotropic.tangent_apply`` as batched (…, 3, 3) matrix
    products (torch.matmul), held and timed against the port's form."""
    F, S, B, c, mu = (_vl(t) if t.ndim == dF.ndim else t for t in fields)
    FdF = (F * dF).sum((-2, -1))
    return (dF @ trans2(S) + (c * FdF)[..., None, None] * F
            + mu[..., None, None] * (B @ dF + F @ trans2(dF) @ F))


@computes.register("HyperElasticIsotropic")
class HyperElasticIsotropic(TensorCompute):
    """St.Venant-Kirchhoff-style hyperelasticity: S = C:(FᵀF−I)/2, P = F·S,
    consistent tangent K4 (reference HyperElasticIsotropic.C:42-52)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.F = self.input_buffer("F")
        self.mu = self.input_buffer("mu")
        self.K = self.input_buffer("K")
        self.tangent = params.get_str("tangent_operator", "dstressdstrain")
        self.outputs = [self.out, self.tangent]
        #: set False by FFTMechanics when nothing else reads the rank-4
        #: tangent: apply() then gives the stress only and the Newton/CG
        #: loop contracts the tangent analytically (tangent_apply)
        self.emit_tangent = True

    @staticmethod
    def _second_pk(F, K, mu):
        """S = C:E without C4: K·tr(E)·I + 2µ·(E − tr(E)/3·I), of a
        value-first F (d, d, …)."""
        ti = _eye_vf(F.shape[0], F)
        E = 0.5 * (_mm(F.transpose(0, 1), F) - ti)
        trE = E.diagonal(dim1=0, dim2=1).sum(-1)
        return K * trE * ti + 2.0 * mu * (E - trE / 3.0 * ti)

    def apply(self, state, ctx):
        dom = self.domain
        F = state[self.F]
        if not self.emit_tangent:
            Fv = _vf(F)
            S = self._second_pk(Fv, state[self.K], state[self.mu])
            # the state keeps the plain layout a checkpoint restores
            return {self.outputs[0]: _vl(_mm(Fv, S)).contiguous()}
        # materialised: the reference's operation order (1e-13 gold parity)
        ti, tI4, tI4rt, tI4s, tII = _identity_tensors(dom.dim, dom.dtype, dom.device)
        Km = state[self.K][..., None, None, None, None]
        mu = state[self.mu][..., None, None, None, None]
        C4 = Km * tII + 2.0 * mu * (tI4s - tII / 3.0)
        S = ddot42(C4, 0.5 * (dot22(trans2(F), F) - ti))
        P = dot22(F, S)
        K4 = dot24(S, tI4) + ddot44(
            ddot44(tI4rt, dot42(dot24(F, C4), trans2(F))), tI4rt)
        return {self.outputs[0]: P, self.tangent: K4}

    def output_specs(self, specs):
        dom = self.domain
        out = {self.outputs[0]: Spec(dom.value_shape((dom.dim,) * 2), dom.dtype)}
        if self.tangent in self.outputs:
            out[self.tangent] = Spec(dom.value_shape((dom.dim,) * 4), dom.dtype)
        return out

    def tangent_fields(self, scope):
        """The fields of the analytic contraction that do not change inside
        CG (functions of F, K and µ), built once a Newton iteration: F, S
        and B = F·Fᵀ value-first, c = K − 2µ/3 and µ."""
        F = _vf(scope[self.F])
        K, mu = scope[self.K], scope[self.mu]
        return (F, self._second_pk(F, K, mu), _mm(F, F.transpose(0, 1)),
                K - 2.0 * mu / 3.0, mu)

    def tangent_apply(self, fields, dF):
        """trans2(ddot42(K4, trans2(dF))) without K4.  With B = F·Fᵀ and
        c = K − 2µ/3 the tangent is
          K4_ijkl = S_il δ_jk + c F_ji F_kl + µ B_jk δ_il + µ F_jl F_ki ,
        so the contraction is dF·Sᵀ + c·(F:dF)·F + µ·(B·dF + F·dFᵀ·F); with
        X = Fᵀ·dF that is dF·Sᵀ + c·tr(X)·F + µ·F·(X + Xᵀ): three 3×3
        products a point, each a broadcast product and a sum over planes
        (14 eager operations; the JAX file's component sums are
        ``tangent_apply_components``)."""
        F, S, _B, c, mu = fields
        dFv = _vf(dF)
        X = _mm(F.transpose(0, 1), dFv)
        trX = X.diagonal(dim1=0, dim2=1).sum(-1)
        out = (_mm(dFv, S.transpose(0, 1)) + (c * trX) * F
               + mu * _mm(F, X + X.transpose(0, 1)))
        return _vl(out)

    def tangent_contract(self, scope, dF):
        return self.tangent_apply(self.tangent_fields(scope), dF)


@computes.register("RankTwoIdentity")
class RankTwoIdentity(TensorCompute):
    """F = I everywhere (reference RankTwoIdentity.C)."""

    def apply(self, state, ctx):
        dom = self.domain
        eye = torch.eye(dom.dim, dtype=dom.dtype, device=dom.device)
        return {self.out: eye.expand(dom.value_shape((dom.dim, dom.dim))).contiguous()}

    def output_specs(self, specs):
        dom = self.domain
        return {self.out: Spec(dom.value_shape((dom.dim, dom.dim)), dom.dtype)}


def newton_exhausted_message(name):
    """Error raised when a Newton solve runs out of iterations (reference
    FFTMechanics.C "Exceeded the maximum number of nonlinear iterations")."""
    return (
        f"FFTMechanics '{name}': Exceeded the maximum number of "
        "nonlinear iterations without converging (reference "
        "FFTMechanics.C error; raise nl_max_its or loosen nl_*_tol)"
    )


@dataclass
class MechanicsCounts:
    """What an FFTMechanics compute's host loops saw since it was built:
    solves (one a substep), Newton iterations, CG iterations (the JAX
    loop's count) and those that ran on the device, device-to-host fetches
    (one a CG iteration that ran, one a Newton iteration after the first),
    operator applications (one a CG iteration that ran, and the residual
    and right-hand side of each Newton iteration and solve), solves that
    did not converge, and the group reductions the solves made on a mesh
    (``parallel.calls()["all_reduce"]`` across them; none without one)."""

    solves: int = 0
    newton: int = 0
    cg: int = 0
    cg_device: int = 0
    fetches: int = 0
    projections: int = 0
    failed: int = 0
    reductions: int = 0


def _hermitian_nyquist(dom, qvec):
    """q (…, dim) on the full spectrum of fft_backend = PALLAS, made to give
    what DEFAULT gives on its half spectrum (rfftn along the last axis).
    At an even extent's Nyquist index a mode (k) and its partner (−k) share
    the index and its one value −π/h, so q(−k) ≠ −q(k), and the real part
    of the inverse averages the two modes' results: the Green projection
    then leaves DEFAULT's (the Newton solution by 3.4e-4 on F at 32³ after
    2 steps of 10 substeps, CPU), and the displacements lose their Nyquist
    components (15% of max|u| on a random F at 16³).  DEFAULT keeps the
    modes of k_last ≥ 0, its Nyquist at +π/h, and gives those of k_last < 0
    their partner's conjugate.  So here: the last axis' Nyquist component
    is +π/h, and the other axes' Nyquist components are +π/h on the modes
    of k_last < 0; then q(−k) = −q(k) off the planes k_last = 0 and
    Nyquist, where the real part treats both backends alike.  The JAX
    package keeps the averaging (ROADMAP §3).  The masks are built on the
    whole grid's axes and cut to the rank's reciprocal block on a mesh."""
    last = dom.dim - 1
    nyquist = []
    for d in range(dom.dim):
        n, h = dom.n_global[d], dom.grid_spacing[d]
        freq = unordered_fft.permuted_freqs(n, d=h)
        mask = (freq == np.fft.fftfreq(n, d=h)[n // 2] if n % 2 == 0
                else np.zeros(n, dtype=bool))
        if d == last:
            negative = ((freq < 0) & ~mask)[dom.reciprocal_slice[d]]
        nyquist.append(mask[dom.reciprocal_slice[d]])
    comps = []
    for d in range(dom.dim):
        q = qvec[..., d]
        if d == last:
            q = torch.where(dom._aligned(nyquist[d], d), -q, q)
        elif nyquist[d].any():
            flip = dom._aligned(nyquist[d], d) & dom._aligned(negative, last)
            q = torch.where(flip, -q, q)
        comps.append(q)
    return torch.stack(comps, dim=-1)


@computes.register("FFTMechanics")
class FFTMechanics(TensorCompute):
    """Galerkin FFT micromechanics: the Green projection applied factorized,
    a Newton loop around matrix-free CG over G(K:dF) (reference
    FFTMechanics.C:96-163)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.F = self.input_buffer("F", required=False) or "F"
        if self.F not in self.inputs:
            self.inputs.append(self.F)
        self.K = self.input_buffer("K")
        self.mu = self.input_buffer("mu", required=False)
        self.stress = params.get_str("stress", "stress")
        self.tangent = params.get_str("tangent_operator", "dstressdstrain")
        self.applied = params.get_str("applied_macroscopic_strain", None)
        if self.applied and self.applied not in self.inputs:
            self.inputs.append(self.applied)
        self.l_tol = params.get_float("l_tol", 1e-2)
        self.l_max_its = params.get_int("l_max_its", 0)
        self.nl_rel_tol = params.get_float("nl_rel_tol", 1e-5)
        self.nl_abs_tol = params.get_float("nl_abs_tol", 1e-8)
        self.nl_max_its = params.get_int("nl_max_its", 100)
        self.constitutive_name = params.get_str("constitutive_model", required=True)
        self.constitutive = None  # bound in check()
        # the convergence flag: a 0-d bool pseudo-buffer ANDed across
        # substeps, checked at the step's one device-to-host transfer
        self.converged_key = f"__converged_{name}__"
        # 'auto' keeps the reference's operation order up to 8192 cells and
        # contracts the tangent analytically above; 'true'/'false' force
        self.analytic_param = params.get_enum(
            "analytic_tangent", ["auto", "true", "false"], "auto")
        self.analytic_tangent = False  # resolved in check()
        # REFERENCE_MEDIUM: the inverse of the homogeneous Green-projected
        # isotropic tangent of the volume-average moduli (Moulinec-Suquet),
        # a closed-form solve a k-point; NONE keeps the reference's CG
        self.precond = params.get_enum(
            "preconditioner", ["NONE", "REFERENCE_MEDIUM"], "NONE")
        self.counts = MechanicsCounts()
        self.cg_log = []  # the JAX loop's CG count of each Newton iteration
        self._green = None  # (qvec, inv_k2, qn), built at first use

    def _tangent_referenced_in_deck(self) -> bool:
        """True if a deck parameter other than a `tangent_operator`
        declaration names the tangent buffer: something besides the
        Newton/CG loop reads the rank-4 field."""
        target = self.tangent

        def walk(node):
            for key, val in node.params.items():
                if key == "tangent_operator":
                    continue
                if target in str(val).split():
                    return True
            return any(walk(ch) for ch in node.blocks())

        return walk(self.problem.root)

    def check(self):
        self.constitutive = self.problem.get_compute(self.constitutive_name)
        if self.stress not in self.constitutive.outputs:
            raise ComputeError(
                f"constitutive_model '{self.constitutive_name}' does not "
                f"provide stress tensor '{self.stress}'."
            )
        want = self.analytic_param
        if want == "auto":
            want = "true" if self.problem.domain.n_cells_global > 8192 else "false"
        self.analytic_tangent = (
            want == "true"
            # gate on the methods apply() calls, so a model without them
            # keeps the materialised form
            and hasattr(self.constitutive, "tangent_fields")
            and hasattr(self.constitutive, "tangent_apply")
            and not self._tangent_referenced_in_deck()
        )
        if self.analytic_tangent:
            self.constitutive.emit_tangent = False
            ct = getattr(self.constitutive, "tangent", None)
            if ct in self.constitutive.outputs:
                self.constitutive.outputs.remove(ct)

    def output_specs(self, specs):
        if self.constitutive is None:
            self.check()
        dom = self.domain
        out = {self.out: Spec(dom.value_shape((dom.dim, dom.dim)), dom.dtype)}
        out.update(self.constitutive.output_specs(specs))
        out[self.converged_key] = Spec((), torch.bool, None)
        return out

    def _green_factors(self):
        """q (dim, …), 1/|q|² (0 at k = 0) and q/|q|² on the reciprocal
        grid, built once: the two factors of the Green projection
        Ĝ_ijlm = δ_im q_j q_l/|q|² (reference FFTMechanics.C:76-87)."""
        if self._green is None:
            dom = self.domain
            rshape = dom.reciprocal_shape
            qvec = torch.stack([dom.reciprocal_axis(d).expand(rshape)
                                for d in range(dom.dim)], dim=-1)
            if dom.fft_backend == "PALLAS":
                qvec = _hermitian_nyquist(dom, qvec)
            k2 = dom.k_square
            inv_k2 = torch.where(k2 == 0, 0.0, 1.0 / torch.where(k2 == 0, 1.0, k2))
            # value-first, (dim, *reciprocal), as the transforms give their
            # spectra
            q = qvec.movedim(-1, 0).contiguous()
            self._green = (q, inv_k2, (q * inv_k2).contiguous())
        return self._green

    def project(self, A2):
        """The Green projection of a (…, dim, dim) field: (Ĝ : A)_ij =
        q_j · (Σ_k q_k Â_ik)/|q|², value-first throughout."""
        dom = self.domain
        qvec, _inv_k2, qn = self._green_factors()
        self.counts.projections += 1
        s = (_vf(dom.fft(A2)) * qvec[None]).sum(1)
        return _real_inverse(dom, _vl(s[:, None] * qn[None]))

    def apply(self, state, ctx):
        if self.constitutive is None:
            self.check()
        dom = self.domain
        counts = self.counts
        reductions = parallel.calls()["all_reduce"]
        qvec, inv_k2, qn = self._green_factors()
        G = self.project

        Minv = None
        if self.precond == "REFERENCE_MEDIUM":
            if self.mu is None:
                raise ComputeError(
                    f"FFTMechanics '{self.name}': preconditioner = "
                    "REFERENCE_MEDIUM needs the `mu` buffer (isotropic "
                    "reference moduli come from the K/mu volume averages)")
            mu0 = dom.average(state[self.mu]).to(dom.dtype)
            lam0 = (dom.average(state[self.K]) - 2.0 * mu0 / 3.0).to(dom.dtype)
            # on range(G), r̂_ij = rho_i q_j/|q|²; the homogeneous operator's
            # inverse there is rho/mu0 − (lam0+mu0)/((lam0+2mu0)·mu0) ·
            # (rho·q) q/|q|² (marlin_tpu/computes/mechanics.py:470-487)
            cfac = (lam0 + mu0) / ((lam0 + 2.0 * mu0) * mu0)

            def Minv(r):
                rho = (_vf(dom.fft(r)) * qvec[None]).sum(1)
                rho_q = (rho * qvec).sum(0)
                w = rho / mu0 - (cfac * rho_q * inv_k2) * qvec
                return _real_inverse(dom, _vl(w[:, None] * qn[None]))

        if self.analytic_tangent:
            def make_op(s):
                fields = self.constitutive.tangent_fields(s)
                return lambda dF: G(self.constitutive.tangent_apply(fields, dF))
        else:
            def make_op(s):
                return lambda dF: G(trans2(ddot42(s[self.tangent], trans2(dF))))

        def run_constitutive(scope):
            scope = dict(scope)
            scope.update(self.constitutive.apply(scope, ctx))
            return scope

        scope = dict(state)
        scope[self.out] = value_major(scope[self.F])
        scope = run_constitutive(scope)
        if self.applied is not None:
            applied = scope[self.applied].expand(scope[self.out].shape)
            b = -make_op(scope)(applied)
            scope[self.out] = scope[self.out] + applied
        else:
            b = -make_op(scope)(torch.zeros_like(scope[self.out]))
        Fn = _norm(scope[self.out], dom)
        l_max = self.l_max_its if self.l_max_its else dom.n_cells_global

        # the JAX loop's state: the first CG starts from zero, each later
        # one from the last correction; iteration 0 is never done
        dF = None
        it, done = 0, False
        while not done and it <= self.nl_max_its:
            cg = conjugate_gradient(make_op(scope), b, dF, self.l_tol, l_max, Minv=Minv,
                                    dom=dom)
            dF = cg.x
            counts.cg += cg.iterations
            self.cg_log.append(cg.iterations)
            counts.cg_device += cg.device_iterations
            counts.fetches += cg.fetches
            if it > 0:
                anorm, fn = torch.stack([_norm(dF, dom), Fn]).tolist()
                done = anorm / fn < self.nl_rel_tol or anorm < self.nl_abs_tol
                counts.fetches += 1
                perf.count("fetches")
            scope[self.out] = scope[self.out] + dF
            scope = run_constitutive(scope)
            if not done and it < self.nl_max_its:
                # the next iteration's right-hand side (the JAX loop also
                # computes it after the last iteration, unused)
                b = -G(scope[self.stress])
            it += 1
        counts.newton += it
        counts.reductions += parallel.calls()["all_reduce"] - reductions
        counts.solves += 1
        counts.failed += int(not done)
        # the plain layout, as a checkpoint restores it: a resumed run then
        # takes the same reductions as an uninterrupted one, bit for bit
        out = {k: scope[k].contiguous()
               for k in sorted({self.out, *self.constitutive.outputs})}
        prev = state.get(self.converged_key)
        flag = torch.tensor(done, device=dom.device)
        out[self.converged_key] = flag if prev is None else prev & flag
        return out


@computes.register("ComputeVonMisesStress")
class ComputeVonMisesStress(TensorCompute):
    """Von Mises stress from the stress tensor
    (reference ComputeVonMisesStress.C)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.stress = params.get_str("stress", "stress")
        if self.stress not in self.inputs:
            self.inputs.append(self.stress)

    def apply(self, state, ctx):
        s = state[self.stress]
        if self.domain.dim == 3:
            sxx, syy, szz = s[..., 0, 0], s[..., 1, 1], s[..., 2, 2]
            sxy, syz, szx = s[..., 0, 1], s[..., 1, 2], s[..., 2, 0]
            u = torch.sqrt(0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2
                                  + (szz - sxx) ** 2
                                  + 6.0 * (sxy ** 2 + syz ** 2 + szx ** 2)))
        elif self.domain.dim == 2:
            sxx, syy, sxy = s[..., 0, 0], s[..., 1, 1], s[..., 0, 1]
            u = torch.sqrt(0.5 * ((sxx - syy) ** 2 + 6.0 * sxy ** 2))
        else:
            raise ComputeError("Unsupported problem dimension")
        return {self.out: u}

    def output_specs(self, specs):
        return {self.out: Spec(self.domain.shape, specs[self.stress].dtype)}


_INTERPOLATION = {1: "linear", 2: "bilinear", 3: "trilinear"}


@computes.register("ComputeDisplacements")
class ComputeDisplacements(TensorCompute):
    """Displacements integrated from F in k-space and interpolated to the
    (n+1)^dim node grid (reference ComputeDisplacements.C).  The node grid
    is the whole grid's: on a mesh the cell field is gathered first and
    every rank holds all the nodes, as the JAX package's global array."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.F = self.input_buffer("F")

    def apply(self, state, ctx):
        dom = self.domain
        F = state[self.F]
        Fbox = dom.average(F)
        Hbar = dom.fft(F - Fbox)
        k = dom.k_grid
        if dom.fft_backend == "PALLAS":
            k = _hermitian_nyquist(dom, k)
        q = k.to(dom.cdtype) * (-1j)
        Q = dom.k_square[..., None]
        numer = (Hbar * q[..., None, :]).sum(-1)
        u_periodic_bar = torch.where(Q == 0, 0.0, numer / Q)
        eye = torch.eye(dom.dim, dtype=dom.dtype, device=dom.device)
        u = (torch.einsum("ij,...j->...i", Fbox - eye, dom.x_grid)
             + _real_inverse(dom, u_periodic_bar))
        # linear interpolation to the node grid with align_corners (the
        # reference's torch interpolate; the JAX package's map_coordinates
        # at linspace(0, n-1, n+1), order 1, mode nearest)
        u = dom.gather(u)
        nodes = torch.nn.functional.interpolate(
            u.movedim(-1, 0)[None], size=tuple(n + 1 for n in dom.n_global),
            mode=_INTERPOLATION[dom.dim], align_corners=True)
        return {self.out: nodes[0].movedim(0, -1).contiguous()}

    def output_specs(self, specs):
        dom = self.domain
        return {self.out: Spec(tuple(n + 1 for n in dom.n_global) + (dom.dim,), dom.dtype,
                               None)}


def _real_inverse(dom, spec):
    """dom.ifft of a fresh spectrum (*reciprocal, …) that need not be
    Hermitian (at the Nyquist indices of even extents).  On DEFAULT's half
    spectrum the planes k_half = 0 and k_half = Nyquist are first made
    Hermitian in the other axes, in place: what numpy's and torch's CPU
    c2r read from them (the real part of the inverse over those axes),
    while cuFFT's multi-axis c2r leaves a non-Hermitian plane's result to
    the algorithm its batch layout picks (128³ float32 on the card: a
    Newton solve's CG stalled at its cap on one layout and not on the
    other).  On a mesh the distributed inverse drops the imaginary part of
    those planes after the other axes' transforms (``parallel._real_ends``),
    which is the same fix.  The full spectrum of PALLAS takes the real part
    anyway."""
    half = dom.half_axis
    if dom.fft_backend == "DEFAULT" and dom.mesh is None and half is not None:
        n = dom.n_global[half]
        lead = tuple(range(dom.dim - 1))  # the plane's spatial axes
        for idx in (0, n // 2) if n % 2 == 0 else (0,):
            plane = spec.select(half, idx)
            partner = plane.flip(lead).roll((1,) * len(lead), lead) if lead else plane
            plane.copy_(0.5 * (plane + partner.conj()))
    return dom.ifft(spec)


def _acoustic_axes(dom):
    """2πi·k_d for d = 0, 1, 2 (zero past the grid's dimension): the
    reference multiplies the already angular axes by another 2πi, kept for
    parity (FFTQuasistaticElasticity.C:96-160).  Under PALLAS the full
    grid's Hermitian-consistent k (``_hermitian_nyquist``)."""
    k = [dom.reciprocal_axis(d) for d in range(3)]
    if dom.fft_backend == "PALLAS":
        full = _hermitian_nyquist(dom, torch.stack(
            [a.expand(dom.reciprocal_shape) for a in k[:dom.dim]], dim=-1))
        k[:dom.dim] = full.unbind(-1)
    return [a * (2j * math.pi) for a in k]


@computes.register("FFTQuasistaticElasticity")
class FFTQuasistaticElasticity(TensorCompute):
    """Homogeneous quasistatic elasticity: the 3×3 acoustic system with the
    eigenstrain right-hand side, solved in closed form a k-point, k = 0
    pinned (reference FFTQuasistaticElasticity.C:96-160)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.displacements = params.get_str_vector("displacements", required=True)
        self.outputs = list(self.displacements)
        self.cbar = self.input_buffer("cbar")
        self.mu = params.get_float("mu", required=True)
        self.lam = params.get_float("lambda", required=True)
        self.e0 = params.get_float("e0", required=True)
        if problem.domain.dim != len(self.displacements):
            params.error(
                "displacements", "Need one displacement variable per mesh dimension")

    def apply(self, state, ctx):
        dom = self.domain
        k = _acoustic_axes(dom)
        mu, lam = self.mu, self.lam
        ul = 2.0 * mu + lam
        shape = dom.reciprocal_shape
        Axx = (ul * k[0] * k[0] + mu * k[1] * k[1] + mu * k[2] * k[2]).expand(shape)
        Ayy = (ul * k[1] * k[1] + mu * k[0] * k[0] + mu * k[2] * k[2]).expand(shape)
        Azz = (ul * k[2] * k[2] + mu * k[0] * k[0] + mu * k[1] * k[1]).expand(shape)
        Axy = ((lam + mu) * k[0] * k[1]).expand(shape)
        Axz = ((lam + mu) * k[0] * k[2]).expand(shape)
        Ayz = ((lam + mu) * k[1] * k[2]).expand(shape)
        # k = 0 pinned by a mask, not a scatter (the JAX package's choice,
        # kept: ROADMAP §3)
        at_zero = dom.k_square == 0
        Axx = torch.where(at_zero, 1.0, Axx)
        Ayy = torch.where(at_zero, 1.0, Ayy)
        Azz = torch.where(at_zero, 1.0, Azz)
        e = 2.0 * self.e0 * state[self.cbar] * (3.0 * lam + mu)
        e = torch.where(at_zero, 0.0, e)
        b0, b1, b2 = k[0] * e, k[1] * e, k[2] * e
        # the symmetric system's cofactors, not a batched LU solve
        c00 = Ayy * Azz - Ayz * Ayz
        c01 = Axz * Ayz - Axy * Azz
        c02 = Axy * Ayz - Axz * Ayy
        inv_det = 1.0 / (Axx * c00 + Axy * c01 + Axz * c02)
        c11 = Axx * Azz - Axz * Axz
        c12 = Axy * Axz - Axx * Ayz
        c22 = Axx * Ayy - Axy * Axy
        x = [(c00 * b0 + c01 * b1 + c02 * b2) * inv_det,
             (c01 * b0 + c11 * b1 + c12 * b2) * inv_det,
             (c02 * b0 + c12 * b1 + c22 * b2) * inv_det]
        return {name: _real_inverse(dom, x[i]) for i, name in enumerate(self.displacements)}

    def output_specs(self, specs):
        dom = self.domain
        return {name: Spec(dom.shape, dom.dtype) for name in self.displacements}


@computes.register("FFTElasticChemicalPotential")
class FFTElasticChemicalPotential(TensorCompute):
    """The elastic chemical potential's contribution in k-space
    (reference FFTElasticChemicalPotential.C)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.displacements = params.get_str_vector("displacements")
        for d in self.displacements:
            if d not in self.inputs:
                self.inputs.append(d)
        self.cbar = self.input_buffer("cbar")
        self.mu = params.get_float("mu", required=True)
        self.lam = params.get_float("lambda", required=True)
        self.e0 = params.get_float("e0", required=True)

    def apply(self, state, ctx):
        dom = self.domain
        k = _acoustic_axes(dom)
        u = [dom.fft(state[d]) for d in self.displacements]
        while len(u) < 3:
            u.append(torch.zeros_like(u[0]))
        cbar = state[self.cbar]
        out = -self.e0 * (
            self.e0 * (9.0 * self.lam * cbar + self.mu * 6.0 * cbar)
            - (2.0 * self.mu + 3.0 * self.lam)
            * (k[0] * u[0] + k[1] * u[1] + k[2] * u[2]))
        return {self.out: out}

    def output_specs(self, specs):
        return {self.out: Spec(self.domain.reciprocal_shape, self.domain.cdtype,
                               parallel.RECIPROCAL)}


@computes.register("MacroscopicShearTensor")
class MacroscopicShearTensor(TensorCompute):
    """The applied shear ramp (I + t·e01) − <F>, a (dim, dim) tensor
    (reference test/src/tensor_computes/MacroscopicShearTensor.C)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.F = params.get_str("F", "F")
        if self.F not in self.inputs:
            self.inputs.append(self.F)

    def apply(self, state, ctx):
        dom = self.domain
        shear = torch.eye(dom.dim, dtype=dom.dtype, device=dom.device)
        shear[0, 1] += ctx["t"]
        return {self.out: shear - dom.average(state[self.F])}

    def output_specs(self, specs):
        dom = self.domain
        return {self.out: Spec((dom.dim, dom.dim), dom.dtype, None)}


@computes.register("PhaseMechanicsTest")
class PhaseMechanicsTest(TensorCompute):
    """Two-phase microstructure: a corner block of 1 of the whole grid
    (reference test/src/tensor_computes/PhaseMechanicsTest.C), this rank's
    block of it on a mesh."""

    def apply(self, state, ctx):
        dom = self.domain
        u = torch.zeros(dom.n_global, dtype=dom.dtype, device=dom.device)
        s = 30 if dom.dim == 2 else 9
        if dom.dim == 3:
            u[-s:, :s, -s:] = 1.0
        elif dom.dim == 2:
            u[-s:, :s] = 1.0
        else:
            raise ComputeError("Unsupported problem dimension")
        return {self.out: dom.local(u).contiguous()}

    def output_specs(self, specs):
        return {self.out: Spec(self.domain.shape, self.domain.dtype)}
