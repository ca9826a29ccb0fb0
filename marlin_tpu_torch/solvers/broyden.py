"""Good-Broyden solver for coupled variables.

The counterpart of marlin_tpu/solvers/broyden.py (reference BroydenSolver,
src/tensor_solver/BroydenSolver.C:55-180): per grid point an N×N complex
inverse Jacobian M, updated by M += (s − M·y)·sᵀ/(sᵀ·y), carried across
substeps and steps in ``state["solver"]["M"]`` (the reference keeps it as
a member), so a checkpoint holds it.  The per-point contractions (N ≤ 5)
are elementwise products and sums in the state's precision.  The loop runs
on the host like SecantSolver's: one fetch before the first iteration and
one after each, of a norm summed over the mesh first (``Domain.reduce``),
so that every rank of a mesh runs the same iterations.
"""

from __future__ import annotations

import torch

from .. import parallel
from ..params import Params
from ..registry import solvers
from .base import IterativeSolver
from .secant import _fetch, _sq


def _matvec(M, x):
    """Σ_j M[..., i, j]·x[..., j]."""
    return (M * x.unsqueeze(-2)).sum(-1)


@solvers.register("BroydenSolver")
class BroydenSolver(IterativeSolver):
    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.max_iterations = params.get_int("max_iterations", 100)
        self.rel_tol = params.get_float("relative_tolerance", 1e-9)
        self.abs_tol = params.get_float("absolute_tolerance", 1e-9)
        # read but inert: the reference reads damping (BroydenSolver.C:24,42)
        # and hard-codes sk*0.5 in the update (:135)
        self.damping = params.get_float("damping", 1.0)
        self.eye_factor = params.get_float("initial_jacobian_guess", 1.0)
        # reference BroydenSolver.C:30 "Show convergence history."
        self.verbose = params.get_bool("verbose", False)
        # BroydenSolver never calls applyPredictors (only SecantSolver.C:100
        # does): attached [Predictors] blocks are built but inert
        self.predictors = []

    STATE_LAYOUTS = {**IterativeSolver.STATE_LAYOUTS, "M": parallel.RECIPROCAL}

    def init_solver_state(self):
        n = len(self.variables)
        dom = self.domain
        eye = torch.eye(n, dtype=dom.cdtype, device=dom.device) * self.eye_factor
        M = eye.expand(dom.reciprocal_shape + (n, n)).contiguous()
        return {**super().init_solver_state(), "M": M}

    def _stack(self, bufs):
        u = torch.stack([bufs[v.reciprocal_buffer] for v in self.variables], -1)
        N = torch.stack([bufs[v.nonlinear_reciprocal] for v in self.variables], -1)
        L = torch.stack([
            bufs[v.linear_reciprocal] if v.linear_reciprocal is not None
            else torch.zeros_like(bufs[v.reciprocal_buffer])
            for v in self.variables], -1)
        return u, N, L

    def _norm(self, R):
        return self.domain.reduce(_sq(self.domain, R)).sqrt()

    def _done(self, R, R0norm):
        """(converged, NaN) of a residual, in one fetch."""
        Rnorm = self._norm(R)
        conv = (Rnorm < self.abs_tol) | (Rnorm / R0norm < self.rel_tol)
        (converged, nan), (host_norm,) = _fetch([conv, torch.isnan(Rnorm)], [Rnorm])
        return converged, nan, host_norm

    def substep(self, state, sub_time, sub_dt, dt, dt_old, substep_index, first_step):
        state = self._run_group(state, sub_time)
        buffers = dict(state["buffers"])
        M = state["solver"]["M"]
        names = [v.buffer for v in self.variables]

        u, N, L = self._stack(buffers)
        u_old = u
        R = (N + L * u) * sub_dt
        R0norm = self._norm(R)

        it = 0
        converged, nan, Rnorm = self._done(R, R0norm)
        while it < self.max_iterations and not converged and not nan:
            if self.verbose:  # reference :128 "i |R|=..."
                print(f"{it} |R|={Rnorm}")
            # update step s = -M·R (reference :128-131)
            sk = -_matvec(M, R)
            u_new = u + sk * 0.5  # the reference's hard-coded 0.5 (:135)
            buffers.update(self._ifft_stacked(names, u_new))
            st = self._run_group({**state, "buffers": buffers}, sub_time)
            buffers = dict(st["buffers"])
            u, N, L = self._stack(buffers)
            Rnew = (N + L * u) * sub_dt + u_old - u
            yk = Rnew - R
            denom = (sk * yk).sum(-1)[..., None, None]
            My = _matvec(M, yk)
            outer = (sk - My).unsqueeze(-1) * sk.unsqueeze(-2)
            M = M + torch.where(denom.abs() > 1e-12, outer / denom, 0.0)
            R = Rnew
            it += 1
            converged, nan, Rnorm = self._done(R, R0norm)

        solver_state = self._record(state, it, converged, syncs=it + 1, extra={"M": M})
        return {**state, "buffers": buffers, "solver": solver_state}
