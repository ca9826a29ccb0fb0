"""Implicit secant solver.

The counterpart of marlin_tpu/solvers/secant.py (reference SecantSolver,
src/tensor_solver/SecantSolver.C:52-204): a per-k-point elementwise secant
iteration du = −R·dx/dy after a semi-implicit bootstrap step
(dt_epsilon), with damping, a NaN abort and the rollback of a solve that
did not converge.

The JAX package runs the iteration as a ``lax.while_loop``; here it is a
host loop that stops on convergence, NaN or ``max_iterations``, as the
reference's ``.item()`` checks do (SecantSolver.C:88).  Each iteration
gathers the convergence flag, the NaN flag and every variable's |R| into
one small device tensor and fetches it once: one device-to-host transfer
an iteration, whatever the number of variables.  On a mesh the norms are
summed over the group first, every variable's in one reduction
(``Domain.reduce``), and the flags are computed from the reduced norms, so every
rank takes the same branch and runs the same iterations.  A pencil's pad
rows are left out of the sums (``Domain.spectrum``).
"""

from __future__ import annotations

import torch

from .. import perf
from ..params import Params
from ..registry import solvers
from .base import IterativeSolver


def _sq(dom, x):
    """This rank's Σ|x|² over the spectrum (a pencil's pad rows left out)."""
    return dom.spectrum(x).abs().square().sum()


def _fetch(flags, norms):
    """One transfer: (bool flags..., norms...) as host values."""
    host = torch.stack([f.to(torch.float64) for f in flags]
                       + [n.to(torch.float64) for n in norms]).tolist()
    perf.count("fetches")
    return [bool(h) for h in host[:len(flags)]], host[len(flags):]


@solvers.register("SecantSolver")
class SecantSolver(IterativeSolver):
    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.max_iterations = params.get_int("max_iterations", 30)
        self.rel_tol = params.get_float("relative_tolerance", 1e-9)
        self.abs_tol = params.get_float("absolute_tolerance", 1e-9)
        self.damping = params.get_float("damping", 1.0)
        self.dt_epsilon = params.get_float("dt_epsilon", 1e-4)
        # reference SecantSolver.C:28 "Show convergence history."
        self.verbose = params.get_bool("verbose", False)
        self.predictors = []  # bound by the problem

    def substep(self, state, sub_time, sub_dt, dt, dt_old, substep_index, first_step):
        state = self._run_group(state, sub_time)
        buffers = dict(state["buffers"])

        dom = self.domain
        u_old, Rprev, R0sq, boots = [], [], [], []
        for v in self.variables:
            u = buffers[v.reciprocal_buffer]
            N = buffers[v.nonlinear_reciprocal]
            if v.linear_reciprocal is not None:
                L = buffers[v.linear_reciprocal]
                Rp = (N + L * u) * sub_dt
            else:
                Rp = N * sub_dt
            Rprev.append(Rp)
            R0sq.append(_sq(dom, Rp))
            u_old.append(u)
            # semi-implicit bootstrap (reference :80-88)
            if v.linear_reciprocal is not None:
                bootstrap = (u + self.dt_epsilon * N) / (1.0 - self.dt_epsilon * L)
            else:
                bootstrap = u + self.dt_epsilon * N
            boots.append((v.buffer, bootstrap))
        R0norm = dom.reduce(torch.stack(R0sq)).sqrt()
        if self.verbose:  # reference :95 "|R0|=..."
            for r in R0norm.tolist():
                print(f"|R0|={r}")
            perf.count("fetches")
        buffers.update(self._ifft_all(boots))

        # forward predict on solver outputs (reference applyPredictors)
        st = {**state, "buffers": buffers}
        for p in self.predictors:
            st = p.apply(st)
        buffers = dict(st["buffers"])

        up, Rp = list(u_old), list(Rprev)
        it, converged, nan_abort = 0, False, False
        while it < self.max_iterations and not converged and not nan_abort:
            st = self._run_group({**state, "buffers": buffers}, sub_time)
            buffers = dict(st["buffers"])
            updates, squares, du_squares = [], [], []
            for i, v in enumerate(self.variables):
                u = buffers[v.reciprocal_buffer]
                N = buffers[v.nonlinear_reciprocal]
                if v.linear_reciprocal is not None:
                    L = buffers[v.linear_reciprocal]
                    R = (N + L * u) * sub_dt + u_old[i] - u
                else:
                    R = N * sub_dt + u_old[i] - u
                dx = u - up[i]
                dy = R - Rp[i]
                # the division runs everywhere; where dy = 0 its inf or NaN
                # is not selected, and a NaN of R itself reaches |R|
                du = torch.where(dy != 0, -R * dx / dy, 0.0)
                up[i], Rp[i] = u, R
                updates.append((v.buffer, u + du if self.damping == 1.0
                                else u + du * self.damping))
                squares.append(_sq(dom, R))
                if self.verbose:
                    du_squares.append(_sq(dom, du))
            n = len(self.variables)
            reduced = dom.reduce(torch.stack(squares + du_squares)).sqrt()
            norms = reduced[:n]
            conv = ((norms < self.abs_tol) | (norms / R0norm < self.rel_tol)).all()
            buffers.update(self._ifft_all(updates))
            (converged, nan_abort), host_norms = _fetch(
                [conv, torch.isnan(norms).any()], list(reduced))
            if self.verbose:  # reference :146 "i |du| = ... |R|=..."
                for r, d in zip(host_norms[:n], host_norms[n:]):
                    print(f"{it} |du| = {d} |R|={r}")
            it += 1

        # rollback on non-convergence (reference :183-193)
        if not converged or nan_abort:
            buffers.update(self._ifft_all(
                [(v.buffer, u_old[i]) for i, v in enumerate(self.variables)]))
        solver_state = self._record(state, it, converged, syncs=it)
        return {**state, "buffers": buffers, "solver": solver_state}
