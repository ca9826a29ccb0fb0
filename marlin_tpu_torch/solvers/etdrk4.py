"""4th-order exponential time differencing (ETDRK4) solver.

The counterpart of marlin_tpu/solvers/etdrk4.py (reference
src/tensor_solver/ETDRK4Solver.C:29-122): the same stage math and the
reference's L→0 guards (phi1 = dt, phi2 = dt²/2, phi3 = dt²/6 where
L·dt == 0, reference :84-91).  ``cox_matthews = true`` takes Cox &
Matthews' (2002) coefficients with Taylor series near L·dt = 0, at the
JAX package's radii, chosen by the same dtype test (a complex L̄ takes the
float32 radii there too).  A substep evaluates the group four times and
transforms back four times, each through ``_ifft_all``.
"""

from __future__ import annotations

import torch

from ..params import Params
from ..registry import solvers
from .base import SplitOperatorBase


@solvers.register("ETDRK4Solver")
class ETDRK4Solver(SplitOperatorBase):
    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        # no old-state reads: the 4 stages live inside one substep
        # (reference getVariables(0), ETDRK4Solver.C:33)
        self.cox_matthews = params.get_bool("cox_matthews", False)

    def group_evals_per_step(self):
        # initial evaluation + 3 stage re-evaluations per substep
        return self.substeps * 4

    def substep(self, state, sub_time, sub_dt, dt, dt_old, substep_index, first_step):
        state = self._run_group(state, sub_time)
        buffers = dict(state["buffers"])

        def eval_nonlinear(ubar_stage):
            nonlocal buffers
            buffers.update(self._ifft_all(
                [(v.buffer, ub) for v, ub in zip(self.variables, ubar_stage)]))
            st = self._run_group({**state, "buffers": buffers}, sub_time)
            buffers = dict(st["buffers"])
            return [buffers[v.nonlinear_reciprocal] for v in self.variables]

        ubar_n, linear, nonlinear1 = [], [], []
        for v in self.variables:
            ubar_n.append(buffers[v.reciprocal_buffer])
            nonlinear1.append(buffers[v.nonlinear_reciprocal])
            if v.linear_reciprocal is not None:
                linear.append(buffers[v.linear_reciprocal])
            else:
                linear.append(torch.zeros_like(buffers[v.reciprocal_buffer]))

        expLdt, expHalf, phi1, phi2, phi3 = [], [], [], [], []
        for i in range(len(self.variables)):
            Ldt = linear[i] * sub_dt
            eL = torch.exp(Ldt)
            if self.cox_matthews:
                p1, p2, p3 = _cox_matthews_phis(Ldt, eL, sub_dt)
            else:
                # the reference's phi tables (ETDRK4Solver.C:80-92) with its
                # two deviations from Cox-Matthews' f1/f3 and its L→0
                # limits, kept for parity
                denom = Ldt * Ldt * Ldt
                p1 = sub_dt * (-4.0 - 3.0 * Ldt + eL * (4.0 - Ldt)) / denom
                p2 = sub_dt * (2.0 + Ldt + eL * (-2.0 + Ldt)) / denom
                p3 = sub_dt * (-4.0 - 3.0 * Ldt - Ldt * Ldt
                               + eL * (4.0 - Ldt)) / denom
                zero = Ldt == 0.0
                p1 = torch.where(zero, sub_dt, p1)
                p2 = torch.where(zero, sub_dt * sub_dt / 2.0, p2)
                p3 = torch.where(zero, sub_dt * sub_dt / 6.0, p3)
            expLdt.append(eL)
            expHalf.append(torch.exp(Ldt / 2.0))
            phi1.append(p1)
            phi2.append(p2)
            phi3.append(p3)

        n = len(self.variables)
        if self.cox_matthews:
            # stages weight N by (h/2)·phi1(Lh/2), and the c stage builds on
            # a_n with 2N(b) − N(u_n) (Cox & Matthews 2002)
            Q = [_phi1_half(linear[i] * sub_dt, sub_dt) for i in range(n)]
            ubar_a = [expHalf[i] * ubar_n[i] + Q[i] * nonlinear1[i] for i in range(n)]
            nonlinear2 = eval_nonlinear(ubar_a)
            ubar_b = [expHalf[i] * ubar_n[i] + Q[i] * nonlinear2[i] for i in range(n)]
            nonlinear3 = eval_nonlinear(ubar_b)
            ubar_c = [expHalf[i] * ubar_a[i]
                      + Q[i] * (2.0 * nonlinear3[i] - nonlinear1[i]) for i in range(n)]
            nonlinear4 = eval_nonlinear(ubar_c)
        else:
            ubar_b = [expHalf[i] * ubar_n[i] + 0.5 * sub_dt * nonlinear1[i]
                      for i in range(n)]
            nonlinear2 = eval_nonlinear(ubar_b)
            ubar_c = [expHalf[i] * ubar_n[i] + 0.5 * sub_dt * nonlinear2[i]
                      for i in range(n)]
            nonlinear3 = eval_nonlinear(ubar_c)
            ubar_d = [expLdt[i] * ubar_n[i] + sub_dt * nonlinear3[i] for i in range(n)]
            nonlinear4 = eval_nonlinear(ubar_d)

        buffers.update(self._ifft_all([
            (v.buffer,
             expLdt[i] * ubar_n[i]
             + phi1[i] * nonlinear1[i]
             + 2.0 * phi2[i] * (nonlinear2[i] + nonlinear3[i])
             + phi3[i] * nonlinear4[i])
            for i, v in enumerate(self.variables)
        ]))
        return {**state, "buffers": buffers}


def _phi1_half(Ldt, sub_dt):
    """(h/2)·phi1(Lh/2) with phi1(w) = (e^w − 1)/w — the Cox-Matthews
    stage weight; series below the cancellation radius."""
    w = Ldt / 2.0
    closed = (torch.exp(w) - 1.0) / torch.where(w == 0.0, 1.0, w)
    series = 1.0 + w / 2.0 + w * w / 6.0 + w * w * w / 24.0
    radius = 1e-4 if w.dtype == torch.float64 else 1e-2
    return 0.5 * sub_dt * torch.where(w.abs() < radius, series, closed)


def _cox_matthews_phis(Ldt, eL, sub_dt):
    """Cox & Matthews (2002) eq. 26 f1/f2/f3 with Taylor series where
    |L·dt| is small (the closed forms lose ~3·log10(1/z) digits to
    cancellation; cf. Kassam & Trefethen 2005)."""
    z = Ldt
    z2, z3, z4 = z * z, z * z * z, z * z * z * z
    denom = torch.where(z3 == 0.0, 1.0, z3)
    f1 = sub_dt * (-4.0 - z + eL * (4.0 - 3.0 * z + z2)) / denom
    f2 = sub_dt * (2.0 + z + eL * (-2.0 + z)) / denom
    f3 = sub_dt * (-4.0 - 3.0 * z - z2 + eL * (4.0 - z)) / denom
    # series about z = 0 through z^4: relative error < 1e-4 at the float32
    # radius 0.35, < 1e-10 at the float64 radius 1e-2
    t1 = sub_dt * (1.0 / 6.0 + z / 6.0 + 3.0 * z2 / 40.0
                   + z3 / 45.0 + 5.0 * z4 / 1008.0)
    t2 = sub_dt * (1.0 / 6.0 + z / 12.0 + z2 / 40.0
                   + z3 / 180.0 + z4 / 1008.0)
    t3 = sub_dt * (1.0 / 6.0 - z2 / 120.0 - z3 / 360.0 - z4 / 1680.0)
    radius = 1e-2 if z.dtype == torch.float64 else 0.35
    small = z.abs() < radius
    return (torch.where(small, t1, f1), torch.where(small, t2, f2),
            torch.where(small, t3, f3))
