"""Coupled Adams-Bashforth-Moulton solver with a dense N×N linear operator.

The counterpart of marlin_tpu/solvers/abm_coupled.py (reference
AdamsBashforthMoultonCoupled, src/tensor_solver/AdamsBashforthMoultonCoupled.C):
per k-point a solve of (I − dt·L)·ū = rhs with off-diagonal coupling
terms, AB predictor and AM corrector, through ``smallsolve.small_solve``
(the JAX package's pivot rule, so both packages agree to rounding).

L is assembled in the reference's stacking order (columns, then rows, both
on the last axis), its effective transpose included, and the solve runs in
the dtype of the first variable's linear buffer: real for −k²-style
operators, where the complex right-hand side's imaginary part is dropped,
as in the reference.  The order-0 corrector still solves, with rhs = ū_n
(AdamsBashforthMoultonCoupled.C:222-227).  Corrector evaluations see
t + dt, like the uncoupled ABM (the reference's extra _sub_time advance,
:181, is not kept).
"""

from __future__ import annotations

import torch

from ..params import Params
from ..registry import solvers
from ..smallsolve import small_solve
from .abm import ALPHA, BETA, MAX_ORDER
from .base import SplitOperatorBase


@solvers.register("AdamsBashforthMoultonCoupled")
class AdamsBashforthMoultonCoupled(SplitOperatorBase):
    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        porder = params.get_int("predictor_order", 2)
        corder = params.get_int("corrector_order", 2)
        if not (1 <= porder <= MAX_ORDER) or not (1 <= corder <= MAX_ORDER):
            params.error("predictor_order", f"must be in [1, {MAX_ORDER}]")
        self.predictor_order = porder - 1
        self.corrector_order = corder - 1
        self.corrector_steps = params.get_int("corrector_steps", 0)
        self.assume_symmetric = params.get_bool("assume_symmetric", False)
        rows = params.get_int_vector("linear_offdiag_rows")
        cols = params.get_int_vector("linear_offdiag_cols")
        self.offdiag_names = params.get_str_vector("linear_offdiag")
        if len(rows) != len(cols) or len(rows) != len(self.offdiag_names):
            params.error(
                "linear_offdiag",
                "'linear_offdiag_rows', 'linear_offdiag_cols', and "
                "'linear_offdiag' must all have the same length.",
            )
        N = len(self.variables)
        for i, j in zip(rows, cols):
            if i >= N or j >= N:
                params.error("linear_offdiag_rows", "Off-diagonal indices out of range.")
        self.offdiag_indices = list(zip(rows, cols))
        self.request_history(max(self.predictor_order, self.corrector_order))

    def extra_input_buffers(self):
        return super().extra_input_buffers() + list(self.offdiag_names)

    def group_evals_per_step(self):
        return self.substeps * (1 + self.corrector_steps)

    @staticmethod
    def _cast(x, dtype):
        if not dtype.is_complex and x.is_complex():
            x = x.real
        return x.to(dtype)

    def _assemble_A(self, buffers, sub_dt, dtype):
        """A = I − dt·L stacked per grid point, in the reference's stacking
        order (cols on the last axis, then rows on the last axis)."""
        N = len(self.variables)
        base = buffers[self.variables[0].reciprocal_buffer]
        zeros = torch.zeros(base.shape, dtype=dtype, device=base.device)
        Lmap = {}
        for i, v in enumerate(self.variables):
            if v.linear_reciprocal is not None:
                Lmap[(i, i)] = buffers[v.linear_reciprocal]
        for (i, j), name in zip(self.offdiag_indices, self.offdiag_names):
            Lmap[(i, j)] = buffers[name]
            if self.assume_symmetric and i != j and (j, i) not in Lmap:
                Lmap[(j, i)] = buffers[name]
        rows = []
        for i in range(N):
            cols = [torch.broadcast_to(self._cast(Lmap.get((i, j), zeros), dtype),
                                       base.shape) for j in range(N)]
            rows.append(torch.stack(cols, dim=-1))
        L = torch.stack(rows, dim=-1)
        eye = torch.eye(N, dtype=dtype, device=base.device)
        return eye - sub_dt * L

    def substep(self, state, sub_time, sub_dt, dt, dt_old, substep_index, first_step):
        N = len(self.variables)
        state = self._run_group(state, sub_time)
        buffers = dict(state["buffers"])
        dt_changed = dt != dt_old
        v0 = self.variables[0]
        dtype = buffers[v0.linear_reciprocal if v0.linear_reciprocal is not None
                        else v0.reciprocal_buffer].dtype

        def select_order(threshold, fallback, n_old_b, maxo):
            cond = substep_index < threshold and dt_changed
            return min(fallback if cond else n_old_b, maxo)

        def solve(A, rhs_list):
            b = torch.stack([self._cast(r, dtype) for r in rhs_list], dim=-1)
            ubar_all = small_solve(A, b)
            return [ubar_all[..., i] for i in range(N)]

        # -- Adams-Bashforth predictor ------------------------------------
        rhs_list = []
        for v in self.variables:
            n_old_b = self.n_old(state, v.nonlinear_reciprocal)
            order = select_order(self.predictor_order, 0, n_old_b, self.predictor_order)
            beta_row = BETA[order]
            old_N = self.old_stack(state, v.nonlinear_reciprocal)
            acc = beta_row[0] * buffers[v.nonlinear_reciprocal]
            for i in range(min(old_N.shape[0], MAX_ORDER - 1)):
                acc = acc + beta_row[i + 1] * old_N[i]
            rhs_list.append(buffers[v.reciprocal_buffer] + sub_dt * acc)

        A = self._assemble_A(buffers, sub_dt, dtype)
        buffers.update(self._ifft_all(
            [(v.buffer, ub) for v, ub in zip(self.variables, solve(A, rhs_list))]))

        # -- Adams-Moulton corrector ---------------------------------------
        if self.corrector_steps:
            sub_time_c = sub_time + sub_dt
            ubar_n = {v.buffer: buffers[v.reciprocal_buffer] for v in self.variables}
            N_n = {v.buffer: buffers[v.nonlinear_reciprocal] for v in self.variables}
            for _ in range(self.corrector_steps):
                state_c = self._run_group({**state, "buffers": buffers}, sub_time_c)
                buffers = dict(state_c["buffers"])
                rhs_corr = []
                for v in self.variables:
                    if self.corrector_order == 0:
                        rhs_corr.append(ubar_n[v.buffer])
                        continue
                    n_old_b = self.n_old(state, v.nonlinear_reciprocal)
                    order = select_order(self.corrector_order, 1, n_old_b + 1,
                                         self.corrector_order)
                    alpha_row = ALPHA[order]
                    old_N = self.old_stack(state, v.nonlinear_reciprocal)
                    acc = (alpha_row[0] * buffers[v.nonlinear_reciprocal]
                           + alpha_row[1] * N_n[v.buffer])
                    for i in range(min(old_N.shape[0], MAX_ORDER - 2)):
                        acc = acc + alpha_row[i + 2] * old_N[i]
                    rhs_corr.append(ubar_n[v.buffer] + sub_dt * acc)
                Ac = self._assemble_A(buffers, sub_dt, dtype)
                buffers.update(self._ifft_all(
                    [(v.buffer, ub) for v, ub in zip(self.variables, solve(Ac, rhs_corr))]))

        return {**state, "buffers": buffers}
