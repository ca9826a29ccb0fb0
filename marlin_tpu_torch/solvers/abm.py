"""Adams-Bashforth-Moulton semi-implicit solver.

The PyTorch counterpart of marlin_tpu/solvers/abm.py (reference
src/tensor_solver/AdamsBashforthMoulton.C:60-187): AB1-5 predictor with the
semi-implicit update ū = (ū + dt·Σβᵢ N̄ᵢ)/(1 − dt·L̄), optional AM1-5
corrector, order fallback on a dt change, per-variable history.  The order
is chosen on the host each substep.

``fused_spectral = true`` (with ``carry_reciprocal = true`` and ``[Domain]
fft_backend = PALLAS``) runs all but the last substep of each step through
the fused kernels of ``spectral.py`` (``_fused_step``); the last substep
runs the regular chain, so the state matches the unfused path.  On an
FFT_SLAB mesh the fused substeps run on the rank's slab
(``spectral.ch_substep_sharded``), ū and N̄ carried as the X-sharded
blocks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import perf
from ..params import Params
from ..registry import solvers
from .base import SplitOperatorBase, advance_state

MAX_ORDER = 5

# Adams–Bashforth coefficients, zero-padded (reference :67-74)
BETA = [
    [1.0, 0.0, 0.0, 0.0, 0.0],
    [3.0 / 2.0, -1.0 / 2.0, 0.0, 0.0, 0.0],
    [23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0, 0.0, 0.0],
    [55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0, 0.0],
    # 190/720 (not the textbook 1901/720) is the reference's own table
    # (AdamsBashforthMoulton.C:72), kept for parity as marlin_tpu does
    [190.0 / 720.0, -2774.0 / 720.0, 2616.0 / 720.0, -1274.0 / 720.0, 251.0 / 720.0],
]

# Adams–Moulton coefficients, zero-padded (reference :108-115)
ALPHA = [
    [1.0, 0.0, 0.0, 0.0, 0.0],
    [0.5, 0.5, 0.0, 0.0, 0.0],
    [5.0 / 12.0, 8.0 / 12.0, -1.0 / 12.0, 0.0, 0.0],
    [9.0 / 24.0, 19.0 / 24.0, -5.0 / 24.0, 1.0 / 24.0, 0.0],
    [251.0 / 720.0, 646.0 / 720.0, -264.0 / 720.0, 106.0 / 720.0, -19.0 / 720.0],
]


@solvers.register("AdamsBashforthMoulton", "SemiImplicitSolver")
class AdamsBashforthMoulton(SplitOperatorBase):
    supports_carry_reciprocal = True  # substep writes the updated ū back

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        porder = params.get_int("predictor_order", 2)
        corder = params.get_int("corrector_order", 2)
        if not (1 <= porder <= MAX_ORDER) or not (1 <= corder <= MAX_ORDER):
            params.error("predictor_order", f"must be in [1, {MAX_ORDER}]")
        self.predictor_order = porder - 1
        self.corrector_order = corder - 1
        self.corrector_steps = params.get_int("corrector_steps", 0)
        self.request_history(max(self.predictor_order, self.corrector_order))
        self.fused_spectral = params.get_bool("fused_spectral", False)
        self._fused_plan = None
        if self.fused_spectral and not self.carry_reciprocal:
            params.error(
                "fused_spectral", "requires carry_reciprocal = true"
            )

    def group_evals_per_step(self):
        return self.substeps * (1 + self.corrector_steps)

    def step(self, state, t, dt, dt_old, first_step):
        if not self.fused_spectral or self.substeps <= 1:
            return super().step(state, t, dt, dt_old, first_step)
        return self._fused_step(state, t, dt, dt_old, first_step)

    def _fused_step(self, state, t, dt, dt_old, first_step):
        """Substeps 0..n-2 through spectral.ch_substep(_multi), with ū and
        N̄ carried as complex64 (nx, L) tensors; the final substep runs the
        regular chain so the state matches the unfused path
        (marlin_tpu/solvers/abm.py:_fused_step, serial branches)."""
        from .. import spectral as sp
        from .. import unordered_fft as uf

        if self._fused_plan is None:
            self._fused_plan = sp.match_chain(self)
        plan = self._fused_plan
        if len(state["old_dt"]) > 1 or any(
            s.shape[0] != 1 for s in state["old"].values()
        ):
            raise sp.SpectralChainError(
                "fused_spectral = true supports history depth 1 only"
            )
        # History on the carried pair (N̄ and u itself) stays exact: both are
        # current through the fused loop, and the one advance before the
        # trailing substep pushes what the unfused per-substep advances
        # would have.  Other buffers go stale in the fused substeps.
        multi = isinstance(plan, sp.SpectralPlanMulti)
        hist_ok = (set(plan.nonlinears) | set(plan.buffers)) if multi else (
            {plan.nonlinear, plan.buffer})
        if not set(state["old"]) <= hist_ok:
            raise sp.SpectralChainError(
                f"fused_spectral = true supports old-state history on "
                f"{sorted(hist_ok)} only (got {sorted(state['old'])})"
            )

        dom = self.domain
        # the kernels take float32 weights, as the TPU kernels' scalar row
        sub_dt = float(np.float32(dt / self.substeps))
        dt_changed = dt != dt_old
        n_adv0 = state["n_advances"]
        shape = plan.shape
        rshape = dom.reciprocal_shape
        sharded = dom.mesh is not None
        # serial: (nx, L) tiles; a slab keeps its 3-D X-sharded block
        flat = rshape if sharded else (shape[0], math.prod(shape[1:]))
        buffers = dict(state["buffers"])

        def carried(name):
            return buffers[name].to(torch.complex64).reshape(flat).contiguous()

        def forward(ci):
            if sharded:
                return dom.fft(ci).to(torch.complex64).contiguous()
            return uf.fftn_unordered(ci).reshape(flat)

        with perf.span("solver::fused_substeps"):
            # carry_reciprocal seed: ū = fft(u) once per step.  The history slot
            # equals buffers[N̄] here: the step-level advance just pushed it (on
            # the first step both are zeros while β₁ = 0), which makes the
            # per-substep history push a rebinding of the carried N̄
            if multi:
                c = torch.stack([buffers[n].to(torch.float32) for n in plan.buffers])
                cbar = torch.stack([forward(ci) for ci in c])
                nbar = torch.stack([carried(n) for n in plan.nonlinears])
                substep_fn = sp.ch_substep_multi
            else:
                c = buffers[plan.buffer].to(torch.float32)
                cbar = forward(c)
                nbar = carried(plan.nonlinear)
                substep_fn = sp.ch_substep
            if sharded:
                sharded_fn = sp.ch_substep_sharded_multi if multi else sp.ch_substep_sharded

                def substep_fn(*args):
                    return sharded_fn(*args, dom.mesh)

            for s in range(self.substeps - 1):
                # AB order selection (substep(), reference :88-91)
                n_old_b = min(n_adv0 + (0 if first_step else s), 1)
                cond = s < self.predictor_order and dt_changed
                order = min(0 if cond else n_old_b, self.predictor_order)
                c2, u2, n2 = substep_fn(c, cbar, nbar, sub_dt, BETA[order][0],
                                        BETA[order][1], plan)
                if self.corrector_steps:
                    # Adams-Moulton corrector (reference :118-186): the same fused
                    # chain with ū base = the pre-predictor ū, β0 → α0 on the
                    # fresh N̄ of the corrected field and β1 → α1 on the frozen N_n
                    cond_c = s < self.corrector_order and dt_changed
                    order_c = min(1 if cond_c else n_old_b + 1, self.corrector_order)
                    a0, a1 = ALPHA[order_c][0], ALPHA[order_c][1]
                    n_n = n2
                    for _ in range(self.corrector_steps):
                        c3, u3, n2 = substep_fn(c2, cbar, n_n, sub_dt, a0, a1, plan)
                        # corrector order 1: the group re-evaluates (N̄ updates)
                        # but ū and u stay
                        if self.corrector_order > 0:
                            c2, u2 = c3, u3
                c, cbar, nbar = c2, u2, n2

            if multi:
                for i, name in enumerate(plan.buffers):
                    buffers[name] = c[i].to(dom.dtype)
                    buffers[plan.reciprocals[i]] = cbar[i].reshape(rshape).to(dom.cdtype)
                    buffers[plan.nonlinears[i]] = nbar[i].reshape(rshape).to(dom.cdtype)
            else:
                buffers[plan.buffer] = c.to(dom.dtype)
                buffers[plan.reciprocal] = cbar.reshape(rshape).to(dom.cdtype)
                buffers[plan.nonlinear] = nbar.reshape(rshape).to(dom.cdtype)
        perf.count("substeps_fused", self.substeps - 1)
        # the skipped in-loop advances (s = 1..substeps-2); the final
        # substep's advance below refreshes the depth-1 old/old_dt slots
        st = {**state, "buffers": buffers,
              "n_advances": n_adv0 + (0 if first_step else self.substeps - 2)}
        s_last = self.substeps - 1
        with perf.span("solver::substep"):
            if not first_step:
                st = advance_state(st, dt)
            return self.substep(st, t + s_last * sub_dt, sub_dt, dt, dt_old,
                                s_last, first_step)

    def substep(self, state, sub_time, sub_dt, dt, dt_old, substep_index, first_step):
        state = self._run_group(state, sub_time)
        buffers = dict(state["buffers"])
        dt_changed = dt != dt_old

        def select_order(threshold, fallback, n_old_b, maxo):
            cond = substep_index < threshold and dt_changed
            return min(fallback if cond else n_old_b, maxo)

        # -- Adams-Bashforth predictor (reference :77-104) -----------------
        final_ubar = {}
        for v in self.variables:
            n_old_b = self.n_old(state, v.nonlinear_reciprocal)
            order = select_order(self.predictor_order, 0, n_old_b, self.predictor_order)
            beta_row = BETA[order]
            N = buffers[v.nonlinear_reciprocal]
            old_N = self.old_stack(state, v.nonlinear_reciprocal)
            acc = beta_row[0] * N
            for i in range(min(old_N.shape[0], MAX_ORDER - 1)):
                acc = acc + beta_row[i + 1] * old_N[i]
            ubar = buffers[v.reciprocal_buffer] + sub_dt * acc
            if v.linear_reciprocal is not None:
                ubar = ubar / (1.0 - sub_dt * buffers[v.linear_reciprocal])
            final_ubar[v.buffer] = ubar
        buffers.update(self._ifft_all(list(final_ubar.items())))

        # -- Adams-Moulton corrector (reference :118-186) ------------------
        if self.corrector_steps:
            sub_time_c = sub_time + sub_dt
            ubar_n = {v.buffer: buffers[v.reciprocal_buffer] for v in self.variables}
            N_n = {v.buffer: buffers[v.nonlinear_reciprocal] for v in self.variables}
            for _ in range(self.corrector_steps):
                # the group is re-evaluated even when the corrector order
                # selection yields a no-op (reference :146-150)
                state_c = self._run_group({**state, "buffers": buffers}, sub_time_c)
                buffers = dict(state_c["buffers"])
                if self.corrector_order == 0:
                    continue
                for v in self.variables:
                    n_old_b = self.n_old(state, v.nonlinear_reciprocal)
                    order = select_order(
                        self.corrector_order, 1, n_old_b + 1, self.corrector_order
                    )
                    alpha_row = ALPHA[order]
                    N_pred = buffers[v.nonlinear_reciprocal]
                    old_N = self.old_stack(state, v.nonlinear_reciprocal)
                    acc = alpha_row[0] * N_pred + alpha_row[1] * N_n[v.buffer]
                    for i in range(min(old_N.shape[0], MAX_ORDER - 2)):
                        acc = acc + alpha_row[i + 2] * old_N[i]
                    ubar = ubar_n[v.buffer] + sub_dt * acc
                    if v.linear_reciprocal is not None:
                        ubar = ubar / (1.0 - sub_dt * buffers[v.linear_reciprocal])
                    final_ubar[v.buffer] = ubar
                buffers.update(self._ifft_all(list(final_ubar.items())))

        if self.carry_reciprocal:
            # the pruned ForwardFFT's role: the next substep reads ū directly
            for v in self.variables:
                buffers[v.reciprocal_buffer] = final_ubar[v.buffer]

        return {**state, "buffers": buffers}
