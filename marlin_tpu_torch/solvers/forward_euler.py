"""Explicit solvers (marlin_tpu/solvers/forward_euler.py).

- ForwardEulerSolver (reference: src/tensor_solver/ForwardEulerSolver.C:29-38):
  u = ifft(ū + dt·dū/dt).  Also used as a no-op wrapper driving steady
  solves (reference: examples/degeus_mechanics/mech.i:84-92).
- RealSpaceForwardEuler (reference: src/tensor_solver/RealSpaceForwardEuler.C:47-56):
  FFT-free explicit Euler, u += dt·du/dt, pointwise on each rank's block:
  it runs serially and on any mesh, REAL_SPACE (the reference's mode for
  it, the derivative from halo'd stencils) included.
"""

from __future__ import annotations

from ..params import Params
from ..registry import solvers
from .base import ExplicitSolverBase, TensorSolver


@solvers.register("ForwardEulerSolver")
class ForwardEulerSolver(ExplicitSolverBase):
    def substep(self, state, sub_time, sub_dt, dt, dt_old, substep_index, first_step):
        state = self._run_group(state, sub_time)
        buffers = dict(state["buffers"])
        buffers.update(self._ifft_all([
            (v.buffer,
             buffers[v.reciprocal_buffer]
             + sub_dt * buffers[v.time_derivative_reciprocal])
            for v in self.variables
        ]))
        return {**state, "buffers": buffers}


@solvers.register("RealSpaceForwardEuler")
class RealSpaceForwardEuler(TensorSolver):
    """Real-space explicit Euler: u += dt · du/dt (no FFT)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.buffers_ = params.get_str_vector("buffer", required=True)
        self.derivatives = params.get_str_vector("time_derivative", required=True)
        if len(self.buffers_) != len(self.derivatives):
            params.error("buffer", "needs as many entries as time_derivative")

    def extra_input_buffers(self):
        return super().extra_input_buffers() + list(self.derivatives)

    def output_buffers(self):
        return super().output_buffers() + list(self.buffers_)

    def substep(self, state, sub_time, sub_dt, dt, dt_old, substep_index, first_step):
        state = self._run_group(state, sub_time)
        buffers = dict(state["buffers"])
        for b, d in zip(self.buffers_, self.derivatives):
            buffers[b] = buffers[b] + sub_dt * buffers[d]
        return {**state, "buffers": buffers}
