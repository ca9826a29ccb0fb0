"""Tensor predictors: initial-guess extrapolation for iterative solvers.

The counterpart of marlin_tpu/solvers/predictors.py (reference
TensorPredictor / LinearTensorPredictor,
src/tensor_predictor/LinearTensorPredictor.C:15-29): u += scale·(u_old0 −
u_old1) once two old states exist.  Only SecantSolver applies them.
"""

from __future__ import annotations

from ..params import Params
from ..registry import predictors


class TensorPredictor:
    def __init__(self, name: str, params: Params, problem):
        self.name = name
        self.params = params
        self.problem = problem
        self.buffer = params.get_str("buffer", required=True)
        self.history_size = params.get_int("history_size", 1)

    def history_requests(self):
        return {self.buffer: self.history_size}

    def apply(self, state):
        raise NotImplementedError


@predictors.register("LinearTensorPredictor")
class LinearTensorPredictor(TensorPredictor):
    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.history_size = 2
        self.scale = params.get_float("scale", 1.0)

    def apply(self, state):
        old = state["old"][self.buffer]
        # only active once two old states exist (reference :19-21); the
        # count is a host value, so an inactive predictor launches nothing
        if min(state["n_advances"], old.shape[0]) <= 1:
            return state
        u = state["buffers"][self.buffer]
        diff = (old[0] - old[1]) * self.scale
        return {**state, "buffers": {**state["buffers"],
                                     self.buffer: u + diff.to(u.dtype)}}
