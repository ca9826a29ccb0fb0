"""LBM streaming solver.

Re-design of reference LBMStream (src/tensor_solver/LBMStream.C:51-80),
after marlin_tpu/solvers/lbm_stream.py: per-direction periodic roll of the
old post-collision distribution, with solid masking.  The substep loop
around it is TensorProblem's (``_lbm_step``).  Under REAL_SPACE on a mesh
the roll crosses ranks: the distribution is padded once with its
neighbours' planes (``Domain.padded``, one exchange an axis) and each
direction is a slice of it."""

from __future__ import annotations

import torch

from ..params import Params
from ..registry import solvers
from .base import TensorSolver


def roll(t, shifts, halo):
    """A direction's pull stream: ``torch.roll`` over (x, y, z), or on a
    padded field (``halo`` its padded axes, counting the leading
    direction axis) a slice along those axes."""
    if not halo:
        return torch.roll(t, shifts, (0, 1, 2))
    from ..parallel import shifted

    return shifted(t, shifts, (0, 1, 2), [d - 1 for d in halo])


@solvers.register("LBMStream")
class LBMStream(TensorSolver):
    is_lbm_stream = True

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.buffers_ = params.get_str_vector("buffer")
        self.f_old = params.get_str_vector("f_old")
        if len(self.buffers_) != len(self.f_old):
            params.error("buffer", "Must have the same number of entries as 'f_old'")

    def history_requests(self):
        return {n: 1 for n in self.f_old}

    def output_buffers(self):
        return super().output_buffers() + list(self.buffers_)

    def extra_input_buffers(self):
        return super().extra_input_buffers() + list(self.f_old)

    def stream(self, state):
        stencil = self.problem.lbm_stencil()
        dom = self.problem.domain
        buffers = dict(state["buffers"])
        mask = self.problem.lbm_solid_mask()
        for out, old_name in zip(self.buffers_, self.f_old):
            # direction-major storage (see computes/lbm.py): each direction
            # a contiguous plane in and out, the (nx, ny, nz, q) buffer a
            # view of it
            fq = state["old"][old_name][0].movedim(-1, 0).contiguous()
            halo = [d + 1 for d in dom.halo_dims()]
            src = dom.padded(fq, lead=1) if halo else fq
            comps = [
                roll(src[i], (int(stencil.ex[i]), int(stencil.ey[i]),
                              int(stencil.ez[i])), halo)
                for i in range(stencil.q)
            ]
            u = torch.stack(comps, 0).movedim(0, -1)
            if mask is not None:
                u = torch.where(mask[..., None], 0.0, u)
            buffers[out] = u
        return {**state, "buffers": buffers}
