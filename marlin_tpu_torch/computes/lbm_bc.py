"""Lattice Boltzmann boundary conditions.

The ported subset of marlin_tpu/computes/lbm_bc.py (reference
src/tensor_computes/LBMBoundaryCondition.C, LBMBounceBack.C,
LBMFixedFirstOrderBC.C, LBMFixedZerothOrderBC.C,
LBMMicroscopicZeroGradientBC.C).  LBMDirichletBC, LBMNeumannBC and
LBMSpecularReflectionBoundary are not ported yet and so unregistered.

Face conventions (reference include/tensor_computes/LBMBoundaryCondition.h):
left x=0, right x=nx-1, bottom y=0, top y=ny-1, front z=0, back z=nz-1;
`wall` = binary-media obstacle cells; `regional` = region-id cells.

A boundary condition returns a new tensor: it clones its buffer once and
writes the clone, so no tensor of the state is written in place.

Faithfulness note: the generic (q != 9) fixed-order BCs replicate the
reference's negative-index selection `f[..., -neutral_x]` verbatim
(LBMFixedFirstOrderBC.C leftBoundary) — the gold files encode exactly this
behavior.  They evaluate it through the affine plan of the fused kernel
(lbm_fused.PostBC, built by ``_zouhe_spec`` from the same formulas), so
the eager chain and the kernel compute the same bits.
"""

from __future__ import annotations

import math

import torch

from ..params import Params
from ..registry import computes
from .base import ComputeError
from .lbm import LatticeBoltzmannOperator

BOUNDARIES = ["top", "bottom", "left", "right", "front", "back", "wall", "regional"]


class LBMBoundaryCondition(LatticeBoltzmannOperator):
    is_boundary_condition = True

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.boundary = params.get_enum("boundary", BOUNDARIES, None)
        if self.boundary is None:
            params.error("boundary", "is required")

    def apply(self, state, ctx):
        u = state[self.out]
        handler = getattr(self, self.boundary + "_boundary")
        u = handler(u, state, ctx)
        return {self.out: self.masked_fill_solids(u)}

    def output_specs(self, specs):
        return {self.out: specs[self.out]}

    # default: unimplemented faces raise
    def _unimplemented(self, *_a, **_k):
        raise ComputeError(
            f"{type(self).__name__}: boundary '{self.boundary}' is not implemented."
        )

    top_boundary = _unimplemented
    bottom_boundary = _unimplemented
    left_boundary = _unimplemented
    right_boundary = _unimplemented
    front_boundary = _unimplemented
    back_boundary = _unimplemented
    wall_boundary = _unimplemented
    regional_boundary = _unimplemented


def _face_index(axis, pos, sels, last=None):
    """The index of the plane ``pos`` along ``axis`` with the transverse
    selections ``sels``, and direction ``last`` when given."""
    idx = list(sels)
    idx.insert(axis, pos)
    return tuple(idx) if last is None else tuple(idx + [last])


@computes.register("LBMBounceBack")
class LBMBounceBack(LBMBoundaryCondition):
    """Halfway bounce-back (reference LBMBounceBack.C)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.f_old = params.get_str("f_old", required=True)
        self.xsel = slice(1, -1) if params.get_bool("exclude_corners_x") else slice(None)
        self.ysel = slice(1, -1) if params.get_bool("exclude_corners_y") else slice(None)
        self.zsel = slice(1, -1) if params.get_bool("exclude_corners_z") else slice(None)
        self._wall_mask = None

    def history_requests(self):
        return {self.f_old: 1}

    def _fold(self, ctx):
        return ctx["old"][self.f_old][0]

    def _face(self, u, fold, axis, pos, unknown_dirs, incoming: bool, sels):
        st = self.stencil
        u = u.clone()
        for d in unknown_dirs:
            d, o = int(d), int(st.op[d])
            if incoming:
                # low face: unknown dir d filled from opposite at same node
                u[_face_index(axis, pos, sels, d)] = fold[_face_index(axis, pos, sels, o)]
            else:
                # high face: opposite dirs filled from face set
                u[_face_index(axis, pos, sels, o)] = fold[_face_index(axis, pos, sels, d)]
        return u

    def left_boundary(self, u, state, ctx):
        return self._face(u, self._fold(ctx), 0, 0, self.stencil.left, True,
                          [self.ysel, self.zsel])

    def right_boundary(self, u, state, ctx):
        return self._face(u, self._fold(ctx), 0, -1, self.stencil.left, False,
                          [self.ysel, self.zsel])

    def bottom_boundary(self, u, state, ctx):
        return self._face(u, self._fold(ctx), 1, 0, self.stencil.bottom, True,
                          [self.xsel, self.zsel])

    def top_boundary(self, u, state, ctx):
        return self._face(u, self._fold(ctx), 1, -1, self.stencil.bottom, False,
                          [self.xsel, self.zsel])

    def front_boundary(self, u, state, ctx):
        return self._face(u, self._fold(ctx), 2, 0, self.stencil.front, True,
                          [self.xsel, self.ysel])

    def back_boundary(self, u, state, ctx):
        return self._face(u, self._fold(ctx), 2, -1, self.stencil.front, False,
                          [self.xsel, self.ysel])

    def wall_boundary(self, u, state, ctx):
        """Obstacle bounce-back (reference wallBoundary3D).  The reference
        captures its boundary mask once at the first substep as
        (adjacent-to-solid) & (u == 0); after the first stream u == 0
        exactly where the upstream cell along that direction is solid, so
        the equivalent static per-direction mask is built once here: one
        media-sized int32 bitfield, bit ic set where direction ic bounces
        (q <= 27; torch's uint32 support is thin, and bit 31 is never
        used)."""
        st = self.stencil
        if self._wall_mask is None:
            media = self.problem.lbm_media()
            if media is None:
                raise ComputeError("wall boundary requires binary media")
            bits = torch.zeros(media.shape, dtype=torch.int32, device=media.device)
            fluid = media >= 1
            for ic in range(1, st.q):
                upstream_solid = torch.roll(
                    media, (int(st.ex[ic]), int(st.ey[ic]), int(st.ez[ic])),
                    (0, 1, 2)) == 0
                bits |= (upstream_solid & fluid).to(torch.int32) << ic
            self._wall_mask = bits
        fold = self._fold(ctx)
        # direction-major, as the stream builds u (computes/lbm.py)
        op = torch.as_tensor(st.op, dtype=torch.long, device=fold.device)
        f_bounce = fold.movedim(-1, 0).index_select(0, op)  # 0 never bounces
        shifts = torch.arange(st.q, dtype=torch.int32, device=fold.device)
        mask = (self._wall_mask[None] >> shifts[:, None, None, None]) & 1
        return torch.where(mask != 0, f_bounce, u.movedim(-1, 0)).movedim(0, -1)


class _FixedOrderBC(LBMBoundaryCondition):
    """Shared reads of the Zou-He fixed-order faces."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.f = self.input_buffer("f")
        self.value = problem.get_constant(params.get_str("value", required=True))

    first_order = False

    def _generic(self, u, f, side):
        """The x face ``side`` of a q != 9 stencil (reference leftBoundary /
        rightBoundary else-branches, incl. the negative-index neutral set
        selection), through the Zou-He affine plan."""
        from ..lbm_fused import _zouhe_spec, apply_zouhe

        spec = _zouhe_spec(self.stencil, 0, side, self.value, self.first_order)
        pos = 0 if side == 0 else -1
        plane = f[pos].movedim(-1, 0)
        u = u.clone()
        for d, val in apply_zouhe(spec, plane).items():
            u[pos, :, :, d] = val
        return u

    def _require_d2q9(self, face):
        if self.stencil.q != 9:
            raise ComputeError(f"{face} boundary only implemented for D2Q9.")


@computes.register("LBMFixedFirstOrderBC")
class LBMFixedFirstOrderBC(_FixedOrderBC):
    """Zou-He velocity boundary (reference LBMFixedFirstOrderBC.C)."""

    first_order = True

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.perturb = params.get_bool("perturb", False)

    def _ux_profile(self, ny, f):
        if not self.perturb:
            return torch.full((ny, 1), self.value, dtype=f.dtype, device=f.device)
        deltaU = 1.0e-6 * self.value
        y = torch.arange(ny, dtype=f.dtype, device=f.device)[:, None]
        return self.value + deltaU * torch.sin(y / ny * 2.0 * math.pi)

    def left_boundary(self, u, state, ctx):
        st = self.stencil
        f = state[self.f]
        if st.q != 9:
            return self._generic(u, f, 0)
        u = u.clone()
        ux = self._ux_profile(f.shape[1], f)
        density = 1.0 / (1.0 - ux) * (
            f[0, :, :, 0] + f[0, :, :, 2] + f[0, :, :, 4]
            + 2.0 * (f[0, :, :, 3] + f[0, :, :, 6] + f[0, :, :, 7])
        )
        d0 = int(st.left[0])
        u[0, :, :, d0] = f[0, :, :, int(st.op[d0])] + 2.0 / 3.0 * density * ux
        for i in range(1, len(st.left)):
            d = int(st.left[i])
            u[0, :, :, d] = (
                f[0, :, :, int(st.op[d])]
                - 0.5 * float(st.ey[d]) * (f[0, :, :, 2] - f[0, :, :, 4])
                + 1.0 / 6.0 * density * ux
            )
        return u

    def right_boundary(self, u, state, ctx):
        st = self.stencil
        f = state[self.f]
        if st.q != 9:
            return self._generic(u, f, 1)
        u = u.clone()
        density = 1.0 / (1.0 + self.value) * (
            f[-1, :, :, 0] + f[-1, :, :, 2] + f[-1, :, :, 4]
            + 2.0 * (f[-1, :, :, 1] + f[-1, :, :, 5] + f[-1, :, :, 8])
        )
        d0 = int(st.left[0])
        o0 = int(st.op[d0])
        u[-1, :, :, o0] = f[-1, :, :, d0] - 2.0 / 3.0 * density * self.value
        for i in range(1, len(st.left)):
            d = int(st.left[i])
            o = int(st.op[d])
            u[-1, :, :, o] = (
                f[-1, :, :, d]
                + 0.5 * float(st.ey[o]) * (f[-1, :, :, 4] - f[-1, :, :, 2])
                - 1.0 / 6.0 * density * self.value
            )
        return u

    def bottom_boundary(self, u, state, ctx):
        st = self.stencil
        f = state[self.f]
        self._require_d2q9("Bottom")
        u = u.clone()
        density = 1.0 / (1.0 - self.value) * (
            f[:, 0, :, 0] + f[:, 0, :, 1] + f[:, 0, :, 3]
            + 2.0 * (f[:, 0, :, 4] + f[:, 0, :, 7] + f[:, 0, :, 8])
        )
        d0 = int(st.bottom[0])
        u[:, 0, :, d0] = f[:, 0, :, int(st.op[d0])] + 2.0 / 3.0 * density * self.value
        for i in range(1, len(st.bottom)):
            d = int(st.bottom[i])
            u[:, 0, :, d] = (
                f[:, 0, :, int(st.op[d])]
                - 0.5 * float(st.ex[d]) * (f[:, 0, :, 1] - f[:, 0, :, 3])
                + 1.0 / 6.0 * density * self.value
            )
        return u

    def top_boundary(self, u, state, ctx):
        st = self.stencil
        f = state[self.f]
        self._require_d2q9("Top")
        u = u.clone()
        density = 1.0 / (1.0 + self.value) * (
            f[:, -1, :, 0] + f[:, -1, :, 1] + f[:, -1, :, 3]
            + 2.0 * (f[:, -1, :, 2] + f[:, -1, :, 5] + f[:, -1, :, 6])
        )
        d0 = int(st.bottom[0])
        o0 = int(st.op[d0])
        u[:, -1, :, o0] = f[:, -1, :, d0] - 2.0 / 3.0 * density * self.value
        for i in range(1, len(st.bottom)):
            d = int(st.bottom[i])
            o = int(st.op[d])
            u[:, -1, :, o] = (
                f[:, -1, :, d]
                + 0.5 * float(st.ex[o]) * (f[:, -1, :, 3] - f[:, -1, :, 1])
                - 1.0 / 6.0 * density * self.value
            )
        return u


@computes.register("LBMFixedZerothOrderBC")
class LBMFixedZerothOrderBC(_FixedOrderBC):
    """Zou-He density boundary (reference LBMFixedZerothOrderBC.C)."""

    def left_boundary(self, u, state, ctx):
        st = self.stencil
        f = state[self.f]
        if st.q != 9:
            return self._generic(u, f, 0)
        u = u.clone()
        velocity = 1.0 - (
            f[0, :, :, 0] + f[0, :, :, 2] + f[0, :, :, 4]
            + 2.0 * (f[0, :, :, 3] + f[0, :, :, 6] + f[0, :, :, 7])
        ) / self.value
        d0 = int(st.left[0])
        u[0, :, :, d0] = f[0, :, :, int(st.op[d0])] + 2.0 / 3.0 * self.value * velocity
        for i in range(1, len(st.left)):
            d = int(st.left[i])
            u[0, :, :, d] = (
                f[0, :, :, int(st.op[d])]
                - 0.5 * float(st.ey[d]) * (f[0, :, :, 2] - f[0, :, :, 4])
                + 1.0 / 6.0 * self.value * velocity
            )
        return u

    def right_boundary(self, u, state, ctx):
        st = self.stencil
        f = state[self.f]
        if st.q != 9:
            return self._generic(u, f, 1)
        u = u.clone()
        velocity = (
            f[-1, :, :, 0] + f[-1, :, :, 2] + f[-1, :, :, 4]
            + 2.0 * (f[-1, :, :, 1] + f[-1, :, :, 5] + f[-1, :, :, 8])
        ) / self.value - 1.0
        d0 = int(st.left[0])
        o0 = int(st.op[d0])
        u[-1, :, :, o0] = f[-1, :, :, d0] - 2.0 / 3.0 * self.value * velocity
        for i in range(1, len(st.left)):
            d = int(st.left[i])
            o = int(st.op[d])
            u[-1, :, :, o] = (
                f[-1, :, :, d]
                + 0.5 * float(st.ey[o]) * (f[-1, :, :, 4] - f[-1, :, :, 2])
                - 1.0 / 6.0 * self.value * velocity
            )
        return u

    def bottom_boundary(self, u, state, ctx):
        st = self.stencil
        f = state[self.f]
        self._require_d2q9("Bottom")
        u = u.clone()
        velocity = 1.0 - (
            f[:, 0, :, 0] + f[:, 0, :, 1] + f[:, 0, :, 3]
            + 2.0 * (f[:, 0, :, 4] + f[:, 0, :, 7] + f[:, 0, :, 8])
        ) / self.value
        d0 = int(st.bottom[0])
        u[:, 0, :, d0] = f[:, 0, :, int(st.op[d0])] + 2.0 / 3.0 * self.value * velocity
        for i in range(1, len(st.bottom)):
            d = int(st.bottom[i])
            u[:, 0, :, d] = (
                f[:, 0, :, int(st.op[d])]
                - 0.5 * float(st.ex[d]) * (f[:, 0, :, 1] - f[:, 0, :, 3])
                + 1.0 / 6.0 * self.value * velocity
            )
        return u

    def top_boundary(self, u, state, ctx):
        st = self.stencil
        f = state[self.f]
        self._require_d2q9("Top")
        u = u.clone()
        velocity = (
            f[:, -1, :, 0] + f[:, -1, :, 1] + f[:, -1, :, 3]
            + 2.0 * (f[:, -1, :, 2] + f[:, -1, :, 5] + f[:, -1, :, 6])
        ) / self.value - 1.0
        d0 = int(st.bottom[0])
        o0 = int(st.op[d0])
        u[:, -1, :, o0] = f[:, -1, :, d0] - 2.0 / 3.0 * self.value * velocity
        for i in range(1, len(st.bottom)):
            d = int(st.bottom[i])
            o = int(st.op[d])
            u[:, -1, :, o] = (
                f[:, -1, :, d]
                + 0.5 * float(st.ex[o]) * (f[:, -1, :, 3] - f[:, -1, :, 1])
                - 1.0 / 6.0 * self.value * velocity
            )
        return u


@computes.register("LBMMicroscopicZeroGradientBC")
class LBMMicroscopicZeroGradientBC(LBMBoundaryCondition):
    """Copy the adjacent inner layer onto the boundary layer
    (reference LBMMicroscopicZeroGradientBC.C)."""

    def _copy(self, u, dst, src):
        u = u.clone()
        u[dst] = u[src]
        return u

    def left_boundary(self, u, state, ctx):
        return self._copy(u, 0, 1)

    def right_boundary(self, u, state, ctx):
        return self._copy(u, -1, -2)

    def bottom_boundary(self, u, state, ctx):
        return self._copy(u, (slice(None), 0), (slice(None), 1))

    def top_boundary(self, u, state, ctx):
        return self._copy(u, (slice(None), -1), (slice(None), -2))

    def front_boundary(self, u, state, ctx):
        return self._copy(u, (slice(None), slice(None), 0),
                          (slice(None), slice(None), 1))

    def back_boundary(self, u, state, ctx):
        return self._copy(u, (slice(None), slice(None), -1),
                          (slice(None), slice(None), -2))
