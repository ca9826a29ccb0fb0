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
behavior.  Every fixed-order face, the D2Q9 ones too, evaluates through
the affine plan of the fused kernel (lbm_fused.PostBC, built by
``_zouhe_spec`` from the same formulas), so the eager chain and the kernel
compute the same bits.
"""

from __future__ import annotations

import dataclasses

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
    """The Zou-He fixed-order faces (reference LBMFixedFirstOrderBC.C,
    LBMFixedZerothOrderBC.C): every face of every stencil through the affine
    plan of the fused kernel (lbm_fused.PostBC, built by ``_zouhe_spec``),
    the D2Q9 branches with their transverse rows, so that the eager chain
    and the kernel compute the same bits.  The bottom and top faces exist
    for D2Q9 only, as in the reference."""

    first_order = False

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.f = self.input_buffer("f")
        self.value = problem.get_constant(params.get_str("value", required=True))

    def spec(self, axis, side):
        from ..lbm_fused import _zouhe_spec

        return _zouhe_spec(self.stencil, axis, side, self.value, self.first_order)

    def _face(self, u, state, axis, side):
        from ..lbm_fused import apply_zouhe, perturb_profile

        if axis == 1 and self.stencil.q != 9:
            raise ComputeError(f"{self.boundary.capitalize()} boundary only "
                               f"implemented for D2Q9.")
        spec = self.spec(axis, side)
        f = state[self.f]
        index = (0 if side == 0 else -1,) if axis == 0 else \
            (slice(None), 0 if side == 0 else -1)
        plane = f[index].movedim(-1, 0)  # (q, transverse, nz)
        a = None
        if spec.perturb_value:
            a = perturb_profile(spec, f.shape[1], f.dtype, f.device)[:, None]
        u = u.clone()
        for d, val in apply_zouhe(spec, plane, a).items():
            u[index + (Ellipsis, d)] = val
        return u

    def left_boundary(self, u, state, ctx):
        return self._face(u, state, 0, 0)

    def right_boundary(self, u, state, ctx):
        return self._face(u, state, 0, 1)

    def bottom_boundary(self, u, state, ctx):
        return self._face(u, state, 1, 0)

    def top_boundary(self, u, state, ctx):
        return self._face(u, state, 1, 1)


@computes.register("LBMFixedFirstOrderBC")
class LBMFixedFirstOrderBC(_FixedOrderBC):
    """Zou-He velocity boundary (reference LBMFixedFirstOrderBC.C); with
    ``perturb = true`` the D2Q9 left face prescribes the sine profile
    v(y) = v·(1 + 1e-6·sin(2πy/ny)) (reference ``_ux_profile``), which every
    other face and stencil ignores, as the reference does."""

    first_order = True

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.perturb = params.get_bool("perturb", False)

    def spec(self, axis, side):
        spec = super().spec(axis, side)
        if self.perturb and self.stencil.q == 9 and (axis, side) == (0, 0):
            return dataclasses.replace(spec, perturb_value=float(self.value))
        return spec


@computes.register("LBMFixedZerothOrderBC")
class LBMFixedZerothOrderBC(_FixedOrderBC):
    """Zou-He density boundary (reference LBMFixedZerothOrderBC.C)."""


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
