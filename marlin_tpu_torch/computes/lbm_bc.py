"""Lattice Boltzmann boundary conditions.

The port of marlin_tpu/computes/lbm_bc.py (reference
src/tensor_computes/LBMBoundaryCondition.C, LBMBounceBack.C,
LBMFixedFirstOrderBC.C, LBMFixedZerothOrderBC.C, LBMDirichletBC.C,
LBMNeumannBC.C, LBMMicroscopicZeroGradientBC.C,
LBMSpecularReflectionBoundary.C).  The Dirichlet, Neumann and specular
conditions run eagerly only: the fused kernel's plan refuses them with
the JAX package's words.  What they precompute (face direction lists,
specular partners, wall and region masks) is built once, on the device.

Face conventions (reference include/tensor_computes/LBMBoundaryCondition.h):
left x=0, right x=nx-1, bottom y=0, top y=ny-1, front z=0, back z=nz-1;
`wall` = binary-media obstacle cells; `regional` = region-id cells.

A boundary condition returns a new tensor: it clones its buffer once and
writes the clone, so no tensor of the state is written in place.

Under REAL_SPACE on a mesh a face's condition runs on the ranks whose
block holds that face of the grid (``Domain.holds_face``), the others
leave their block as it is; the masks built from shifted media take the
shift across ranks (``Domain.padded``); the perturbed inlet reads its
profile over the global y.  Corner exclusion along an axis the mesh cuts
is a named error.

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

import numpy as np
import torch

from ..params import Params
from ..registry import computes
from .base import ComputeError
from .lbm import LatticeBoltzmannOperator, _ensure3d, _equilibrium

BOUNDARIES = ["top", "bottom", "left", "right", "front", "back", "wall", "regional"]


class LBMBoundaryCondition(LatticeBoltzmannOperator):
    is_boundary_condition = True

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.boundary = params.get_enum("boundary", BOUNDARIES, None)
        if self.boundary is None:
            params.error("boundary", "is required")

    def boundary_adjacent_mask(self):
        """The media with every fluid cell next to a solid one (along any
        stencil direction) marked -1 (reference LBMBounceBack.C ctor,
        binary-media block), on the device; None without media."""
        media = self.problem.lbm_media_ids()
        if media is None:
            return None
        st = self.stencil
        marked = media.clone()
        for ic, shifted in _shifts(self.domain, media, st):
            marked = torch.where((shifted == 0) & (media >= 1), -1, marked)
        return marked

    def apply(self, state, ctx):
        u = state[self.out]
        face = _FACE_SIDE.get(self.boundary)
        if face is None or self.domain.holds_face(*face):
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


#: (axis, side) of each face
_FACE_SIDE = {"left": (0, 0), "right": (0, 1), "bottom": (1, 0), "top": (1, 1),
              "front": (2, 0), "back": (2, 1)}


def _shifts(dom, media, st):
    """(ic, media rolled by e_ic) for every direction but the rest one,
    across ranks on a mesh (one padding for all of them)."""
    halo = dom.halo_dims()
    src = dom.padded(media) if halo else media
    for ic in range(1, st.q):
        e = (int(st.ex[ic]), int(st.ey[ic]), int(st.ez[ic]))
        if halo:
            from ..parallel import shifted

            yield ic, shifted(src, e, (0, 1, 2), halo)
        else:
            yield ic, torch.roll(media, e, (0, 1, 2))


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
        self.xsel, self.ysel, self.zsel = (
            self._corner_sel(axis, params.get_bool(f"exclude_corners_{'xyz'[axis]}"))
            for axis in range(3))
        self._wall_mask = None

    def _corner_sel(self, axis: int, exclude: bool) -> slice:
        """The transverse selection along ``axis``: everything, or with
        ``exclude_corners`` the grid's planes 1 .. n-2 (``slice(1, -1)``
        on the whole grid).  On an axis that the mesh cuts, a block drops
        its first plane only where it starts at plane 0 and its last only
        where it ends at plane n, from its ``real_slice``; an empty block
        drops nothing."""
        if not exclude:
            return slice(None)
        dom = self.domain
        if axis not in dom.halo_dims():
            return slice(1, -1)
        block = dom.real_slice[axis]
        n = block.stop - block.start
        if not n:
            return slice(0, 0)
        return slice(1 if block.start == 0 else 0,
                     n - 1 if block.stop == dom.n_global[axis] else n)

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
            for ic, shifted in _shifts(self.domain, media, st):
                bits |= ((shifted == 0) & fluid).to(torch.int32) << ic
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
            # the profile over the global y, this block's rows of it
            dom = self.domain
            a = perturb_profile(spec, dom.n_global[1], f.dtype, f.device)[
                dom.real_slice[1]][:, None]
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


#: (axis, position) of each face's plane
_FACES = {"left": (0, 0), "right": (0, -1), "bottom": (1, 0), "top": (1, -1),
          "front": (2, 0), "back": (2, -1)}


def _plane(t, axis, pos):
    """The face plane of ``t`` along ``axis`` kept as a plane of extent 1,
    so the spatial rank stays 3."""
    return t.narrow(axis, pos % t.shape[axis], 1)


def _face_dirs(stencil, face):
    """The directions a face's condition writes: the stencil's incoming set
    on a low face, the opposites of the low face's set on the high face (a
    D2Q9 stencil has no front set: AttributeError, as in the JAX package)."""
    low = {"right": "left", "top": "bottom", "back": "front"}.get(face)
    if low is None:
        return [int(d) for d in getattr(stencil, face)]
    return [int(stencil.op[int(d)]) for d in getattr(stencil, low)]


class _EquilibriumBC(LBMBoundaryCondition):
    """Non-equilibrium extrapolation: the boundary's equilibrium plus the
    non-equilibrium part f_old − feq, f_old read from its history slot 0
    (reference LBMDirichletBC.C / LBMNeumannBC.C).  A face computes on its
    plane only; ``wall`` (cells marked by ``boundary_adjacent_mask``) and
    ``regional`` (media == region_id) compute on the grid and take a mask
    built once on the device."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.f_old = params.get_str("f_old", required=True)
        self.feq = self.input_buffer("feq")
        self.rho = self.input_buffer("rho")
        self.velocity = self.input_buffer("velocity")
        self.region_id = params.get_int("region_id", None) if params.has("region_id") else None
        self._mask = None
        dirs = self.face_dirs() if self.boundary in _FACES else None
        # the directions a face writes, None for all of them
        self._dirs = None if dirs is None else torch.as_tensor(
            dirs, dtype=torch.long, device=self.domain.device)

    def face_dirs(self):
        return None

    def history_requests(self):
        return {self.f_old: 1}

    def boundary_feq(self, rho, velocity):
        raise NotImplementedError

    def _corrected(self, state, ctx, cut=lambda t: t):
        """feq_boundary + (f_old − feq) on ``cut`` of the grid."""
        feq = cut(state[self.feq])
        fneq = cut(ctx["old"][self.f_old][0]) - feq
        rho = cut(_ensure3d(state[self.rho]))
        return self.boundary_feq(rho, cut(state[self.velocity])) + fneq

    def _face(self, u, state, ctx):
        axis, pos = _FACES[self.boundary]
        corr = self._corrected(state, ctx, lambda t: _plane(t, axis, pos))
        u = u.clone()
        face = _plane(u, axis, pos)
        if self._dirs is None:
            face.copy_(corr)
        else:
            face[..., self._dirs] = corr.index_select(-1, self._dirs)
        return u

    def _mask_update(self, u, state, ctx, target, marked=True):
        if self._mask is None:
            mesh = self.boundary_adjacent_mask() if marked else \
                self.problem.lbm_media_ids()
            if mesh is None:
                raise ComputeError("wall/regional boundary requires binary media")
            self._mask = (mesh == target)[..., None]
        return torch.where(self._mask, self._corrected(state, ctx), u)

    def left_boundary(self, u, state, ctx):
        return self._face(u, state, ctx)

    top_boundary = bottom_boundary = right_boundary = left_boundary
    front_boundary = back_boundary = left_boundary

    def wall_boundary(self, u, state, ctx):
        return self._mask_update(u, state, ctx, -1)

    def regional_boundary(self, u, state, ctx):
        return self._mask_update(u, state, ctx, self.region_id or 0, marked=False)


@computes.register("LBMDirichletBC")
class LBMDirichletBC(_EquilibriumBC):
    """The equilibrium at the density ``value`` and the local velocity,
    written in every direction of the boundary's cells."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.boundary_value = params.get_float("value", 0.0)

    def boundary_feq(self, rho, velocity):
        return _equilibrium(self, self.boundary_value, velocity, self.domain.dim)


@computes.register("LBMNeumannBC")
class LBMNeumannBC(_EquilibriumBC):
    """The equilibrium at the local density plus ``gradient`` and the local
    velocity, written in a face's incoming directions (every direction on
    wall and regional boundaries)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.gradient = params.get_float("gradient", 0.0)

    def face_dirs(self):
        return _face_dirs(self.stencil, self.boundary)

    def boundary_feq(self, rho, velocity):
        return _equilibrium(self, rho + self.gradient, velocity, self.domain.dim)


@computes.register("LBMSpecularReflectionBoundary")
class LBMSpecularReflectionBoundary(LBMBoundaryCondition):
    """Slip/specular reflection (reference LBMSpecularReflectionBoundary.C,
    "under development and not tested" upstream; the JAX package's mix):
    each incoming direction d of a face takes r·f_old[op(d)] +
    (1 − r)·f_old[s(d)], s(d) the direction with the same tangential
    components and the normal one flipped (op(d) where the stencil has
    none).  The partners are found once, at build."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.f_old = params.get_str("f_old", required=True)
        self.r = params.get_float("r", 0.5)
        self._index = None
        if self.boundary in _FACES:
            st = self.stencil
            axis = _FACES[self.boundary][0]
            e = np.stack([st.ex, st.ey, st.ez], 1)
            dirs = _face_dirs(st, self.boundary)
            bounce, partner = [], []
            for d in dirs:
                o = int(st.op[d])
                want = e[d].copy()
                want[axis] = -want[axis]
                hits = np.flatnonzero((e == want).all(1))
                bounce.append(o)
                partner.append(int(hits[0]) if hits.size else o)
            dev = self.domain.device
            self._index = tuple(torch.as_tensor(x, dtype=torch.long, device=dev)
                                for x in (dirs, bounce, partner))

    def history_requests(self):
        return {self.f_old: 1}

    def left_boundary(self, u, state, ctx):
        axis, pos = _FACES[self.boundary]
        dirs, bounce, partner = self._index
        fold = _plane(ctx["old"][self.f_old][0], axis, pos)
        value = self.r * fold.index_select(-1, bounce) + \
            (1.0 - self.r) * fold.index_select(-1, partner)
        u = u.clone()
        _plane(u, axis, pos)[..., dirs] = value
        return u

    top_boundary = bottom_boundary = right_boundary = left_boundary
    front_boundary = back_boundary = left_boundary
