"""Fused LBM substep: the port of marlin_tpu/pallas_lbm.py.

With ``[Problem] lbm_backend = PALLAS`` (the JAX package's backend name,
kept so decks run unchanged) every substep but the last of a step is one
pass over the distribution (``fused_substep``):

    read  fpc_old (pull-streamed, periodic on all three axes)
    write fpc_new, speed

in which the whole chain of the deck runs per cell in registers: face and
obstacle bounce-back from the unstreamed distribution, solid masking, the
post-stream Zou-He and zero-gradient faces in deck order, the moments, the
equilibrium and the BGK collision.  The distribution is held q-major,
(q, nx, ny, nz), so each direction is one contiguous plane; the layout
changes once per MOOSE step, around the loop.  The last substep of a step
runs the eager chain, so every deck buffer and the old-state ring leave the
step as the unfused path leaves them.

This slice fuses D3Q19 and D3Q27 BGK chains with face bounce-back, a body
force, binary media (obstacle bounce-back and solid masking) and Zou-He
fixed-order (first and zeroth order) and zero-gradient faces.
``match_chain`` raises ``FusedChainError`` with the JAX package's own
message, word for word, for a chain the JAX package would not fuse, and
with a message of its own, naming the feature, for a chain it would fuse
but this port does not yet: 2-D decks and the D2Q9 stencil, a second
lattice and the collisionless chain.  MRT, Smagorinsky, the Hermite
projection and force fields fail earlier, at build: their computes are not
ported (computes/lbm.py); sharded domains fail in the Domain.  None of them
ever falls back to the eager chain.

``fused_substep`` launches the CUDA kernel of ``csrc/lbm_substep.cu`` (the
counterpart of pallas_lbm.py:224 ``_make_kernel``) on a CUDA tensor and
computes its plain twin ``fused_substep_twin`` on a CPU tensor; a CUDA
tensor never reaches the twin.  It counts its launches.

Kernel, twin and the eager chain (computes/lbm.py, computes/lbm_bc.py) do
the same operations in the same order, so ``PALLAS`` and ``JNP`` give the
same bits: the sums over directions in index order, the divisions by
constants as multiplications by their reciprocals, the Zou-He faces
through one affine plan (``apply_zouhe``), the kernel built without
fused multiply-adds.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import unordered_fft as uf
from .computes.lbm import INV_CS2, INV_CS4

CS2 = 1.0 / 3.0  # the Zou-He plan's (pallas_lbm.py CS2)

MAX_FACES = 8  # csrc/lbm_substep.cu LBM_MAX_FACES
MAX_POST = 8  # csrc/lbm_substep.cu LBM_MAX_POST
MAX_Q = 27


class FusedChainError(Exception):
    """The deck's LBM chain does not match the fused-kernel pattern."""


@dataclass(frozen=True)
class PostBC:
    """One post-stream boundary condition, compiled to a static update plan
    at match time (kind 'zh': Zou-He fixed-order, reference
    LBMFixedFirstOrderBC.C / LBMFixedZerothOrderBC.C; kind 'zg':
    microscopic zero-gradient, reference LBMMicroscopicZeroGradientBC.C).

    Zou-He reduces to ONE uniform affine form for both orders, both sides,
    and both the D2Q9 and generic branches:

        facesum = sum(f[sum1]) + 2 * sum(f[sum2])      (known dirs at face)
        m       = a * facesum + b                      (momentum scalar)
        f[d]    = f[src] + cm * m + tc * (f[tp] - f[tm])   per unknown dir

    where for first-order (velocity v): m = v * rho = v * facesum / (1 -/+ v)
    -> a = v / (1 -/+ v), b = 0; and for zeroth-order (density r):
    m = r * u = +/-(r - facesum) -> a = -/+1, b = +/-r.  The D2Q9 branch
    adds the transverse correction rows (tc != 0); the generic branch keeps
    the reference's quirky negative-index neutral set in `sum1` verbatim.
    Reads within one BC see the PRE-BC distribution; writes become visible
    to LATER BCs."""

    kind: str  # "zh" | "zg"
    axis: int
    side: int
    a: float = 0.0
    b: float = 0.0
    sum1: Tuple[int, ...] = ()
    sum2: Tuple[int, ...] = ()
    # per-unknown update rows: (dir, src, cm, tc, tp, tm)
    rows: Tuple[Tuple[int, int, float, float, int, int], ...] = ()


@dataclass(frozen=True)
class FusedLBMConfig:
    q: int
    e: Tuple[Tuple[int, int, int], ...]
    w: Tuple[float, ...]
    op: Tuple[int, ...]
    nx: int
    ny: int
    nz: int
    tau: float
    body_force: Tuple[float, float, float]
    # (axis, side, replaced_dirs) per bounce-back face, in deck order;
    # axis == -1 marks the obstacle ("wall") bounce-back slot
    faces: Tuple[Tuple[int, int, Tuple[int, ...]], ...]
    # binary media: solid masking + optional obstacle bounce-back
    has_media: bool = False
    # post-stream BCs (Zou-He fixed-order / zero-gradient faces), deck order
    post_bcs: Tuple[PostBC, ...] = ()
    # the carried scalar: "umag" (velocity magnitude) or "none" (zeros)
    speed_kind: str = "umag"


@dataclass(frozen=True)
class FusedLBMPlan:
    config: FusedLBMConfig
    fpc: str  # post-collision distribution (the carried state)
    speed: Optional[str]  # carried scalar buffer (residual input)


# ---------------------------------------------------------------------------
# matching the deck's chain (pallas_lbm.py:match_chain)
# ---------------------------------------------------------------------------

_FACE_AXIS_SIDE = {
    "left": (0, 0), "right": (0, 1),
    "bottom": (1, 0), "top": (1, 1),
    "front": (2, 0), "back": (2, 1),
}


def _reject(msg):
    raise FusedChainError(f"lbm_backend = PALLAS: {msg} (use the default JNP backend)")


def _not_ported(feature):
    raise FusedChainError(
        f"lbm_backend = PALLAS: {feature} is not ported to marlin_tpu_torch "
        f"yet (use the default JNP backend)")


def _zouhe_spec(st, axis, side, value, first_order) -> PostBC:
    """Compile one Zou-He fixed-order face to the uniform PostBC affine form
    (see PostBC).  Reproduces reference LBMFixedFirstOrderBC.C /
    LBMFixedZerothOrderBC.C exactly: the D2Q9 branch's transverse
    correction rows AND the generic branch's negative-index neutral-set
    quirk (`f[..., -neutral_x]`) both fall out of the same coefficients."""
    q = int(st.q)
    if axis == 0:
        low_set = st.left
        e_t = st.ey
        neutral = st.neutral_x if q == 9 else (-st.neutral_x) % q
    else:
        low_set = st.bottom
        e_t = st.ex
        neutral = st.neutral_y
    high_set = st.op[low_set]
    unknown = low_set if side == 0 else high_set
    sum2 = high_set if side == 0 else low_set
    sgn = 1.0 if side == 0 else -1.0
    if first_order:
        a, b = value / (1.0 - sgn * value), 0.0
    else:
        a, b = -sgn, sgn * value
    if q == 9:
        # tangential pair: the +/- transverse axis-aligned directions
        e_n = st.ex if axis == 0 else st.ey
        tp = int(np.where((e_n == 0) & (e_t == 1) & (st.ez == 0))[0][0])
        tm = int(st.op[tp])
    else:
        tp = tm = 0
    rows = []
    for d in unknown:
        d = int(d)
        cm = sgn * 2.0 * float(st.weights[d]) / CS2
        tc = -0.5 * float(e_t[d]) if q == 9 else 0.0
        rows.append((d, int(st.op[d]), cm, tc, tp, tm))
    return PostBC(
        kind="zh", axis=axis, side=side, a=float(a), b=float(b),
        sum1=tuple(int(i) for i in neutral),
        sum2=tuple(int(i) for i in sum2),
        rows=tuple(rows),
    )


def apply_zouhe(bc: PostBC, f) -> Dict[int, torch.Tensor]:
    """One Zou-He face's affine update: {direction d: f[src] + cm·m} with
    m = a·(Σ f[sum1] + Σ 2·f[sum2]), every read from ``f`` (indexed by
    direction: the state before this face).  Each sum runs in ascending
    direction order, in every backend."""
    fsum = None
    for d in sorted(bc.sum1):
        fsum = f[d] if fsum is None else fsum + f[d]
    for d in sorted(bc.sum2):
        fsum = fsum + 2.0 * f[d]
    m = bc.a * fsum + bc.b
    out = {}
    for d, src, cm, tc, tp, tm in bc.rows:
        val = f[src] + cm * m
        if tc:
            val = val + tc * (f[tp] - f[tm])
        out[d] = val
    return out


def match_chain(problem) -> FusedLBMPlan:
    """Validate the deck's LBM chain against the fused pattern and build the
    kernel plan.  Raises FusedChainError naming the unsupported feature."""
    from .computes import lbm as L
    from .computes import lbm_bc as LB
    from .solvers.lbm_stream import LBMStream

    dom = problem.domain
    if dom.dim not in (2, 3):
        _reject("only 2-D/3-D decks are supported")
    if dom.dim == 2:
        _not_ported("the 2-D (D2Q9) fused substep")
    has_media = problem.lbm_solid_mask() is not None

    solver = problem.solver
    if not isinstance(solver, LBMStream):
        _reject("the solver must be LBMStream")
    if len(solver.buffers_) not in (1, 2):
        _reject("at most two streamed buffers are supported")
    f_name, fpc_name = solver.buffers_[0], solver.f_old[0]
    if len(solver.buffers_) == 2:
        if solver.buffers_[1] == f_name:
            _reject("the two streamed buffers must be distinct")
        _not_ported("a second streamed lattice (the two-lattice thermal chain)")

    st = problem.lbm_stencil()
    if int(st.q) == 9:
        _not_ported("the D2Q9 stencil")
    faces = []
    post_bcs = []
    for bc in problem.bc_computes:
        lat = bc.out
        if lat != f_name:
            _reject(f"boundary compute '{bc.name}' writes '{lat}', which is "
                    f"not a streamed buffer")
        if isinstance(bc, (LB.LBMFixedFirstOrderBC, LB.LBMFixedZerothOrderBC)):
            # Zou-He fixed-order faces (reference LBMFixedFirstOrderBC.C /
            # LBMFixedZerothOrderBC.C) — compiled to PostBC update plans
            if bc.f != lat:
                _reject(
                    f"fixed-order BC '{bc.name}' must read and write the "
                    f"same streamed buffer"
                )
            first = isinstance(bc, LB.LBMFixedFirstOrderBC)
            if bc.boundary not in ("left", "right", "bottom", "top"):
                _reject(
                    f"fixed-order BC boundary '{bc.boundary}' is not fusable"
                )
            axis, side = _FACE_AXIS_SIDE[bc.boundary]
            if axis == 1:
                # parity: the eager chain raises for q != 9 on these faces
                _reject("bottom/top fixed-order BCs exist for D2Q9 only")
            # perturb = true changes only the D2Q9 left face (out of this
            # slice); everywhere else the eager chain ignores it too
            post_bcs.append(_zouhe_spec(st, axis, side, float(bc.value), first))
            continue
        if isinstance(bc, LB.LBMMicroscopicZeroGradientBC):
            if bc.boundary not in _FACE_AXIS_SIDE:
                _reject(
                    f"zero-gradient boundary '{bc.boundary}' is not a domain "
                    f"face"
                )
            axis, side = _FACE_AXIS_SIDE[bc.boundary]
            post_bcs.append(PostBC(kind="zg", axis=axis, side=side))
            continue
        if not isinstance(bc, LB.LBMBounceBack):
            _reject(f"boundary compute '{bc.name}' ({type(bc).__name__}) "
                    f"is not fusable")
        if post_bcs:
            # bounce-back runs inside the streaming stage; a deck listing
            # it AFTER a Zou-He/zero-gradient face would reorder the face
            # writes
            _reject(
                f"bounce-back '{bc.name}' listed after a Zou-He/zero-"
                f"gradient BC is not fusable"
            )
        if bc.f_old != fpc_name:
            _reject(f"bounce-back '{bc.name}' must act on the streamed pair")
        if bc.boundary == "wall":
            if not has_media:
                _reject("wall bounce-back requires binary media")
            faces.append((-1, 0, ()))  # keep the deck's BC ordering
            continue
        if bc.boundary not in _FACE_AXIS_SIDE:
            _reject(f"bounce-back boundary '{bc.boundary}' is not a domain face")
        if (bc.xsel, bc.ysel, bc.zsel) != (slice(None),) * 3:
            _reject("exclude_corners_* options are not supported")
        axis, side = _FACE_AXIS_SIDE[bc.boundary]
        incoming = {"left": st.left, "bottom": st.bottom, "front": st.front}
        if side == 0:
            dirs = incoming[bc.boundary]
        else:
            low = {"right": "left", "top": "bottom", "back": "front"}[bc.boundary]
            dirs = st.op[incoming[low]]
        faces.append((axis, side, tuple(int(d) for d in dirs)))

    # classify the Solve chain (collect by type, then wire by the buffer
    # dataflow)
    by_type = {"density": [], "velocity": [], "equilibrium": [],
               "collision": [], "speed": [], "residual": []}
    for c in problem.solve_computes:
        if isinstance(c, L.LBMComputeDensity):
            by_type["density"].append(c)
        elif isinstance(c, L.LBMComputeVelocity):
            by_type["velocity"].append(c)
        elif isinstance(c, L.LBMEquilibrium):
            by_type["equilibrium"].append(c)
        elif type(c) is L.LBMBGKCollision:
            by_type["collision"].append(c)
        elif isinstance(c, L.LBMComputeVelocityMagnitude):
            by_type["speed"].append(c)
        elif isinstance(c, L.LBMComputeResidual):
            by_type["residual"].append(c)
        else:
            _reject(f"solve compute '{c.name}' ({type(c).__name__}) is not fusable")
    for key in by_type:
        limit = 2 if key in ("density", "equilibrium", "collision") else 1
        if len(by_type[key]) > limit:
            _reject(f"more than {limit} {key} compute(s) in the chain")

    def pick(key, pred):
        for c in by_type[key]:
            if pred(c):
                return c
        return None

    density = pick("density", lambda c: c.f == f_name)
    velocity = by_type["velocity"][0] if by_type["velocity"] else None
    speed = by_type["speed"][0] if by_type["speed"] else None
    residual = by_type["residual"][0] if by_type["residual"] else None

    for what, c in (("LBMComputeDensity", density),
                    ("LBMComputeVelocity", velocity)):
        if c is None:
            _reject(f"the chain requires a {what} compute")

    equilibrium = pick("equilibrium", lambda c: c.rho == density.out)
    collision = pick("collision", lambda c: c.f == f_name)

    if density.f != f_name:
        _reject("density must be computed from the streamed distribution")
    if velocity.f != f_name or velocity.rho != density.out:
        _reject("velocity must be computed from the streamed distribution/density")
    if velocity.enable_forces:
        # LBMComputeForces is not ported, so no chain supplies the field
        _reject("enable_forces requires a LBMComputeForces compute in the chain")

    if collision is None:
        # collisionless chain (reference mixed_bcs_* decks)
        if equilibrium is not None:
            _reject("an equilibrium compute without a collision would go "
                    "stale across fused substeps")
        if fpc_name != f_name:
            _reject("collisionless chains require f_old = the streamed "
                    "buffer itself")
        _not_ported("the collisionless chain (LBMStream with f_old = f)")
    if equilibrium is None:
        _reject("the chain requires a LBMEquilibrium compute")
    if equilibrium.rho != density.out or equilibrium.velocity != velocity.out:
        _reject("equilibrium must consume the chain's density and velocity")
    if collision.f != f_name or collision.feq != equilibrium.out:
        _reject("collision must consume the streamed distribution and equilibrium")
    if collision.out != fpc_name:
        _reject("collision must write the solver's f_old buffer")

    if speed is not None and speed.velocity != velocity.out:
        _reject("velocity magnitude must consume the chain's velocity")
    # the carried scalar: the residual field (velocity magnitude)
    speed_kind = "none"
    speed_buffer = None
    if residual is not None:
        if speed is not None and residual.speed == speed.out:
            speed_kind, speed_buffer = "umag", speed.out
        else:
            _reject("the residual must consume the chain's velocity "
                    "magnitude or the thermal lattice's zeroth moment")
    elif speed is not None:
        speed_kind, speed_buffer = "umag", speed.out

    bf = velocity.body_force if velocity.add_body_force else [0.0, 0.0, 0.0]
    nx, ny, nz = (list(dom.shape) + [1, 1])[:3]
    cfg = FusedLBMConfig(
        q=int(st.q),
        e=tuple((int(st.ex[i]), int(st.ey[i]), int(st.ez[i])) for i in range(st.q)),
        w=tuple(float(w) for w in st.weights),
        op=tuple(int(o) for o in st.op),
        nx=int(nx), ny=int(ny), nz=int(nz),
        tau=float(collision.tau_0),
        body_force=(float(bf[0]), float(bf[1]), float(bf[2])),
        faces=tuple(faces),
        has_media=has_media,
        post_bcs=tuple(post_bcs),
        speed_kind=speed_kind,
    )
    old_keys = set()
    for c in [solver] + list(problem.bc_computes) + list(problem.solve_computes):
        old_keys |= set(getattr(c, "history_requests", dict)())
    allowed = {fpc_name, speed_buffer} - {None}
    if not old_keys <= allowed:
        _reject(f"unsupported old-state history on {sorted(old_keys)}")
    return FusedLBMPlan(
        config=cfg,
        fpc=fpc_name,
        speed=speed_buffer,
    )


# ---------------------------------------------------------------------------
# the plain twin: the kernel's decomposition in torch ops
# ---------------------------------------------------------------------------


def _face_masks(cfg: FusedLBMConfig, device) -> Dict[Tuple[int, int], torch.Tensor]:
    """(axis, side) -> a bool tensor broadcastable to (nx, ny, nz), true on
    that face."""
    masks = {}
    keys = [(a, s) for a, s, _d in cfg.faces] + [(bc.axis, bc.side)
                                                 for bc in cfg.post_bcs]
    dims = (cfg.nx, cfg.ny, cfg.nz)
    for axis, side in keys:
        if axis < 0 or (axis, side) in masks:
            continue
        view = [1, 1, 1]
        view[axis] = dims[axis]
        io = torch.arange(dims[axis], device=device).reshape(view)
        masks[(axis, side)] = io == (0 if side == 0 else dims[axis] - 1)
    return masks


def fused_substep_twin(fpc_qm: torch.Tensor, media: Optional[torch.Tensor],
                       cfg: FusedLBMConfig):
    """One lattice update in plain torch ops, in the kernel's order
    (pallas_lbm.py:_make_kernel); returns (fpc_new_qm, speed).  ``fpc_qm``
    is (q, nx, ny, nz); ``media`` the (nx, ny, nz) media code, or None."""
    q = cfg.q
    zero = torch.zeros((), dtype=fpc_qm.dtype, device=fpc_qm.device)
    masks = _face_masks(cfg, fpc_qm.device)
    if cfg.has_media:
        solid = media == 0
        # bounce-back applies at FLUID cells only (media >= 1); negative
        # media ids are neither solid-filled nor bounced
        fluid = media >= 1

    def streamed(qi):
        """Pull-streamed direction qi with face + obstacle bounce-back and
        solid masking (reference LBMStream.C:51-80 + LBMBounceBack.C +
        maskedFillSolids)."""
        e = cfg.e[qi]
        a = torch.roll(fpc_qm[qi], e, (0, 1, 2))
        for axis, side, dirs in cfg.faces:
            if axis < 0:
                # obstacle bounce-back: fluid cells whose upstream
                # neighbor along e is solid
                if qi != 0:
                    m_up = torch.roll(media, e, (0, 1, 2))
                    a = torch.where((m_up == 0) & fluid, fpc_qm[cfg.op[qi]], a)
            elif qi in dirs:
                # face bounce-back: the OPPOSITE direction of the unstreamed
                # old distribution at the same node
                a = torch.where(masks[(axis, side)], fpc_qm[cfg.op[qi]], a)
        if cfg.has_media:
            a = torch.where(solid, zero, a)
        return a

    fs = [streamed(qi) for qi in range(q)]
    for bc in cfg.post_bcs:
        # deck order, each BC reading the state the earlier ones left
        mask = masks[(bc.axis, bc.side)]
        prev = list(fs)

        def put(d, val):
            if cfg.has_media:
                val = torch.where(solid, zero, val)
            fs[d] = torch.where(mask, val, fs[d])

        if bc.kind == "zg":
            # copy the adjacent inner layer onto the face layer
            shift = 1 if bc.side == 1 else -1
            for qi in range(q):
                put(qi, torch.roll(prev[qi], shift, bc.axis))
        else:
            for d, val in apply_zouhe(bc, prev).items():
                put(d, val)

    # moments (reference LBMComputeDensity / LBMComputeVelocity)
    rho = mx = my = mz = None
    for qi in range(q):
        a = fs[qi]
        rho = a if rho is None else rho + a
        ex, ey, ez = cfg.e[qi]
        if ex:
            t = a if ex > 0 else -a
            mx = t if mx is None else mx + t
        if ey:
            t = a if ey > 0 else -a
            my = t if my is None else my + t
        if ez:
            t = a if ez > 0 else -a
            mz = t if mz is None else mz + t
    # u = m / rho (+ F / (2 rho) for each non-zero body force); tensor
    # divisions, as the eager chain's (a Python scalar over a tensor would
    # multiply by the tensor's reciprocal)
    vel = [m / rho for m in (mx, my, mz)]
    bf = torch.tensor(cfg.body_force, dtype=rho.dtype, device=rho.device)
    for i, force in enumerate(cfg.body_force):
        if force != 0.0:
            vel[i] = vel[i] + bf[i] / (2.0 * rho)
    ux, uy, uz = vel
    if cfg.has_media:
        # solids carry rho = 0: zero the velocity as the masked chain does
        ux, uy, uz = (torch.where(solid, zero, c) for c in (ux, uy, uz))
    usqr = ux * ux + uy * uy + uz * uz
    if cfg.speed_kind == "umag":
        speed = torch.sqrt(usqr)
    else:
        speed = torch.zeros_like(rho)

    inv_tau = 1.0 / cfg.tau
    third = 0.5 * usqr * INV_CS2
    out = []
    for qi in range(q):
        # equilibrium (reference LBMEquilibrium.C:42-66), then BGK
        ex, ey, ez = cfg.e[qi]
        edotu = None
        for c, u in ((ex, ux), (ey, uy), (ez, uz)):
            if c:
                t = u if c > 0 else -u
                edotu = t if edotu is None else edotu + t
        if edotu is None:
            feq = cfg.w[qi] * rho * (1.0 - third)
        else:
            second = edotu * INV_CS2 + 0.5 * edotu * edotu * INV_CS4
            feq = cfg.w[qi] * rho * (1.0 + second - third)
        fneq = fs[qi] - feq
        u = feq + fneq - fneq * inv_tau
        if cfg.has_media:
            u = torch.where(solid, zero, u)
        out.append(u)
    return torch.stack(out), speed


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/lbm_substep.cu)
# ---------------------------------------------------------------------------


class _Post(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int32), ("axis", ctypes.c_int32),
                ("side", ctypes.c_int32), ("sum1", ctypes.c_uint32),
                ("sum2", ctypes.c_uint32), ("rows", ctypes.c_uint32),
                ("a", ctypes.c_double), ("b", ctypes.c_double),
                ("cm", ctypes.c_double * MAX_Q)]


class _Plan(ctypes.Structure):
    """csrc/lbm_substep.cu ``LbmPlan``, field for field."""

    _fields_ = [("nx", ctypes.c_int64), ("ny", ctypes.c_int64),
                ("nz", ctypes.c_int64), ("w", ctypes.c_double * MAX_Q),
                ("inv_tau", ctypes.c_double), ("inv_cs2", ctypes.c_double),
                ("inv_cs4", ctypes.c_double), ("bf", ctypes.c_double * 3),
                ("n_faces", ctypes.c_int32),
                ("face_axis", ctypes.c_int32 * MAX_FACES),
                ("face_side", ctypes.c_int32 * MAX_FACES),
                ("face_dirs", ctypes.c_uint32 * MAX_FACES),
                ("n_post", ctypes.c_int32), ("speed", ctypes.c_int32),
                ("post", _Post * MAX_POST)]


LIBRARY = uf.CudaLibrary("lbm_substep", {
    # fpc, media (or null), fpc_new, speed; q, double?; the host plan; stream
    "mtt_lbm_substep": [uf._P] * 4 + [ctypes.c_int] * 2 + [uf._P, uf._P],
    # q; the compiled-in e (q·3) and op (q) tables out
    "mtt_lbm_tables": [ctypes.c_int, uf._P, uf._P],
}, source=os.path.join(uf.CSRC, "lbm_substep.cu"), flags=["-fmad=false"])


def _mask(dirs) -> int:
    m = 0
    for d in dirs:
        m |= 1 << int(d)
    return m


def pack(cfg: FusedLBMConfig) -> _Plan:
    """The kernel's plan struct for ``cfg``; raises for what the kernel
    does not take."""
    if len(cfg.faces) > MAX_FACES or len(cfg.post_bcs) > MAX_POST:
        raise FusedChainError(
            f"lbm_backend = PALLAS: the kernel takes at most {MAX_FACES} "
            f"bounce-back and {MAX_POST} post-stream boundary conditions")
    p = _Plan(nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, inv_tau=1.0 / cfg.tau,
              inv_cs2=INV_CS2, inv_cs4=INV_CS4,
              n_faces=len(cfg.faces), n_post=len(cfg.post_bcs),
              speed=int(cfg.speed_kind == "umag"))
    p.w[:cfg.q] = cfg.w
    p.bf[:] = cfg.body_force
    for i, (axis, side, dirs) in enumerate(cfg.faces):
        p.face_axis[i], p.face_side[i], p.face_dirs[i] = axis, side, _mask(dirs)
    for i, bc in enumerate(cfg.post_bcs):
        post = p.post[i]
        post.kind, post.axis, post.side = int(bc.kind == "zg"), bc.axis, bc.side
        post.a, post.b = bc.a, bc.b
        # the kernel sums sum1, then 2·sum2, each in ascending direction
        # order (as apply_zouhe), and reads each row's source at op[d] (as
        # _zouhe_spec sets)
        post.sum1, post.sum2 = _mask(bc.sum1), _mask(bc.sum2)
        for d, src, cm, tc, _tp, _tm in bc.rows:
            if src != cfg.op[d] or tc or post.rows >> d & 1:
                raise FusedChainError(
                    "lbm_backend = PALLAS: a Zou-He row the kernel does not "
                    "take (a source other than op[d], a D2Q9 transverse "
                    "term, or a direction twice)")
            post.rows |= 1 << d
            post.cm[d] = cm
    return p


_CHECKED_TABLES = set()


def _check_tables(cfg: FusedLBMConfig):
    """The kernel compiles each stencil's e and op in (so every direction
    index is static); hold them to the plan's once per stencil."""
    key = (cfg.q, cfg.e, cfg.op)
    if key in _CHECKED_TABLES:
        return
    if cfg.q not in (19, 27):
        raise FusedChainError(f"lbm_backend = PALLAS: the kernel takes q = 19 "
                              f"or 27 (got {cfg.q})")
    e = np.zeros((cfg.q, 3), np.int32)
    op = np.zeros(cfg.q, np.int32)
    err = LIBRARY.load().mtt_lbm_tables(cfg.q, e.ctypes.data, op.ctypes.data)
    if err != 0 or [tuple(r) for r in e.tolist()] != list(cfg.e) or \
            tuple(op.tolist()) != cfg.op:
        raise FusedChainError(f"lbm_backend = PALLAS: the D3Q{cfg.q} tables "
                              "compiled into csrc/lbm_substep.cu differ from "
                              "the stencil's")
    _CHECKED_TABLES.add(key)


def fused_substep(fpc_qm: torch.Tensor, media: Optional[torch.Tensor],
                  cfg: FusedLBMConfig):
    """One lattice update of the (q, nx, ny, nz) post-collision
    distribution; ``media`` is the (nx, ny, nz) int8 media code
    (TensorProblem.lbm_media) or None.  Returns (fpc_new_qm, speed).
    Replaces pallas_lbm.py:224 ``_make_kernel`` (via ``fused_substep``)."""
    shape = (cfg.q, cfg.nx, cfg.ny, cfg.nz)
    if tuple(fpc_qm.shape) != shape:
        raise ValueError(f"fused_substep: fpc shape {tuple(fpc_qm.shape)}, "
                         f"plan {shape}")
    if fpc_qm.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_substep: dtype {fpc_qm.dtype} (float32 or float64)")
    if cfg.has_media != (media is not None):
        raise ValueError("fused_substep: media must be given exactly when the "
                         "plan has binary media")
    if media is not None and (tuple(media.shape) != shape[1:]
                              or media.dtype != torch.int8
                              or media.device != fpc_qm.device):
        raise TypeError("fused_substep: media must be the (nx, ny, nz) int8 "
                        "media code on the distribution's device")
    if not uf._launch_kernel(fpc_qm, "fused_substep"):
        return fused_substep_twin(fpc_qm, media, cfg)
    if not fpc_qm.is_contiguous() or (media is not None and not media.is_contiguous()):
        raise ValueError("fused_substep: inputs must be contiguous")
    _check_tables(cfg)
    plan = pack(cfg)
    out = torch.empty_like(fpc_qm)
    speed = torch.empty(shape[1:], dtype=fpc_qm.dtype, device=fpc_qm.device)
    uf._launch(LIBRARY.load().mtt_lbm_substep, uf._ptr(fpc_qm), uf._ptr(media),
               uf._ptr(out), uf._ptr(speed), cfg.q,
               int(fpc_qm.dtype == torch.float64), ctypes.addressof(plan),
               device=fpc_qm.device, name="fused_substep")
    fused_substep.launches += 1
    return out, speed


fused_substep.launches = 0


def reset_launches():
    fused_substep.launches = 0


def launches() -> Dict[str, int]:
    return {"lbm_substep": fused_substep.launches}
