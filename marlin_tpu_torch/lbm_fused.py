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

The fused pattern covers 3-D D3Q19 and D3Q27 chains and 2-D D2Q9 chains:
BGK or MRT collisions, with or without the Hermite projection; on 2-D
decks the Smagorinsky collision, whose τ a cell needs the mean density of
the whole grid; face bounce-back, a body force, binary media (obstacle
bounce-back and solid masking); Zou-He fixed-order (first and zeroth
order, with the D2Q9 transverse rows on every face and the perturbed
sine inlet) and zero-gradient faces; the collisionless chain (LBMStream
with f_old = f); and the thermal double-distribution chain (a second
streamed lattice g with its own faces, T = Σg, Boussinesq buoyancy and
gravity through LBMComputeForces, the Guo source through LBMApplyForces,
the residual on T).  ``match_chain`` raises ``FusedChainError`` with the
JAX package's own message, word for word, for a chain the JAX package
would not fuse; sharded domains fail earlier, in the Domain.  None of
them ever falls back to the eager chain.

``fused_substep`` launches the CUDA kernel of ``csrc/lbm_substep.cu`` (the
counterpart of pallas_lbm.py:224 ``_make_kernel``) on CUDA tensors and
computes its plain twin ``fused_substep_twin`` on CPU tensors; a CUDA
tensor never reaches the twin.  On 3-D plans whose rows suit the bulk
copies the kernel walks bricks (``brick_plan`` chooses its rows a brick,
stages and threads, packed into the plan); elsewhere it runs one thread a
cell; both give the same bits.  A Smagorinsky plan first launches
``density_mean``'s two reduction passes (the streamed density's mean, on
the device, with no host sync).  Each wrapper counts its launches.

Kernel, twin and the eager chain (computes/lbm.py, computes/lbm_bc.py) do
the same operations in the same order, so ``PALLAS`` and ``JNP`` give the
same bits: the sums over directions in index order (the MRT rows and the
Hermite sums too, zero coefficients skipped), the divisions by constants
as multiplications by their reciprocals, the Zou-He faces through one
affine plan (``apply_zouhe``, the perturbed inlet's a(y) from
``perturb_profile``, computed once on the host), the mean density by one
pairwise tree (``tree_mean``), the coefficients from one function each
(``computes/lbm.py`` ``mrt_matrix``, ``hermite_tables``,
``smagorinsky_constants``, ``guo_prefactors``), the kernel built without
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
from .computes.lbm import (CS2 as LATTICE_CS2, INV_CS2, INV_CS4, _direction_sum,
                           guo_prefactors, hermite, hermite_tables, mrt_matrix, mrt_relax,
                           signed_sum, smagorinsky_constants, smagorinsky_inv_tau,
                           tree_mean)

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
    # perturb = true (the D2Q9 left-face velocity inlet, reference
    # LBMFixedFirstOrderBC::_ux_profile): the prescribed velocity is the row
    # profile v(y) = value·(1 + 1e-6·sin(2πy/ny)), so the momentum scalar
    # is m = a(y)·facesum with a(y) = v(y)/(1 − v(y)) (``perturb_profile``)
    perturb_value: float = 0.0


@dataclass(frozen=True)
class ForceSpec:
    """Force-field chain of the thermal two-lattice decks (reference
    LBMComputeForces.C + LBMApplyForces.C): a gravity/buoyancy field
    F_d = g·ρ (gravity) + g·ρ₀·(T − T₀) (Boussinesq buoyancy) enters the
    velocity as u += F/(2ρ) and the fluid collision as the Guo source
    (1 − 1/(2τ))·w_i·ρ·(e_i·F)/c_s²."""

    gravity: bool
    buoyancy: bool
    g: float
    rho0: float
    T0: float
    direction: int
    apply_tau: float  # LBMApplyForces tau0 (source prefactor); 0: none


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
    # MRT collision: fpc = feq + fneq - MSM·fneq with the static q×q
    # matrix MSM = M⁻¹·S'·M (computes/lbm.py mrt_matrix); None = BGK
    msm: Optional[Tuple[Tuple[float, ...], ...]] = None
    # post-stream BCs (Zou-He fixed-order / zero-gradient faces), deck order
    post_bcs: Tuple[PostBC, ...] = ()
    # False: the collisionless chain (LBMStream with f_old = f): the carried
    # state is the post-face streamed distribution itself
    collide: bool = True
    # moments needed (a collision, a speed compute or a second lattice)
    need_moments: bool = True
    # coupled second lattice (thermal double-distribution decks): lattice 2
    # carries the temperature advected at the fluid velocity; its zeroth
    # moment T feeds the buoyancy force on lattice 1
    two_lattice: bool = False
    tau2: float = 1.0
    msm2: Optional[Tuple[Tuple[float, ...], ...]] = None
    faces2: Tuple[Tuple[int, int, Tuple[int, ...]], ...] = ()
    post_bcs2: Tuple[PostBC, ...] = ()
    force: Optional[ForceSpec] = None
    # the carried scalar: "umag" (velocity magnitude), "t" (lattice 2's
    # zeroth moment, the thermal decks' residual field) or "none" (zeros)
    speed_kind: str = "umag"
    # Hermite projection of fneq before the collision, per lattice
    proj: bool = False
    proj2: bool = False
    # a 2-D deck (D2Q9): nz = 1 and the velocity has no z component
    two_d: bool = False
    # the Smagorinsky collision on the fluid lattice, (C_s, τ₀): τ a cell
    # from the non-equilibrium momentum flux and the grid's mean density
    smag: Optional[Tuple[float, float]] = None


@dataclass(frozen=True)
class FusedLBMPlan:
    config: FusedLBMConfig
    fpc: str  # post-collision distribution (the carried state)
    speed: Optional[str]  # carried scalar buffer (residual input)
    fpc2: Optional[str] = None  # the second lattice's carried distribution


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


def perturb_profile(bc: PostBC, ny: int, dtype, device) -> torch.Tensor:
    """The perturbed inlet's a(y) = v(y)/(1 − v(y)), v(y) = v + 1e-6·v·
    sin(2πy/ny), for y in 0..ny−1: computed once in double on the host and
    rounded to ``dtype``, so the eager chain, the twin and the kernel
    multiply by the same values (no backend evaluates the sine)."""
    key = (bc.perturb_value, ny, dtype, str(device))
    a = _PERTURB.get(key)
    if a is None:
        v0 = bc.perturb_value
        v = v0 + 1.0e-6 * v0 * np.sin(np.arange(ny, dtype=np.float64) / ny * 2.0 * np.pi)
        a = torch.as_tensor(v / (1.0 - v), dtype=dtype).to(device)
        _PERTURB[key] = a
    return a


_PERTURB: Dict[tuple, torch.Tensor] = {}


def apply_zouhe(bc: PostBC, f, a=None) -> Dict[int, torch.Tensor]:
    """One Zou-He face's affine update: {direction d: f[src] + cm·m
    (+ tc·(f[tp] − f[tm]) on the D2Q9 rows)} with m = a·(Σ f[sum1] +
    Σ 2·f[sum2]) + b, every read from ``f`` (indexed by direction: the
    state before this face); ``a``, where given, is the perturbed inlet's
    a(y), broadcastable to the planes.  Each sum runs in ascending direction
    order, in every backend."""
    fsum = None
    for d in sorted(bc.sum1):
        fsum = f[d] if fsum is None else fsum + f[d]
    for d in sorted(bc.sum2):
        fsum = fsum + 2.0 * f[d]
    m = (bc.a if a is None else a) * fsum + bc.b
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
    two_d = dom.dim == 2
    has_media = problem.lbm_solid_mask() is not None

    solver = problem.solver
    if not isinstance(solver, LBMStream):
        _reject("the solver must be LBMStream")
    if len(solver.buffers_) not in (1, 2):
        _reject("at most two streamed buffers are supported")
    two_lattice = len(solver.buffers_) == 2
    f_name, fpc_name = solver.buffers_[0], solver.f_old[0]
    g_name = solver.buffers_[1] if two_lattice else None
    gpc_name = solver.f_old[1] if two_lattice else None
    pc_of = {f_name: fpc_name}
    if two_lattice:
        if g_name in pc_of:
            _reject("the two streamed buffers must be distinct")
        pc_of[g_name] = gpc_name

    st = problem.lbm_stencil()
    faces_by = {name: [] for name in pc_of}
    post_by = {name: [] for name in pc_of}
    for bc in problem.bc_computes:
        lat = bc.out
        if lat not in pc_of:
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
            if axis == 1 and int(st.q) != 9:
                # parity: the eager chain raises for q != 9 on these faces
                _reject("bottom/top fixed-order BCs exist for D2Q9 only")
            # the perturbed sine inlet exists only on the D2Q9 left face;
            # everywhere else the eager chain ignores perturb, and so does
            # the plan (bc.spec gives the face's plan as the eager chain
            # runs it)
            post_by[lat].append(bc.spec(axis, side))
            continue
        if isinstance(bc, LB.LBMMicroscopicZeroGradientBC):
            if bc.boundary not in _FACE_AXIS_SIDE:
                _reject(
                    f"zero-gradient boundary '{bc.boundary}' is not a domain "
                    f"face"
                )
            if two_d and bc.boundary in ("front", "back"):
                _reject("front/back faces do not exist in 2-D")
            axis, side = _FACE_AXIS_SIDE[bc.boundary]
            post_by[lat].append(PostBC(kind="zg", axis=axis, side=side))
            continue
        if not isinstance(bc, LB.LBMBounceBack):
            _reject(f"boundary compute '{bc.name}' ({type(bc).__name__}) "
                    f"is not fusable")
        if post_by[lat]:
            # bounce-back runs inside the streaming stage; a deck listing
            # it AFTER a Zou-He/zero-gradient face on the same lattice
            # would reorder the face writes
            _reject(
                f"bounce-back '{bc.name}' listed after a Zou-He/zero-"
                f"gradient BC is not fusable"
            )
        if bc.f_old != pc_of[lat]:
            _reject(f"bounce-back '{bc.name}' must act on the streamed pair")
        if bc.boundary == "wall":
            if not has_media:
                _reject("wall bounce-back requires binary media")
            faces_by[lat].append((-1, 0, ()))  # keep the deck's BC ordering
            continue
        if bc.boundary not in _FACE_AXIS_SIDE:
            _reject(f"bounce-back boundary '{bc.boundary}' is not a domain face")
        if two_d and bc.boundary in ("front", "back"):
            _reject("front/back faces do not exist in 2-D")
        if (bc.xsel, bc.ysel, bc.zsel) != (slice(None),) * 3:
            _reject("exclude_corners_* options are not supported")
        axis, side = _FACE_AXIS_SIDE[bc.boundary]
        incoming = {"left": st.left, "bottom": st.bottom,
                    "front": getattr(st, "front", None)}
        if side == 0:
            dirs = incoming[bc.boundary]
        else:
            low = {"right": "left", "top": "bottom", "back": "front"}[bc.boundary]
            dirs = st.op[incoming[low]]
        faces_by[lat].append((axis, side, tuple(int(d) for d in dirs)))

    # classify the Solve chain (collect by type, then wire by the buffer
    # dataflow)
    by_type = {"density": [], "velocity": [], "equilibrium": [],
               "collision": [], "speed": [], "residual": [],
               "forces": [], "apply": []}
    for c in problem.solve_computes:
        if isinstance(c, L.LBMComputeDensity):
            by_type["density"].append(c)
        elif isinstance(c, L.LBMComputeVelocity):
            by_type["velocity"].append(c)
        elif isinstance(c, L.LBMEquilibrium):
            by_type["equilibrium"].append(c)
        elif type(c) in (L.LBMBGKCollision, L.LBMMRTCollision,
                         L.LBMSmagorinskyCollision):
            by_type["collision"].append(c)
        elif isinstance(c, L.LBMComputeVelocityMagnitude):
            by_type["speed"].append(c)
        elif isinstance(c, L.LBMComputeResidual):
            by_type["residual"].append(c)
        elif isinstance(c, L.LBMComputeForces):
            by_type["forces"].append(c)
        elif isinstance(c, L.LBMApplyForces):
            by_type["apply"].append(c)
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
    t_density = pick("density", lambda c: c.f == g_name) if two_lattice else None
    velocity = by_type["velocity"][0] if by_type["velocity"] else None
    speed = by_type["speed"][0] if by_type["speed"] else None
    residual = by_type["residual"][0] if by_type["residual"] else None
    forces = by_type["forces"][0] if by_type["forces"] else None
    apply_f = by_type["apply"][0] if by_type["apply"] else None

    for what, c in (("LBMComputeDensity", density),
                    ("LBMComputeVelocity", velocity)):
        if c is None:
            _reject(f"the chain requires a {what} compute")
    if two_lattice and t_density is None:
        _reject("two-lattice chains require a density (zeroth-moment) "
                "compute on the second streamed buffer")

    equilibrium = pick("equilibrium", lambda c: c.rho == density.out)
    collision = pick("collision", lambda c: c.f == f_name)
    equilibrium2 = collision2 = None
    if two_lattice:
        equilibrium2 = pick("equilibrium", lambda c: c.rho == t_density.out)
        collision2 = pick("collision", lambda c: c.f == g_name)

    if density.f != f_name:
        _reject("density must be computed from the streamed distribution")
    if velocity.f != f_name or velocity.rho != density.out:
        _reject("velocity must be computed from the streamed distribution/density")

    # force-field coupling (reference LBMComputeForces.C + LBMApplyForces.C:
    # the thermal decks' buoyancy chain)
    force_spec = None
    if velocity.enable_forces:
        if forces is None:
            _reject("enable_forces requires a LBMComputeForces compute in "
                    "the chain")
        if velocity.forces != forces.out:
            _reject("the velocity's force field must be the "
                    "LBMComputeForces output")
    if forces is not None:
        if not velocity.enable_forces:
            _reject("a LBMComputeForces compute requires "
                    "enable_forces = true on the velocity")
        if forces.enable_buoyancy:
            if not two_lattice:
                _reject("buoyancy forces need the thermal (second) lattice")
            if forces.temperature != t_density.out:
                _reject("the buoyancy temperature must be the second "
                        "lattice's zeroth moment")
        if forces.enable_gravity and forces.rho != density.out:
            _reject("the gravity force must consume the chain's density")
        d = int(forces.gravity_direction)
        if d >= dom.dim:
            _reject(f"gravity_direction {d} does not exist in {dom.dim}-D")
        apply_tau = 0.0
        if apply_f is not None:
            if apply_f.out != fpc_name:
                _reject("LBMApplyForces must write the fluid post-collision "
                        "buffer")
            if apply_f.rho != density.out or apply_f.forces != forces.out:
                _reject("LBMApplyForces must consume the chain's density "
                        "and force field")
            apply_tau = float(apply_f.tau)
        force_spec = ForceSpec(
            gravity=bool(forces.enable_gravity),
            buoyancy=bool(forces.enable_buoyancy),
            g=float(forces.g), rho0=float(forces.rho0),
            T0=float(forces.T0), direction=d, apply_tau=apply_tau,
        )
    elif apply_f is not None:
        _reject("LBMApplyForces requires a LBMComputeForces compute")

    if collision is None:
        # collisionless chain (reference mixed_bcs_* decks): LBMStream with
        # f_old = f — the carried state is the post-BC streamed distribution
        if two_lattice:
            _reject("two-lattice chains require a collision per lattice")
        if equilibrium is not None:
            _reject("an equilibrium compute without a collision would go "
                    "stale across fused substeps")
        if fpc_name != f_name:
            _reject("collisionless chains require f_old = the streamed "
                    "buffer itself")
    else:
        if equilibrium is None:
            _reject("the chain requires a LBMEquilibrium compute")
        if equilibrium.rho != density.out or equilibrium.velocity != velocity.out:
            _reject("equilibrium must consume the chain's density and velocity")
        if collision.f != f_name or collision.feq != equilibrium.out:
            _reject("collision must consume the streamed distribution and equilibrium")
        if collision.out != fpc_name:
            _reject("collision must write the solver's f_old buffer")
    smag = None
    if collision is not None and type(collision) is L.LBMSmagorinskyCollision:
        # the per-cell τ needs the GLOBAL mean density inside the substep;
        # the JAX package fuses it on 2-D decks only (the kernel's two
        # reduction passes would take any grid)
        if not two_d:
            _reject("Smagorinsky collisions fuse on 2-D decks only (the "
                    "global mean density needs the single-block kernel)")
        smag = (float(collision.C_s), float(collision.tau_0))
    if two_lattice:
        if equilibrium2 is None or collision2 is None:
            _reject("the second lattice requires its own equilibrium and "
                    "collision computes")
        if type(collision2) is L.LBMSmagorinskyCollision:
            _reject("Smagorinsky collisions fuse on the fluid lattice only")
        if equilibrium2.velocity != velocity.out:
            _reject("the thermal equilibrium must advect at the fluid "
                    "velocity")
        if collision2.f != g_name or collision2.feq != equilibrium2.out:
            _reject("the thermal collision must consume the second "
                    "lattice's distribution and equilibrium")
        if collision2.out != gpc_name:
            _reject("the thermal collision must write the solver's second "
                    "f_old buffer")

    if speed is not None and speed.velocity != velocity.out:
        _reject("velocity magnitude must consume the chain's velocity")
    # the carried scalar: the residual field (velocity magnitude, or on
    # thermal decks the second lattice's zeroth moment)
    speed_kind = "none"
    speed_buffer = None
    if residual is not None:
        if speed is not None and residual.speed == speed.out:
            speed_kind, speed_buffer = "umag", speed.out
        elif two_lattice and residual.speed == t_density.out:
            speed_kind, speed_buffer = "t", t_density.out
        else:
            _reject("the residual must consume the chain's velocity "
                    "magnitude or the thermal lattice's zeroth moment")
    elif speed is not None:
        speed_kind, speed_buffer = "umag", speed.out

    def msm_of(coll):
        if type(coll) is not L.LBMMRTCollision:
            return None
        return tuple(tuple(float(x) for x in row)
                     for row in mrt_matrix(st, coll.tau_0))

    bf = velocity.body_force if velocity.add_body_force else [0.0, 0.0, 0.0]
    nx, ny, nz = (list(dom.shape) + [1, 1])[:3]
    cfg = FusedLBMConfig(
        q=int(st.q),
        e=tuple((int(st.ex[i]), int(st.ey[i]), int(st.ez[i])) for i in range(st.q)),
        w=tuple(float(w) for w in st.weights),
        op=tuple(int(o) for o in st.op),
        nx=int(nx), ny=int(ny), nz=int(nz),
        tau=float(collision.tau_0) if collision is not None else 1.0,
        body_force=(float(bf[0]), float(bf[1]), float(bf[2])),
        faces=tuple(faces_by[f_name]),
        has_media=has_media,
        msm=msm_of(collision),
        post_bcs=tuple(post_by[f_name]),
        collide=collision is not None,
        need_moments=(collision is not None or speed_kind != "none"
                      or two_lattice),
        two_lattice=two_lattice,
        tau2=float(collision2.tau_0) if collision2 is not None else 1.0,
        msm2=msm_of(collision2) if two_lattice else None,
        faces2=tuple(faces_by[g_name]) if two_lattice else (),
        post_bcs2=tuple(post_by[g_name]) if two_lattice else (),
        force=force_spec,
        speed_kind=speed_kind,
        proj=bool(collision is not None and collision.projection),
        proj2=bool(collision2 is not None and collision2.projection),
        two_d=two_d,
        smag=smag,
    )
    old_keys = set()
    for c in [solver] + list(problem.bc_computes) + list(problem.solve_computes):
        old_keys |= set(getattr(c, "history_requests", dict)())
    allowed = {fpc_name, gpc_name, speed_buffer} - {None}
    if not old_keys <= allowed:
        _reject(f"unsupported old-state history on {sorted(old_keys)}")
    return FusedLBMPlan(
        config=cfg,
        fpc=fpc_name,
        speed=speed_buffer,
        fpc2=gpc_name,
    )


# ---------------------------------------------------------------------------
# the plain twin: the kernel's decomposition in torch ops
# ---------------------------------------------------------------------------


def _face_masks(cfg: FusedLBMConfig, device) -> Dict[Tuple[int, int], torch.Tensor]:
    """(axis, side) -> a bool tensor broadcastable to (nx, ny, nz), true on
    that face."""
    masks = {}
    keys = ([(a, s) for a, s, _d in cfg.faces + cfg.faces2]
            + [(bc.axis, bc.side) for bc in cfg.post_bcs + cfg.post_bcs2])
    dims = (cfg.nx, cfg.ny, cfg.nz)
    for axis, side in keys:
        if axis < 0 or (axis, side) in masks:
            continue
        view = [1, 1, 1]
        view[axis] = dims[axis]
        io = torch.arange(dims[axis], device=device).reshape(view)
        masks[(axis, side)] = io == (0 if side == 0 else dims[axis] - 1)
    return masks


def _streamed_lattice(src: torch.Tensor, media: Optional[torch.Tensor],
                      cfg: FusedLBMConfig, faces, post_bcs):
    """One lattice's q streamed planes (nx, ny, nz) after its bounce-back
    and post-stream faces, in the kernel's order (pallas_lbm.py:_make_kernel
    ``streamed`` and ``apply_post``)."""
    q = cfg.q
    zero = torch.zeros((), dtype=src.dtype, device=src.device)
    masks = _face_masks(cfg, src.device)
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
        a = torch.roll(src[qi], e, (0, 1, 2))
        for axis, side, dirs in faces:
            if axis < 0:
                # obstacle bounce-back: fluid cells whose upstream
                # neighbor along e is solid
                if qi != 0:
                    m_up = torch.roll(media, e, (0, 1, 2))
                    a = torch.where((m_up == 0) & fluid, src[cfg.op[qi]], a)
            elif qi in dirs:
                # face bounce-back: the OPPOSITE direction of the unstreamed
                # old distribution at the same node
                a = torch.where(masks[(axis, side)], src[cfg.op[qi]], a)
        if cfg.has_media:
            a = torch.where(solid, zero, a)
        return a

    fs = [streamed(qi) for qi in range(q)]
    for bc in post_bcs:
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
            a = None
            if bc.perturb_value:
                a = perturb_profile(bc, cfg.ny, src.dtype, src.device).reshape(1, cfg.ny, 1)
            for d, val in apply_zouhe(bc, prev, a).items():
                put(d, val)
    return fs


def density_mean_twin(fpc_qm: torch.Tensor, media: Optional[torch.Tensor],
                      cfg: FusedLBMConfig) -> torch.Tensor:
    """The mean over the grid of the streamed density Σ_q f (solids, at
    zero, included) as a 0-d tensor, by ``tree_mean``: what the Smagorinsky
    τ of a fused substep reads."""
    return tree_mean(_direction_sum(_streamed_lattice(fpc_qm, media, cfg, cfg.faces,
                                                      cfg.post_bcs)))


def fused_substep_twin(fpc_qm: torch.Tensor, media: Optional[torch.Tensor],
                       cfg: FusedLBMConfig, gpc_qm: Optional[torch.Tensor] = None):
    """One lattice update in plain torch ops, in the kernel's order
    (pallas_lbm.py:_make_kernel); returns (fpc_new_qm, speed), or
    (fpc_new_qm, gpc_new_qm, speed) on two-lattice plans.  ``fpc_qm`` (and
    ``gpc_qm``) is (q, nx, ny, nz); ``media`` the (nx, ny, nz) media code,
    or None."""
    q = cfg.q
    zero = torch.zeros((), dtype=fpc_qm.dtype, device=fpc_qm.device)
    if cfg.has_media:
        solid = media == 0
    fs = _streamed_lattice(fpc_qm, media, cfg, cfg.faces, cfg.post_bcs)
    gs = _streamed_lattice(gpc_qm, media, cfg, cfg.faces2, cfg.post_bcs2) \
        if cfg.two_lattice else None

    # moments (reference LBMComputeDensity / LBMComputeVelocity)
    rho = _direction_sum(fs)
    # 2-D: the velocity has no z component, whatever the stencil
    dims = 2 if cfg.two_d else 3
    moments = [signed_sum([e[k] for e in cfg.e], fs) for k in range(dims)]
    temp = _direction_sum(gs) if cfg.two_lattice else None
    # the force field along its direction, zero at solids (reference
    # LBMComputeForces)
    forces = None
    if cfg.force is not None:
        fc = cfg.force
        fd = torch.zeros_like(rho)
        if fc.gravity:
            fd = fc.g * rho
        if fc.buoyancy:
            t = fc.g * fc.rho0 * (temp - fc.T0)
            fd = fd + t if fc.gravity else t
        if cfg.has_media:
            fd = torch.where(solid, zero, fd)
        forces = [torch.zeros_like(rho)] * 3
        forces[fc.direction] = fd
    # u = m / rho (+ F / (2 rho)) (+ the body force / (2 rho) where it is
    # non-zero); tensor divisions, as the eager chain's (a Python scalar
    # over a tensor would multiply by the tensor's reciprocal)
    vel = [m / rho for m in moments]
    if forces is not None:
        vel = [v + fc_ / (2.0 * rho) for v, fc_ in zip(vel, forces)]
    bf = torch.tensor(cfg.body_force, dtype=rho.dtype, device=rho.device)
    for i, force in enumerate(cfg.body_force[:dims]):
        if force != 0.0:
            vel[i] = vel[i] + bf[i] / (2.0 * rho)
    if cfg.two_d:
        vel.append(torch.zeros_like(rho))
    ux, uy, uz = vel
    if cfg.has_media:
        # solids carry rho = 0: zero the velocity as the masked chain does
        ux, uy, uz = (torch.where(solid, zero, c) for c in (ux, uy, uz))
    usqr = ux * ux + uy * uy + uz * uz
    if cfg.speed_kind == "umag":
        speed = torch.sqrt(usqr)
    elif cfg.speed_kind == "t":
        speed = temp
    else:
        speed = torch.zeros_like(rho)

    if not cfg.collide:
        # the collisionless chain carries the post-face streamed planes
        return torch.stack(fs), speed

    third = 0.5 * usqr * INV_CS2

    def equilibrium(qi, dens):
        """feq (reference LBMEquilibrium.C:42-66) for the bulk ``dens``."""
        edotu = signed_sum(cfg.e[qi], (ux, uy, uz))
        if edotu is None:
            return cfg.w[qi] * dens * (1.0 - third)
        second = edotu * INV_CS2 + 0.5 * edotu * edotu * INV_CS4
        return cfg.w[qi] * dens * (1.0 + second - third)

    def collide(planes, dens, msm, tau, proj, source, smag=None):
        """BGK or MRT (with the Hermite projection first where asked), or
        BGK with the Smagorinsky τ a cell, the Guo source, solid masking."""
        inv_tau = 1.0 / tau
        feqs = [equilibrium(qi, dens) for qi in range(q)]
        if msm is None and not proj and smag is None:
            fneqs = None
        else:
            fneqs = [planes[qi] - feqs[qi] for qi in range(q)]
            if proj:
                fneqs = hermite(fneqs, hermite_tables(cfg.e, cfg.w))
            if smag is not None:
                # the mean over the grid of Σ_q f, solids (zero) included
                inv_tau = smagorinsky_inv_tau(fneqs, cfg.e, tree_mean(rho), smag[0],
                                              smag[1], cfg.nz == 1)
        out = []
        for qi in range(q):
            if fneqs is None:
                fneq = planes[qi] - feqs[qi]
                u = feqs[qi] + fneq - fneq * inv_tau
            elif msm is None:
                u = feqs[qi] + fneqs[qi] - fneqs[qi] * inv_tau
            else:
                u = feqs[qi] + fneqs[qi] - mrt_relax(fneqs, msm, qi)
            if source is not None:
                edotf = signed_sum(cfg.e[qi], forces)
                if edotf is not None:
                    u = u + source[qi] * rho * edotf
            if cfg.has_media:
                u = torch.where(solid, zero, u)
            out.append(u)
        return torch.stack(out)

    guo = None
    if cfg.force is not None and cfg.force.apply_tau:
        guo = guo_prefactors(cfg.w, cfg.force.apply_tau)
    fpc_new = collide(fs, rho, cfg.msm, cfg.tau, cfg.proj, guo, cfg.smag)
    if not cfg.two_lattice:
        return fpc_new, speed
    return fpc_new, collide(gs, temp, cfg.msm2, cfg.tau2, cfg.proj2, None), speed


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/lbm_substep.cu)
# ---------------------------------------------------------------------------


class _Post(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int32), ("axis", ctypes.c_int32),
                ("side", ctypes.c_int32), ("sum1", ctypes.c_uint32),
                ("sum2", ctypes.c_uint32), ("rows", ctypes.c_uint32),
                ("tp", ctypes.c_int32), ("tm", ctypes.c_int32),
                ("perturb", ctypes.c_int32),
                ("a", ctypes.c_double), ("b", ctypes.c_double),
                ("cm", ctypes.c_double * MAX_Q), ("tc", ctypes.c_double * MAX_Q)]


class _Faces(ctypes.Structure):
    _fields_ = [("n_faces", ctypes.c_int32),
                ("face_axis", ctypes.c_int32 * MAX_FACES),
                ("face_side", ctypes.c_int32 * MAX_FACES),
                ("face_dirs", ctypes.c_uint32 * MAX_FACES),
                ("n_post", ctypes.c_int32), ("post", _Post * MAX_POST)]


def _coef(ct):
    class _Coef(ctypes.Structure):
        _fields_ = [("w", ct * MAX_Q), ("inv_tau", ct * 2), ("bf", ct * 3),
                    ("inv_cs2", ct), ("inv_cs4", ct), ("g", ct), ("g_rho0", ct),
                    ("t0", ct), ("cs2", ct), ("smag_eta", ct), ("smag_eta2", ct),
                    ("smag_inv_2tsgs", ct), ("smag_c", ct), ("smag_tau0", ct),
                    ("guo", ct * MAX_Q), ("hpref", ct * MAX_Q),
                    ("h2", ct * (MAX_Q * 9)), ("msm", ct * (2 * MAX_Q * MAX_Q))]
    return _Coef


class _Brick(ctypes.Structure):
    _fields_ = [("by", ctypes.c_int32), ("stages", ctypes.c_int32),
                ("threads", ctypes.c_int32), ("smem", ctypes.c_int32)]


class _Plan(ctypes.Structure):
    """csrc/lbm_substep.cuh ``LbmPlan``, field for field."""

    _fields_ = [("nx", ctypes.c_int64), ("ny", ctypes.c_int64),
                ("nz", ctypes.c_int64), ("two_lattice", ctypes.c_int32),
                ("collide", ctypes.c_int32), ("speed", ctypes.c_int32),
                ("force", ctypes.c_int32), ("gravity", ctypes.c_int32),
                ("buoyancy", ctypes.c_int32), ("force_dir", ctypes.c_int32),
                ("guo", ctypes.c_int32), ("mrt", ctypes.c_int32 * 2),
                ("proj", ctypes.c_int32 * 2), ("bf_on", ctypes.c_int32 * 3),
                ("two_d", ctypes.c_int32), ("smag", ctypes.c_int32),
                ("brick", _Brick), ("lat", _Faces * 2), ("d", _coef(ctypes.c_double)),
                ("f", _coef(ctypes.c_float))]


LIBRARY = uf.CudaLibrary("lbm_substep", {
    # fpc, gpc (or null), media (or null), the perturbed inlets' a(y) rows
    # (or null), the mean density (or null), fpc_new, gpc_new (or null),
    # speed; q, double?; the host plan; stream
    "mtt_lbm_substep": [uf._P] * 8 + [ctypes.c_int] * 2 + [uf._P, uf._P],
    # fpc, media (or null), a(y) rows (or null), partial sums, mean out; q,
    # double?, 1/(nx·ny·nz); the host plan; stream
    "mtt_lbm_density_mean": [uf._P] * 5 + [ctypes.c_int] * 2
                            + [ctypes.c_double, uf._P, uf._P],
    # q; the compiled-in e (q·3) and op (q) tables out
    "mtt_lbm_tables": [ctypes.c_int, uf._P, uf._P],
    # the plan's size and field offsets out (int64[8])
    "mtt_lbm_plan_layout": [uf._P],
}, source=os.path.join(uf.CSRC, "lbm_substep.cu"),
    # no contraction (the eager chain's bits); the register report; the 24
    # substep instantiations optimized on every core (-split-compile=0; a
    # third of the single-threaded build time, PERF.md)
    flags=["-fmad=false", "-Xptxas=-v", "-split-compile=0"])

_SPEED_KIND = {"none": 0, "umag": 1, "t": 2}
DENSITY_BLOCK = 256  # csrc/lbm_substep.cu LBM_DENSITY_BLOCK: cells a partial sum


def _mask(dirs) -> int:
    m = 0
    for d in dirs:
        m |= 1 << int(d)
    return m


def _perturbed(cfg: FusedLBMConfig):
    """The perturbed Zou-He faces of both lattices, in the order of their
    rows in the kernel's a(y) table."""
    return [bc for bc in cfg.post_bcs + cfg.post_bcs2 if bc.perturb_value]


def _pack_faces(lat: _Faces, cfg: FusedLBMConfig, faces, post_bcs, perturbed):
    if len(faces) > MAX_FACES or len(post_bcs) > MAX_POST:
        raise FusedChainError(
            f"lbm_backend = PALLAS: the kernel takes at most {MAX_FACES} "
            f"bounce-back and {MAX_POST} post-stream boundary conditions "
            f"a lattice")
    lat.n_faces, lat.n_post = len(faces), len(post_bcs)
    for i, (axis, side, dirs) in enumerate(faces):
        lat.face_axis[i], lat.face_side[i], lat.face_dirs[i] = axis, side, _mask(dirs)
    for i, bc in enumerate(post_bcs):
        post = lat.post[i]
        post.kind, post.axis, post.side = int(bc.kind == "zg"), bc.axis, bc.side
        post.a, post.b = bc.a, bc.b
        post.tp = post.tm = post.perturb = -1
        if bc.perturb_value:
            post.perturb = next(k for k, p in enumerate(perturbed) if p is bc)
        # the kernel sums sum1, then 2·sum2, each in ascending direction
        # order (as apply_zouhe), and reads each row's source at op[d] (as
        # _zouhe_spec sets) and its transverse pair at (tp, tm)
        post.sum1, post.sum2 = _mask(bc.sum1), _mask(bc.sum2)
        for d, src, cm, tc, tp, tm in bc.rows:
            if src != cfg.op[d] or post.rows >> d & 1 or \
                    (tc and post.tp >= 0 and (tp, tm) != (post.tp, post.tm)):
                raise FusedChainError(
                    "lbm_backend = PALLAS: a Zou-He row the kernel does not "
                    "take (a source other than op[d], a direction twice, or "
                    "two transverse pairs on one face)")
            post.rows |= 1 << d
            post.cm[d] = cm
            if tc:
                post.tc[d] = tc
                post.tp, post.tm = tp, tm


@dataclass(frozen=True)
class BrickPlan:
    """The brick walk of a 3-D plan (csrc/lbm_substep.cuh ``LbmBrick``): a
    brick is one x-plane, ``by`` rows of y and every z; a block of
    ``threads`` threads (a producer warp and the consumer warps that update
    the cells) holds ``stages`` bricks in flight in ``smem`` bytes of
    shared memory."""

    by: int
    stages: int
    threads: int
    smem: int


SMEM_BLOCK = 232448  # 227 KB: the shared memory a block may have on an H100
STAGE_BYTES = 20 * 1024  # a brick's stage aims at this size (lbm_probe.py)


def brick_threads(cfg: FusedLBMConfig) -> int:
    """The most threads a brick block of ``cfg`` runs (csrc/lbm_substep.cuh
    ``kBrickThreads``): a producer warp and eight consumer warps on one
    lattice's D3Q19 plans, four on D3Q27 and two-lattice plans."""
    return 160 if cfg.two_lattice or cfg.q == 27 else 288


def brick_stages(cfg: FusedLBMConfig) -> int:
    """Bricks in flight a block: three on one lattice's D3Q19 plans, two on
    D3Q27 and on two-lattice MRT plans, one on two-lattice BGK plans, whose
    three blocks an SM then fit its shared memory (lbm_probe.py)."""
    if cfg.two_lattice:
        return 2 if cfg.msm is not None or cfg.msm2 is not None else 1
    return 2 if cfg.q == 27 else 3


def brick_layout(cfg: FusedLBMConfig, itemsize: int, by: int, stages: int) -> int:
    """Shared memory a block of the brick kernel takes (csrc/lbm_substep.cuh
    ``brick_layout``): each stage holds [lattice][q][by][nz] values and, on
    media plans, [3][by + 2][nz] media bytes, rounded up to 16 bytes; then
    two 8-byte mbarriers a stage; then, on MRT plans, each lattice's q x q
    MRT matrix, its rows padded to 16 bytes."""
    lattices = 2 if cfg.two_lattice else 1
    stage = lattices * cfg.q * by * cfg.nz * itemsize
    if cfg.has_media:
        stage += 3 * (by + 2) * cfg.nz
    stage = -(-stage // 16) * 16
    mrt = cfg.msm is not None or (cfg.two_lattice and cfg.msm2 is not None)
    row = -(-cfg.q * itemsize // 16) * 16
    return stages * stage + 16 * stages + (lattices * cfg.q * row if mrt else 0)


def brick_plan(cfg: FusedLBMConfig, dtype, stage_bytes: int = STAGE_BYTES,
               stages: Optional[int] = None, threads: Optional[int] = None
               ) -> Optional[BrickPlan]:
    """The brick walk of the kernel for ``cfg`` in ``dtype``, or None where
    the flat kernel runs: 2-D plans, rows (of the distribution, and of the
    media on media plans) that are not a multiple of 16 bytes, as the bulk
    copies need, and a stage that does not fit a block.  ``by`` is the most
    rows whose stage stays within ``stage_bytes`` (at least one, at most
    ny); ``stages`` is ``brick_stages`` by default, and fewer where they
    do not fit a block; ``threads`` (at most ``brick_threads``, the
    default) is cut to no more consumer warps than the brick has cells.
    The defaults are the probe's choice at 256³."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if cfg.nz == 1 or (cfg.nz * itemsize) % 16 or (cfg.has_media and cfg.nz % 16):
        return None
    lattices = 2 if cfg.two_lattice else 1
    by = max(1, min(cfg.ny, stage_bytes // (lattices * cfg.q * cfg.nz * itemsize)))
    stages = stages or brick_stages(cfg)
    while stages > 1 and brick_layout(cfg, itemsize, by, stages) > SMEM_BLOCK:
        stages -= 1
    smem = brick_layout(cfg, itemsize, by, stages)
    if smem > SMEM_BLOCK:
        return None
    threads = min(threads or brick_threads(cfg), brick_threads(cfg))
    threads = 32 + min(threads - 32, -(-by * cfg.nz // 32) * 32)
    return BrickPlan(by=by, stages=stages, threads=threads, smem=smem)


def pack(cfg: FusedLBMConfig, brick: Optional[BrickPlan] = None) -> _Plan:
    """The kernel's plan struct for ``cfg`` (with the brick walk ``brick``,
    or none: the flat kernel); raises for what the kernel does not take."""
    q = cfg.q
    fc = cfg.force
    p = _Plan(nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, two_lattice=int(cfg.two_lattice),
              collide=int(cfg.collide), speed=_SPEED_KIND[cfg.speed_kind],
              force=int(fc is not None),
              gravity=int(fc is not None and fc.gravity),
              buoyancy=int(fc is not None and fc.buoyancy),
              force_dir=fc.direction if fc is not None else 0,
              guo=int(fc is not None and bool(fc.apply_tau)),
              two_d=int(cfg.two_d), smag=int(cfg.smag is not None))
    if brick is not None:
        p.brick.by, p.brick.stages = brick.by, brick.stages
        p.brick.threads, p.brick.smem = brick.threads, brick.smem
    p.mrt[:] = [int(cfg.msm is not None), int(cfg.msm2 is not None)]
    p.proj[:] = [int(cfg.proj), int(cfg.proj2)]
    # 2-D: the velocity has no z component, so no z body force either
    p.bf_on[:] = [int(b != 0.0 and not (cfg.two_d and i == 2))
                  for i, b in enumerate(cfg.body_force)]
    perturbed = _perturbed(cfg)
    _pack_faces(p.lat[0], cfg, cfg.faces, cfg.post_bcs, perturbed)
    _pack_faces(p.lat[1], cfg, cfg.faces2, cfg.post_bcs2, perturbed)
    _ccr, h2, hpref = hermite_tables(cfg.e, cfg.w)
    # each table in double and rounded to float: the constants the eager
    # chain multiplies by, as a Python float (double) or cast to float32
    for t in (p.d, p.f):
        t.w[:q] = cfg.w
        t.inv_tau[:] = [1.0 / cfg.tau, 1.0 / cfg.tau2]
        t.bf[:] = cfg.body_force
        t.inv_cs2, t.inv_cs4, t.cs2 = INV_CS2, INV_CS4, LATTICE_CS2
        if fc is not None:
            t.g, t.g_rho0, t.t0 = fc.g, fc.g * fc.rho0, fc.T0
            if fc.apply_tau:
                t.guo[:q] = guo_prefactors(cfg.w, fc.apply_tau)
        if cfg.smag is not None:
            k = smagorinsky_constants(*cfg.smag)
            t.smag_eta, t.smag_eta2 = k["eta"], k["eta2"]
            t.smag_inv_2tsgs, t.smag_c = k["inv_2tsgs"], k["cs_over_cs2"]
            t.smag_tau0 = cfg.smag[1]
        t.hpref[:q] = hpref
        t.h2[:q * 9] = [float(x) for x in h2.reshape(-1)]
        for lat, msm in enumerate((cfg.msm, cfg.msm2)):
            if msm is not None:
                base = lat * MAX_Q * MAX_Q
                t.msm[base:base + q * q] = [x for row in msm for x in row]
    return p


_CHECKED_TABLES = set()


def _check_tables(cfg: FusedLBMConfig):
    """The kernel compiles each stencil's e and op in (so every direction
    index is static): hold them to the plan's once per stencil, and the
    plan's ctypes mirror to the kernel's struct once."""
    key = (cfg.q, cfg.e, cfg.op)
    if key in _CHECKED_TABLES:
        return
    if cfg.q not in (9, 19, 27):
        raise FusedChainError(f"lbm_backend = PALLAS: the kernel takes q = 9, 19 "
                              f"or 27 (got {cfg.q})")
    lib = LIBRARY.load()
    layout = np.zeros(8, np.int64)
    lib.mtt_lbm_plan_layout(layout.ctypes.data)
    coef_d, coef_f = _Plan.d.offset, _Plan.f.offset
    ours = [ctypes.sizeof(_Plan), _Plan.lat.offset,
            _Plan.lat.offset + ctypes.sizeof(_Faces), coef_d,
            coef_d + type(_Plan().d).msm.offset, coef_f,
            coef_f + type(_Plan().f).msm.offset, _Plan.brick.offset]
    if layout.tolist() != ours:
        raise RuntimeError(f"lbm_substep: the ctypes plan {ours} differs from "
                           f"csrc/lbm_substep.cu's LbmPlan {layout.tolist()}")
    e = np.zeros((cfg.q, 3), np.int32)
    op = np.zeros(cfg.q, np.int32)
    err = lib.mtt_lbm_tables(cfg.q, e.ctypes.data, op.ctypes.data)
    if err != 0 or [tuple(r) for r in e.tolist()] != list(cfg.e) or \
            tuple(op.tolist()) != cfg.op:
        raise FusedChainError(f"lbm_backend = PALLAS: the D{2 if cfg.q == 9 else 3}"
                              f"Q{cfg.q} tables compiled into csrc/lbm_substep.cu "
                              "differ from the stencil's")
    _CHECKED_TABLES.add(key)


def _check_inputs(fpc_qm, media, cfg: FusedLBMConfig, what):
    shape = (cfg.q, cfg.nx, cfg.ny, cfg.nz)
    if tuple(fpc_qm.shape) != shape:
        raise ValueError(f"{what}: fpc shape {tuple(fpc_qm.shape)}, plan {shape}")
    if fpc_qm.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {fpc_qm.dtype} (float32 or float64)")
    if cfg.has_media != (media is not None):
        raise ValueError(f"{what}: media must be given exactly when the plan "
                         "has binary media")
    if media is not None and (tuple(media.shape) != shape[1:]
                              or media.dtype != torch.int8
                              or media.device != fpc_qm.device):
        raise TypeError(f"{what}: media must be the (nx, ny, nz) int8 media code "
                        "on the distribution's device")


def _kernel_args(fpc_qm, media, cfg: FusedLBMConfig, gpc_qm, what):
    """Contiguity, then the packed plan (with ``brick_plan``'s walk) and the
    perturbed inlets' a(y) rows (one (n, ny) tensor, or None) for a launch:
    built once per plan, dtype and device (packing takes ~0.1 ms of host
    time, longer than a 2-D launch at its shipped size)."""
    if not fpc_qm.is_contiguous() or (media is not None and not media.is_contiguous()) \
            or (gpc_qm is not None and not gpc_qm.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    key = (cfg, fpc_qm.dtype, fpc_qm.device)
    args = _KERNEL_ARGS.get(key)
    if args is None:
        _check_tables(cfg)
        perturbed = _perturbed(cfg)
        avec = None
        if perturbed:
            avec = torch.stack([perturb_profile(bc, cfg.ny, fpc_qm.dtype, fpc_qm.device)
                                for bc in perturbed]).contiguous()
        args = _KERNEL_ARGS[key] = (pack(cfg, brick_plan(cfg, fpc_qm.dtype)), avec)
    return args


_KERNEL_ARGS: Dict[tuple, tuple] = {}


def density_mean(fpc_qm: torch.Tensor, media: Optional[torch.Tensor],
                 cfg: FusedLBMConfig) -> torch.Tensor:
    """The mean over the grid of the streamed density (fluid lattice, after
    its faces), a 0-d tensor on the distribution's device: on a CUDA tensor
    two launches of csrc/lbm_substep.cu (a partial tree sum a block of
    DENSITY_BLOCK cells, then one block over the partials, both in
    ``tree_mean``'s pairs), with no host sync; on a CPU tensor
    ``density_mean_twin``.  Part of the port of pallas_lbm.py:224
    ``_make_kernel`` (the mean of its ``smag_inv_tau``, :687)."""
    _check_inputs(fpc_qm, media, cfg, "density_mean")
    if not uf._launch_kernel(fpc_qm, "density_mean"):
        return density_mean_twin(fpc_qm, media, cfg)
    plan, avec = _kernel_args(fpc_qm, media, cfg, None, "density_mean")
    cells = cfg.nx * cfg.ny * cfg.nz
    partial = torch.empty(-(-cells // DENSITY_BLOCK), dtype=fpc_qm.dtype,
                          device=fpc_qm.device)
    mean = torch.empty((), dtype=fpc_qm.dtype, device=fpc_qm.device)
    uf._launch(LIBRARY.load().mtt_lbm_density_mean, uf._ptr(fpc_qm), uf._ptr(media),
               uf._ptr(avec), uf._ptr(partial), uf._ptr(mean), cfg.q,
               int(fpc_qm.dtype == torch.float64), 1.0 / cells, ctypes.addressof(plan),
               device=fpc_qm.device, name="density_mean")
    density_mean.launches += 2
    return mean


def fused_substep(fpc_qm: torch.Tensor, media: Optional[torch.Tensor],
                  cfg: FusedLBMConfig, gpc_qm: Optional[torch.Tensor] = None):
    """One lattice update of the (q, nx, ny, nz) post-collision
    distribution (and on two-lattice plans the second lattice's,
    ``gpc_qm``); ``media`` is the (nx, ny, nz) int8 media code
    (TensorProblem.lbm_media) or None.  Returns (fpc_new_qm, speed), or
    (fpc_new_qm, gpc_new_qm, speed) on two-lattice plans.  A Smagorinsky
    plan first takes ``density_mean``.  Replaces pallas_lbm.py:224
    ``_make_kernel`` (via ``fused_substep``)."""
    _check_inputs(fpc_qm, media, cfg, "fused_substep")
    if cfg.two_lattice != (gpc_qm is not None):
        raise ValueError("fused_substep: gpc must be given exactly when the plan "
                         "has two lattices")
    if gpc_qm is not None and (gpc_qm.shape != fpc_qm.shape or gpc_qm.dtype != fpc_qm.dtype
                               or gpc_qm.device != fpc_qm.device):
        raise TypeError("fused_substep: gpc must match fpc's shape, dtype and device")
    if not uf._launch_kernel(fpc_qm, "fused_substep"):
        return fused_substep_twin(fpc_qm, media, cfg, gpc_qm)
    mean = density_mean(fpc_qm, media, cfg) if cfg.smag is not None else None
    plan, avec = _kernel_args(fpc_qm, media, cfg, gpc_qm, "fused_substep")
    got = launch_substep(fpc_qm, media, cfg, gpc_qm, plan, avec, mean)
    fused_substep.launches += 1
    return got


def launch_substep(fpc_qm, media, cfg: FusedLBMConfig, gpc_qm, plan: "_Plan", avec=None,
                   mean=None):
    """One launch of ``mtt_lbm_substep`` with a packed ``plan`` (its brick
    fields choose the brick or the flat kernel) on checked CUDA inputs;
    returns what ``fused_substep`` returns.  ``fused_substep`` is the entry
    point; ``lbm_probe`` calls this with a plan of its own."""
    out = torch.empty_like(fpc_qm)
    gout = torch.empty_like(gpc_qm) if gpc_qm is not None else None
    speed = torch.empty(fpc_qm.shape[1:], dtype=fpc_qm.dtype, device=fpc_qm.device)
    uf._launch(LIBRARY.load().mtt_lbm_substep, uf._ptr(fpc_qm), uf._ptr(gpc_qm),
               uf._ptr(media), uf._ptr(avec), uf._ptr(mean), uf._ptr(out),
               uf._ptr(gout), uf._ptr(speed), cfg.q, int(fpc_qm.dtype == torch.float64),
               ctypes.addressof(plan), device=fpc_qm.device, name="fused_substep")
    if gout is None:
        return out, speed
    return out, gout, speed


fused_substep.launches = 0
density_mean.launches = 0


def reset_launches():
    fused_substep.launches = 0
    density_mean.launches = 0


def launches() -> Dict[str, int]:
    return {"lbm_substep": fused_substep.launches,
            "lbm_density_mean": density_mean.launches}
