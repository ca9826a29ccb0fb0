"""Fused semi-implicit spectral substep (Cahn-Hilliard class): the port of
marlin_tpu/pallas_spectral.py.

With ``[TensorSolver] carry_reciprocal = true`` and ``fused_spectral =
true`` under ``[Domain] fft_backend = PALLAS``, every substep but the last
of a step runs as five kernel passes (``ch_substep``):

1. µ = f′(c) evaluated in the first forward-axis kernel's read
   (``unordered_fft.fwd_lanes_pre``), so µ never reaches memory;
2. the middle forward axes (``fwd_sublanes``);
3. the last forward axis (x) of µ̄ fused with the whole ABM update in its
   epilogue (``fwd_x_update``, kernel 5): M̄ and L̄ are rebuilt in registers
   from two 1-D tables of permuted |k|², and the kernel writes ū′ and the
   new N̄;
4. the inverse transform of ū′ (two sublanes and one lanes pass).

The N-field chain (the benchmark-2a shape: coupled Cahn-Hilliard and
Allen-Cahn fields) evaluates its µ stack as one torch pointwise stage, as
the JAX package does, and runs every field through one launch of
``fwd_x_update_poly`` (kernel 6), whose M̄ and L̄ are polynomials in k² read
per field.  ū and N̄ are carried between substeps as contiguous complex64
(nx, L) tensors; the fused path is float32 whatever the deck's precision.

``match_chain`` pattern-matches the deck's chain and raises
``SpectralChainError`` naming what it cannot fuse, word for word as the
JAX package does.  The slab-sharded substeps of the JAX package wait for
the port's distributed modes; ``[Domain] parallel_mode`` other than NONE is
a named error of the port's Domain.

``fwd_x_update`` and ``fwd_x_update_poly`` launch the CUDA kernels of
``csrc/spectral_update.cu`` on a CUDA tensor and compute their plain twins
(``*_plain``: ``fwd_sublanes_plain`` along axis 0, then the update in torch
ops in the TPU kernel's order) on a CPU tensor; a CUDA tensor never
reaches a twin.  Each wrapper counts its launches.
"""

from __future__ import annotations

import ctypes
import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import unordered_fft as uf

MAX_FIELDS = 16  # csrc/spectral_update.cu kMaxFields

LIBRARY = uf.CudaLibrary("spectral_update", {
    # 8 pointers; n, L, b; the L̄ form and mobility flags; dt, β0, β1, two
    # L̄ constants, mobility; the stream
    "mtt_fwd_x_update": ([uf._P] * 8 + [uf._I] * 3 + [ctypes.c_int] * 2
                         + [ctypes.c_float] * 6 + [uf._P]),
    # 8 pointers; N, n, L, b; the host rows; the stream
    "mtt_fwd_x_update_poly": [uf._P] * 8 + [uf._I] * 4 + [uf._P, uf._P],
}, source=os.path.join(uf.CSRC, "spectral_update.cu"), flags=["-Xptxas=-v"])


class SpectralChainError(Exception):
    """The deck's solve chain does not match the fused-substep pattern."""


@dataclass
class SpectralPlan:
    pre: uf.Pointwise  # µ = f′(u), fused into the first kernel's read
    mobility: Optional[float]  # M̄ = -k² · mobility; None → N̄ = µ̄ directly
    # L̄ rebuilt in registers: ("lapsq", κ) → k⁴·κ
    # (ReciprocalLaplacianSquareFactor) or ("sh", r, α) → r − α²(1−k²)²
    # (SwiftHohenbergLinear)
    lin: tuple
    buffer: str  # u
    reciprocal: str  # ū
    nonlinear: str  # N̄
    linear: str  # L̄ buffer name (rebuilt in the kernel)
    mu: str  # µ buffer name
    mubar: str  # µ̄ buffer name
    shape: tuple
    kx2: torch.Tensor  # (nx,) permuted kx², float32
    kyz2: torch.Tensor  # (ny·nz,) permuted ky²+kz² flattened, float32


@dataclass
class SpectralPlanMulti:
    """N-field plan: M̄_i = m0 + m1·k² and L̄_i = la0 + la1·k² + la2·k⁴,
    rebuilt in registers from the rows of ``coef``
    (pallas_spectral.SpectralPlanMulti)."""

    mu_stack: Callable  # (N,)+shape real stack -> (N,)+shape µ stack
    coef: np.ndarray  # (N, 5) float32 rows [m0, m1, la0, la1, la2]
    buffers: list
    reciprocals: list
    nonlinears: list
    mus: list
    mubars: list
    shape: tuple
    kx2: torch.Tensor
    kyz2: torch.Tensor


def _reject(msg):
    raise SpectralChainError(
        f"fused_spectral = true: {msg} (drop the flag for the general path)"
    )


# ---------------------------------------------------------------------------
# kernels 5 and 6: the last forward axis fused with the ABM update
# ---------------------------------------------------------------------------


def _f32(v) -> float:
    return float(np.float32(v))


def _update(m, ubar, n_old, dt, b0, b1, lb, mb):
    """The TPU kernel's update in its order: N̄ = M̄·µ̄ (µ̄ itself when
    ``mb`` is None), den = 1/(1 − dt·L̄), ū′ = (ū + dt(β0 N̄ + β1 N̄_old))·den."""
    nn = m if mb is None else mb * m
    acc = b0 * nn + b1 * n_old
    den = 1.0 / (1.0 - dt * lb)
    return (ubar + dt * acc) * den, nn


def fwd_x_update_plain(mubar, ubar, n_old, kx2, kyz2, dt, b0, b1,
                       mobility, lin) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of ``fwd_x_update``: ``fwd_sublanes_plain`` along axis 0 of the
    (n, L) µ̄ tile, then the update in torch ops."""
    n, L = mubar.shape
    m = uf.fwd_sublanes_plain(mubar.reshape(1, n, L)).reshape(n, L)
    k2 = kx2.reshape(n, 1) + kyz2.reshape(1, L)
    if lin[0] == "lapsq":
        lb = (k2 * k2) * _f32(lin[1])
    else:
        om = 1.0 - k2
        lb = _f32(lin[1]) - _f32(lin[2] * lin[2]) * (om * om)
    mb = None if mobility is None else -k2 * _f32(mobility)
    return _update(m, ubar, n_old, _f32(dt), _f32(b0), _f32(b1), lb, mb)


def fwd_x_update_poly_plain(mubar, ubar, n_old, kx2, kyz2, rows):
    """Twin of ``fwd_x_update_poly``: per field f, the row [dt, β0, β1, m0,
    m1, la0, la1, la2] gives M̄ = m0 + m1·k² and L̄ = la0 + la1·k² + la2·k⁴."""
    N, n, L = mubar.shape
    m = uf.fwd_sublanes_plain(mubar)
    k2 = kx2.reshape(n, 1) + kyz2.reshape(1, L)
    us, ns = [], []
    for f in range(N):
        dt, b0, b1, m0, m1, la0, la1, la2 = (float(v) for v in
                                             np.asarray(rows[f], np.float32))
        lb = la0 + la1 * k2 + la2 * (k2 * k2)
        mb = m0 + m1 * k2
        u, nn = _update(m[f], ubar[f], n_old[f], dt, b0, b1, lb, mb)
        us.append(u)
        ns.append(nn)
    return torch.stack(us), torch.stack(ns)


def _check_update(what, mubar, ubar, n_old, kx2, kyz2):
    n, L = mubar.shape[-2:]
    if not uf.supported(n):
        raise ValueError(f"{what}: extent {n} does not factor as "
                         f"{uf.SUPPORTED_RULE}")
    for name, t in (("mubar", mubar), ("ubar", ubar), ("n_old", n_old)):
        if t.dtype != torch.complex64 or tuple(t.shape) != tuple(mubar.shape):
            raise TypeError(f"{what}: {name} must be complex64 of shape "
                            f"{tuple(mubar.shape)} (got {t.dtype} "
                            f"{tuple(t.shape)})")
        if not t.is_contiguous() or t.device != mubar.device:
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{mubar.device}")
    for name, t, size in (("kx2", kx2, n), ("kyz2", kyz2, L)):
        if (t.dtype != torch.float32 or t.numel() != size
                or not t.is_contiguous() or t.device != mubar.device):
            raise TypeError(f"{what}: {name} must be a contiguous float32 "
                            f"table of {size} entries on {mubar.device}")


def fwd_x_update(mubar, ubar, n_old, kx2, kyz2, dt, b0, b1, mobility, lin):
    """Forward along axis 0 of the (n, L) complex64 µ̄ tile fused with the
    ABM update; returns (ū′, N̄).  kx2 (n,) and kyz2 (L,) are the permuted
    |k|² tables; ``mobility`` None means N̄ = µ̄; ``lin`` is ("lapsq", κ) or
    ("sh", r, α).  Replaces pallas_spectral._fwd_x_update_kernel."""
    _check_update("fwd_x_update", mubar, ubar, n_old, kx2, kyz2)
    if not uf._launch_kernel(mubar, "fwd_x_update"):
        return fwd_x_update_plain(mubar, ubar, n_old, kx2, kyz2, dt, b0, b1,
                                  mobility, lin)
    n, L = mubar.shape
    u_out = torch.empty_like(mubar)
    n_out = torch.empty_like(mubar)
    sh = lin[0] == "sh"
    # sh: r and α² (α² rounded once, as the TPU kernel's Python constant)
    lin0, lin1 = (lin[1], lin[2] * lin[2]) if sh else (lin[1], 0.0)
    uf._launch(LIBRARY.load().mtt_fwd_x_update, uf._ptr(mubar), uf._ptr(ubar),
               uf._ptr(n_old), uf._ptr(u_out), uf._ptr(n_out), uf._ptr(kx2),
               uf._ptr(kyz2), uf._ptr(uf._table(n, False, mubar.device)),
               n, L, uf.base(n), int(sh), int(mobility is not None),
               dt, b0, b1, lin0, lin1,
               0.0 if mobility is None else mobility,
               device=mubar.device, name="fwd_x_update")
    fwd_x_update.launches += 1
    return u_out, n_out


def fwd_x_update_poly(mubar, ubar, n_old, kx2, kyz2, rows):
    """N-field ``fwd_x_update`` over (N, n, L) complex64 stacks, all fields
    in one launch; ``rows`` (N, 8) holds each field's [dt, β0, β1, m0, m1,
    la0, la1, la2].  Replaces pallas_spectral._fwd_x_update_kernel_poly."""
    _check_update("fwd_x_update_poly", mubar, ubar, n_old, kx2, kyz2)
    N, n, L = mubar.shape
    rows = np.ascontiguousarray(rows, dtype=np.float32).reshape(-1, 8)
    if rows.shape[0] != N or not 1 <= N <= MAX_FIELDS:
        raise ValueError(f"fwd_x_update_poly: {rows.shape[0]} rows for {N} "
                         f"fields (1 to {MAX_FIELDS})")
    if not uf._launch_kernel(mubar, "fwd_x_update_poly"):
        return fwd_x_update_poly_plain(mubar, ubar, n_old, kx2, kyz2, rows)
    u_out = torch.empty_like(mubar)
    n_out = torch.empty_like(mubar)
    uf._launch(LIBRARY.load().mtt_fwd_x_update_poly, uf._ptr(mubar),
               uf._ptr(ubar), uf._ptr(n_old), uf._ptr(u_out), uf._ptr(n_out),
               uf._ptr(kx2), uf._ptr(kyz2),
               uf._ptr(uf._table(n, False, mubar.device)),
               N, n, L, uf.base(n), rows.ctypes.data,
               device=mubar.device, name="fwd_x_update_poly")
    fwd_x_update_poly.launches += 1
    return u_out, n_out


WRAPPERS = (fwd_x_update, fwd_x_update_poly)
for _w in WRAPPERS:
    _w.launches = 0


def reset_launches():
    for w in WRAPPERS:
        w.launches = 0


def launches() -> Dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


# ---------------------------------------------------------------------------
# the fused substeps
# ---------------------------------------------------------------------------


def ch_substep(c, ubar, n_old, sub_dt, b0, b1, plan: SpectralPlan):
    """One fused predictor substep (pallas_spectral.ch_substep).

    c: the float32 field; ubar, n_old: (nx, L) complex64 ū and old N̄; the
    update weights are Python floats.  Returns (c′, ū′, N̄)."""
    shape = plan.shape
    nx, L = shape[0], math.prod(shape[1:])
    mubar = uf.fftn_unordered(c, pre=plan.pre, skip_axis0=True).reshape(nx, L)
    u_new, n_new = fwd_x_update(mubar, ubar, n_old, plan.kx2, plan.kyz2,
                                sub_dt, b0, b1, plan.mobility, plan.lin)
    return uf.ifftn_unordered(u_new, shape), u_new, n_new


def ch_substep_multi(u, ubar, n_old, sub_dt, b0, b1, plan: SpectralPlanMulti):
    """One fused predictor substep over the N-field stack
    (pallas_spectral.ch_substep_multi): u (N,)+shape float32; ubar, n_old
    (N, nx, L) complex64.  Each transform runs over the whole stack in one
    launch (the fields are part of the prefix).  Returns (u′, ū′, N̄)."""
    shape = plan.shape
    N, nx, L = len(plan.buffers), shape[0], math.prod(shape[1:])
    mus = plan.mu_stack(u).to(torch.float32)
    mubar = uf.fwd_axes(mus, range(2, len(shape) + 1)).reshape(N, nx, L)
    rows = np.concatenate(
        [np.tile(np.asarray([sub_dt, b0, b1], np.float32), (N, 1)), plan.coef],
        axis=1)
    u_new, n_new = fwd_x_update_poly(mubar, ubar, n_old, plan.kx2, plan.kyz2,
                                     rows)
    u_out = uf.inv_axes(u_new.reshape((N,) + shape), range(1, len(shape) + 1),
                        real_output=True)
    return u_out, u_new, n_new


# ---------------------------------------------------------------------------
# deck-chain pattern matching (pallas_spectral.py:393-667)
# ---------------------------------------------------------------------------


def _flatten(group):
    from .computes.base import ComputeGroup

    out = []
    for m in group.members:
        if isinstance(m, ComputeGroup):
            out += _flatten(m)
        else:
            out.append(m)
    return out


def _check_preconditions(solver):
    dom = solver.domain
    if dom.fft_backend != "PALLAS":
        _reject("requires [Domain] fft_backend = PALLAS")
    if dom.dim < 2:
        _reject("only 2-D/3-D domains are supported")
    if not solver.carry_reciprocal:
        _reject("requires carry_reciprocal = true")
    if solver.predictor_order > 1:  # 0-indexed; orders 1-2
        _reject("predictor orders above 2 are not fusable (history depth 1)")
    if solver.corrector_steps and solver.corrector_order > 1:
        _reject("corrector orders above 2 are not fusable (history depth 1)")
    if solver.forwarded_buffers:
        _reject("buffer forwarding is not supported")
    if getattr(solver, "predictors", []):
        _reject("predictors are not supported")


def _find_ic(problem, name, classes, what):
    for m in _flatten(problem.ic_computes):
        if getattr(m, "out", None) == name:
            if not isinstance(m, classes):
                _reject(f"{what} must be produced by one of "
                        f"{[c.__name__ for c in classes]}")
            return m
    _reject(f"no Initialize compute produces {what} '{name}'")


def _k2_tables(dom) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kx2 (nx,), kyz2 (ny·nz,)) float32 on the domain's device, from the
    permuted reciprocal axes (pallas_spectral._k2_tables)."""
    kx2 = (dom._np_raxes[0] ** 2).astype(np.float32)
    trailing = dom._np_raxes[1] ** 2
    for d in range(2, dom.dim):
        trailing = trailing[..., None] + dom._np_raxes[d] ** 2
    kyz2 = trailing.reshape(-1).astype(np.float32)
    return (torch.from_numpy(kx2).to(dom.device),
            torch.from_numpy(np.ascontiguousarray(kyz2)).to(dom.device))


def _verify_product(nl, mbar_name, mubar_name):
    """The N̄ ParsedCompute must be exactly the product M̄·µ̄."""
    rng = np.random.RandomState(0)
    a = rng.randn(4).astype(np.float64)
    b = rng.randn(4) + 1j * rng.randn(4)
    got = np.asarray(nl.expr({mbar_name: torch.from_numpy(a),
                              mubar_name: torch.from_numpy(b)}))
    if not np.allclose(got, a * b, rtol=1e-5, atol=1e-6):
        _reject("N̄ expression is not the product M̄·µ̄")


def match_chain(solver):
    """Validate the solver's chain against the fused pattern; raises
    SpectralChainError naming the unsupported feature.  Multi-variable
    chains (and single-variable ones whose L̄ is -k²·factor) dispatch to
    match_chain_multi."""
    from .computes.core import (ForwardFFT, ParsedCompute,
                                ReciprocalLaplacianFactor,
                                ReciprocalLaplacianSquareFactor,
                                SwiftHohenbergLinear)

    problem = solver.problem
    dom = solver.domain
    _check_preconditions(solver)
    if len(solver.variables) != 1:
        return match_chain_multi(solver)
    v = solver.variables[0]
    if v.linear_reciprocal is None:
        _reject("a linear_reciprocal buffer is required")

    mu = fftc = nl = None
    for m in _flatten(solver.compute):
        if isinstance(m, ForwardFFT) and fftc is None:
            fftc = m
        elif isinstance(m, ParsedCompute) and m.inputs == [v.buffer] and mu is None:
            mu = m
        elif isinstance(m, ParsedCompute) and nl is None:
            nl = m
        else:
            _reject(f"solve compute '{m.name}' ({type(m).__name__}) is not fusable")

    for what, c in (("pointwise µ(u) ParsedCompute", mu),
                    ("ForwardFFT", fftc)):
        if c is None:
            _reject(f"the chain requires a {what}")
    if mu.extra_symbols or mu.expand != "NONE" or mu.is_integer:
        _reject("µ must be a pure pointwise function of the variable")
    if fftc.input != mu.out:
        _reject("the ForwardFFT must transform µ")

    if nl is None:
        # Swift-Hohenberg class: N̄ IS the transform of the pointwise
        # nonlinearity — no mobility factor
        if fftc.out != v.nonlinear_reciprocal:
            _reject("without an N̄ ParsedCompute, the ForwardFFT must "
                    "produce nonlinear_reciprocal directly")
        mobility = None
    else:
        if nl.out != v.nonlinear_reciprocal:
            _reject("the second ParsedCompute must produce nonlinear_reciprocal")
        mbar_in = [b for b in nl.inputs if b != fftc.out]
        if set(nl.inputs) != {fftc.out} | set(mbar_in) or len(mbar_in) != 1:
            _reject("N̄ must be a function of µ̄ and one k-space factor buffer")
        mbar = _find_ic(problem, mbar_in[0], (ReciprocalLaplacianFactor,), "M̄")
        _verify_product(nl, mbar_in[0], fftc.out)
        mobility = float(mbar.factor)

    lbar = _find_ic(
        problem, v.linear_reciprocal,
        (ReciprocalLaplacianFactor, ReciprocalLaplacianSquareFactor,
         SwiftHohenbergLinear), "L̄",
    )
    if isinstance(lbar, ReciprocalLaplacianFactor):
        # L̄ = -k²·factor: kernel 5 encodes only the lapsq/sh forms, the
        # N-field polynomial plan takes every L̄ polynomial in k², at N = 1
        return match_chain_multi(solver)
    if isinstance(lbar, ReciprocalLaplacianSquareFactor):
        lin = ("lapsq", float(lbar.factor))
    else:
        lin = ("sh", float(lbar.r), float(lbar.alpha))

    kx2, kyz2 = _k2_tables(dom)
    return SpectralPlan(
        pre=uf.Pointwise(mu.expr, v.buffer),
        mobility=mobility,
        lin=lin,
        buffer=v.buffer,
        reciprocal=v.reciprocal_buffer,
        nonlinear=v.nonlinear_reciprocal,
        linear=v.linear_reciprocal,
        mu=mu.out,
        mubar=fftc.out,
        shape=tuple(dom.shape),
        kx2=kx2,
        kyz2=kyz2,
    )


def match_chain_multi(solver) -> SpectralPlanMulti:
    """N-variable fused pattern (pallas_spectral.match_chain_multi): per
    variable a pointwise µ of the N fields, its ForwardFFT µ̄, N̄ = µ̄ or
    M̄·µ̄ with M̄ from ReciprocalLaplacianFactor, and L̄ from
    ReciprocalLaplacianFactor / ReciprocalLaplacianSquareFactor /
    SwiftHohenbergLinear.  Anything else raises SpectralChainError."""
    from .computes.core import (ForwardFFT, ParsedCompute,
                                ReciprocalLaplacianFactor,
                                ReciprocalLaplacianSquareFactor,
                                SwiftHohenbergLinear)

    problem = solver.problem
    dom = solver.domain
    varnames = [v.buffer for v in solver.variables]
    members = _flatten(solver.compute)
    by_out = {}
    for m in members:
        out = getattr(m, "out", None)
        if out is None:
            _reject(f"solve compute '{m.name}' has no output buffer")
        if out in by_out:
            _reject(f"solve computes '{by_out[out].name}' and '{m.name}' "
                    f"both write buffer '{out}'")
        by_out[out] = m

    used = set()
    coef = np.zeros((len(varnames), 5), np.float32)
    mus, mubars = [], []

    for i, v in enumerate(solver.variables):
        if v.linear_reciprocal is None:
            _reject(f"variable '{v.buffer}' has no linear_reciprocal")
        nl_prod = by_out.get(v.nonlinear_reciprocal)
        if nl_prod is None:
            _reject(f"no solve compute produces nonlinear_reciprocal "
                    f"'{v.nonlinear_reciprocal}'")
        if isinstance(nl_prod, ForwardFFT):
            fftc, m0, m1 = nl_prod, 1.0, 0.0
        elif isinstance(nl_prod, ParsedCompute):
            ff = [n for n in nl_prod.inputs
                  if isinstance(by_out.get(n), ForwardFFT)]
            rest = [n for n in nl_prod.inputs if n not in ff]
            if len(ff) != 1 or len(rest) != 1:
                _reject(f"N̄ '{nl_prod.name}' must combine one ForwardFFT "
                        "output with one k-space factor buffer")
            fftc = by_out[ff[0]]
            mbar = _find_ic(problem, rest[0], (ReciprocalLaplacianFactor,),
                            f"M̄ for '{v.buffer}'")
            _verify_product(nl_prod, rest[0], ff[0])
            m0, m1 = 0.0, -float(mbar.factor)  # -k² · factor
            used.add(id(nl_prod))
        else:
            _reject(f"nonlinear_reciprocal producer '{nl_prod.name}' "
                    f"({type(nl_prod).__name__}) is not fusable")
        used.add(id(fftc))

        mu = by_out.get(fftc.input)
        if not isinstance(mu, ParsedCompute):
            _reject(f"µ for '{v.buffer}' must be a ParsedCompute "
                    f"(ForwardFFT input '{fftc.input}')")
        if mu.extra_symbols or mu.expand != "NONE" or mu.is_integer:
            _reject(f"µ '{mu.name}' must be a pure pointwise expression")
        if not set(mu.inputs) <= set(varnames):
            _reject(f"µ '{mu.name}' reads non-variable buffers "
                    f"{sorted(set(mu.inputs) - set(varnames))}")
        used.add(id(mu))
        mus.append(mu)
        mubars.append(fftc.out)

        lbar = _find_ic(
            problem, v.linear_reciprocal,
            (ReciprocalLaplacianFactor, ReciprocalLaplacianSquareFactor,
             SwiftHohenbergLinear), f"L̄ for '{v.buffer}'")
        if isinstance(lbar, ReciprocalLaplacianSquareFactor):
            la = (0.0, 0.0, float(lbar.factor))  # k⁴ · factor
        elif isinstance(lbar, ReciprocalLaplacianFactor):
            la = (0.0, -float(lbar.factor), 0.0)  # -k² · factor
        else:  # r − α²(1−k²)² expanded in k²
            r, a = float(lbar.r), float(lbar.alpha)
            la = (r - a * a, 2.0 * a * a, -a * a)
        coef[i] = [m0, m1, *la]

    extra = [m for m in members if id(m) not in used]
    if extra:
        _reject("solve computes "
                f"{[m.name for m in extra]} are not part of the N-variable "
                "µ/FFT/N̄ pattern")

    exprs = [(mu.expr, list(mu.inputs)) for mu in mus]

    def mu_stack(u):
        env = {name: u[i] for i, name in enumerate(varnames)}
        return torch.stack([expr({n: env[n] for n in inputs})
                            for expr, inputs in exprs])

    kx2, kyz2 = _k2_tables(dom)
    return SpectralPlanMulti(
        mu_stack=mu_stack,
        coef=coef,
        buffers=varnames,
        reciprocals=[v.reciprocal_buffer for v in solver.variables],
        nonlinears=[v.nonlinear_reciprocal for v in solver.variables],
        mus=[m.out for m in mus],
        mubars=mubars,
        shape=tuple(dom.shape),
        kx2=kx2,
        kyz2=kyz2,
    )
