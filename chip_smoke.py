#!/usr/bin/env python3
"""Smoke run of marlin_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, one line each, flushed as they finish:

0. toolchain: torch, CUDA, nvcc, the card's name and power limit;
1. build: the CUDA libraries of marlin_tpu_torch/csrc (the unordered FFT,
   the fused k-space update, the fused LBM substep) and the generated
   library of the 3-D Cahn-Hilliard µ fused into the forward lanes read,
   one nvcc each, all started together, with ptxas's registers and spills
   of every FFT and LBM kernel, forward and inverse (and the register FFT
   kernels' shared memory), the LBM substep's flat and brick kernels;
2. kernels: each kernel at its 512³ main-path shapes (and at n = 64, 200,
   384) against its plain PyTorch twin, max error ≤ 1e-5 of the twin's
   largest magnitude; kernel, twin, bound and yardstick times, and which
   path (register or tile) each FFT shape takes, forward and inverse.  The LBM
   substep kernel (``lbm_substep``) at 256³ in float32 on nine plans (the
   porous deck's, the mixed deck's, a D3Q27 all-faces plan with a z body
   force, a zeroth-order Zou-He channel; the thermal deck's two lattices
   with buoyancy and the Guo source, the Pebbles deck's MRT on both
   lattices through media, an MRT D3Q27 all-faces plan, the porous deck
   with the Hermite projection, the collisionless chain), and at 9³ and
   33×17×20, each 256³ plan with the kernel it takes (the brick kernel,
   with its rows a brick, stages, threads and shared memory, or the flat
   one); the 256³ rows of the decks run in phases 7-10 beside their
   eager JNP substep.  The LBM kernels' bound takes their operations at
   half the float32 rate (built without FMA, each multiply and add issues
   alone).  The 2-D (D2Q9) plans at 800×200 and 4096×2048 in
   float32 (the channel with BGK and with MRT, the 2-D thermal pair, the
   Kármán plan: Smagorinsky with the projection, a perturbed inlet and the
   cylinder) and at 33×17 and 1000×333; the Kármán plan's two density-mean
   passes (``lbm_density_mean``) against their twin at the same extents;
3. main path: the 3-D Cahn-Hilliard deck at 512³ through ``run_deck`` with
   ``fft_backend = PALLAS`` in float32 (10 substeps, 2 steps, dt = 1): the
   launch counters rise by exactly the count the path implies, c is finite
   and its mean (mass) stays within 1e-5 of the start;
4. library anchor: the same deck with ``fft_backend = DEFAULT`` (torch.fft);
   max |c_PALLAS − c_DEFAULT| ≤ 5e-5 (tests/test_pallas_fft.py's tolerance);
5. fused single-field path: the same deck on PALLAS with
   ``carry_reciprocal`` and ``fused_spectral``: exact launch counts, mass
   within 1e-5, max |c_fused − c_DEFAULT| ≤ 2e-4
   (tests/test_pallas_spectral.py's fused-versus-library tolerance);
6. fused N-field path: the 3-D two-field chain (decks.MULTI_3D_DECK: a
   Cahn-Hilliard field c and an Allen-Cahn field n1) at 512³, float32,
   10 substeps, 2 steps, dt = 0.05, fused and unfused (carry only):
   max |Δ| ≤ 5e-5 on c and n1, mass of c within 1e-5, one
   ``fwd_x_update_poly`` launch per fused substep;
7. LBM porous: ``decks.POROUS_DECK`` (D3Q19 BGK through the benchmark's
   sphere pack, ``decks.porous_media``, handed in as an array so no HDF5
   file is needed) at 256³, float32, 20 substeps × 3 steps, through
   ``run_deck`` with ``lbm_backend = PALLAS`` and ``JNP``: exactly 2 × 19
   ``lbm_substep`` launches on PALLAS and none on JNP; on f, fpc, density,
   velocity and speed max |PALLAS − JNP| ≤ 1e-5 of the JNP buffer's
   largest magnitude; the fluid mass Σρ (float64) within 1e-5 of its start
   on both; every buffer finite;
8. LBM mixed: ``decks.MIXED_DECK`` (bounce-back walls, Zou-He velocity
   inlet, zero-gradient outlet) the same way, without the mass check (the
   inlet and the outlet move mass);
9. LBM thermal: ``decks.THERMAL3D_DECK`` (two D3Q19 BGK lattices, f and
   the temperature g, Boussinesq buoyancy, Guo forcing, bounce-back plates
   and Zou-He temperature faces) the same way, on f, fpc, g, gpc, density,
   T and velocity, with the mass check; MLUPS count both lattices;
10. LBM Pebbles: ``decks.PEBBLES_DECK`` (MRT on both lattices through the
   benchmark's sphere pack, buoyancy, Guo forcing, Zou-He temperature
   faces, the residual on T) the same way;
11. LBM Kármán: ``decks.KARMAN_DECK`` (D2Q9, Smagorinsky with the Hermite
   projection, the cylinder of ``decks.karman_media``, a perturbed Zou-He
   inlet, a zero-gradient outlet) at 800×200, float32, 100 substeps × 3
   steps, on PALLAS and JNP: exactly 2 × 99 ``lbm_substep`` launches and
   2 × 198 ``lbm_density_mean`` launches on PALLAS, none on JNP; on f, fpc,
   feq, density, velocity and speed max |PALLAS − JNP| ≤ 1e-5 of the JNP
   buffer's largest magnitude; every buffer finite; ms a substep, MLUPS and
   peak device memory on both.

Then one JSON line with every kernel's numbers (a kernel timed at more
than one main shape also lists each under ``shapes``) and, last, the JSON
result line.  Any failure ends the run with a non-zero exit and no result line.
Needs one CUDA card; fails without one, and fails where the package is not
beside it.
"""

import concurrent.futures
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N = 512
SUBSTEPS = 10
STEPS = 2
MULTI_DT = 0.05
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12     # H100 SXM data sheet, float32 outside tensor cores
# csrc/lbm_substep.cu is built with -fmad=false: every multiply and add
# issues on its own, at half the rate that counts an FMA as two
F32_NO_FMA_FLOP_PER_S = F32_FLOP_PER_S / 2
KERNEL_TOL = 1e-5
ANCHOR_TOL = 5e-5
FUSED_ANCHOR_TOL = 2e-4
MULTI_TOL = 5e-5
MASS_TOL = 1e-5
FUSED = "carry_reciprocal = true\n  fused_spectral = true"
LBM_N = 256
LBM_SUBSTEPS = 20
LBM_STEPS = 3
LBM_ODD = [(9, 9, 9), (33, 17, 20)]
KARMAN = (800, 200)  # the reference cylinder.i's shipped extent
LBM_2D = [KARMAN, (4096, 2048)]  # the shipped 2-D size, and one above launch cost
LBM_ODD_2D = [(33, 17), (1000, 333)]  # 1000×333: the mean's chunked finish
KARMAN_SUBSTEPS = 100


def say(*parts):
    print(*parts, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps=10, warmup=2):
    """Mean device time of one call, by CUDA events over `reps` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, flops, flop_rate=F32_FLOP_PER_S):
    """Least time: bytes over the memory rate against flops over the
    float32 rate (``flop_rate``); returns (ms, "bytes" | "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fft_flops(rows, n):
    """The standard count, 5·n·log2 n flop a length-n transform."""
    return rows * 5 * n * math.log2(n)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def check(name, shape, got, ref):
    """max |got − ref| against 1e-5 of the twin's largest magnitude, over
    every output; returns the error."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = 0.0
    for g, r in zip(got, ref):
        e = (g - r).abs().max().item()
        mag = r.abs().max().item()
        assert e <= KERNEL_TOL * mag, (name, shape, e, mag)
        err = max(err, e)
    return err


def summarise(rows):
    """The mean over a kernel's main-shape rows; with more than one row,
    each row also stands on its own under ``shapes``, so that a loss at one
    shape is not hidden by a win at another."""
    k = len(rows)
    mean = lambda key: sum(r[key] for r in rows) / k
    out = {"max_abs_err": max(r["max_abs_err"] for r in rows),
           "ms": mean("ms"), "plain_ms": mean("plain_ms"),
           "bound_ms": mean("bound_ms"), "bound_by": rows[0]["bound_by"],
           "library_ms": None if rows[0]["library_ms"] is None else mean("library_ms")}
    if "yardstick_ms" in rows[0]:
        out["yardstick_ms"] = mean("yardstick_ms")
        out["yardstick"] = rows[0]["yardstick"]
    if k > 1:
        out["shapes"] = rows
    return out


def measure(name, shape, kernel, twin, library, n_bytes, flops, yardstick=None,
            flop_rate=F32_FLOP_PER_S):
    """One main-shape row: the check, then kernel, twin, library or
    composite yardstick times and the bound."""
    got = kernel()
    torch.cuda.synchronize()
    ref = twin()
    err = check(name, shape, got, ref)
    del got, ref
    ms = cuda_ms(kernel)
    plain = cuda_ms(twin, reps=3, warmup=1)
    lib = None if library is None else cuda_ms(library)
    bnd, by = bound_ms(n_bytes, flops, flop_rate)
    row = {"shape": list(shape), "max_abs_err": err, "ms": ms, "plain_ms": plain,
           "library_ms": lib, "bound_ms": bnd, "bound_by": by}
    text = (f"[kernels] {name} {tuple(shape)}: max_abs_err {err:.3e}, kernel "
            f"{ms:.3f} ms, twin {plain:.3f} ms, bound {bnd:.3f} ms ({by})")
    if lib is not None:
        text += f", torch.fft {lib:.3f} ms"
    if yardstick is not None:
        label, fn = yardstick
        row["yardstick"] = label
        row["yardstick_ms"] = cuda_ms(fn)
        text += f", {label} {row['yardstick_ms']:.3f} ms"
    say(text)
    torch.cuda.empty_cache()
    return row


def phase_fft_kernels(uf, dev, gen):
    """Kernels 1-4 against their twins."""
    def make(shape, dtype):
        return torch.randn(shape, generator=gen, dtype=dtype).to(dev)

    plane = N * N
    main_shapes = {
        "fwd_lanes": [((plane, N), torch.float32)],
        "inv_lanes": [((plane, N), torch.complex64)],
        "fwd_sublanes": [((1, N, plane), torch.complex64),
                         ((N, N, N), torch.complex64)],
        "inv_sublanes": [((1, N, plane), torch.complex64),
                         ((N, N, N), torch.complex64)],
    }
    small = {
        "fwd_lanes": [((4096, n), torch.float32) for n in (64, 200, 384)],
        "inv_lanes": [((4096, n), torch.complex64) for n in (64, 200, 384)],
        "fwd_sublanes": [((8, n, 300), torch.float32) for n in (64, 200, 384)],
        "inv_sublanes": [((8, n, 300), torch.complex64) for n in (64, 200, 384)],
    }
    library = {
        "fwd_lanes": lambda x: torch.fft.fft(x, dim=-1),
        "inv_lanes": lambda x: torch.fft.ifft(x, dim=-1),
        "fwd_sublanes": lambda x: torch.fft.fft(x, dim=1),
        "inv_sublanes": lambda x: torch.fft.ifft(x, dim=1),
    }
    results = {}
    for name in main_shapes:
        kernel = getattr(uf, name)
        twin = getattr(uf, name + "_plain")
        for shape, dtype in small[name]:
            x = make(shape, dtype)
            got = kernel(x)
            torch.cuda.synchronize()
            err = check(name, shape, got, twin(x))
            say(f"[kernels] {name} {tuple(shape)} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3e}")
        rows = []
        for shape, dtype in main_shapes[name]:
            x = make(shape, dtype)
            n = shape[1] if "sub" in name else shape[-1]
            out_bytes = x.numel() * (4 if name == "inv_lanes" else 8)
            lib = uf.LIBRARY.load()
            which = lib.mtt_fwd_path if name.startswith("fwd") else lib.mtt_inv_path
            path = "register" if which(n, uf.base(n)) else "tile"
            say(f"[kernels] {name} {tuple(shape)}: {path} path")
            rows.append(measure(
                name, shape, lambda: kernel(x), lambda: twin(x),
                lambda: library[name](x),
                nbytes(x) + out_bytes + n * 8,  # + the twiddle table
                fft_flops(x.numel() // n, n)))
            del x
        results[name] = summarise(rows)
    return results


def phase_fused_kernels(uf, sp, dev, gen, pre, k2):
    """fwd_lanes_pre, fwd_x_update and fwd_x_update_poly against their
    twins."""
    def make(shape, dtype, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=gen, dtype=dtype)).to(dev)

    results = {}
    # -- kernel 1 with the fused µ read: c-like values around 0.5
    pre_ops = pre.expr.cuda_source(pre.var).count("\n")  # one flop a statement
    for n in (64, 200, 384):
        x = make((4096, n), torch.float32, 0.05, 0.5)
        err = check("fwd_lanes_pre", (4096, n), uf.fwd_lanes(x, pre=pre),
                    uf.fwd_lanes_plain(pre(x)))
        say(f"[kernels] fwd_lanes_pre (4096, {n}) float32: max_abs_err {err:.3e}")
    x = make((N * N, N), torch.float32, 0.05, 0.5)
    results["fwd_lanes_pre"] = summarise([measure(
        "fwd_lanes_pre", x.shape, lambda: uf.fwd_lanes(x, pre=pre),
        lambda: uf.fwd_lanes_plain(pre(x)), None,
        nbytes(x) + 2 * nbytes(x) + N * 8,
        fft_flops(N * N, N) + pre_ops * x.numel(),
        ("composite µ (torch ops) + torch.fft.fft",
         lambda: torch.fft.fft(pre(x), dim=-1)))])
    del x

    # -- kernels 5 and 6: the last forward axis with the ABM update
    forms = {"lapsq_mobility": (5.0, ("lapsq", -10.0)),
             "sh_no_mobility": (None, ("sh", 0.025, 1.0))}
    args = (0.1, 1.5, -0.5)

    def tables(n, L):
        return (make((n,), torch.float32).abs().contiguous(),
                make((L,), torch.float32).abs().contiguous())

    def composite(m, u, o, kx2, kyz2, mobility, lin):
        """torch.fft.fft along x plus the update in torch ops (a yardstick:
        no single torch call computes the fused function)."""
        mb = torch.fft.fft(m, dim=0)
        k2 = kx2[:, None] + kyz2
        lb = (k2 * k2) * lin[1] if lin[0] == "lapsq" else (
            lin[1] - lin[2] ** 2 * (1.0 - k2) ** 2)
        return sp._update(mb, u, o, *args, lb,
                          None if mobility is None else -k2 * mobility)

    for form, (mobility, lin) in forms.items():
        for n in (64, 200, 384):
            m, u, o = (make((n, 300), torch.complex64) for _ in range(3))
            kx2, kyz2 = tables(n, 300)
            err = check("fwd_x_update", (n, 300),
                        sp.fwd_x_update(m, u, o, kx2, kyz2, *args, mobility, lin),
                        sp.fwd_x_update_plain(m, u, o, kx2, kyz2, *args, mobility, lin))
            say(f"[kernels] fwd_x_update {form} ({n}, 300): max_abs_err {err:.3e}")
    rows = []
    kx2, kyz2 = k2
    L = N * N
    for form, (mobility, lin) in forms.items():
        m, u, o = (make((N, L), torch.complex64) for _ in range(3))
        rows.append(measure(
            f"fwd_x_update {form}", m.shape,
            lambda: sp.fwd_x_update(m, u, o, kx2, kyz2, *args, mobility, lin),
            lambda: sp.fwd_x_update_plain(m, u, o, kx2, kyz2, *args, mobility, lin),
            None, 5 * nbytes(m) + nbytes(kx2, kyz2),
            fft_flops(L, N) + 25 * m.numel(),
            ("composite torch.fft.fft(dim=0) + update (torch ops)",
             lambda: composite(m, u, o, kx2, kyz2, mobility, lin))))
        del m, u, o
    results["fwd_x_update"] = summarise(rows)

    coef = np.asarray([[0.0, -5.0, 0.0, 0.0, -10.0],    # Cahn-Hilliard field
                       [1.0, 0.0, 0.0, -15.0, 0.0]],    # Allen-Cahn field
                      np.float32)
    rows8 = np.concatenate([np.tile(np.asarray(args, np.float32), (2, 1)), coef], 1)
    for n in (64, 200, 384):
        m, u, o = (make((2, n, 300), torch.complex64) for _ in range(3))
        kx2s, kyz2s = tables(n, 300)
        err = check("fwd_x_update_poly", (2, n, 300),
                    sp.fwd_x_update_poly(m, u, o, kx2s, kyz2s, rows8),
                    sp.fwd_x_update_poly_plain(m, u, o, kx2s, kyz2s, rows8))
        say(f"[kernels] fwd_x_update_poly (2, {n}, 300): max_abs_err {err:.3e}")
    m, u, o = (make((2, N, L), torch.complex64) for _ in range(3))
    # kernel 6 locked to kernel 5: field 0's row is the lapsq/mobility form
    lock = check("fwd_x_update_poly vs fwd_x_update", m[0].shape,
                 tuple(t[0] for t in sp.fwd_x_update_poly(m, u, o, kx2, kyz2, rows8)),
                 sp.fwd_x_update(m[0], u[0], o[0], kx2, kyz2, *args, 5.0,
                                 ("lapsq", -10.0)))
    say(f"[kernels] fwd_x_update_poly field 0 against fwd_x_update: "
        f"max_abs_err {lock:.3e}")

    def composite_poly():
        mb = torch.fft.fft(m, dim=1)
        k2t = kx2[:, None] + kyz2
        return [sp._update(mb[f], u[f], o[f], *args,
                           float(coef[f, 3]) * k2t + float(coef[f, 4]) * k2t * k2t,
                           float(coef[f, 0]) + float(coef[f, 1]) * k2t)
                for f in range(2)]

    results["fwd_x_update_poly"] = summarise([measure(
        "fwd_x_update_poly", m.shape,
        lambda: sp.fwd_x_update_poly(m, u, o, kx2, kyz2, rows8),
        lambda: sp.fwd_x_update_poly_plain(m, u, o, kx2, kyz2, rows8),
        None, 5 * nbytes(m) + nbytes(kx2, kyz2),
        2 * fft_flops(L, N) + 25 * m.numel(),
        ("composite torch.fft.fft(dim=1) + update (torch ops)", composite_poly))])
    del m, u, o
    torch.cuda.empty_cache()
    return results


# -- the fused LBM substep ---------------------------------------------------------


def lbm_flops(cfg):
    """Operations a cell: the density and momentum sums, u (three
    quotients, three sums, one product each), |u|², √, and per lattice and
    direction e·u, the equilibrium and the collision: BGK, or the MRT row
    (a product and a sum a non-zero entry), after the Hermite projection's
    sums where the plan has it; on two-lattice plans T, the force and the
    Guo source."""
    q = cfg.q
    nnz = [sum(1 for c in e if c) for e in cfg.e]
    per_q = sum(13 + max(0, k - 1) for k in nnz)
    ops = (q - 1) + sum(nnz) + 16
    if not cfg.collide:
        return ops
    lattices = [(cfg.msm, cfg.proj)]
    if cfg.two_lattice:
        lattices.append((cfg.msm2, cfg.proj2))
        ops += (q - 1) + 12  # T, the force, u += F/(2ρ)
    if cfg.force is not None and cfg.force.apply_tau:
        ops += sum(3 + max(0, k - 1) for k in nnz)
    for msm, proj in lattices:
        ops += per_q
        if msm is not None:
            ops += sum(2 * sum(1 for c in row if c) for row in msm)
        if proj:
            ops += 2 * sum(nnz) * 9 + 2 * q * 9
    if cfg.smag is not None:
        # the flux component, its square, two roots, two quotients, four
        # products and sums
        ops += sum(1 for e in cfg.e if e[0] * e[1]) + 10
    return ops


def lbm_rand(cfg, shape, gen, dev):
    w = torch.tensor(cfg.w, dtype=torch.float32, device=dev)
    return w[:, None, None, None] * (1.0 + 0.05 * torch.randn(
        (cfg.q,) + shape, generator=gen, device=dev))


def ptxas_report(log, describe):
    """One line per kernel of nvcc's -Xptxas=-v output that ``describe``
    names (it maps a mangled entry name to a label, or None to skip):
    registers and spill bytes."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = describe(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return out


def lbm_kernel_name(mangled):
    """lbm_substep_kernel or lbm_brick_kernel <Q, T, TWO, MRT> of a mangled
    entry name, or None."""
    m = re.search(r"lbm_(substep|brick)_kernelILi(\d+)E([fd])Lb([01])ELb([01])E", mangled)
    if not m:
        return None
    kind, q, t, two, mrt = m.groups()
    return (f"lbm_{kind}_kernel<{q}, {'float' if t == 'f' else 'double'}, "
            f"two={two}, mrt={mrt}>")


FFT_KERNEL = re.compile(r"(reg_lanes|reg_sublanes|tile_lanes|tile_sublanes)_kernel")
TEMPLATE_ARG = re.compile(r"L[ib](\d+)E|NS_(\d+)")


def template_args(mangled, i):
    """The template arguments of a mangled name whose list opens at
    ``mangled[i] == "I"``: ints and bools as digits, the port's functors
    (types in its anonymous namespace, ``NS_<len><name>``, with their own
    arguments) by name; returns (list, index past the list)."""
    out, i = [], i + 1
    while mangled[i] != "E":
        m = TEMPLATE_ARG.match(mangled, i)
        if m is None:
            raise ValueError(mangled)
        if m.group(1) is not None:
            out.append(m.group(1))
            i = m.end()
            continue
        name_end = m.end() + int(m.group(2))
        name, i = mangled[m.end():name_end], name_end
        if mangled[i] == "I":
            inner, i = template_args(mangled, i)
            name += f"<{', '.join(inner)}>"
        if mangled[i] != "E":
            raise ValueError(mangled)
        out.append(name)
        i += 1
    return out, i + 1


def fft_kernel_namer(uf):
    """A ``describe`` for ptxas_report: each FFT kernel with its template
    arguments (the epilogue InvStore marks an inverse kernel); a
    register-resident one (each N) also with the dynamic shared memory a
    block takes at that N."""
    def describe(mangled):
        k = FFT_KERNEL.search(mangled)
        if not k:
            return None
        kind = k.group(1)
        try:
            args = template_args(mangled, k.end())[0] if mangled[k.end()] == "I" else []
        except (ValueError, IndexError):
            return mangled
        label = f"{kind}_kernel<{', '.join(args)}>"
        if kind.startswith("tile"):  # the generic tile: its shared memory goes by extent
            return label
        smem = uf.LIBRARY.load().mtt_smem(int(args[0]), 128, int(kind == "reg_sublanes"))
        return f"{label} ({smem} B shared memory)"
    return describe


def phase_lbm_kernel(lf, dev):
    """lbm_substep against its twin at 256³ (float32) on every 3-D plan,
    at 800×200 and 4096×2048 on every 2-D plan, and at odd extents; the
    density mean of the Smagorinsky plan against its twin at the same
    extents.  Returns the main-shape rows by plan (2-D plans by plan and
    extent) and the density mean's rows."""
    import dataclasses

    from marlin_tpu_torch.decks import karman_media, porous_media
    from marlin_tpu_torch.lbm_probe import deck_plans

    gen = torch.Generator(device=dev).manual_seed(1)
    rows, mean_rows = {}, []
    for name, base in deck_plans().items():
        if base.two_d:
            shapes = [s + (1,) for s in LBM_ODD_2D + LBM_2D]
            main = [s + (1,) for s in LBM_2D]
        else:
            shapes = LBM_ODD + [(LBM_N,) * 3]
            main = [(LBM_N,) * 3]
        for shape in shapes:
            cfg = dataclasses.replace(base, nx=shape[0], ny=shape[1], nz=shape[2])
            fpc = lbm_rand(cfg, shape, gen, dev)
            gpc = lbm_rand(cfg, shape, gen, dev) if cfg.two_lattice else None
            media = None
            if cfg.has_media:
                # the code TensorProblem.lbm_media gives: 1 fluid, 0 solid
                if cfg.two_d:
                    # the cylinder at every extent: random media leave NaN
                    # (a zero-gradient face cell copying a solid neighbour)
                    m = torch.as_tensor(karman_media(*shape[:2]), device=dev)[..., None]
                elif shape in main:
                    m = torch.as_tensor(porous_media(shape[0]), device=dev)
                else:
                    m = torch.rand(shape, generator=gen, device=dev) > 0.2
                media = m.to(torch.int8).contiguous()
                fpc = torch.where(media == 0, 0.0, fpc)
                if gpc is not None:
                    gpc = torch.where(media == 0, 0.0, gpc).contiguous()
            fpc = fpc.contiguous()
            kernel = lambda: lf.fused_substep(fpc, media, cfg, gpc)
            twin = lambda: lf.fused_substep_twin(fpc, media, cfg, gpc)
            cells = math.prod(shape)
            if cfg.smag is not None:
                mean_rows += lbm_density_mean_check(lf, fpc, media, cfg, shape, shape in main)
            if shape not in main:
                err = check(f"lbm_substep {name}", shape, kernel(), twin())
                say(f"[kernels] lbm_substep {name} {shape}: max_abs_err {err:.3e}")
                continue
            lattices = 2 if cfg.two_lattice else 1
            n_bytes = (2 * lattices * nbytes(fpc) + cells * 4
                       + (cells if media is not None else 0))
            if not cfg.two_d:
                walk = lf.brick_plan(cfg, fpc.dtype)
                say(f"[kernels] lbm_substep {name} {shape}: " + (
                    "flat kernel" if walk is None else
                    f"brick kernel, by {walk.by}, {walk.stages} stages, {walk.threads} "
                    f"threads, {walk.smem} B shared memory"))
            row = measure(f"lbm_substep {name}", (lattices, cfg.q) + shape, kernel,
                          twin, None, n_bytes, lbm_flops(cfg) * cells,
                          flop_rate=F32_NO_FMA_FLOP_PER_S)
            say(f"[kernels] lbm_substep {name} {shape}: "
                f"{lattices * cells / (row['ms'] * 1e3):.0f} MLUPS (byte bound "
                f"{lattices * cells / (row['bound_ms'] * 1e3):.0f})")
            rows[name if not cfg.two_d else f"{name} {shape[0]}x{shape[1]}"] = row
            del fpc, gpc, media
            torch.cuda.empty_cache()
    return rows, mean_rows


def lbm_density_mean_check(lf, fpc, media, cfg, shape, timed):
    """The Smagorinsky plan's density mean (two launches) against its twin,
    exactly as the kernel's check: ≤ 1e-5 of the twin's magnitude; on a
    main extent also its times, bound by the bytes it reads (the q planes
    and the media byte)."""
    kernel = lambda: lf.density_mean(fpc, media, cfg)
    twin = lambda: lf.density_mean_twin(fpc, media, cfg)
    if not timed:
        err = check("lbm_density_mean", shape, kernel(), twin())
        say(f"[kernels] lbm_density_mean {shape}: max_abs_err {err:.3e}")
        return []
    cells = math.prod(shape)
    n_bytes = nbytes(fpc) + (cells if media is not None else 0)
    return [measure("lbm_density_mean", shape, kernel, twin, None, n_bytes, cfg.q * cells,
                    flop_rate=F32_NO_FMA_FLOP_PER_S)]


LBM_PATHS = {
    # deck: (compared buffers, fluid mass conserved, lattices)
    "porous": (("f", "fpc", "density", "velocity", "speed"), True, 1),
    "mixed": (("f", "fpc", "density", "velocity", "speed"), False, 1),
    "thermal": (("f", "fpc", "g", "gpc", "density", "T", "velocity"), True, 2),
    "pebbles": (("f", "fpc", "g", "gpc", "density", "T", "velocity"), True, 2),
}


def lbm_deck(name, backend):
    """(deck text at LBM_N³ in float32 with LBM_STEPS steps, arrays)."""
    import re

    from marlin_tpu_torch import decks

    fmt = dict(substeps=LBM_SUBSTEPS, backend=backend)
    arrays = None
    if name == "porous":
        deck = decks.POROUS_DECK.format(n=LBM_N, media_h5="media.h5", **fmt)
        arrays = {"media": decks.porous_media(LBM_N)}
    elif name == "mixed":
        deck = decks.MIXED_DECK.format(n=LBM_N, **fmt)
    elif name == "thermal":
        deck = decks.THERMAL3D_DECK.format(n=LBM_N, **fmt)
    else:
        deck = decks.PEBBLES_DECK.format(nx=LBM_N, ny=LBM_N, nz=LBM_N,
                                         media_h5="media.h5", **fmt)
        arrays = {"media": decks.porous_media(LBM_N)}
    deck = deck.replace("[Domain]", "[Domain]\n  floating_precision = SINGLE")
    deck = re.sub(r"\[Executioner\]\n(  .*\n)*\[\]\n", "", deck)
    assert "[Executioner]" not in deck, name
    deck += f"""
[Executioner]
  type = Transient
  num_steps = {LBM_STEPS}
[]
"""
    return deck, arrays


def lbm_run(name, backend, dev):
    """run_deck on an LBM deck at LBM_N³, float32; returns (transient, wall
    seconds, launches)."""
    from marlin_tpu_torch import hit
    from marlin_tpu_torch import lbm_fused as lf
    from marlin_tpu_torch.executioner import run_deck

    deck, arrays = lbm_deck(name, backend)
    lf.reset_launches()
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = run_deck(hit.parse(deck), output_dir=out_dir, device=dev, arrays=arrays)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return tr, wall, lf.launches()["lbm_substep"]


def lbm_substep_ms(tr, substeps=LBM_SUBSTEPS):
    """Device time of one steady step of the finished run, a substep."""
    p, st = tr.problem, tr.state
    ms = cuda_ms(lambda: p.step(st, tr.time, 1.0, 1.0, False), reps=2, warmup=1)
    return ms / substeps


def fluid_mass(state, solid):
    rho = state["buffers"]["density"].double()
    return rho[~solid].sum().item()


def phase_lbm_path(name, dev):
    """One LBM deck on PALLAS and JNP: launches, PALLAS against JNP, mass,
    ms a substep and MLUPS.  Returns (PALLAS launches, PALLAS ms, JNP ms)."""
    keys, mass_check, lattices = LBM_PATHS[name]
    cells = LBM_N ** 3
    # the first MOOSE step runs no substeps, the last substep of each step
    # runs the eager chain
    expected = (LBM_STEPS - 1) * (LBM_SUBSTEPS - 1)
    out = {}
    for backend in ("PALLAS", "JNP"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr, wall, launched = lbm_run(name, backend, dev)
        want = expected if backend == "PALLAS" else 0
        say(f"[lbm {name}] {backend} {LBM_N}^3, {LBM_STEPS} steps x {LBM_SUBSTEPS} "
            f"substeps: run_deck {wall:.2f} s, lbm_substep launches {launched} "
            f"(expected {want}), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        assert launched == want, (name, backend, launched, want)
        for k, v in tr.state["buffers"].items():
            assert bool(torch.isfinite(v).all()), (name, backend, k)
        ms = lbm_substep_ms(tr)
        say(f"[lbm {name}] {backend} {ms:.3f} ms/substep, "
            f"{lattices * cells / (ms * 1e3):.0f} MLUPS ({lattices} lattice"
            f"{'s' if lattices > 1 else ''})")
        problem = tr.problem
        solid = problem.lbm_solid_mask()
        if solid is None:
            solid = torch.zeros((LBM_N,) * 3, dtype=torch.bool, device=dev)
        else:
            say(f"[lbm {name}] solid fraction {solid.double().mean().item():.4f}")
        if mass_check:
            # the deck starts every fluid cell at density 1
            m0 = float((~solid).sum().item())
            m1 = fluid_mass(tr.state, solid)
            say(f"[lbm {name}] {backend} fluid mass {m0:.6f} -> {m1:.6f}")
            assert abs(m1 - m0) <= MASS_TOL * m0, (name, backend, m0, m1)
        out[backend] = (tr.state["buffers"], ms, launched)
        del tr, problem
    for k in keys:
        a, b = out["PALLAS"][0][k], out["JNP"][0][k]
        d = (a - b).abs().max().item()
        mag = b.abs().max().item()
        say(f"[lbm {name}] max|{k}_PALLAS - {k}_JNP| {d:.3e} (limit "
            f"{KERNEL_TOL} x {mag:.4e})")
        assert d <= KERNEL_TOL * mag, (name, k, d, mag)
    return out["PALLAS"][2], out["PALLAS"][1], out["JNP"][1]


def karman_deck(backend):
    """decks.KARMAN_DECK at its shipped 800×200 in float32, KARMAN_SUBSTEPS
    substeps × LBM_STEPS steps; (text, arrays)."""
    from marlin_tpu_torch import decks

    nx, ny = KARMAN
    deck = decks.KARMAN_DECK.format(nx=nx, ny=ny, substeps=KARMAN_SUBSTEPS,
                                    backend=backend)
    deck = deck.replace("[Domain]", "[Domain]\n  floating_precision = SINGLE")
    deck = deck.replace("  num_steps = 3\n", f"  num_steps = {LBM_STEPS}\n")
    return deck, {"binary_media": decks.karman_media(nx, ny)}


def phase_karman(dev):
    """The Kármán deck at 800×200 on PALLAS and JNP: launches, PALLAS
    against JNP, ms a substep, MLUPS, peak memory.  Returns (launches of
    PALLAS, PALLAS ms, JNP ms)."""
    from marlin_tpu_torch import hit
    from marlin_tpu_torch import lbm_fused as lf
    from marlin_tpu_torch.executioner import run_deck

    cells = KARMAN[0] * KARMAN[1]
    fused = (LBM_STEPS - 1) * (KARMAN_SUBSTEPS - 1)
    out = {}
    for backend in ("PALLAS", "JNP"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by earlier phases' live objects
        deck, arrays = karman_deck(backend)
        lf.reset_launches()
        with tempfile.TemporaryDirectory() as out_dir:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr = run_deck(hit.parse(deck), output_dir=out_dir, device=dev, arrays=arrays)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched = lf.launches()
        want = ({"lbm_substep": fused, "lbm_density_mean": 2 * fused} if backend == "PALLAS"
                else {"lbm_substep": 0, "lbm_density_mean": 0})
        say(f"[karman] {backend} {KARMAN[0]}x{KARMAN[1]}, {LBM_STEPS} steps x "
            f"{KARMAN_SUBSTEPS} substeps: run_deck {wall:.2f} s, launches {launched} "
            f"(expected {want}), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, of which "
            f"{held / 2**30:.3f} GiB held before the run")
        assert launched == want, (backend, launched, want)
        for k, v in tr.state["buffers"].items():
            assert bool(torch.isfinite(v).all()), (backend, k)
        ms = lbm_substep_ms(tr, KARMAN_SUBSTEPS)
        say(f"[karman] {backend} {ms:.4f} ms/substep, {cells / (ms * 1e3):.0f} MLUPS; "
            f"max speed {tr.state['buffers']['speed'].max().item():.5f}")
        out[backend] = (tr.state["buffers"], ms, launched)
        del tr
    for k in ("f", "fpc", "feq", "density", "velocity", "speed"):
        a, b = out["PALLAS"][0][k], out["JNP"][0][k]
        d = (a - b).abs().max().item()
        mag = b.abs().max().item()
        say(f"[karman] max|{k}_PALLAS - {k}_JNP| {d:.3e} (limit {KERNEL_TOL} x {mag:.4e})")
        assert d <= KERNEL_TOL * mag, (k, d, mag)
    return out["PALLAS"][2], out["PALLAS"][1], out["JNP"][1]


def transient(deck, dt, buffer):
    return deck + f"""
[Executioner]
  type = Transient
  num_steps = {STEPS}
  dt = {dt}
[]
[Postprocessors]
  [mean]
    type = TensorAveragePostprocessor
    buffer = {buffer}
    execute_on = 'INITIAL TIMESTEP_END'
  []
  [max]
    type = TensorExtremeValuePostprocessor
    buffer = {buffer}
    value_type = MAX
  []
[]
[Outputs]
  csv = true
[]
"""


def ch3d_deck(backend, solver_extra=""):
    from marlin_tpu_torch.decks import CH3D_DECK

    deck = CH3D_DECK.format(n=N, substeps=SUBSTEPS).replace(
        "[Domain]",
        f"[Domain]\n  fft_backend = {backend}\n  floating_precision = SINGLE")
    if solver_extra:
        deck = deck.replace("[TensorSolver]", f"[TensorSolver]\n  {solver_extra}")
    return transient(deck, 1, "c")


def multi_deck(solver_extra):
    from marlin_tpu_torch.decks import MULTI_3D_DECK

    deck = MULTI_3D_DECK.format(
        n=N, domain_extra="fft_backend = PALLAS\n  floating_precision = SINGLE",
        solver_extra=solver_extra).replace("substeps = 5",
                                           f"substeps = {SUBSTEPS}")
    return transient(deck, MULTI_DT, "c")


def run_main_path(deck, dev):
    """run_deck on a deck (its CSV into a temporary directory); returns
    (transient, wall seconds)."""
    from marlin_tpu_torch import hit
    from marlin_tpu_torch.executioner import run_deck

    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = run_deck(hit.parse(deck), output_dir=out_dir, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return tr, wall


def substep_ms(tr, dt):
    """Device time of one steady-state step of the finished run, a substep."""
    p, st = tr.problem, tr.state
    ms = cuda_ms(lambda: p.step(st, tr.time, dt, dt, False), reps=2, warmup=1)
    return ms / SUBSTEPS


def mass(tr, label):
    rows = tr.csv.rows
    m0, m1 = rows[0]["mean"], rows[-1]["mean"]
    say(f"[{label}] mean(c) {m0:.9f} -> {m1:.9f}, max(c) {tr.pp_values['max']:.6f}")
    assert abs(m1 - m0) <= MASS_TOL, (label, m0, m1)


def counters(uf, sp):
    return {**uf.launches(), **sp.launches()}


def reset(uf, sp):
    uf.reset_launches()
    sp.reset_launches()


def main():
    if not torch.cuda.is_available():
        say("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
        return 1
    sys.path.insert(0, HERE)
    from marlin_tpu_torch import hit
    from marlin_tpu_torch import lbm_fused as lf
    from marlin_tpu_torch import spectral as sp
    from marlin_tpu_torch import unordered_fft as uf
    from marlin_tpu_torch.decks import CH3D_DECK
    from marlin_tpu_torch.problem import TensorProblem

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # -- 0: toolchain ---------------------------------------------------------
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc = run([uf._nvcc(), "--version"]).splitlines()[-1]
    say(f"[toolchain] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, nvcc: {nvcc}")

    # -- 1: build, one nvcc a library, all at once -------------------------------
    # the plan of the fused deck gives the µ of the lanes kernel's read; its
    # library is named by the generated source, the same at every extent
    small = TensorProblem(hit.parse(CH3D_DECK.format(n=16, substeps=2).replace(
        "[Domain]", "[Domain]\n  fft_backend = PALLAS\n  floating_precision = SINGLE"
    ).replace("[TensorSolver]", f"[TensorSolver]\n  {FUSED}")), device=dev)
    pre = sp.match_chain(small.solver).pre
    libs = {"unordered_fft": uf.LIBRARY, "spectral_update": sp.LIBRARY,
            "lbm_substep": lf.LIBRARY, "fwd_lanes_pre (CH3D µ)": pre.library}
    cold = {k: not os.path.exists(lib.path()) for k, lib in libs.items()}

    def timed_build(lib):
        t0 = time.perf_counter()
        lib.build()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        times = dict(zip(libs, pool.map(timed_build, libs.values())))
    for k, lib in libs.items():
        lib.load()
        say(f"[build] {'built' if cold[k] else 'reused'} {k}: "
            f"{os.path.relpath(lib.path(), HERE)} in {times[k]:.2f} s")
    say(f"[build] all libraries in {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(lf.LIBRARY.log, lbm_kernel_name):
        say(f"[build] ptxas {line}")
    for k in ("unordered_fft", "spectral_update", "fwd_lanes_pre (CH3D µ)"):
        for line in ptxas_report(libs[k].log, fft_kernel_namer(uf)):
            say(f"[build] ptxas {k}: {line}")

    # -- 2: kernels against their twins ---------------------------------------
    gen = torch.Generator().manual_seed(0)
    kernels = phase_fft_kernels(uf, dev, gen)
    dom = TensorProblem(hit.parse(CH3D_DECK.format(n=N, substeps=2).replace(
        "[Domain]", "[Domain]\n  fft_backend = PALLAS\n  floating_precision = SINGLE")),
        device=dev).domain
    kernels.update(phase_fused_kernels(uf, sp, dev, gen, pre, sp._k2_tables(dom)))
    del dom
    lbm_rows, mean_rows = phase_lbm_kernel(lf, dev)
    say("[kernels] ok")

    # -- 3: the main path -----------------------------------------------------
    reset(uf, sp)
    tr, wall = run_main_path(ch3d_deck("PALLAS"), dev)
    launches = counters(uf, sp)
    n_sub = STEPS * SUBSTEPS
    # each substep: mubar = fft(mu) and cbar = fft(c), each one lanes and two
    # sublanes launches; c = ifft(ū), two sublanes and one lanes launch
    expected = {"fwd_lanes": 2 * n_sub, "fwd_lanes_pre": 0,
                "fwd_sublanes": 4 * n_sub, "inv_sublanes": 2 * n_sub,
                "inv_lanes": n_sub, "fwd_x_update": 0, "fwd_x_update_poly": 0}
    say(f"[main] PALLAS {N}^3, {STEPS} steps x {SUBSTEPS} substeps: "
        f"run_deck {wall:.2f} s, launches {launches}")
    assert launches == expected, (launches, expected)
    c_pallas = tr.state["buffers"]["c"]
    assert c_pallas.shape == (N, N, N) and c_pallas.dtype == torch.float32
    assert bool(torch.isfinite(c_pallas).all())
    mass(tr, "main")
    say(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ms_pallas = substep_ms(tr, 1.0)
    say(f"[main] PALLAS {ms_pallas:.3f} ms/substep")
    del tr

    # -- 4: the library anchor -------------------------------------------------
    tr_def, wall_def = run_main_path(ch3d_deck("DEFAULT"), dev)
    ms_default = substep_ms(tr_def, 1.0)
    c_default = tr_def.state["buffers"]["c"]
    diff = (c_default - c_pallas).abs().max().item()
    say(f"[anchor] DEFAULT run_deck {wall_def:.2f} s, {ms_default:.3f} ms/substep; "
        f"PALLAS {ms_pallas:.3f} ms/substep; max|c_PALLAS - c_DEFAULT| {diff:.3e} "
        f"(limit {ANCHOR_TOL})")
    assert diff <= ANCHOR_TOL, diff
    del tr_def, c_pallas

    # -- 5: the fused single-field path ----------------------------------------
    reset(uf, sp)
    torch.cuda.reset_peak_memory_stats()
    tr, wall = run_main_path(ch3d_deck("PALLAS", FUSED), dev)
    fused_launches = counters(uf, sp)
    # per step (3-D): the ū seed fft(c), 1 lanes + 2 sublanes; each of the
    # S-1 fused substeps 1 lanes with µ fused + 1 sublanes + 1 fwd_x_update
    # + 2 inverse sublanes + 1 inverse lanes; the trailing regular substep
    # fft(µ), 1 lanes + 2 sublanes, and ifft(ū), 2 sublanes + 1 lanes
    S = SUBSTEPS
    expected = {"fwd_lanes": STEPS * 2, "fwd_lanes_pre": STEPS * (S - 1),
                "fwd_sublanes": STEPS * (2 + (S - 1) + 2),
                "fwd_x_update": STEPS * (S - 1), "fwd_x_update_poly": 0,
                "inv_sublanes": STEPS * 2 * S, "inv_lanes": STEPS * S}
    say(f"[fused] PALLAS fused {N}^3, {STEPS} steps x {S} substeps: run_deck "
        f"{wall:.2f} s, launches {fused_launches}")
    assert fused_launches == expected, (fused_launches, expected)
    c_fused = tr.state["buffers"]["c"]
    assert c_fused.shape == (N, N, N) and bool(torch.isfinite(c_fused).all())
    mass(tr, "fused")
    diff_f = (c_fused - c_default).abs().max().item()
    ms_fused = substep_ms(tr, 1.0)
    say(f"[fused] {ms_fused:.3f} ms/substep (PALLAS {ms_pallas:.3f}, DEFAULT "
        f"{ms_default:.3f}); max|c_fused - c_DEFAULT| {diff_f:.3e} (limit "
        f"{FUSED_ANCHOR_TOL}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    assert diff_f <= FUSED_ANCHOR_TOL, diff_f
    del tr, c_fused, c_default

    # -- 6: the fused N-field path ------------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset(uf, sp)
    tr_m, wall_m = run_main_path(multi_deck(FUSED), dev)
    multi_launches = counters(uf, sp)
    say(f"[multi] fused {N}^3, 2 fields, {STEPS} steps x {S} substeps: run_deck "
        f"{wall_m:.2f} s, launches {multi_launches}")
    assert multi_launches["fwd_x_update_poly"] == STEPS * (S - 1), multi_launches
    assert multi_launches["fwd_x_update"] == multi_launches["fwd_lanes_pre"] == 0
    assert min(multi_launches[k] for k in ("fwd_lanes", "fwd_sublanes",
                                           "inv_sublanes", "inv_lanes")) > 0
    mass(tr_m, "multi")
    ms_multi = substep_ms(tr_m, MULTI_DT)
    fields = {k: tr_m.state["buffers"][k] for k in ("c", "n1")}
    del tr_m
    tr_u, wall_u = run_main_path(multi_deck("carry_reciprocal = true"), dev)
    ms_multi_unfused = substep_ms(tr_u, MULTI_DT)
    for k, v in fields.items():
        assert bool(torch.isfinite(v).all()), k
        d = (v - tr_u.state["buffers"][k]).abs().max().item()
        say(f"[multi] max|{k}_fused - {k}_unfused| {d:.3e} (limit {MULTI_TOL})")
        assert d <= MULTI_TOL, (k, d)
    say(f"[multi] fused {ms_multi:.3f} ms/substep, unfused (carry) "
        f"{ms_multi_unfused:.3f} ms/substep (run_deck {wall_u:.2f} s); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del tr_u, fields

    # -- 7 to 10: the LBM paths ------------------------------------------------
    lbm_launches = 0
    lbm_ms = {}
    for name in LBM_PATHS:
        launched, ms_pallas_lbm, ms_jnp_lbm = phase_lbm_path(name, dev)
        lbm_launches += launched
        lbm_ms[name] = (ms_pallas_lbm, ms_jnp_lbm)
        say(f"[lbm {name}] lbm_substep {lbm_rows[name]['ms']:.3f} ms a launch "
            f"(bound {lbm_rows[name]['bound_ms']:.3f}); ms/substep PALLAS "
            f"{ms_pallas_lbm:.3f}, JNP {ms_jnp_lbm:.3f}")

    # -- 11: the 2-D Kármán path -------------------------------------------------
    karman_launches, ms_pallas_k, ms_jnp_k = phase_karman(dev)
    kname = f"karman {KARMAN[0]}x{KARMAN[1]}"
    lbm_launches += karman_launches["lbm_substep"]
    lbm_ms[kname] = (ms_pallas_k, ms_jnp_k)
    say(f"[karman] lbm_substep {lbm_rows[kname]['ms']:.4f} ms a launch (bound "
        f"{lbm_rows[kname]['bound_ms']:.4f}), lbm_density_mean {mean_rows[0]['ms']:.4f} "
        f"ms a pair (bound {mean_rows[0]['bound_ms']:.4f}); ms/substep PALLAS "
        f"{ms_pallas_k:.4f}, JNP {ms_jnp_k:.4f}")
    lbm = summarise([lbm_rows[name] for name in list(LBM_PATHS) + [kname]])
    lbm["yardstick"] = "the eager JNP substep (run_deck, lbm_backend = JNP)"
    lbm["yardstick_ms"] = sum(jnp for _p, jnp in lbm_ms.values()) / len(lbm_ms)
    # every plan's own row, each at its main extent
    lbm["plans"] = lbm_rows
    kernels["lbm_substep"] = lbm
    kernels["lbm_density_mean"] = summarise(mean_rows[:1])
    kernels["lbm_density_mean"]["plans"] = {f"karman {x}x{y}": row
                                            for (x, y), row in zip(LBM_2D, mean_rows)}
    say(f"[done] {time.perf_counter() - t_start:.1f} s")

    # -- result -----------------------------------------------------------------
    table = [
        ("fwd_lanes", "unordered_fft.cu", "marlin_tpu/pallas_fft.py:237", launches),
        ("inv_lanes", "unordered_fft.cu", "marlin_tpu/pallas_fft.py:276", launches),
        ("fwd_sublanes", "unordered_fft.cu", "marlin_tpu/pallas_fft.py:340", launches),
        ("inv_sublanes", "unordered_fft.cu", "marlin_tpu/pallas_fft.py:355", launches),
        ("fwd_lanes_pre", "fft_tile.cuh", "marlin_tpu/pallas_fft.py:237",
         fused_launches),
        ("fwd_x_update", "spectral_update.cu", "marlin_tpu/pallas_spectral.py:120",
         fused_launches),
        ("fwd_x_update_poly", "spectral_update.cu",
         "marlin_tpu/pallas_spectral.py:203", multi_launches),
        ("lbm_substep", "lbm_substep.cu", "marlin_tpu/pallas_lbm.py:224",
         {"lbm_substep": lbm_launches}),
        ("lbm_density_mean", "lbm_substep.cu", "marlin_tpu/pallas_lbm.py:687",
         karman_launches),
    ]
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"marlin_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": counts[name], **kernels[name]}
        for name, src, replaces, counts in table
    ]}
    say(json.dumps(line))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
