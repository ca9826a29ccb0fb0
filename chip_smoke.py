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
   kernels' shared memory), the LBM substep's flat and brick kernels.  The
   LBM substep library, the slowest to build, builds while phase 2's
   spectral rows and phases 3-6 run; its report and phase 2's LBM rows
   follow phase 6.  A ``[time]`` line closes each group of phases;
2. kernels: each kernel at its 512³ main-path shapes (and at n = 64, 200,
   384) against its plain PyTorch twin, max error ≤ 1e-5 of the twin's
   largest magnitude; kernel, twin, bound and yardstick times, and which
   path (register, small or tile) each FFT shape takes, forward and
   inverse.  The small-extent path (b = n) over SMALL_SWEEP, kernels 1-4,
   and measured at benchmark 1a's 200² shapes, kernels 1-4, 1′ and 5: each
   also within 2.4e-7 of its largest output of the correctly rounded
   transform (torch.fft in complex128 rounded to complex64, the fused
   kernels' update in torch ops), device µs by the profiler beside the
   same-function torch call (or a composite) and the bound.  The LBM
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
   cylinder) and at 33×17 and 1000×333, each with the kernel it takes
   (the flat one; the Kármán plan the plane kernel, with its cooperative
   grid); the Kármán plan's mean density (``lbm_density_mean``, 7′,
   computed inside the plane kernel's launch) against its twin at the
   same extents, its own device time at the main extents taken as the
   plane launch's less the flat kernel's given the mean;
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
   file is needed) at 256³, float32, 10 substeps × 3 steps, through
   ``run_deck`` with ``lbm_backend = PALLAS`` and ``JNP``: exactly 2 × 9
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
   steps, on PALLAS and JNP: exactly 2 × 99 ``lbm_substep`` launches on
   PALLAS, each computing its mean density inside (``lbm_density_mean``
   counts them: no launch of its own), none on JNP; on f, fpc, feq,
   density, velocity and speed max |PALLAS − JNP| ≤ 1e-5 of the JNP
   buffer's largest magnitude; every buffer finite; ms a substep, MLUPS and
   peak device memory on both; then the host's µs a fused substep (the
   fused loop's wrapper, 1000 back-to-back calls at 800×200);
12. benchmark 1a: ``decks.BENCH_1A_DECK`` (the 2-D spinodal decomposition,
   the stand-in for the reference's 1a.i) at 200², 1000 substeps a step,
   through ``run_deck`` to its end (t = 10500, or the Terminator's
   ``change < 1e-4``), four times: DEFAULT (torch.fft) in float64, the
   card's reference, and in float32; PALLAS unfused in float32 (kernels
   1-4 on the small-extent path at n = 200, in every substep and in the
   free-energy group); PALLAS with ``carry_reciprocal`` and
   ``fused_spectral`` in float32 (kernels 1′ with the 1a µ, 5, 4 and 2,
   and kernels 1-4 in the group).  Each after a warm-up of 1 step that
   builds and loads its kernels.  Gates: F(0) against a numpy float64
   evaluation of the same formula (1e-9 relative in float64, 1e-5 in
   float32); the same steps and final t in all four runs; exact launch
   counts (none on DEFAULT); c_integral within 1e-10 (float64) or 1e-5
   (float32) of its start and mass (cbar's k = 0 slot) equal to it within
   the same bound at every step; c finite; each float32 run's F within
   1e-3 of the float64 run's while t ≤ 10, and its final F within 10%.
   Each run's seconds to the finished transient, ms a substep, steps,
   t_final, F_final, peak device memory and perf-graph sections, beside
   the card's name and power limit and the reference's 45 s on an L4.

Then one JSON line with every kernel's numbers (a kernel timed at more
than one main shape also lists each under ``shapes``; ``launches_by_path``
splits ``launches`` by the paths that reached it; the small-extent kernels
stand as their own entries, ``<wrapper> small``, timed at 200² and
launched by phase 12's PALLAS runs) and, last, the JSON result line.  Any failure ends the run with a non-zero exit and no result line.
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
# the small-extent path against torch.fft in complex128 rounded to complex64:
# 2 float32 ulps of the largest output (the kernel's rounding and the
# reference's)
C128_TOL = 2.4e-7
# b = n extents the small-extent kernels are held at: every radix, primes
# above 7, both ends of the range
SMALL_SWEEP = [8, 9, 12, 25, 49, 64, 97, 100, 125, 199, 200, 243, 343, 397, 400]
PATHS = {0: "tile", 1: "register", 2: "small"}
ANCHOR_TOL = 5e-5
FUSED_ANCHOR_TOL = 2e-4
MULTI_TOL = 5e-5
MASS_TOL = 1e-5
FUSED = "carry_reciprocal = true\n  fused_spectral = true"
LBM_N = 256
LBM_SUBSTEPS = 10  # the 3-D LBM decks (phases 7-10); Kármán has its own
LBM_STEPS = 3
LBM_ODD = [(9, 9, 9), (33, 17, 20)]
KARMAN = (800, 200)  # the reference cylinder.i's shipped extent
LBM_2D = [KARMAN, (4096, 2048)]  # the shipped 2-D size, and one above launch cost
LBM_ODD_2D = [(33, 17), (1000, 333)]  # 1000×333: the mean's chunked finish
KARMAN_SUBSTEPS = 100
BENCH_1A_N = 200  # benchmark 1a: 200², 1000 substeps a step, to t = 10500
BENCH_1A_SUBSTEPS = 1000
BENCH_1A_WARM_STEPS = 1  # a step runs every kernel of its run
BENCH_1A_F0_TOL = {torch.float64: 1e-9, torch.float32: 1e-5}  # relative
BENCH_1A_MASS_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}  # relative
BENCH_1A_EARLY = (10.0, 1e-3)  # float32 F within 1e-3 of float64's while t <= 10
BENCH_1A_FINAL_TOL = 0.10  # final F, float32 against float64 (relative)
PFHUB_F0 = 319.03  # PFHub's F(0) of benchmark 1a (prismspf, BASELINE.md:9)
REFERENCE_1A = "45 s and 277 MB on an NVIDIA L4 (the reference's, BASELINE.md:7)"
BENCH_1A_RUNS = {  # run: its route in marlin_tpu_torch.bench_1a_runs.ROUTES
    "DEFAULT float64": "D64", "DEFAULT float32": "D32",
    "PALLAS float32": "P32", "PALLAS fused float32": "F32",
}


def say(*parts):
    print(*parts, flush=True)


def lap(phases, t_start):
    say(f"[time] phase {phases} done at {time.perf_counter() - t_start:.1f} s")


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
    if "path" in rows[0]:  # the small-extent rows
        out["path"] = rows[0]["path"]
        out["c128_rel_err"] = max(r["c128_rel_err"] for r in rows)
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


def fft_path(uf, name, n):
    """The path the library takes for wrapper ``name`` at extent n."""
    lib = uf.LIBRARY.load()
    which = lib.mtt_fwd_path if name.startswith("fwd") else lib.mtt_inv_path
    return PATHS[which(n, uf.base(n))]


class ExactTransforms:
    """Within the block, the plain twins' transforms are torch.fft in
    complex128 rounded once to complex64 (the inverse's real part to
    float32): the correctly rounded DFT of the same input, for extents with
    b = n (natural order).  The fused twins (kernels 1′ and 5) call the
    transform twins, so they give the exact transform and the update in
    torch ops."""
    NAMES = ("fwd_lanes_plain", "inv_lanes_plain", "fwd_sublanes_plain", "inv_sublanes_plain")

    def __init__(self, uf):
        self.uf = uf

    @staticmethod
    def fwd(x, dim):
        return torch.fft.fft(x.to(torch.complex128), dim=dim).to(torch.complex64)

    @staticmethod
    def inv(x, dim, real_output=False):
        y = torch.fft.ifft(x.to(torch.complex128), dim=dim)
        return y.real.to(torch.float32) if real_output else y.to(torch.complex64)

    def __enter__(self):
        self.saved = {k: getattr(self.uf, k) for k in self.NAMES}
        self.uf.fwd_lanes_plain = lambda x: self.fwd(x, -1)
        self.uf.inv_lanes_plain = lambda x, real_output=True: self.inv(x, -1, real_output)
        self.uf.fwd_sublanes_plain = lambda x: self.fwd(x, 1)
        self.uf.inv_sublanes_plain = lambda x: self.inv(x, 1)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.uf, k, v)


def check_c128(name, shape, got, exact):
    """max |got − exact| against C128_TOL of exact's largest magnitude, over
    every output; returns the error relative to that magnitude."""
    got = got if isinstance(got, tuple) else (got,)
    exact = exact if isinstance(exact, tuple) else (exact,)
    rel = 0.0
    for g, e in zip(got, exact):
        r = (g - e).abs().max().item() / e.abs().max().item()
        assert r <= C128_TOL, (name, shape, "complex128", r)
        rel = max(rel, r)
    return rel


def measure_1a(uf, name, path, shape, kernel, twin, library, n_bytes, flops,
               yardstick=None):
    """One row at benchmark 1a's 200² shapes: the kernel against its twin
    (KERNEL_TOL) and against the correctly rounded transform (C128_TOL),
    then device ms a call by the profiler of the kernel, the twin and the
    same-function torch call (``library``, (label, call)) or the composite
    ``yardstick`` (label, call), and the bound."""
    got = kernel()
    torch.cuda.synchronize()
    err = check(name, shape, got, twin())
    with ExactTransforms(uf):
        rel = check_c128(name, shape, got, twin())
    del got
    ms, plain = device_ms(kernel), device_ms(twin)
    lib = None if library is None else device_ms(library[1])
    bnd, by = bound_ms(n_bytes, flops)
    row = {"shape": list(shape), "path": path, "max_abs_err": err, "c128_rel_err": rel,
           "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bnd, "bound_by": by}
    text = (f"[kernels] {name} {tuple(shape)}: {path} path, max_abs_err {err:.3e} "
            f"(twin), {rel:.3e} of the largest output (complex128 rounded, limit "
            f"{C128_TOL}); device us: kernel {1e3 * ms:.2f}, twin {1e3 * plain:.2f}, "
            f"bound {1e3 * bnd:.3f} ({by})")
    if lib is not None:
        text += f", {library[0]} {1e3 * lib:.2f}"
    if yardstick is not None:
        label, fn = yardstick
        row["yardstick"] = label
        row["yardstick_ms"] = device_ms(fn)
        text += f", {label} {1e3 * row['yardstick_ms']:.2f}"
    say(text)
    torch.cuda.empty_cache()
    return row


def phase_small_sweep(uf, dev, gen):
    """The small-extent kernels over SMALL_SWEEP, forward and inverse, lanes
    and sublanes, against their twins and the correctly rounded transform;
    each must take the small path."""
    shapes = {"fwd_lanes": ((64, None), torch.float32),
              "inv_lanes": ((64, None), torch.complex64),
              "fwd_sublanes": ((2, None, 64), torch.complex64),
              "inv_sublanes": ((2, None, 64), torch.complex64)}
    for name, (shape_of, dtype) in shapes.items():
        kernel, errs = getattr(uf, name), []
        for n in SMALL_SWEEP:
            path = fft_path(uf, name, n)
            assert path == "small" == uf.path(n), (name, n, path)
            shape = tuple(n if d is None else d for d in shape_of)
            x = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
            got = kernel(x)
            torch.cuda.synchronize()
            err = check(name, shape, got, getattr(uf, name + "_plain")(x))
            with ExactTransforms(uf):
                rel = check_c128(name, shape, got, getattr(uf, name + "_plain")(x))
            errs.append(f"{n}: {err:.1e} / {rel:.1e}")
        say(f"[kernels] {name} small path at n = {SMALL_SWEEP[0]}..{SMALL_SWEEP[-1]} "
            f"(max_abs_err against the twin / against complex128, relative): "
            + ", ".join(errs))


def phase_fft_kernels(uf, dev, gen):
    """Kernels 1-4 against their twins; the small-extent path over its sweep
    and, measured, at benchmark 1a's shapes."""
    def make(shape, dtype):
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev)

    plane = N * N
    main_shapes = {
        "fwd_lanes": [((plane, N), torch.float32)],
        "inv_lanes": [((plane, N), torch.complex64)],
        "fwd_sublanes": [((1, N, plane), torch.complex64),
                         ((N, N, N), torch.complex64)],
        "inv_sublanes": [((1, N, plane), torch.complex64),
                         ((N, N, N), torch.complex64)],
    }
    a = BENCH_1A_N  # benchmark 1a's shapes: lanes (200, 200), sublanes (1, 200, 200)
    small = {
        "fwd_lanes": [((4096, n), torch.float32) for n in (64, 200, 384)],
        "inv_lanes": [((4096, n), torch.complex64) for n in (64, 200, 384)],
        "fwd_sublanes": [((8, n, 300), torch.float32) for n in (64, 200, 384)],
        "inv_sublanes": [((8, n, 300), torch.complex64) for n in (64, 200, 384)],
    }
    shapes_1a = {"fwd_lanes": ((a, a), torch.float32),
                 "inv_lanes": ((a, a), torch.complex64),
                 "fwd_sublanes": ((1, a, a), torch.complex64),
                 "inv_sublanes": ((1, a, a), torch.complex64)}
    library = {
        "fwd_lanes": lambda x: torch.fft.fft(x, dim=-1),
        "inv_lanes": lambda x: torch.fft.ifft(x, dim=-1),
        "fwd_sublanes": lambda x: torch.fft.fft(x, dim=1),
        "inv_sublanes": lambda x: torch.fft.ifft(x, dim=1),
    }
    # the same function as one torch call at 1a's shapes (kernel 2's takes
    # .real, a view: one device kernel)
    labels_1a = {"fwd_lanes": "torch.fft.fft(x, -1)", "inv_lanes": "torch.fft.ifft(x, -1).real",
                 "fwd_sublanes": "torch.fft.fft(x, 1)", "inv_sublanes": "torch.fft.ifft(x, 1)"}
    results = {}
    phase_small_sweep(uf, dev, gen)
    for name in main_shapes:
        kernel = getattr(uf, name)
        twin = getattr(uf, name + "_plain")
        for shape, dtype in small[name]:
            x = make(shape, dtype)
            got = kernel(x)
            torch.cuda.synchronize()
            err = check(name, shape, got, twin(x))
            n = shape[1] if "sub" in name else shape[-1]
            say(f"[kernels] {name} {tuple(shape)} {str(dtype)[6:]}: "
                f"{fft_path(uf, name, n)} path, max_abs_err {err:.3e}")
        shape, dtype = shapes_1a[name]
        x = make(shape, dtype)
        call = library[name]
        same = (lambda: call(x).real) if name == "inv_lanes" else (lambda: call(x))
        out_bytes = x.numel() * (4 if name == "inv_lanes" else 8)
        results[name + " small"] = summarise([measure_1a(
            uf, name, fft_path(uf, name, a), shape, lambda: kernel(x),
            lambda: getattr(uf, name + "_plain")(x),
            (labels_1a[name], same),
            nbytes(x) + out_bytes + uf.small_plan_bytes(a), fft_flops(x.numel() // a, a))])
        del x
        rows = []
        for shape, dtype in main_shapes[name]:
            x = make(shape, dtype)
            n = shape[1] if "sub" in name else shape[-1]
            out_bytes = x.numel() * (4 if name == "inv_lanes" else 8)
            path = fft_path(uf, name, n)
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
        return shift + scale * torch.randn(shape, generator=gen, dtype=dtype, device=dev)

    results = {}
    # -- kernel 1 with the fused µ read: c-like values around 0.5
    pre_ops = pre.expr.cuda_source(pre.var).count("\n")  # one flop a statement
    a = BENCH_1A_N  # and benchmark 1a's (200, 200), the same µ in 2-D
    for shape in [(4096, n) for n in (64, 200, 384)]:
        x = make(shape, torch.float32, 0.05, 0.5)
        err = check("fwd_lanes_pre", shape, uf.fwd_lanes(x, pre=pre),
                    uf.fwd_lanes_plain(pre(x)))
        say(f"[kernels] fwd_lanes_pre {shape} float32: max_abs_err {err:.3e}")
    x = make((a, a), torch.float32, 0.05, 0.5)
    results["fwd_lanes_pre small"] = summarise([measure_1a(
        uf, "fwd_lanes_pre", fft_path(uf, "fwd_lanes", a), x.shape,
        lambda: uf.fwd_lanes(x, pre=pre), lambda: uf.fwd_lanes_plain(pre(x)), None,
        nbytes(x) + 2 * nbytes(x) + uf.small_plan_bytes(a),
        fft_flops(a, a) + pre_ops * x.numel(),
        ("composite µ (torch ops) + torch.fft.fft", lambda: torch.fft.fft(pre(x), dim=-1)))])
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

    rows_1a = []
    for form, (mobility, lin) in forms.items():
        for n, L in [(64, 300), (200, 300), (384, 300)]:
            m, u, o = (make((n, L), torch.complex64) for _ in range(3))
            kx2, kyz2 = tables(n, L)
            err = check("fwd_x_update", (n, L),
                        sp.fwd_x_update(m, u, o, kx2, kyz2, *args, mobility, lin),
                        sp.fwd_x_update_plain(m, u, o, kx2, kyz2, *args, mobility, lin))
            say(f"[kernels] fwd_x_update {form} ({n}, {L}): max_abs_err {err:.3e}")
        # (200, 200): benchmark 1a's update, measured
        m, u, o = (make((a, a), torch.complex64) for _ in range(3))
        kx2a, kyz2a = tables(a, a)
        rows_1a.append(measure_1a(
            uf, f"fwd_x_update {form}", fft_path(uf, "fwd_sublanes", a), m.shape,
            lambda: sp.fwd_x_update(m, u, o, kx2a, kyz2a, *args, mobility, lin),
            lambda: sp.fwd_x_update_plain(m, u, o, kx2a, kyz2a, *args, mobility, lin),
            None, 5 * nbytes(m) + nbytes(kx2a, kyz2a) + uf.small_plan_bytes(a),
            fft_flops(a, a) + 25 * m.numel(),
            ("composite torch.fft.fft(dim=0) + update (torch ops)",
             lambda: composite(m, u, o, kx2a, kyz2a, mobility, lin))))
        del m, u, o
    results["fwd_x_update small"] = summarise(rows_1a)
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


FFT_KERNEL = re.compile(
    r"(reg_lanes|reg_sublanes|small_lanes|small_sublanes|tile_lanes|tile_sublanes)_kernel")
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
        if not kind.startswith("reg"):  # its shared memory goes by extent
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
            step = lf.substepper(fpc, media, cfg, gpc)  # the fused loop's wrapper
            kernel = lambda: step(fpc, gpc)
            twin = lambda: lf.fused_substep_twin(fpc, media, cfg, gpc)
            cells = math.prod(shape)
            lattices = 2 if cfg.two_lattice else 1
            n_bytes = (2 * lattices * nbytes(fpc) + cells * 4
                       + (cells if media is not None else 0))
            if cfg.smag is not None:
                mean_rows += lbm_mean_check(lf, fpc, media, cfg, shape, shape in main)
            if shape not in main:
                err = check(f"lbm_substep {name}", shape, kernel(), twin())
                say(f"[kernels] lbm_substep {name} {shape}: max_abs_err {err:.3e}")
                continue
            say(f"[kernels] lbm_substep {name} {shape}: {walk_text(lf, cfg, fpc.dtype)}")
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


def walk_text(lf, cfg, dtype):
    """The kernel a plan takes and its walk."""
    walk = lf.walk_plan(cfg, dtype, torch.cuda.get_device_properties(0).multi_processor_count)
    if walk is None:
        return "flat kernel"
    if isinstance(walk, lf.PlanePlan):
        return (f"plane kernel, cooperative grid of {walk.grid} x {walk.threads} threads, "
                f"{min(cfg.nx * cfg.ny, walk.grid * walk.threads)} of {cfg.nx * cfg.ny} cells "
                f"held across the mean")
    return (f"brick kernel, by {walk.by}, {walk.stages} stages, {walk.threads} threads, "
            f"{walk.smem} B shared memory")


def lbm_mean_check(lf, fpc, media, cfg, shape, timed):
    """The Smagorinsky plan's mean density, computed inside the plane
    kernel's launch (7′: no launch of its own), against its twin, as the
    kernel's check: ≤ 1e-5 of the twin's magnitude.  On a main extent also
    its own device time, measured as a difference: the plane kernel's launch
    (the substep with its mean) less the flat kernel's launch of the same
    substep given the twin's mean, in turn (plane, flat, flat, plane); the
    twin's mean alone as the plain time, also by device time; the bound of
    its own work (each cell's q values and media byte read once, its q
    additions)."""
    plane = lf.substepper(fpc, media, cfg)  # the fused loop's wrapper
    _plan, avec = lf._kernel_args(fpc, media, cfg, None, "chip_smoke")
    flat = lf.plan_stepper(fpc, media, cfg, None, lf.pack(cfg), avec)

    def kernel():
        mean = torch.full((), float("nan"), dtype=fpc.dtype, device=fpc.device)
        plane(fpc, None, mean)
        return mean

    twin = lambda: lf.density_mean_twin(fpc, media, cfg)
    err = check("lbm_density_mean", shape, kernel(), twin())
    if not timed:
        say(f"[kernels] lbm_density_mean {shape} (inside lbm_substep): max_abs_err {err:.3e}")
        return []
    given = twin()
    with_mean, without = [], []
    for order in (0, 1):
        runs = [(with_mean, lambda: plane(fpc)), (without, lambda: flat(fpc, None, given))]
        for times, fn in (runs if order == 0 else runs[::-1]):
            times.append(device_ms(fn))
    ms = sum(with_mean) / 2 - sum(without) / 2
    plain = device_ms(twin)
    cells = math.prod(shape)
    n_bytes = cells * (cfg.q * fpc.element_size() + (media is not None))
    bnd, by = bound_ms(n_bytes, cells * cfg.q, F32_NO_FMA_FLOP_PER_S)
    say(f"[kernels] lbm_density_mean {shape} (inside lbm_substep): max_abs_err {err:.3e}, "
        f"device ms: plane launch {sum(with_mean) / 2:.4f} less flat launch given the mean "
        f"{sum(without) / 2:.4f} = {ms:.4f}, twin {plain:.4f}, bound {bnd:.4f} ({by})")
    torch.cuda.empty_cache()
    return [{"shape": list(shape), "max_abs_err": err, "ms": ms, "plain_ms": plain,
             "library_ms": None, "bound_ms": bnd, "bound_by": by,
             "plane_launch_ms": sum(with_mean) / 2, "flat_launch_ms": sum(without) / 2}]


def device_ms(fn, calls=20):
    """Device ms a call: the time of the kernels ``fn`` launches, by
    torch.profiler over ``calls`` calls (at 800×200 the host cannot keep
    the card busy, so CUDA events would time the host)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    assert us > 0, "the profiler saw no device time"
    return us / calls / 1e3


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
        # one launch a fused substep, its mean density inside it
        want = ({"lbm_substep": fused, "lbm_density_mean": fused} if backend == "PALLAS"
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


HOST_CALLS = 1000


def karman_host_us(lf, dev):
    """The host's µs a fused Kármán substep at 800×200: the fused loop's
    wrapper (``substepper``'s step), HOST_CALLS back-to-back calls with one
    sync, over HOST_CALLS (the device's time a substep is well below it)."""
    import dataclasses

    from marlin_tpu_torch.decks import karman_media
    from marlin_tpu_torch.lbm_probe import deck_plans

    cfg = dataclasses.replace(deck_plans()["karman"], nx=KARMAN[0], ny=KARMAN[1])
    gen = torch.Generator(device=dev).manual_seed(2)
    media = torch.as_tensor(karman_media(*KARMAN), device=dev)[..., None].to(torch.int8)
    fpc = torch.where(media == 0, 0.0, lbm_rand(cfg, KARMAN + (1,), gen, dev)).contiguous()
    step = lf.substepper(fpc, media, cfg)
    step(fpc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        step(fpc)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / HOST_CALLS


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


# -- benchmark 1a ------------------------------------------------------------------


def bench_1a_deck(run, warm=False):
    """decks.BENCH_1A_DECK at 200², 1000 substeps a step, for one of
    BENCH_1A_RUNS; the warm-up is BENCH_1A_WARM_STEPS steps without the perf
    graph."""
    from marlin_tpu_torch.bench_1a_runs import deck_text

    deck = deck_text(BENCH_1A_RUNS[run], BENCH_1A_N, BENCH_1A_SUBSTEPS)
    if warm:
        deck = deck.replace("  perf_graph = true\n", "").replace(
            "  end_time = 10500\n",
            f"  end_time = 10500\n  num_steps = {BENCH_1A_WARM_STEPS}\n")
    return deck


def bench_1a_launches(run, steps, substeps):
    """Each kernel's launches in a 2-D 1a run of ``steps`` steps: the solve
    chain's every substep, and the postprocess group (FFTGradientSquare of
    c: one forward transform, lanes then sublanes, and two inverse ones,
    sublanes then lanes) at INITIAL and every TIMESTEP_END."""
    zero = {"fwd_lanes": 0, "fwd_lanes_pre": 0, "fwd_sublanes": 0, "inv_sublanes": 0,
            "inv_lanes": 0, "fwd_x_update": 0, "fwd_x_update_poly": 0}
    if not run.startswith("PALLAS"):
        return zero
    S, groups = substeps, steps + 1
    if "fused" in run:
        # a step: the ū seed fft(c); S - 1 fused substeps, each µ fused into
        # the lanes read, the x axis with the update, and ifft(ū); the
        # trailing regular substep fft(µ) and ifft(ū) (fft(c) is pruned)
        solve = {"fwd_lanes": 2, "fwd_lanes_pre": S - 1, "fwd_sublanes": 2,
                 "fwd_x_update": S - 1, "inv_sublanes": S, "inv_lanes": S}
    else:
        # a substep: fft(µ) and fft(c), then ifft(ū)
        solve = {"fwd_lanes": 2 * S, "fwd_sublanes": 2 * S,
                 "inv_sublanes": S, "inv_lanes": S}
    group = {"fwd_lanes": 1, "fwd_sublanes": 1, "inv_sublanes": 2, "inv_lanes": 2}
    return {k: steps * solve.get(k, 0) + groups * group.get(k, 0) for k in zero}


def free_energy_numpy(n, full_spectrum):
    """F(0) of the 1a deck on its n² grid (h = 1), independent of both
    packages: the initial condition in numpy float64, its gradient by the
    periodic spectral derivative, f = 5(c−0.3)²(0.7−c)² + |∇c|² summed over
    the cells.  The initial condition is not periodic on the box, so the
    Nyquist frequencies carry weight and each backend's convention is
    followed: DEFAULT the reference's half spectrum along the last axis
    (numpy's rfft2, that axis' Nyquist positive), PALLAS the full spectrum
    (``full_spectrum``: numpy's fft2, the real part; every Nyquist
    negative).  At 200² the two differ by 1.2e-6 of F(0)."""
    x = np.arange(n) + 0.5
    X, Y = np.meshgrid(x, x, indexing="ij")
    c = 0.5 + 0.01 * (np.cos(0.105 * X) * np.cos(0.11 * Y)
                      + (np.cos(0.13 * X) * np.cos(0.087 * Y)) ** 2
                      + np.cos(0.025 * X - 0.15 * Y) * np.cos(0.07 * X - 0.02 * Y))
    kx = 2 * np.pi * np.fft.fftfreq(n, d=1.0)[:, None]
    if full_spectrum:
        ky = kx.T
        ch = np.fft.fft2(c)
        gx, gy = (np.fft.ifft2(1j * k * ch).real for k in (kx, ky))
    else:
        ky = 2 * np.pi * np.fft.rfftfreq(n, d=1.0)[None, :]
        ch = np.fft.rfft2(c)
        gx, gy = (np.fft.irfft2(1j * k * ch, s=(n, n)) for k in (kx, ky))
    return float(np.sum(5 * (c - 0.3) ** 2 * (0.7 - c) ** 2 + gx ** 2 + gy ** 2))


def phase_bench_1a(uf, sp, dev, smi):
    """Benchmark 1a whole, four times (BENCH_1A_RUNS), each after a warm-up
    of BENCH_1A_WARM_STEPS steps that builds and loads its kernels; the
    gates of each run, then across runs.  Returns {run: launches}."""
    from marlin_tpu_torch import hit
    from marlin_tpu_torch.executioner import run_deck

    f0_refs = {full: free_energy_numpy(BENCH_1A_N, full) for full in (False, True)}
    say(f"[1a] F(0) by numpy float64 {f0_refs[False]:.9f} (half spectrum, DEFAULT), "
        f"{f0_refs[True]:.9f} (full spectrum, PALLAS); PFHub, prismspf: {PFHUB_F0} "
        f"(information only)")
    out = {}
    for run in BENCH_1A_RUNS:
        with tempfile.TemporaryDirectory() as out_dir:
            run_deck(hit.parse(bench_1a_deck(run, warm=True)), output_dir=out_dir,
                     device=dev)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            reset(uf, sp)
            t0 = time.perf_counter()
            tr = run_deck(hit.parse(bench_1a_deck(run)), output_dir=out_dir, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched = counters(uf, sp)
        rows = tr.csv.rows
        c = tr.state["buffers"]["c"]
        dtype = tr.problem.domain.dtype
        sub = tr.step_count * BENCH_1A_SUBSTEPS
        peak = torch.cuda.max_memory_allocated()
        say(f"[1a] {run}: {wall:.3f} s to t = {tr.time} ({tr.step_count} steps x "
            f"{BENCH_1A_SUBSTEPS} substeps), {1e3 * wall / sub:.5f} ms a substep, "
            f"F_final {rows[-1]['F']:.9f}, peak device memory {peak / 2**20:.1f} MiB "
            f"({held / 2**20:.1f} MiB held before the run); {smi}; beside "
            f"{REFERENCE_1A}")
        say(f"[1a] {run} perf graph: " + ", ".join(
            f"{name} {secs:.3f} s x{calls}" for name, (secs, calls)
            in sorted(tr.perf.sections.items(), key=lambda kv: -kv[1][0])))
        # -- the gates of one run
        want = bench_1a_launches(run, tr.step_count, BENCH_1A_SUBSTEPS)
        say(f"[1a] {run} launches {launched} (expected {want})")
        assert launched == want, (run, launched, want)
        assert c.shape == (BENCH_1A_N,) * 2 and c.dtype == dtype
        assert bool(torch.isfinite(c).all()), run
        f0, f0_ref = rows[0]["F"], f0_refs[run.startswith("PALLAS")]
        say(f"[1a] {run} F(0) {f0:.9f}, relative to numpy "
            f"{abs(f0 - f0_ref) / f0_ref:.3e} (limit {BENCH_1A_F0_TOL[dtype]})")
        assert abs(f0 - f0_ref) <= BENCH_1A_F0_TOL[dtype] * f0_ref, (run, f0, f0_ref)
        m0, tol = rows[0]["c_integral"], BENCH_1A_MASS_TOL[dtype]
        drift = max(abs(r["c_integral"] - m0) for r in rows) / m0
        slot = max(abs(r["mass"] - r["c_integral"]) for r in rows[1:]) / m0
        say(f"[1a] {run} c_integral drift {drift:.3e}, |mass - c_integral| {slot:.3e} "
            f"(relative, limit {tol}); c in [{rows[-1]['c_min']:.6f}, "
            f"{rows[-1]['c_max']:.6f}], last change {rows[-1]['change']:.3e}")
        assert drift <= tol and slot <= tol, (run, drift, slot)
        out[run] = (tr.step_count, tr.time, [(r["time"], r["F"]) for r in rows],
                    launched, wall)
        del tr, c
    # -- across runs: the float64 DEFAULT run is the reference
    steps, t_end, ref, _l, _w = out["DEFAULT float64"]
    f_ref = dict(ref)
    t_early, early_tol = BENCH_1A_EARLY
    for run, (n, t, series, _l, _w) in out.items():
        assert (n, t) == (steps, t_end), (run, n, t, steps, t_end)
        if run == "DEFAULT float64":
            continue
        early = max(abs(F - f_ref[tt]) / f_ref[tt] for tt, F in series if tt <= t_early)
        final = abs(series[-1][1] - ref[-1][1]) / ref[-1][1]
        say(f"[1a] {run} against DEFAULT float64: F while t <= {t_early} within "
            f"{early:.3e} (limit {early_tol}), final F {final:.3e} (limit "
            f"{BENCH_1A_FINAL_TOL})")
        assert early <= early_tol and final <= BENCH_1A_FINAL_TOL, (run, early, final)
    say(f"[1a] every run {steps} steps to t = {t_end}; {smi}")
    return {run: v[3] for run, v in out.items()}


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
            "lbm_substep": lf.LIBRARY, "fwd_lanes_pre (Cahn-Hilliard µ)": pre.library}
    cold = {k: not os.path.exists(lib.path()) for k, lib in libs.items()}

    def timed_build(lib):
        t0 = time.perf_counter()
        lib.build()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    # the LBM substep library takes the longest: the spectral phases (2's FFT
    # rows, 3-6) run while it builds, and its rows of phase 2 wait for it
    pool = concurrent.futures.ThreadPoolExecutor(len(libs))
    builds = {k: pool.submit(timed_build, lib) for k, lib in libs.items()}

    def loaded(keys):
        for k in keys:
            seconds = builds[k].result()
            libs[k].load()
            say(f"[build] {'built' if cold[k] else 'reused'} {k}: "
                f"{os.path.relpath(libs[k].path(), HERE)} in {seconds:.2f} s")

    spectral = ("unordered_fft", "spectral_update", "fwd_lanes_pre (Cahn-Hilliard µ)")
    loaded(spectral)
    for k in spectral:
        for line in ptxas_report(libs[k].log, fft_kernel_namer(uf)):
            say(f"[build] ptxas {k}: {line}")
    lap("1 (spectral libraries)", t_start)

    # -- 2: kernels against their twins (the FFT and k-space update rows) --------
    # inputs drawn on the card: a 512³ complex draw takes seconds on the host
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = phase_fft_kernels(uf, dev, gen)
    dom = TensorProblem(hit.parse(CH3D_DECK.format(n=N, substeps=2).replace(
        "[Domain]", "[Domain]\n  fft_backend = PALLAS\n  floating_precision = SINGLE")),
        device=dev).domain
    kernels.update(phase_fused_kernels(uf, sp, dev, gen, pre, sp._k2_tables(dom)))
    del dom
    lap("2 (spectral kernels)", t_start)

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
    lap("3-6 (3-D spectral paths)", t_start)

    # -- 1 and 2, the rest: the LBM substep library and its kernel rows -----------
    loaded(["lbm_substep"])
    pool.shutdown()
    say(f"[build] all libraries in {time.perf_counter() - t0:.2f} s (the spectral "
        f"phases ran meanwhile)")
    for line in ptxas_report(lf.LIBRARY.log, lbm_kernel_name):
        say(f"[build] ptxas {line}")
    lbm_rows, mean_rows = phase_lbm_kernel(lf, dev)
    say("[kernels] ok")
    lap("2 (LBM kernels)", t_start)

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
    say(f"[karman] lbm_substep {lbm_rows[kname]['ms']:.4f} ms a launch, its mean density "
        f"inside (bound {lbm_rows[kname]['bound_ms']:.4f}); ms/substep PALLAS "
        f"{ms_pallas_k:.4f}, JNP {ms_jnp_k:.4f}")
    host_us = karman_host_us(lf, dev)
    say(f"[karman] host {host_us:.2f} us a fused substep at {KARMAN[0]}x{KARMAN[1]} (the fused "
        f"loop's wrapper, {HOST_CALLS} back-to-back calls, one sync)")
    lbm = summarise([lbm_rows[name] for name in list(LBM_PATHS) + [kname]])
    lbm["yardstick"] = "the eager JNP substep (run_deck, lbm_backend = JNP)"
    lbm["yardstick_ms"] = sum(jnp for _p, jnp in lbm_ms.values()) / len(lbm_ms)
    # every plan's own row, each at its main extent
    lbm["plans"] = lbm_rows
    kernels["lbm_substep"] = lbm
    kernels["lbm_density_mean"] = summarise(mean_rows[:1])
    kernels["lbm_density_mean"]["plans"] = {f"karman {x}x{y}": row
                                            for (x, y), row in zip(LBM_2D, mean_rows)}
    kernels["lbm_density_mean"]["note"] = (
        "no launch of its own: launches counts the lbm_substep launches that computed the "
        "mean inside; ms is that launch's device time less the flat lbm_substep launch "
        "given the mean; plain_ms is density_mean_twin's device time")

    lap("7-11 (LBM paths)", t_start)

    # -- 12: benchmark 1a, the 200² spinodal decomposition whole --------------------
    launches_1a = phase_bench_1a(uf, sp, dev, smi)
    lap("12 (benchmark 1a)", t_start)
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
    # the small-extent kernels, timed at benchmark 1a's 200²: their launches
    # are those of the 1a runs (every transform there is at n = 200)
    paths_1a = {f"1a {run}": counts for run, counts in launches_1a.items()
                if run.startswith("PALLAS")}
    table_small = [
        ("fwd_lanes", "small_lanes_kernel<Identity, Store>", "marlin_tpu/pallas_fft.py:237"),
        ("inv_lanes", "small_lanes_kernel<Identity, InvStore>", "marlin_tpu/pallas_fft.py:276"),
        ("fwd_sublanes", "small_sublanes_kernel<Store>", "marlin_tpu/pallas_fft.py:340"),
        ("inv_sublanes", "small_sublanes_kernel<InvStore>", "marlin_tpu/pallas_fft.py:355"),
        ("fwd_lanes_pre", "small_lanes_kernel<Pre, Store>", "marlin_tpu/pallas_fft.py:237"),
        ("fwd_x_update", "small_sublanes_kernel<Update>", "marlin_tpu/pallas_spectral.py:120"),
    ]

    def entry(name, src, replaces, counts):
        return {"name": name, "route": "cuda",
                "source": f"marlin_tpu_torch/csrc/{src}", "replaces": replaces,
                "launches": counts[name], "launches_by_path": {"main": counts[name]},
                **kernels[name]}

    def entry_small(name, kernel, replaces):
        by_path = {k: v[name] for k, v in paths_1a.items() if v[name]}
        return {"name": f"{name} small", "kernel": kernel, "route": "cuda",
                "source": "marlin_tpu_torch/csrc/fft_tile.cuh", "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                **kernels[f"{name} small"]}

    line = {"kernels": [entry(*row) for row in table]
            + [entry_small(*row) for row in table_small]}
    for k in line["kernels"]:
        assert k["launches"] > 0, (k["name"], k["launches_by_path"])
    say(json.dumps(line))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
