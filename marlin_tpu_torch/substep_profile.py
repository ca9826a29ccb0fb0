"""Where the time of a Cahn-Hilliard or lattice Boltzmann step goes on the
card.

    python -m marlin_tpu_torch.substep_profile [--backend PALLAS|DEFAULT]
        [--deck ch3d|multi3d|porous|mixed|thermal|pebbles|karman] [--carry]
        [--fused] [--lbm-backend PALLAS|JNP]

Builds ``decks.CH3D_DECK`` (or the two-field ``decks.MULTI_3D_DECK``, dt =
0.05) at 512³ (10 substeps a step) in float32 on the card, with
``carry_reciprocal`` (``--carry``) or ``carry_reciprocal`` and
``fused_spectral`` (``--fused``, PALLAS only); or ``decks.POROUS_DECK``
(through ``decks.porous_media``), ``decks.MIXED_DECK``, the thermal
``decks.THERMAL3D_DECK`` or ``decks.PEBBLES_DECK`` (through
``decks.porous_media``) at 256³ (20 substeps a step), or the 2-D
``decks.KARMAN_DECK`` (through ``decks.karman_media``) at its shipped
800×200 (100 substeps a step), with ``lbm_backend`` from
``--lbm-backend``.  Times
problem construction and ``init_state``, warms up with one step (two for
LBM, whose first step runs no substeps), then traces one more step with
``torch.profiler``: device time by kernel name, split into the hand
kernels and the rest, the step's wall time and the share of it in which
the device ran no kernel.  On ``lbm_backend = PALLAS`` it then traces the
fused loop alone (the substeps but the last of one step) and counts its
kernel launches by name and its host-to-device copies.  Prints one line
per finding; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import hit
from .decks import (CH3D_DECK, KARMAN_DECK, MIXED_DECK, MULTI_3D_DECK, PEBBLES_DECK,
                    POROUS_DECK, THERMAL3D_DECK, karman_media, porous_media)
from .problem import TensorProblem

N = 512
SUBSTEPS = 10
LBM_N = 256
LBM_SUBSTEPS = 20
KARMAN = (800, 200)
KARMAN_SUBSTEPS = 100
TOP = 12
LBM_KERNELS = ("lbm_substep_kernel", "lbm_brick_kernel", "lbm_plane_kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="marlin_tpu_torch.substep_profile")
    ap.add_argument("--backend", default="PALLAS", choices=["PALLAS", "DEFAULT"])
    ap.add_argument("--deck", default="ch3d",
                    choices=["ch3d", "multi3d", "porous", "mixed", "thermal",
                             "pebbles", "karman"])
    ap.add_argument("--carry", action="store_true")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--lbm-backend", default="PALLAS", choices=["PALLAS", "JNP"])
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("substep_profile: needs a CUDA card", file=sys.stderr)
        return 1
    solver = ("carry_reciprocal = true\n  fused_spectral = true" if ns.fused
              else "carry_reciprocal = true" if ns.carry else "")
    domain = f"fft_backend = {ns.backend}\n  floating_precision = SINGLE"
    arrays, n, substeps, warm = None, N, SUBSTEPS, 1
    extent = None
    if ns.deck == "karman":
        dt, substeps, warm = 1.0, KARMAN_SUBSTEPS, 2
        extent = f"{KARMAN[0]}x{KARMAN[1]}"
        deck = KARMAN_DECK.format(nx=KARMAN[0], ny=KARMAN[1], substeps=substeps,
                                  backend=ns.lbm_backend).replace(
            "[Domain]", "[Domain]\n  floating_precision = SINGLE")
        arrays = {"binary_media": karman_media(*KARMAN)}
    elif ns.deck in ("porous", "mixed", "thermal", "pebbles"):
        dt, n, substeps, warm = 1.0, LBM_N, LBM_SUBSTEPS, 2
        fmt = dict(substeps=substeps, backend=ns.lbm_backend)
        if ns.deck == "porous":
            deck = POROUS_DECK.format(n=n, media_h5="media.h5", **fmt)
            arrays = {"media": porous_media(n)}
        elif ns.deck == "mixed":
            deck = MIXED_DECK.format(n=n, **fmt)
        elif ns.deck == "thermal":
            deck = THERMAL3D_DECK.format(n=n, **fmt)
        else:
            deck = PEBBLES_DECK.format(nx=n, ny=n, nz=n, media_h5="media.h5", **fmt)
            arrays = {"media": porous_media(n)}
        deck = deck.replace("[Domain]", "[Domain]\n  floating_precision = SINGLE")
    elif ns.deck == "ch3d":
        dt = 1.0
        deck = CH3D_DECK.format(n=N, substeps=SUBSTEPS).replace(
            "[Domain]", f"[Domain]\n  {domain}").replace(
            "[TensorSolver]", f"[TensorSolver]\n  {solver}")
    else:
        dt = 0.05
        deck = MULTI_3D_DECK.format(n=N, domain_extra=domain,
                                    solver_extra=solver).replace(
            "substeps = 5", f"substeps = {SUBSTEPS}")

    t0 = time.perf_counter()
    problem = TensorProblem(hit.parse(deck), device="cuda", arrays=arrays)
    t1 = time.perf_counter()
    state = problem.init_state()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if problem.is_lbm:
        label = f"{ns.deck} lbm_backend {ns.lbm_backend}"
    else:
        label = f"{ns.deck} {ns.backend}{' fused' if ns.fused else ' carry' if ns.carry else ''}"
    print(f"[profile] {label} {extent or f'{n}^3'}: build {t1 - t0:.3f} s, "
          f"init_state {t2 - t1:.3f} s", flush=True)
    for i in range(warm):  # warm-up
        state = problem.step(state, i * dt, dt, dt, i == 0)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t3 = time.perf_counter()
        state = problem.step(state, warm * dt, dt, dt, False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t3) * 1e6
    # device-side events (kernels, memcpy, memset), grouped by name
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    # the hand kernels: the fused LBM substep (flat or brick); the FFT
    # kernels (cuFFT's carry "fft" in their names, the port's "lanes"; the
    # fused update kernel is the forward sublanes kernel with an epilogue,
    # so it counts)
    if problem.is_lbm:
        what = "LBM substep kernels"
        hand_us = sum(e.self_device_time_total for e in kernels
                      if any(k in e.key for k in LBM_KERNELS))
    else:
        what = "FFT kernels"
        hand_us = sum(e.self_device_time_total for e in kernels
                      if "fft" in e.key or "lanes_kernel" in e.key)
    print(f"[profile] one step ({substeps} substeps): wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms ({what} {hand_us / 1e3:.3f} ms, "
          f"other {(busy_us - hand_us) / 1e3:.3f} ms), idle share "
          f"{max(0.0, 1 - busy_us / wall_us):.3f}", flush=True)
    if not kernels:
        print("[profile] the trace holds no device events", flush=True)
        return 1
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:TOP]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<4d} {e.key[:90]}")
    if problem.is_lbm and ns.lbm_backend == "PALLAS":
        fused_loop(problem, state, acts)
    return 0


def fused_loop(problem, state, acts):
    """Trace the fused loop of one step alone (``_lbm_fused_substeps``, the
    substeps but the last) and count, on the device, each kernel's
    launches and the host-to-device copies."""
    with torch.profiler.profile(activities=acts) as prof:
        problem._lbm_fused_substeps(state)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    n = problem.lbm_substeps - 1
    copies = sum(e.count for e in events if "HtoD" in e.key)
    launches = {e.key: e.count for e in events if "Memcpy" not in e.key
                and "Memset" not in e.key}
    lbm = sum(c for k, c in launches.items() if any(x in k for x in LBM_KERNELS))
    print(f"[profile] fused loop ({n} substeps): {lbm} LBM kernel launches "
          f"({lbm / n:.2f} a substep), {sum(launches.values())} kernel launches in all, "
          f"{copies} host-to-device copies ({copies / n:.2f} a substep)", flush=True)
    for k, c in sorted(launches.items(), key=lambda kc: -kc[1]):
        print(f"[profile]   x{c:<5d} {k[:90]}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
