"""Where the time of a Cahn-Hilliard step goes on the card.

    python -m marlin_tpu_torch.substep_profile [--backend PALLAS|DEFAULT]
        [--deck ch3d|multi3d] [--carry] [--fused]

Builds ``decks.CH3D_DECK`` (or the two-field ``decks.MULTI_3D_DECK``, dt =
0.05) at 512³ (10 substeps a step) in float32 on the card, with
``carry_reciprocal`` (``--carry``) or ``carry_reciprocal`` and
``fused_spectral`` (``--fused``, PALLAS only); times problem construction
and ``init_state``, warms up with one step, then traces one more step with
``torch.profiler``: device time by kernel name, the step's wall time and
the share of it in which the device ran no kernel.  Prints one line per
finding; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import hit
from .decks import CH3D_DECK, MULTI_3D_DECK
from .problem import TensorProblem

N = 512
SUBSTEPS = 10
TOP = 12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="marlin_tpu_torch.substep_profile")
    ap.add_argument("--backend", default="PALLAS", choices=["PALLAS", "DEFAULT"])
    ap.add_argument("--deck", default="ch3d", choices=["ch3d", "multi3d"])
    ap.add_argument("--carry", action="store_true")
    ap.add_argument("--fused", action="store_true")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("substep_profile: needs a CUDA card", file=sys.stderr)
        return 1
    solver = ("carry_reciprocal = true\n  fused_spectral = true" if ns.fused
              else "carry_reciprocal = true" if ns.carry else "")
    domain = f"fft_backend = {ns.backend}\n  floating_precision = SINGLE"
    if ns.deck == "ch3d":
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
    problem = TensorProblem(hit.parse(deck), device="cuda")
    t1 = time.perf_counter()
    state = problem.init_state()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    label = f"{ns.deck} {ns.backend}{' fused' if ns.fused else ' carry' if ns.carry else ''}"
    print(f"[profile] {label} {N}^3: build {t1 - t0:.3f} s, "
          f"init_state {t2 - t1:.3f} s", flush=True)
    state = problem.step(state, 0.0, dt, dt, True)  # warm-up
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t3 = time.perf_counter()
        state = problem.step(state, dt, dt, dt, False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t3) * 1e6
    # device-side events (kernels, memcpy, memset), grouped by name
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    # FFT kernels: cuFFT's carry "fft" in their names, the port's "lanes"
    # (the fused update kernel is the forward sublanes kernel with an
    # epilogue, so it counts here)
    fft_us = sum(e.self_device_time_total for e in kernels
                 if "fft" in e.key or "lanes_kernel" in e.key)
    print(f"[profile] one step ({SUBSTEPS} substeps): wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms (FFT kernels {fft_us / 1e3:.3f} ms, "
          f"other {(busy_us - fft_us) / 1e3:.3f} ms), idle share "
          f"{max(0.0, 1 - busy_us / wall_us):.3f}", flush=True)
    if not kernels:
        print("[profile] the trace holds no device events", flush=True)
        return 1
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:TOP]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<4d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
