"""Diagnosis of the fused LBM substep (kernel 7) on the card: each plan's
kernel beside its stripped variants.

    python -m marlin_tpu_torch.lbm_probe [--plans porous,mixed,...] [--n 256]
        [--reps 10] [--rounds 4]

At n³ float32 (256³ by default, the decks' main extent) for each named
plan of ``deck_plans`` (by default the nine 3-D plans) it times, by CUDA
events over ``--reps`` launches after a warm-up, on the flat
one-thread-a-cell kernel and on the brick kernel (``brick_plan``'s walk):
the variants of ``csrc/lbm_probe.cu``, copy only (each lattice's q planes
read and written at the cell, no shift), stream only (the pull reads and
the stores, no media, faces or collision) and stream + media/bounce (face
and obstacle bounce-back and solid masking); the shipped kernel whole
(``lbm_fused.launch_substep`` on the flat or the brick plan); and the
brick kernel whole on the other walks of ``WALKS`` (stages, consumer
warps, rows a brick), each first checked bit for bit against the flat
kernel.  The times go in turns over ``--rounds`` rounds, the order
reversed every other round.  Beside each variant stands its own byte
bound (the planes it reads and writes once, and the media bytes where it
reads them, at 3.35 TB/s) and the whole kernel's.  The inputs are those
of ``chip_smoke.py`` phase 2: w_q (1 + 0.05 N(0, 1)) from a seeded
generator, and on media plans ``decks.porous_media(n)`` with its solids
zeroed.  Prints the card's name and power limit and the probe library's
ptxas report.  Needs a CUDA card; no solver path runs it.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import subprocess
import sys

import torch

from . import lbm_fused as lf
from . import unordered_fft as uf

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

LIBRARY = uf.CudaLibrary("lbm_probe", {
    # mode, q, fpc, gpc, media, out, gout, the host plan; stream
    "probe_lbm_flat": [ctypes.c_int] * 2 + [uf._P] * 5 + [uf._P, uf._P],
    "probe_lbm_brick": [ctypes.c_int] * 2 + [uf._P] * 5 + [uf._P, uf._P],
}, source=os.path.join(uf.CSRC, "lbm_probe.cu"), flags=["-fmad=false", "-Xptxas=-v"])

MODES = ["copy only", "stream only", "stream + media/bounce"]
PLANS_3D = ["porous", "mixed", "allface_d3q27", "zouhe_zeroth", "thermal", "pebbles",
            "allface_d3q27_mrt", "porous_proj", "collisionless"]


def zeroth_order_deck(backend):
    """decks.INLET_OUTLET_DECK as a pressure-driven channel: Zou-He density
    faces on both x faces (zeroth order)."""
    from .decks import INLET_OUTLET_DECK

    deck = INLET_OUTLET_DECK.format(backend=backend)
    deck = deck.replace("type = LBMFixedFirstOrderBC", "type = LBMFixedZerothOrderBC")
    deck = deck.replace("value = 0.01", "value = 1.001")
    return deck.replace("""      type = LBMMicroscopicZeroGradientBC
      buffer = f
      boundary = right""", """      type = LBMFixedZerothOrderBC
      buffer = f
      f = f
      value = 1.0
      boundary = right""")


def deck_plans():
    """name -> FusedLBMConfig of each deck's own chain, built at a small
    extent on the CPU; the callers set the extents."""
    from . import decks, hit
    from .problem import TensorProblem

    media = {"media": decks.porous_media(8)}
    allface27 = decks.ALLFACE_DECK.format(n=8, stencil="LBMD3Q27", backend="PALLAS")
    texts = {
        "porous": (decks.POROUS_DECK.format(n=8, substeps=2, backend="PALLAS",
                                            media_h5="media.h5"), media),
        "mixed": (decks.MIXED_DECK.format(n=8, substeps=2, backend="PALLAS"), None),
        "allface_d3q27": (allface27, None),
        "zouhe_zeroth": (zeroth_order_deck("PALLAS"), None),
        "thermal": (decks.THERMAL3D_DECK.format(n=8, substeps=2, backend="PALLAS"),
                    None),
        "pebbles": (decks.PEBBLES_DECK.format(nx=8, ny=8, nz=8, substeps=2,
                                              backend="PALLAS", media_h5="media.h5"),
                    media),
        "allface_d3q27_mrt": (allface27.replace("LBMBGKCollision", "LBMMRTCollision"),
                              None),
        "porous_proj": (decks.PROJECTED_DECK.format(n=8, substeps=2, backend="PALLAS",
                                                    media_h5="media.h5"), media),
        "collisionless": (decks.COLLISIONLESS_DECK.format(backend="PALLAS"), None),
        "channel2d": (decks.CHANNEL2D_DECK.format(nx=8, ny=6, substeps=2,
                                                  backend="PALLAS"), None),
        "channel2d_mrt": (decks.CHANNEL2D_MRT_DECK.format(nx=8, ny=6, substeps=2,
                                                          backend="PALLAS"), None),
        "thermal2d": (decks.THERMAL2D_DECK.format(n=8, substeps=2, backend="PALLAS"),
                      None),
        "karman": (decks.KARMAN_DECK.format(nx=40, ny=20, substeps=2, backend="PALLAS"),
                   {"binary_media": decks.karman_media(40, 20)}),
    }
    plans = {}
    for name, (text, arrays) in texts.items():
        p = TensorProblem(hit.parse(text), device="cpu", arrays=arrays)
        p.init_state()
        plans[name] = lf.match_chain(p).config
    return plans


def inputs(cfg, gen, dev):
    """(fpc, gpc or None, media or None) of chip_smoke.py phase 2 at the
    plan's extent: the decks' media where the plan has media."""
    from .decks import porous_media

    shape = (cfg.nx, cfg.ny, cfg.nz)
    w = torch.tensor(cfg.w, dtype=torch.float32, device=dev)[:, None, None, None]

    def rand():
        return w * (1.0 + 0.05 * torch.randn((cfg.q,) + shape, generator=gen, device=dev))

    fpc = rand()
    gpc = rand() if cfg.two_lattice else None
    media = None
    if cfg.has_media:
        media = torch.as_tensor(porous_media(cfg.nx), device=dev).to(torch.int8).contiguous()
        fpc = torch.where(media == 0, 0.0, fpc)
        if gpc is not None:
            gpc = torch.where(media == 0, 0.0, gpc).contiguous()
    return fpc.contiguous(), gpc, media


def cuda_ms(fn, reps, warmup=2):
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


# brick walks the probe times the whole kernel on beside brick_plan's:
# (label, brick_plan keyword arguments)
WALKS = [("1 stage", {"stages": 1}),
         ("2 stages", {"stages": 2}),
         ("3 stages", {"stages": 3}),
         ("4 consumer warps", {"threads": 160}),
         ("2 consumer warps", {"threads": 96}),
         ("double stage", {"stage_bytes": 2 * lf.STAGE_BYTES})]


def _variant(kind, mode, cfg, fpc, gpc, media, plan, out, gout):
    fn = getattr(LIBRARY.load(), f"probe_lbm_{kind}")
    args = (mode, cfg.q, uf._ptr(fpc), uf._ptr(gpc), uf._ptr(media), uf._ptr(out),
            uf._ptr(gout), ctypes.addressof(plan))
    return lambda: uf._launch(fn, *args, device=fpc.device, name=f"probe_lbm_{kind}")


def _walk(b):
    return f"by {b.by}, {b.stages} stages, {b.threads} threads, {b.smem} B"


def probe_plan(name, cfg, ns, gen, dev):
    fpc, gpc, media = inputs(cfg, gen, dev)
    lattices = 2 if cfg.two_lattice else 1
    cells = cfg.nx * cfg.ny * cfg.nz
    planes = 2 * lattices * cfg.q * cells * 4
    whole_bytes = planes + 4 * cells + (cells if media is not None else 0)
    brick = lf.brick_plan(cfg, torch.float32)
    plans = {"flat": lf.pack(cfg)}
    if brick is not None:
        plans["brick"] = lf.pack(cfg, brick)
    _plan, avec = lf._kernel_args(fpc, media, cfg, gpc, "lbm_probe")
    out, gout = torch.empty_like(fpc), None if gpc is None else torch.empty_like(gpc)
    runs, bounds = {}, {}
    for kind, plan in plans.items():
        for mode, label in enumerate(MODES):
            runs[f"{kind} {label}"] = _variant(kind, mode, cfg, fpc, gpc, media, plan, out,
                                               gout)
            bounds[f"{kind} {label}"] = planes + (cells if mode == 2 and media is not None
                                                   else 0)
        runs[f"{kind} whole"] = (lambda plan=plan:
                                 lf.launch_substep(fpc, media, cfg, gpc, plan, avec))
        bounds[f"{kind} whole"] = whole_bytes
    walks = {}
    if brick is not None:
        for label, kw in WALKS:
            b = lf.brick_plan(cfg, torch.float32, **kw)
            if b is None or b == brick or b in walks.values():
                continue
            walks[label] = b
            plan = lf.pack(cfg, b)
            runs[f"brick whole, {label}"] = (lambda plan=plan:
                                             lf.launch_substep(fpc, media, cfg, gpc, plan, avec))
            bounds[f"brick whole, {label}"] = whole_bytes
    # the brick kernel against the flat one, bit for bit, on every walk
    same = []
    if brick is not None:
        ref = runs["flat whole"]()
        for k in [k for k in runs if k.startswith("brick whole")]:
            got = runs[k]()
            same.append(all(torch.equal(a, b) for a, b in zip(got, ref)))
        del ref, got
    times = {k: [] for k in runs}
    for i in range(ns.rounds):
        for k in (list(runs) if i % 2 == 0 else list(reversed(runs))):
            times[k].append(cuda_ms(runs[k], ns.reps))
    text = "; ".join(f"{k} {' / '.join(f'{t:.3f}' for t in v)} (bound "
                     f"{1e3 * bounds[k] / HBM_BYTES_PER_S:.3f})" for k, v in times.items())
    walk_text = "flat only" if brick is None else (
        f"brick {_walk(brick)}; " + "; ".join(f"{k}: {_walk(b)}" for k, b in walks.items())
        + f"; brick whole equals flat whole bit for bit: {same}")
    print(f"[probe] {name} {(cfg.nx, cfg.ny, cfg.nz)} {lattices} lattice(s) q={cfg.q}: "
          f"{walk_text}", flush=True)
    print(f"[probe] {name}: {text} ms", flush=True)
    if brick is not None and not all(same):
        raise RuntimeError(f"lbm_probe {name}: the brick kernel differs from the flat one")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="marlin_tpu_torch.lbm_probe")
    ap.add_argument("--plans", default=",".join(PLANS_3D))
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=4)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lbm_probe: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[probe] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    LIBRARY.load()
    for line in LIBRARY.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[probe] ptxas {line.strip()}", flush=True)
    plans = deck_plans()
    gen = torch.Generator(device=dev).manual_seed(1)
    for name in ns.plans.split(","):
        cfg = dataclasses.replace(plans[name], nx=ns.n, ny=ns.n, nz=ns.n)
        probe_plan(name, cfg, ns, gen, dev)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
