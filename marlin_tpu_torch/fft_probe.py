"""Diagnosis of the unordered-FFT kernels on the card: each kernel beside
its stripped variants and one torch.fft call.

    python -m marlin_tpu_torch.fft_probe [--shape 512 | 1a] [--reps 20] [--rounds 6]

At the 512³ main-path shapes of kernel 1 (``fwd_lanes``, (262144, 512)
float32), kernel 3 (``fwd_sublanes``, (1, 512, 262144) and (512, 512,
512) complex64), kernel 2 (``inv_lanes``, (262144, 512) complex64, real
output) and kernel 4 (``inv_sublanes``, the two shapes of kernel 3) it
times, by CUDA events over ``--reps`` launches after a warm-up: the
kernel through its wrapper (the register-resident kernel at these
extents); ``torch.fft.fft`` or ``torch.fft.ifft`` along the same axis;
and the variants of ``csrc/fft_probe.cu``: the generic shared-memory tile
kernel whole, copy only (the kernel's global loads and stores, no FFT
stages) and stages only (the FFT stages on data made in the block, no
global traffic) of the register kernel (and, forward, of the tile), and,
for kernel 4, the register kernel on the other cluster size.  The tile
kernel whole (and kernel 4 on the other cluster size) is also checked
against the register kernel, bit for bit.  The times go in turns over
``--rounds`` rounds, the order reversed every other round, so each round
holds one interleaved kernel / torch.fft pair; the line says in how many
rounds the kernel was the faster.  The byte bound is the input read once
and the output written once at 3.35 TB/s.  Prints the card's name and
power limit and the probe library's ptxas report.  Needs a CUDA card; no
solver path runs it.

``--shape 1a`` probes the small-extent path at benchmark 1a's shapes:
kernels 1 and 2 at (200, 200) (float32 in, float32 out), kernels 3 and 4
at (1, 200, 200) complex64.  Each kernel through its wrapper, its
same-function torch call (``torch.fft.fft`` or ``ifft`` along its axis;
kernel 2's is ``ifft(x).real``, whose ``.real`` is a view), the generic
tile kernel whole (which the small path replaces at n = 200), the small
kernel copy only (fetch, widening and rounded store, no stages) and whole
on other rows or columns a block and on its radices in the tile's order
(8, 4, 2 first, a plan of its own); device µs a call by the profiler (at
this size CUDA events time the host), in ``--rounds`` interleaved rounds.
The small kernel is checked against the tile within 1e-5 of the tile's
largest output.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from . import unordered_fft as uf

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
N = 512

_LANES = [ctypes.c_int] * 2 + [uf._P] * 4 + [uf._I] * 3 + [ctypes.c_int, uf._P]
_SUBLANES = [ctypes.c_int] * 2 + [uf._P] * 4 + [uf._I] * 4 + [ctypes.c_int, uf._P]
LIBRARY = uf.CudaLibrary("fft_probe", {
    "probe_tile_lanes": _LANES, "probe_tile_sublanes": _SUBLANES,
    "probe_reg_lanes": _LANES, "probe_reg_sublanes": _SUBLANES,
    "probe_small_lanes": _LANES, "probe_small_sublanes": _SUBLANES,
}, source=os.path.join(uf.CSRC, "fft_probe.cu"), flags=["-Xptxas=-v"])

# (label, library function, mode), forward and inverse
FORWARD = [("tile whole", "probe_tile_{}", 2),
           ("tile copy only", "probe_tile_{}", 0),
           ("tile stages only", "probe_tile_{}", 1),
           ("register copy only", "probe_reg_{}", 0),
           ("register stages only", "probe_reg_{}", 1)]
INVERSE = [("tile whole", "probe_tile_{}", 2),
           ("register copy only", "probe_reg_{}", 0),
           ("register stages only", "probe_reg_{}", 1)]
OTHER_CLUSTERS = ("register, other cluster size", "probe_reg_{}", 3)
# (wrapper, shape, input dtype, axis)
SHAPES = [("fwd_sublanes", (1, N, N * N), torch.complex64, 1),
          ("fwd_sublanes", (N, N, N), torch.complex64, 1),
          ("fwd_lanes", (N * N, N), torch.float32, -1),
          ("inv_sublanes", (1, N, N * N), torch.complex64, 1),
          ("inv_sublanes", (N, N, N), torch.complex64, 1),
          ("inv_lanes", (N * N, N), torch.complex64, -1)]


def cuda_ms(fn, reps, warmup=3):
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


def _variant(fn_name, mode, inverse, kind, x, out, width=0, plan=None):
    """A probe variant as a call; `width` is a small kernel's rows or
    columns a block (0: the launcher's), `plan` a small plan of its own
    (a device tensor; by default the extent's)."""
    lib = LIBRARY.load()
    fn = getattr(lib, fn_name.format(kind))
    real = x.dtype == torch.float32
    xr, xc = (uf._ptr(x), None) if real else (None, uf._ptr(x))
    n = x.shape[-1] if kind == "lanes" else x.shape[1]
    # the small variants read the small plan, the others W_n^j
    table = uf._small_plan if "small" in fn_name else uf._twiddle_table
    tw = uf._ptr(table(n, bool(inverse), x.device) if plan is None else plan)
    if kind == "lanes":
        B = x.shape[0]
        args = (mode, inverse, xr, xc, uf._ptr(out), tw, B, n, uf.base(n), width)
    else:
        P_, _, L = x.shape
        args = (mode, inverse, xr, xc, uf._ptr(out), tw, P_, n, L, uf.base(n), width)
    return lambda: uf._launch(fn, *args, device=x.device, name=fn_name)


def device_us(fn, calls=50):
    """Device µs a call: every device event of ``calls`` calls, by
    torch.profiler."""
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
    return us / calls


A = 200  # benchmark 1a's extent
# (wrapper, shape, input dtype, axis, other widths of the small kernel)
SHAPES_1A = [("fwd_lanes", (A, A), torch.float32, -1, (1, 4)),
             ("inv_lanes", (A, A), torch.complex64, -1, (1, 4)),
             ("fwd_sublanes", (1, A, A), torch.complex64, 1, (2, 8)),
             ("inv_sublanes", (1, A, A), torch.complex64, 1, (2, 8))]


def probe_1a(ns, dev):
    """The small-extent kernels at benchmark 1a's shapes (``--shape 1a``)."""
    gen = torch.Generator().manual_seed(0)
    for name, shape, dtype, dim, widths in SHAPES_1A:
        inverse = name.startswith("inv")
        x = torch.randn(shape, generator=gen, dtype=dtype).to(dev)
        kind = "lanes" if name.endswith("_lanes") else "sublanes"
        odtype = torch.float32 if name == "inv_lanes" else torch.complex64
        out = torch.empty(shape, dtype=odtype, device=dev)
        wrapper = getattr(uf, name)
        if name == "inv_lanes":
            ref_name, library = "torch.fft.ifft(x).real", lambda: torch.fft.ifft(x, dim=dim).real
        elif inverse:
            ref_name, library = "torch.fft.ifft", lambda: torch.fft.ifft(x, dim=dim)
        else:
            ref_name, library = "torch.fft.fft", lambda: torch.fft.fft(x, dim=dim)
        runs = {"kernel": lambda: wrapper(x), ref_name: library,
                "tile whole": _variant("probe_tile_{}", 2, int(inverse), kind, x, out),
                "small copy only": _variant("probe_small_{}", 0, int(inverse), kind, x, out)}
        for w in widths:
            unit = "rows" if kind == "lanes" else "columns"
            runs[f"small whole, {w} {unit} a block"] = _variant(
                "probe_small_{}", 1, int(inverse), kind, x, out, w)
        # the tile's order of the radices, 8, 4, 2 first (the plan takes
        # the odd ones first)
        order = uf.radices(A)
        plan = torch.from_numpy(uf.build_small_plan(A, order, inverse)).to(dev)
        runs[f"small whole, radices {order}"] = _variant(
            "probe_small_{}", 1, int(inverse), kind, x, out, 0, plan)
        got = wrapper(x)
        runs["tile whole"]()
        torch.cuda.synchronize()
        err = (got - out).abs().max().item() / out.abs().max().item()
        assert err <= 1e-5, (name, err)
        path = uf.path(shape[dim])
        times = {k: [] for k in runs}
        for i in range(ns.rounds):
            for k in (list(runs) if i % 2 == 0 else list(reversed(runs))):
                times[k].append(device_us(runs[k], ns.reps))
        wins = sum(a <= b for a, b in zip(times["kernel"], times[ref_name]))
        bound = 1e6 * (x.numel() * x.element_size() + out.numel() * out.element_size()
                       + uf.small_plan_bytes(A)) / HBM_BYTES_PER_S
        text = ", ".join(f"{k} {' / '.join(f'{t:.2f}' for t in v)}" for k, v in times.items())
        print(f"[probe 1a] {name} {shape} {str(dtype)[6:]}: {path} path, within {err:.2e} "
              f"of the tile; bound {bound:.3f} us; kernel no slower than {ref_name} in "
              f"{wins} of {ns.rounds} rounds; device us a call: {text}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="marlin_tpu_torch.fft_probe")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--shape", default="512", choices=["512", "1a"])
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fft_probe: needs a CUDA card", file=sys.stderr)
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
    if ns.shape == "1a":
        probe_1a(ns, dev)
        return 0
    gen = torch.Generator().manual_seed(0)
    for name, shape, dtype, dim in SHAPES:
        inverse = name.startswith("inv")
        x = torch.randn(shape, generator=gen, dtype=dtype).to(dev)
        # the inverse lanes kernel writes the real part, as on the main path
        odtype = torch.float32 if name == "inv_lanes" else torch.complex64
        out = torch.empty(shape, dtype=odtype, device=dev)
        kind = "lanes" if name.endswith("_lanes") else "sublanes"
        wrapper = getattr(uf, name)
        ref_name = "torch.fft.ifft" if inverse else "torch.fft.fft"
        library = torch.fft.ifft if inverse else torch.fft.fft
        runs = {"kernel": lambda: wrapper(x), ref_name: lambda: library(x, dim=dim)}
        variants = list(INVERSE if inverse else FORWARD)
        if name == "inv_sublanes":
            variants.append(OTHER_CLUSTERS)
        for label, fn_name, mode in variants:
            runs[label] = _variant(fn_name, mode, int(inverse), kind, x, out)
        got = wrapper(x)
        checks = []
        for label in ("tile whole", OTHER_CLUSTERS[0]):
            if label in runs:
                runs[label]()
                checks.append(f"{'equals' if torch.equal(got, out) else 'DIFFERS FROM'} "
                              f"the {label}")
        del got
        bound = 1e3 * (x.numel() * x.element_size()
                       + out.numel() * out.element_size()) / HBM_BYTES_PER_S
        times = {k: [] for k in runs}
        for i in range(ns.rounds):
            for k in (list(runs) if i % 2 == 0 else list(reversed(runs))):
                times[k].append(cuda_ms(runs[k], ns.reps))
        wins = sum(a < b for a, b in zip(times["kernel"], times[ref_name]))
        text = ", ".join(f"{k} {' / '.join(f'{t:.3f}' for t in v)}"
                         for k, v in times.items())
        print(f"[probe] {name} {shape} {str(dtype)[6:]}: register kernel "
              f"{' and '.join(checks)} bit for bit; bound {bound:.3f} ms; kernel "
              f"faster than {ref_name} in {wins} of {ns.rounds} rounds; {text} ms",
              flush=True)
        del x, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
