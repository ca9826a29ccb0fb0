"""Unordered (permuted-spectrum) FFT: four hand-written CUDA kernels and
their plain PyTorch twins.

This is the port of marlin_tpu/pallas_fft.py.  Each wrapper replaces one
Pallas TPU kernel:

=================  ===============================================
wrapper            replaces
=================  ===============================================
``fwd_lanes``      pallas_fft.py:237 ``_fwd_lanes_kernel``
``fwd_lanes_pre``  the same kernel with its fused ``pre`` read
``inv_lanes``      pallas_fft.py:276 ``_inv_lanes_kernel``
``fwd_sublanes``   pallas_fft.py:340 ``_fwd_sublanes_kernel``
``inv_sublanes``   pallas_fft.py:355 ``_inv_sublanes_kernel``
=================  ===============================================

The contract kept from the JAX package is the storage order of the
spectrum: with n = b·r (``base``), a forward transform stores the natural
frequency k = t + r·s at slot k' = t·b + s (``true_k_order``) and an inverse
transform consumes that order.  Everything between a forward and an inverse
transform is pointwise, so a solver runs on k-space operators built from
``permuted_freqs`` and never materialises the permutation.  The planar re/im
split, the 128-lane tiling and the VMEM budgets of the TPU kernels do not
carry over: the wrappers take and return ``complex64`` (interleaved), the
forward wrappers also take a real ``float32`` input, and ``inv_lanes`` can
return the real part only.

The kernels (``csrc/unordered_fft.cu`` over ``csrc/fft_tile.cuh``) are
built with ``nvcc`` for ``sm_90a`` into a plain C shared library at first
use and loaded with ``ctypes``.  Bound at 512³ on an H100 SXM (3.35 TB/s):
a real-input forward or real-output inverse lanes pass moves 1.61 GB
(0.48 ms), a complex sublanes pass 2.15 GB (0.64 ms).  Every kernel takes
one of three paths, chosen in C by the extent (``mtt_fwd_path``,
``mtt_inv_path``; ``path`` here): at n = 128, 256, 512 and 1024 a
register-resident Stockham FFT (persistent blocks fed by a ring of
asynchronous 16-byte copies, N/8 threads a transform with 8 values each,
the exchanges through shared memory; the forward stores straight to the
permuted slot, the inverse reads from it and stores in natural order); at
every other extent with b = n (8 to 400, benchmark 1a's 200) a small-extent
kernel that gives each transform a warp and runs its stages in float64
over a plan built here (``small_plan``), each output rounded once; at n =
384, 640, 768 and 896 a mixed-radix Stockham FFT over a tile in shared
memory (radix-8/4/2 butterflies in registers, odd radices summed
directly) that permutes on the way out or in.  The register path and the
tile give the same bits.  ``python -m marlin_tpu_torch.fft_probe`` times
the kernels beside stripped variants of each path and torch.fft on the
card (``--shape 1a`` at benchmark 1a's 200²).

The TPU kernel's fused pointwise producer (``pre``: µ = f′(c) evaluated in
the forward lanes kernel's read, so µ never reaches memory) is a
``Pointwise``: a parsed expression printed as CUDA source
(``expression.CudaSourceOps``).  ``fwd_lanes_pre`` compiles it, with the
lanes kernel of ``fft_tile.cuh``, into a library of its own in ``_build/``
named by a hash of the generated source, once per distinct expression.

On a CPU tensor each wrapper computes its plain twin (``*_plain``), which
repeats the JAX kernels' arithmetic in torch ops: radix-r butterflies, the
W_n twiddle and the b-point DFT as a matmul.  On a CUDA tensor it launches
the kernel or raises; it never falls back.  Each wrapper counts its kernel
launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import perf

P = 128  # the TPU kernels' DFT-matmul size; kept because it fixes the order
MAX_R = 8  # largest radix: n up to 128·8 = 1024
#: largest extent handled as one direct b = n DFT (pallas_fft.DIRECT_MAX)
DIRECT_MAX = 400

SUPPORTED_RULE = (f"a multiple of 128 up to 1024, or any extent in "
                  f"[8, {DIRECT_MAX}] (direct DFT)")

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


@functools.lru_cache(maxsize=None)
def base(n: int) -> int:
    """The DFT size b of extent n = b·r (pallas_fft.base): b = 128 with
    radix r ≤ 8 for multiples of 128, else b = n for n in [8, DIRECT_MAX];
    0 when unsupported."""
    if n % P == 0 and 1 <= n // P <= MAX_R:
        return P
    if 8 <= n <= DIRECT_MAX:
        return n
    return 0


def supported(n: int) -> bool:
    return base(n) > 0


def path(n: int):
    """The path of the kernels at extent n, as ``mtt_fwd_path`` and
    ``mtt_inv_path`` choose it in C: "register" at n = 128, 256, 512, 1024,
    "small" at every other extent with b = n, "tile" at the rest (384,
    640, 768, 896); None where the extent is not supported."""
    b = base(n)
    if b == 0:
        return None
    if b == P and n in (128, 256, 512, 1024):
        return "register"
    return "small" if b == n else "tile"


#: the most prefix batches a sublanes launch takes (the grid's y extent)
MAX_PREFIX = 65535


def slab_grid_unsupported_reason(shape, p: int):
    """Why the 3-D FFT_SLAB path at ``p`` ranks cannot run the kernels on
    this grid, or None (pallas_fft.slab_grid_unsupported_reason): kernels 1
    and 3 take the Y-sharded block (nx, ny/p, nz), kernel 3 along y (and
    kernels 5-6 in their slab form) the X-sharded block (nx/p, ny, nz).
    Every path of the kernels takes any row count and column count; what
    limits them is the extents and the prefix of a sublanes launch (the
    fields times nx/p rows of kernel 6 included)."""
    nx, ny, nz = (int(s) for s in shape)
    for n in (nx, ny, nz):
        if not supported(n):
            return f"extent {n} does not factor as {SUPPORTED_RULE}"
    if ny % p or nx % p:
        return (f"FFT_SLAB PALLAS needs nx and ny divisible by the mesh "
                f"size {p} (got {nx}x{ny})")
    if nx // p > MAX_PREFIX:
        return (f"the y kernel's prefix of {nx // p} rows exceeds "
                f"{MAX_PREFIX}")
    return None


def true_k_order(n: int) -> np.ndarray:
    """true_k[k'] — the natural frequency index stored at permuted slot k'."""
    b = base(n)
    r = n // b
    kp = np.arange(n)
    return (kp // b) + r * (kp % b)


def permuted_freqs(n: int, d: float) -> np.ndarray:
    """np.fft.fftfreq(n, d) reordered to the kernels' k' storage order."""
    return np.fft.fftfreq(n, d=d)[true_k_order(n)]


# ---------------------------------------------------------------------------
# plain PyTorch twins: the JAX kernels' n = b·r arithmetic in torch ops
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _np_tables(n: int, inverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(W_b (b, b), twiddles (r, b)) as complex64, computed in float64
    (pallas_fft._tables)."""
    b = base(n)
    r = n // b
    s = 2j if inverse else -2j
    w = np.exp(s * np.pi * np.outer(np.arange(b), np.arange(b)) / b)
    tw = np.exp(s * np.pi * np.outer(np.arange(r), np.arange(b)) / n)
    return w.astype(np.complex64), tw.astype(np.complex64)


def _tables(n: int, inverse: bool, device) -> Tuple[torch.Tensor, torch.Tensor]:
    w, tw = _np_tables(n, inverse)
    return (torch.from_numpy(w).to(device), torch.from_numpy(tw).to(device))


def _radix(parts, r: int, inverse: bool):
    """DFT_r across the r parts, A[t] = Σ_q x[q]·W_r^{∓qt}, with the W_r
    entries rounded to 15 digits and 0/±1 coefficients folded away
    (pallas_fft._radix_generic; exact for the ±1/±i radices 2 and 4)."""
    if r == 1:
        return list(parts)
    sign = 1.0 if inverse else -1.0
    out = []
    for t in range(r):
        acc = None
        for q in range(r):
            ang = sign * 2.0 * math.pi * ((q * t) % r) / r
            c, s = round(math.cos(ang), 15), round(math.sin(ang), 15)
            if c == 1.0 and s == 0.0:
                term = parts[q]
            elif c == -1.0 and s == 0.0:
                term = -parts[q]
            else:
                term = parts[q] * complex(c, s)
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def fwd_lanes_plain(x: torch.Tensor) -> torch.Tensor:
    """Forward along the last axis of (B, n), permuted complex64 output."""
    B, n = x.shape
    b = base(n)
    r = n // b
    w, tw = _tables(n, False, x.device)
    xc = x.to(torch.complex64).reshape(B, r, b)  # n_index = p + b·q
    a = _radix([xc[:, q, :] for q in range(r)], r, inverse=False)
    bt = torch.stack(a, dim=1) * tw  # (B, r, b): twiddle W_n^{t·p}
    return (bt.reshape(B * r, b) @ w).reshape(B, n)  # k' = t·b + s


def inv_lanes_plain(x: torch.Tensor, real_output: bool = True) -> torch.Tensor:
    """Inverse along the last axis of (B, n), permuted input, natural-order
    output divided by n (real part only with ``real_output``): a division,
    as the kernel's, not a product with the rounded 1/n.  n is a 0-d tensor
    on x's device: a host number would become that product on the card."""
    B, n = x.shape
    b = base(n)
    r = n // b
    w, tw = _tables(n, True, x.device)
    a = (x.to(torch.complex64).reshape(B * r, b) @ w).reshape(B, r, b)
    c = a * tw  # twiddle W_n^{+m·t}
    u = _radix([c[:, t, :] for t in range(r)], r, inverse=True)
    out = torch.stack(u, dim=1).reshape(B, n)  # x[m + b·u]
    d = torch.tensor(float(n), dtype=out.real.dtype, device=x.device)
    if real_output:
        return (out.real / d).contiguous()
    return torch.complex(out.real / d, out.imag / d)


def _sublanes_via_lanes(fn, x: torch.Tensor, *args) -> torch.Tensor:
    P_, n, L = x.shape
    rows = x.transpose(1, 2).reshape(P_ * L, n)
    return fn(rows, *args).reshape(P_, L, n).transpose(1, 2).contiguous()


def fwd_sublanes_plain(x: torch.Tensor) -> torch.Tensor:
    """Forward along axis 1 of (P, n, L), permuted complex64 output."""
    return _sublanes_via_lanes(fwd_lanes_plain, x)


def inv_sublanes_plain(x: torch.Tensor) -> torch.Tensor:
    """Inverse along axis 1 of (P, n, L), permuted input, complex output."""
    return _sublanes_via_lanes(inv_lanes_plain, x, False)


# ---------------------------------------------------------------------------
# build and load: nvcc into a plain C shared library, bound with ctypes
# ---------------------------------------------------------------------------


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise KernelBuildError("nvcc not found (on PATH or under $CUDA_HOME/bin)")


def _header_bytes() -> bytes:
    out = b""
    for name in sorted(os.listdir(CSRC)):
        if name.endswith(".cuh"):
            with open(os.path.join(CSRC, name), "rb") as f:
                out += f.read()
    return out


class CudaLibrary:
    """One shared library built by nvcc from a source in ``csrc/`` (or from
    generated source text) and bound with ctypes.  Its file name carries a
    hash of the source, the shared headers and the flags, so a changed
    source builds anew.  ``flags`` are added to NVCC_FLAGS for this library;
    ``log`` keeps what nvcc printed on the build this process made (the
    ``-Xptxas=-v`` register report, where a library asks for it)."""

    def __init__(self, stem: str, signatures: Dict[str, list],
                 source: str = None, text: str = None, flags=()):
        self.stem = stem
        self.signatures = signatures
        self.source = source
        self.text = text
        self.flags = list(NVCC_FLAGS) + list(flags)
        self.log = ""
        self._lib = None

    def _source_bytes(self) -> bytes:
        if self.text is not None:
            return self.text.encode()
        with open(self.source, "rb") as f:
            return f.read()

    def path(self) -> str:
        digest = hashlib.sha256(self._source_bytes() + _header_bytes()
                                + " ".join(self.flags).encode())
        return os.path.join(BUILD_DIR, f"{self.stem}_{digest.hexdigest()[:16]}.so")

    def build(self) -> str:
        """Compile unless the library for this source exists.  Raises
        KernelBuildError with nvcc's output when the build fails."""
        path = self.path()
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        source = self.source
        if self.text is not None:
            source = path[:-3] + ".cu"
            with open(source, "w") as f:
                f.write(self.text)
        # at a lower priority where `nice` exists: a build beside other work
        # (chip_smoke.py's host-bound phases while the LBM library builds)
        # leaves the cores to it, and takes what is idle
        nvcc = (["nice", "-n", "10"] if shutil.which("nice") else []) + [_nvcc()]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [*nvcc, *self.flags, "-I", CSRC, "-o", tmp, source]
        try:
            with perf.span("kernels::build"):
                proc = subprocess.run(cmd, capture_output=True, text=True)
            perf.count("kernel_builds")
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stderr}{proc.stdout}")
            self.log = proc.stderr + proc.stdout
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library."""
        if self._lib is None:
            path = self.build()
            with perf.span("kernels::load"):
                lib = ctypes.CDLL(path)
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib


_P = ctypes.c_void_p
_I = ctypes.c_int64
LIBRARY = CudaLibrary("unordered_fft", {
    "mtt_fwd_path": [_I, _I],
    "mtt_inv_path": [_I, _I],
    "mtt_smem": [_I, _I, ctypes.c_int],
    "mtt_fwd_lanes": [_P, _P, _P, _P, _I, _I, _I, _P],
    "mtt_inv_lanes": [_P, _P, _P, _P, _I, _I, _I, _P],
    "mtt_fwd_sublanes": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mtt_inv_sublanes": [_P, _P, _P, _I, _I, _I, _I, _P],
}, source=os.path.join(CSRC, "unordered_fft.cu"), flags=["-Xptxas=-v"])


_TWIDDLES: Dict[Tuple[int, bool, str], torch.Tensor] = {}


def _twiddle_table(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """W_n^{∓j}, j < n, computed in float64 and rounded to complex64;
    uploaded once per (n, direction, device)."""
    key = (n, inverse, str(device))
    tab = _TWIDDLES.get(key)
    if tab is None:
        s = 2j if inverse else -2j
        w = np.exp(s * np.pi * np.arange(n) / n).astype(np.complex64)
        tab = torch.from_numpy(w).to(device)
        _TWIDDLES[key] = tab
    return tab


#: the small-extent plan's header (fft_tile.cuh): 64 int32 words, stage s
#: at words 4 + 5s .. 8 + 5s
SMALL_HEADER_BYTES = 256
SMALL_STAGE_WORDS = 5


def radices(n: int) -> list:
    """The Stockham radices of n: 8, 4, 2, then odd primes ascending
    (fft_tile.cuh make_plan)."""
    out, m = [], n
    for r in (8, 4, 2):
        while m % r == 0:
            out.append(r)
            m //= r
    f = 3
    while m > 1:
        while m % f == 0:
            out.append(f)
            m //= f
        f += 2
    return out


def small_radices(n: int) -> list:
    """The small-extent plan's radices: the odd primes ascending, then 2,
    4, 8.  A first stage (Ns = 1) writes its outputs R values apart, which
    for R = 8 puts a quarter-warp's 16-byte stores on one bank; an odd R
    spreads them (``fft_probe.py --shape 1a`` times both orders, PERF.md
    section 6)."""
    return sorted(radices(n), key=lambda r: (r % 2 == 0, r))


def small_plan_bytes(n: int) -> int:
    """Bytes of the small-extent plan at n (fft_tile.cuh small_plan_bytes):
    the header, n − 1 stage twiddles and the roots of each prime radix > 7,
    16 bytes each."""
    return SMALL_HEADER_BYTES + 16 * (n - 1 + sum(r for r in radices(n) if r > 8))


@functools.lru_cache(maxsize=None)
def small_plan(n: int, inverse: bool) -> np.ndarray:
    """The plan the small-extent kernels read at extent n (b = n), as
    float64 words; fft_tile.cuh documents the layout.  Its header holds n,
    the number of stages, the direction, the number of twiddles and, per
    stage, the radix R, Ns (the product of the radices before it), n/R,
    the index of its first twiddle (in complex128 values from the plan's
    start) and the bits of float32(1/Ns); then, per stage, the twiddles
    W_{Ns·R}^{∓q·j} (q = 1..R−1, j < Ns), and for a prime R > 7 its roots
    W_R^{∓m}, all computed in float64."""
    return build_small_plan(n, small_radices(n), inverse)


def build_small_plan(n: int, rads, inverse: bool) -> np.ndarray:
    """``small_plan`` on the Stockham radices ``rads`` in that order (any
    order of n's factors gives the transform; ``fft_probe.py`` times
    another)."""
    sign = 2j if inverse else -2j
    header = np.zeros(SMALL_HEADER_BYTES // 4, np.int32)
    tables, first, ns = [], SMALL_HEADER_BYTES // 16, 1
    for s, r in enumerate(rads):
        q = np.arange(1, r)[:, None]
        j = np.arange(ns)[None, :]
        w = np.exp(sign * np.pi * (q * j) / (ns * r)).ravel()
        if r > 8:
            w = np.concatenate([w, np.exp(sign * np.pi * np.arange(r) / r)])
        rec = np.array([1.0 / ns], np.float32).view(np.int32)[0]
        header[4 + SMALL_STAGE_WORDS * s:][:SMALL_STAGE_WORDS] = (r, ns, n // r, first, rec)
        tables.append(w)
        first += len(w)
        ns *= r
    twiddles = np.concatenate(tables).astype(np.complex128)
    header[:4] = (n, len(rads), int(inverse), len(twiddles))
    plan = np.frombuffer(header.tobytes() + twiddles.tobytes(), np.float64).copy()
    assert plan.nbytes == small_plan_bytes(n), (n, plan.nbytes)
    return plan


_PLANS: Dict[Tuple[int, bool, str], torch.Tensor] = {}


def _small_plan(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """``small_plan`` uploaded once per (n, direction, device)."""
    key = (n, inverse, str(device))
    tab = _PLANS.get(key)
    if tab is None:
        tab = torch.from_numpy(small_plan(n, inverse)).to(device)
        _PLANS[key] = tab
    return tab


def _table(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """The table the kernels of extent n read: the small-extent plan on the
    small path, W_n^{∓j} in complex64 on the others."""
    if path(n) == "small":
        return _small_plan(n, inverse, device)
    return _twiddle_table(n, inverse, device)


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(x: torch.Tensor, n: int, what: str, complex_only: bool):
    if not supported(n):
        raise ValueError(f"{what}: extent {n} does not factor as {SUPPORTED_RULE}")
    ok = (torch.complex64,) if complex_only else (torch.float32, torch.complex64)
    if x.dtype not in ok:
        raise TypeError(f"{what}: dtype {x.dtype} not in {ok}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")


def _launch(fn, *args, device: torch.device, name: str):
    """Launch on `device`'s current stream; raise on a non-zero CUDA error."""
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        err = fn(*args, stream)
    if err != 0:
        raise KernelLaunchError(f"{name}: CUDA error {err}")


def _launch_kernel(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (compute the twin); any other device raises."""
    if x.device.type in ("cuda", "cpu"):
        return x.device.type == "cuda"
    raise ValueError(f"{what}: unsupported device {x.device}")


# ---------------------------------------------------------------------------
# the fused pointwise read of the forward lanes kernel (``pre``)
# ---------------------------------------------------------------------------


class Pointwise:
    """A pointwise real function f(x) of one float32 value, fused into the
    forward lanes kernel's read (pallas_fft._fwd_lanes_kernel's ``pre``).

    ``expr`` is a ``CompiledExpression`` of the variable ``var``.  Calling
    the object evaluates it with torch (the twin's read); ``source`` is the
    generated ``.cu`` file, printed at construction by
    ``expression.CudaSourceOps``, which raises ``CudaSourceError`` for what
    it cannot print."""

    def __init__(self, expr, var: str):
        self.expr = expr
        self.var = var
        body = "\n".join("    " + line for line in expr.cuda_source(var).splitlines())
        self.source = f"""// Generated by marlin_tpu_torch.unordered_fft: the forward lanes kernel
// of fft_tile.cuh with the pointwise read
//   {var} -> {expr.ast}
#include "fft_tile.cuh"

namespace {{
struct Pre {{
  __device__ __forceinline__ float operator()(float x) const {{
{body}
  }}
}};
}}  // namespace

// x: (B, n) float; out: (B, n) complex, permuted.
extern "C" cudaError_t mtt_fwd_lanes_pre(const void* x, void* out,
                                         const void* tw, int64_t B,
                                         int64_t n, int64_t b,
                                         cudaStream_t stream) {{
  return launch_lanes((const float*)x, nullptr, (const float2*)tw, B, n, b,
                      stream, Pre(), Store{{(float2*)out}});
}}
"""
        self.library = CudaLibrary(
            "fwd_lanes_pre", {"mtt_fwd_lanes_pre": [_P, _P, _P, _I, _I, _I, _P]},
            text=self.source, flags=["-Xptxas=-v"])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = self.expr({self.var: x})
        return torch.as_tensor(out, dtype=x.dtype, device=x.device).expand_as(x)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def fwd_lanes(x: torch.Tensor, pre: Pointwise = None) -> torch.Tensor:
    """Forward along the last axis of (B, n), float32 or complex64 input;
    permuted complex64 output.  Replaces pallas_fft._fwd_lanes_kernel; with
    ``pre`` (float32 input only) the transform is of pre(x), see
    ``fwd_lanes_pre``."""
    if pre is not None:
        return fwd_lanes_pre(x, pre)
    B, n = x.shape
    _check(x, n, "fwd_lanes", complex_only=False)
    if not _launch_kernel(x, "fwd_lanes"):
        return fwd_lanes_plain(x)
    out = torch.empty((B, n), dtype=torch.complex64, device=x.device)
    real = x.dtype == torch.float32
    _launch(LIBRARY.load().mtt_fwd_lanes, _ptr(x) if real else None,
            None if real else _ptr(x), _ptr(out),
            _ptr(_table(n, False, x.device)), B, n, base(n),
            device=x.device, name="fwd_lanes")
    fwd_lanes.launches += 1
    return out


def fwd_lanes_pre(x: torch.Tensor, pre: Pointwise) -> torch.Tensor:
    """Forward along the last axis of (B, n) of pre(x), x float32: the
    pointwise function is evaluated in the kernel's read, so pre(x) never
    reaches memory.  Replaces pallas_fft._fwd_lanes_kernel with ``pre``;
    the twin is ``fwd_lanes_plain(pre(x))``."""
    B, n = x.shape
    _check(x, n, "fwd_lanes_pre", complex_only=False)
    if x.dtype != torch.float32:
        raise TypeError("fwd_lanes_pre: the fused read takes a float32 input "
                        f"(got {x.dtype})")
    if not _launch_kernel(x, "fwd_lanes_pre"):
        return fwd_lanes_plain(pre(x))
    out = torch.empty((B, n), dtype=torch.complex64, device=x.device)
    _launch(pre.library.load().mtt_fwd_lanes_pre, _ptr(x), _ptr(out),
            _ptr(_table(n, False, x.device)), B, n, base(n),
            device=x.device, name="fwd_lanes_pre")
    fwd_lanes_pre.launches += 1
    return out


def inv_lanes(x: torch.Tensor, real_output: bool = True) -> torch.Tensor:
    """Inverse along the last axis of (B, n) complex64, permuted input;
    natural-order float32 (``real_output``) or complex64 output divided by n.
    Replaces pallas_fft._inv_lanes_kernel."""
    B, n = x.shape
    _check(x, n, "inv_lanes", complex_only=True)
    if not _launch_kernel(x, "inv_lanes"):
        return inv_lanes_plain(x, real_output)
    dtype = torch.float32 if real_output else torch.complex64
    out = torch.empty((B, n), dtype=dtype, device=x.device)
    _launch(LIBRARY.load().mtt_inv_lanes, _ptr(x), _ptr(out) if real_output else None,
            None if real_output else _ptr(out),
            _ptr(_table(n, True, x.device)), B, n, base(n),
            device=x.device, name="inv_lanes")
    inv_lanes.launches += 1
    return out


def fwd_sublanes(x: torch.Tensor) -> torch.Tensor:
    """Forward along axis 1 of (P, n, L), float32 or complex64 input;
    permuted complex64 output.  The prefix P is one grid dimension of a
    single launch.  Replaces pallas_fft._fwd_sublanes_kernel."""
    P_, n, L = x.shape
    _check(x, n, "fwd_sublanes", complex_only=False)
    if not _launch_kernel(x, "fwd_sublanes"):
        return fwd_sublanes_plain(x)
    out = torch.empty((P_, n, L), dtype=torch.complex64, device=x.device)
    real = x.dtype == torch.float32
    _launch(LIBRARY.load().mtt_fwd_sublanes, _ptr(x) if real else None,
            None if real else _ptr(x), _ptr(out),
            _ptr(_table(n, False, x.device)), P_, n, L, base(n),
            device=x.device, name="fwd_sublanes")
    fwd_sublanes.launches += 1
    return out


def inv_sublanes(x: torch.Tensor) -> torch.Tensor:
    """Inverse along axis 1 of (P, n, L) complex64, permuted input;
    natural-order complex64 output divided by n.  Replaces
    pallas_fft._inv_sublanes_kernel."""
    P_, n, L = x.shape
    _check(x, n, "inv_sublanes", complex_only=True)
    if not _launch_kernel(x, "inv_sublanes"):
        return inv_sublanes_plain(x)
    out = torch.empty((P_, n, L), dtype=torch.complex64, device=x.device)
    _launch(LIBRARY.load().mtt_inv_sublanes, _ptr(x), _ptr(out),
            _ptr(_table(n, True, x.device)), P_, n, L, base(n),
            device=x.device, name="inv_sublanes")
    inv_sublanes.launches += 1
    return out


WRAPPERS = (fwd_lanes, fwd_lanes_pre, inv_lanes, fwd_sublanes, inv_sublanes)
for _w in WRAPPERS:
    _w.launches = 0


def reset_launches():
    for w in WRAPPERS:
        w.launches = 0


def launches() -> Dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


# ---------------------------------------------------------------------------
# n-D unordered transforms (full complex spectrum, permuted along every axis)
# ---------------------------------------------------------------------------


def _split(shape: Sequence[int], d: int) -> Tuple[int, int, int]:
    return math.prod(shape[:d]), shape[d], math.prod(shape[d + 1:])


def _check_extents(shape, axes):
    for d in axes:
        if not supported(shape[d]):
            raise ValueError(f"unordered fft: extent {shape[d]} does not "
                             f"factor as {SUPPORTED_RULE}")


def fwd_axes(x: torch.Tensor, axes: Sequence[int], pre: Pointwise = None) -> torch.Tensor:
    """Forward unordered transform of x along ``axes``, last to first: the
    last array axis (which must be in ``axes``) through ``fwd_lanes``, with
    ``pre`` fused into its read, every other axis through ``fwd_sublanes``
    with the axes before it as the launch's prefix
    (pallas_fft.fwd_axes_planar).  complex64, permuted along ``axes``."""
    shape = tuple(x.shape)
    axes = sorted(axes, reverse=True)
    if not axes or axes[0] != len(shape) - 1:
        raise ValueError("unordered fft: the last axis must be transformed")
    _check_extents(shape, axes)
    u = fwd_lanes(x.contiguous().reshape(-1, shape[-1]), pre=pre).reshape(shape)
    for d in axes[1:]:
        u = fwd_sublanes(u.reshape(_split(shape, d))).reshape(shape)
    return u


def inv_axes(u: torch.Tensor, axes: Sequence[int], real_output: bool = False) -> torch.Tensor:
    """Inverse of ``fwd_axes`` along ``axes``, first to last; with
    ``real_output`` (the last array axis in ``axes``) the REAL float32
    array (the imaginary part of the last-axis inverse is dropped, as in
    irfftn), else complex64 (pallas_fft.inv_axes_planar)."""
    shape = tuple(u.shape)
    axes = sorted(axes)
    last = len(shape) - 1
    if real_output and (not axes or axes[-1] != last):
        raise ValueError("real_output requires the last axis in `axes`")
    _check_extents(shape, axes)
    u = u.to(torch.complex64).contiguous()
    for d in axes:
        if d == last:
            return inv_lanes(u.reshape(-1, shape[-1]),
                             real_output=real_output).reshape(shape)
        u = inv_sublanes(u.reshape(_split(shape, d))).reshape(shape)
    return u


def fftn_unordered(x: torch.Tensor, pre: Pointwise = None,
                   skip_axis0: bool = False) -> torch.Tensor:
    """Forward n-D FFT of a float32 (or complex64) array, complex64 and
    permuted along every axis.  ``pre`` fuses a pointwise function into the
    first (last-axis) kernel's read; ``skip_axis0`` leaves axis 0
    untransformed for a caller that fuses its own kernel along it
    (pallas_fft.fftn_unordered_planar)."""
    return fwd_axes(x, range(1 if skip_axis0 else 0, x.ndim), pre=pre)


def ifftn_unordered(u: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Inverse of ``fftn_unordered``; returns the REAL float32 array (the
    imaginary part of the last-axis inverse is dropped, as in irfftn)."""
    shape = tuple(shape)
    return inv_axes(u.reshape(shape), range(len(shape)), real_output=True)
