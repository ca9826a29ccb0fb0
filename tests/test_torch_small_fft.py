"""The small-extent path of the unordered-FFT kernels (b = n, n = 8 to 400
but 128; csrc/fft_tile.cuh small_lanes_kernel and small_sublanes_kernel).

On the CPU: the plan that unordered_fft.py builds and uploads for the
kernels, read back as the kernels read it and run through their stage loop
in numpy float64 (the same index arithmetic, float32 1/Ns included), against
numpy's FFT to 1e-12 of the largest output; the path rule; the plan's
dtype and cache.  On the card (`cuda`, skipped here): each kernel against
its twin (1e-5 of the twin's largest output, the twins sum in float32) and
against torch.fft in complex128 rounded to complex64 (2.4e-7 of the largest
output: two float32 roundings, the kernel's and the reference's).
"""

import numpy as np
import pytest
import torch

from marlin_tpu_torch import unordered_fft as uf

EMULATION_TOL = 1e-12
TWIN_TOL = 1e-5
C128_TOL = 2.4e-7
SMALL = [n for n in range(8, 401) if n not in (128, 256, 384)]
# the sweep on the card: every radix, primes above 7, b = n at both ends
SWEEP = [8, 9, 12, 25, 49, 64, 97, 100, 125, 199, 200, 243, 343, 397, 400]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def read_plan(plan):
    """The plan's header and complex128 values, as the kernels read them."""
    raw = np.asarray(plan).tobytes()
    words = np.frombuffer(raw, np.int32)
    values = np.frombuffer(raw, np.complex128)
    n, nstages, inverse, ntw = (int(v) for v in words[:4])
    stages = []
    for s in range(nstages):
        R, Ns, nb, first, rec = words[4 + uf.SMALL_STAGE_WORDS * s:][:uf.SMALL_STAGE_WORDS]
        stages.append((int(R), int(Ns), int(nb), int(first),
                       np.array([rec], np.int32).view(np.float32)[0]))
    return n, inverse, ntw, stages, values


def run_stages(x, plan):
    """small_fft of csrc/fft_tile.cuh in numpy float64: for each stage,
    butterfly j takes j/Ns as float32 (j + 1/2)·(1/Ns) rounded down, reads
    a[j + q·nb], multiplies by twiddle (q−1)·Ns + j mod Ns, takes DFT_R (a
    direct sum over the plan's roots for a prime R > 7) and writes
    c[(j/Ns)·Ns·R + j mod Ns + t·Ns].  Returns the unnormalised transform."""
    n, inverse, _ntw, stages, values = read_plan(plan)
    assert len(x) == n
    sign = 2j if inverse else -2j
    a = x.astype(np.complex128)
    for R, Ns, nb, first, rNs in stages:
        j = np.arange(nb)
        jh = ((j.astype(np.float32) + np.float32(0.5)) * rNs).astype(np.int64)
        assert np.array_equal(jh, j // Ns), (n, R, Ns)
        jl = j - jh * Ns
        out0 = jh * Ns * R + jl
        q = np.arange(R)
        u = a[j[:, None] + q[None, :] * nb]
        tw = np.ones((nb, R), np.complex128)
        tw[:, 1:] = values[first + (q[None, 1:] - 1) * Ns + jl[:, None]]
        u = u * tw
        if R > 8:
            roots = values[first + (R - 1) * Ns:][:R]
            v = u @ roots[np.outer(q, q) % R]
        else:
            v = u @ np.exp(sign * np.pi * np.outer(q, q) / R)
        c = np.empty(n, np.complex128)
        c[out0[:, None] + q[None, :] * Ns] = v
        a = c
    return a


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_small_plan_stage_loop_matches_numpy(inverse):
    """Every b = n extent from 8 to 400, both directions."""
    rng = np.random.default_rng(11)
    for n in SMALL:
        plan = uf.small_plan(n, inverse)
        got_n, got_inv, ntw, stages, _ = read_plan(plan)
        assert (got_n, got_inv) == (n, int(inverse))
        assert [s[0] for s in stages] == uf.small_radices(n)
        assert sorted(uf.small_radices(n)) == sorted(uf.radices(n))
        assert ntw == n - 1 + sum(r for r in uf.radices(n) if r > 8)
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        ref = n * np.fft.ifft(x) if inverse else np.fft.fft(x)
        err = np.abs(run_stages(x, plan) - ref).max() / np.abs(ref).max()
        assert err <= EMULATION_TOL, (n, err)


@pytest.mark.parametrize("n", [12, 40, 200, 343, 374, 400])
def test_small_plan_any_radix_order(n):
    """A plan on n's radices in another order (8, 4, 2 first, as the tile
    takes them and fft_probe.py times them) is a plan of the same
    transform."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    for inverse in (False, True):
        plan = uf.build_small_plan(n, uf.radices(n), inverse)
        assert plan.nbytes == uf.small_plan_bytes(n)
        ref = n * np.fft.ifft(x) if inverse else np.fft.fft(x)
        err = np.abs(run_stages(x, plan) - ref).max() / np.abs(ref).max()
        assert err <= EMULATION_TOL, (n, inverse, err)


def test_path_rule():
    """register at n = 128, 256, 512, 1024; small wherever b = n otherwise;
    the tile at the other multiples of 128; None where unsupported."""
    for n in range(2, 1101):
        b = uf.base(n)
        want = (None if b == 0 else "register" if n in (128, 256, 512, 1024)
                else "small" if b == n else "tile")
        assert uf.path(n) == want, n
    assert [n for n in range(2, 1101) if uf.path(n) == "tile"] == [384, 640, 768, 896]
    assert [n for n in range(2, 1101) if uf.path(n) == "small"] == SMALL


def test_small_plan_is_float64_and_cached():
    cpu = torch.device("cpu")
    for n in (8, 200, 397):
        for inverse in (False, True):
            tab = uf._small_plan(n, inverse, cpu)
            assert tab.dtype == torch.float64 and tab.is_contiguous()
            assert tab.numel() * 8 == uf.small_plan_bytes(n)
            assert uf._small_plan(n, inverse, cpu) is tab
            assert uf._table(n, inverse, cpu) is tab
            assert np.array_equal(tab.numpy(), uf.small_plan(n, inverse))
        assert not torch.equal(uf._small_plan(n, False, cpu), uf._small_plan(n, True, cpu))
    # the other paths keep the complex64 W_n^j table
    assert uf._table(384, False, cpu).dtype == torch.complex64
    assert uf._table(512, True, cpu).dtype == torch.complex64


def test_small_plan_twiddles_are_exact_roots():
    """Each stage's twiddles are W_{Ns·R}^{∓q·j} to float64 rounding."""
    for inverse in (False, True):
        n, _inv, _ntw, stages, values = read_plan(uf.small_plan(200, inverse))
        sign = 2j if inverse else -2j
        for R, Ns, _nb, first, _r in stages:
            q, j = np.meshgrid(np.arange(1, R), np.arange(Ns), indexing="ij")
            want = np.exp(sign * np.pi * q * j / (Ns * R)).ravel()
            assert np.abs(values[first:first + len(want)] - want).max() <= 4e-16


# -- on the card ------------------------------------------------------------------


def _c128(name, x):
    """torch.fft in complex128 along the kernel's axis, rounded to complex64
    (the inverse lanes kernel's real part to float32)."""
    dim = -1 if name.endswith("_lanes") else 1
    y = x.to(torch.complex128)
    y = torch.fft.ifft(y, dim=dim) if name.startswith("inv") else torch.fft.fft(y, dim=dim)
    return y.real.to(torch.float32) if name == "inv_lanes" else y.to(torch.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SWEEP)
@pytest.mark.parametrize("name", ["fwd_lanes", "inv_lanes", "fwd_sublanes", "inv_sublanes"])
def test_cuda_small_kernel_matches_twin_and_c128(cuda, name, n):
    lib = uf.LIBRARY.load()
    assert lib.mtt_fwd_path(n, n) == lib.mtt_inv_path(n, n) == 2 and uf.path(n) == "small"
    gen = torch.Generator().manual_seed(n)
    shape = (37, n) if name.endswith("_lanes") else (3, n, 37)
    inputs = [torch.randn(shape, generator=gen, dtype=torch.complex64)]
    if name.startswith("fwd"):
        inputs.append(torch.randn(shape, generator=gen, dtype=torch.float32))
    for x in inputs:
        x = x.to(cuda)
        got = getattr(uf, name)(x)
        torch.cuda.synchronize()
        ref = getattr(uf, name + "_plain")(x)
        assert (got - ref).abs().max().item() <= TWIN_TOL * ref.abs().max().item()
        exact = _c128(name, x)
        assert (got - exact).abs().max().item() <= C128_TOL * exact.abs().max().item()


@pytest.mark.cuda
def test_cuda_paths(cuda):
    """The C library chooses the path that ``path`` names at every extent."""
    lib = uf.LIBRARY.load()
    names = {0: "tile", 1: "register", 2: "small"}
    for n in range(8, 1025):
        if uf.supported(n):
            assert names[lib.mtt_fwd_path(n, uf.base(n))] == uf.path(n), n
            assert names[lib.mtt_inv_path(n, uf.base(n))] == uf.path(n), n
