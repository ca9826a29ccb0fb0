"""The port's unordered FFT (marlin_tpu_torch/unordered_fft.py) against the
JAX package's Pallas kernels (marlin_tpu/pallas_fft.py).

On the CPU the port's wrappers compute their plain twins; the Pallas
kernels run in interpret mode, as tests/test_pallas_fft.py runs them.  The
`cuda` cases hold each CUDA kernel against its twin on the card and skip
where there is none.  Tolerance: 1e-5 of the result's largest magnitude —
both sides sum in float32 (twiddles rounded from float64), in different
orders.
"""

import numpy as np
import pytest
import torch

from marlin_tpu_torch import unordered_fft as uf

TOL = 1e-5


@pytest.fixture
def pf():
    """marlin_tpu.pallas_fft in interpret mode."""
    pf = pytest.importorskip("marlin_tpu.pallas_fft")
    old = pf._INTERPRET
    pf._INTERPRET = True
    yield pf
    pf._INTERPRET = old


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _planar(rr, ri):
    return np.asarray(rr) + 1j * np.asarray(ri)


@pytest.mark.parametrize("n", [64, 128, 200, 256, 384, 512])
def test_lanes_twin_matches_pallas(pf, n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((8, n)).astype(np.float32)
    xi = rng.standard_normal((8, n)).astype(np.float32)
    # forward, real and complex input
    ref = _planar(*pf.fft_lanes(x, None, n))
    assert _rel(uf.fwd_lanes(torch.from_numpy(x)).numpy(), ref) <= TOL
    refc = _planar(*pf.fft_lanes(x, xi, n))
    got = uf.fwd_lanes(torch.from_numpy(x + 1j * xi).to(torch.complex64))
    assert _rel(got.numpy(), refc) <= TOL
    # inverse, real and complex output
    spec = torch.from_numpy(refc.astype(np.complex64))
    ref_r = np.asarray(pf.ifft_lanes(refc.real.astype(np.float32),
                                     refc.imag.astype(np.float32), n))
    assert _rel(uf.inv_lanes(spec).numpy(), ref_r) <= TOL
    ref_c = _planar(*pf.ifft_lanes(refc.real.astype(np.float32),
                                   refc.imag.astype(np.float32), n,
                                   real_output=False))
    assert _rel(uf.inv_lanes(spec, real_output=False).numpy(), ref_c) <= TOL


@pytest.mark.parametrize("n", [64, 128, 256, 384])
@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
def test_sublanes_twin_matches_pallas(pf, n, real):
    rng = np.random.default_rng(1000 + n)
    L = 128
    x = rng.standard_normal((n, L)).astype(np.float32)
    xi = None if real else rng.standard_normal((n, L)).astype(np.float32)
    ref = _planar(*pf.fft_sublanes(x, xi, n))
    tx = torch.from_numpy(x if real else (x + 1j * xi).astype(np.complex64))
    got = uf.fwd_sublanes(tx.reshape(1, n, L)).numpy()[0]
    assert _rel(got, ref) <= TOL
    ref_i = _planar(*pf.ifft_sublanes(ref.real.astype(np.float32),
                                      ref.imag.astype(np.float32), n))
    spec = torch.from_numpy(ref.astype(np.complex64)).reshape(1, n, L)
    assert _rel(uf.inv_sublanes(spec).numpy()[0], ref_i) <= TOL


def test_nd_transforms_match_pallas(pf):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((32, 64, 128)).astype(np.float32)
    ref = np.asarray(pf.fftn_unordered(x))
    got = uf.fftn_unordered(torch.from_numpy(x))
    assert _rel(got.numpy(), ref) <= TOL
    back = uf.ifftn_unordered(got, x.shape).numpy()
    ref_back = np.asarray(pf.ifftn_unordered(ref, x.shape))
    assert np.abs(back - ref_back).max() <= 1e-4
    assert np.abs(back - x).max() <= 1e-4


def test_order_tables_equal_pallas(pf):
    for n in range(1, 1100):
        assert uf.base(n) == pf.base(n), n
        assert uf.supported(n) == pf.supported(n), n
        if uf.supported(n):
            assert np.array_equal(uf.true_k_order(n), pf.true_k_order(n)), n
            h = 0.37
            assert np.array_equal(uf.permuted_freqs(n, h),
                                  pf.permuted_freqs(n, h)), n
    assert uf.SUPPORTED_RULE.split(" (")[0] == pf.SUPPORTED_RULE.split(" (")[0]


def test_cpu_wrappers_use_twins_and_launch_nothing():
    from marlin_tpu_torch.expression import CompiledExpression

    uf.reset_launches()
    x = torch.randn(4, 64, dtype=torch.float32)
    u = uf.fwd_lanes(x)
    pre = uf.Pointwise(CompiledExpression("c^3 - c", ["c"]).compile(), "c")
    assert torch.equal(uf.fwd_lanes(x, pre=pre), uf.fwd_lanes_plain(x**3 - x))
    uf.inv_lanes(u)
    uf.fwd_sublanes(x.reshape(1, 4, 64).transpose(1, 2).contiguous())
    uf.inv_sublanes(u.reshape(1, 4, 64).transpose(1, 2).contiguous())
    assert uf.launches() == {"fwd_lanes": 0, "fwd_lanes_pre": 0, "inv_lanes": 0,
                             "fwd_sublanes": 0, "inv_sublanes": 0}


# -- the register kernels' index maps (csrc/fft_tile.cuh), on the CPU ----------


def _last_radix(n):
    """The radix of the last Stockham stage (fft_tile.cuh reg_radix)."""
    return {128: 2, 256: 4, 512: 8, 1024: 2}[n]


def _reg_slot(n, k):
    """fft_tile.cuh reg_slot: the permuted slot that holds natural index k."""
    r = n // 128
    return (k % r) * 128 + k // r


def _reg_lanes_at(n, e):
    """fft_tile.cuh reg_lanes_at<N, true>: where element e of an inverse
    lanes tile sits in its ring slot."""
    r = n // 128
    shift = {2: 3, 4: 2}.get(r, 1)
    return e ^ (((e >> 7) & (r - 1)) << shift)


def _reg_stockham(x, inverse):
    """The register kernels' schedule in numpy (fft_tile.cuh reg_fft): N/8
    threads, thread t runs butterflies t + T*m of every stage on 8 values,
    outputs to their Stockham places; returns the (T, 8) values the threads
    hold after the last stage."""
    n = len(x)
    T = n // 8
    radices = [8, 8] + {128: [2], 256: [4], 512: [8], 1024: [8, 2]}[n]
    sign = 1.0 if inverse else -1.0
    buf, ns = x.astype(np.complex128), 1
    t = np.arange(T)[:, None]
    for R in radices:
        j = t + T * np.arange(8 // R)[None, :]                  # (T, 8/R)
        q = np.arange(R)
        u = buf[j[..., None] + q * (n // R)]                    # (T, 8/R, R)
        u = u * np.exp(sign * 2j * np.pi * q * (j[..., None] % ns) / (ns * R))
        dft = np.exp(sign * 2j * np.pi * np.outer(q, q) / R)    # [q, u]
        v = u @ dft                                             # (T, 8/R, R)
        out = np.empty(n, np.complex128)
        out[(j[..., None] // ns) * ns * R + j[..., None] % ns + q * ns] = v
        buf, ns = out, ns * R
    return v.reshape(T, 8)


@pytest.mark.parametrize("n", [128, 256, 512, 1024])
def test_register_inverse_index_maps(n):
    """The inverse register kernels read input q of thread t, x[t + q*N/8],
    from its permuted slot and store value i of thread t at natural index
    t + T*m + (N/R)*u (i = m*R + u): both maps are permutations of
    0..N-1, the slot holds that index by true_k_order, and the schedule
    puts the transform's value there.  The lanes swizzle moves whole
    16-byte copies and gives each half-warp's permuted reads 16 distinct
    8-byte bank pairs."""
    T, R = n // 8, _last_radix(n)
    t = np.arange(T)[:, None]
    k_in = t + T * np.arange(8)[None, :]
    slot = _reg_slot(n, k_in)
    assert np.array_equal(np.sort(slot.ravel()), np.arange(n))
    assert np.array_equal(uf.true_k_order(n)[slot], k_in)
    i = np.arange(8)[None, :]
    k_out = t + T * (i // R) + (n // R) * (i % R)
    assert np.array_equal(np.sort(k_out.ravel()), np.arange(n))
    assert np.array_equal(uf.true_k_order(n)[_reg_slot(n, k_out)], k_out)

    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    for inverse, ref in ((False, np.fft.fft(x)), (True, n * np.fft.ifft(x))):
        v = _reg_stockham(x, inverse)
        assert np.abs(v - ref[k_out]).max() <= 1e-9 * np.abs(ref).max()

    e = np.arange(n)
    pos = _reg_lanes_at(n, e)
    assert np.array_equal(np.sort(pos), e)
    assert np.array_equal(pos[1::2], pos[0::2] + 1)
    for q in range(8):
        for h in range(0, T, 16):
            assert len(set(_reg_lanes_at(n, slot[h:h + 16, q]) % 16)) == 16


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError, match="does not factor"):
        uf.fwd_lanes(torch.zeros(2, 516))
    with pytest.raises(TypeError, match="dtype"):
        uf.inv_lanes(torch.zeros(2, 64))
    with pytest.raises(ValueError, match="contiguous"):
        uf.fwd_sublanes(torch.zeros(1, 64, 8).transpose(1, 2))


# -- on the card: each kernel against its twin --------------------------------

_CASES = [
    ("fwd_lanes", (4096, 64), torch.float32),
    ("fwd_lanes", (1000, 200), torch.complex64),
    ("fwd_lanes", (2048, 512), torch.float32),
    ("inv_lanes", (1000, 384), torch.complex64),
    ("inv_lanes", (2048, 512), torch.complex64),
    ("fwd_sublanes", (3, 384, 100), torch.float32),
    ("fwd_sublanes", (8, 512, 512), torch.complex64),
    ("inv_sublanes", (2, 200, 77), torch.complex64),
    ("inv_sublanes", (8, 512, 512), torch.complex64),
]
# the register path of the forward kernels (n = 128 to 1024), real and
# complex, with ragged tails: B = 1001 rows is no multiple of a tile's
# rows (512 / (n/8)), L = 300 and 262145 no multiple of a tile's columns
_CASES += [(name, shape, dtype)
           for n in (128, 256, 512, 1024)
           for name, shape in (("fwd_lanes", (1001, n)), ("fwd_sublanes", (3, n, 300)))
           for dtype in (torch.float32, torch.complex64)]
_CASES += [("fwd_sublanes", (1, 512, 262145), torch.complex64),
           ("fwd_sublanes", (2, 256, 1), torch.float32),
           ("fwd_lanes", (1, 1024), torch.complex64),
           ("fwd_sublanes", (3, 64, 300), torch.float32)]
# the register path of the inverse kernels, with the same ragged tails
_CASES += [(name, shape, torch.complex64)
           for n in (128, 256, 512, 1024)
           for name, shape in (("inv_lanes", (1001, n)), ("inv_sublanes", (3, n, 300)))]
_CASES += [("inv_sublanes", (1, 512, 262145), torch.complex64),
           ("inv_sublanes", (2, 256, 1), torch.complex64)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,dtype", _CASES)
def test_cuda_kernel_matches_twin(cuda, name, shape, dtype):
    """Each kernel against its twin; inv_lanes with the real and the
    complex output."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen, dtype=dtype).to(cuda)
    wrapper = getattr(uf, name)
    twin = getattr(uf, name + "_plain")
    outputs = ({"real_output": True}, {"real_output": False}) if name == "inv_lanes" else ({},)
    for kw in outputs:
        before = wrapper.launches
        got = wrapper(x, **kw)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        ref = twin(x, **kw)
        assert got.dtype == ref.dtype
        err = (got - ref).abs().max().item()
        assert err <= TOL * ref.abs().max().item(), kw


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,dtype", [
    ("fwd_lanes", (77, 512), torch.float32),
    ("fwd_lanes", (77, 512), torch.complex64),
    ("fwd_sublanes", (2, 512, 300), torch.float32),
    ("fwd_sublanes", (2, 512, 300), torch.complex64),
    ("inv_lanes", (77, 512), torch.complex64),
    ("inv_sublanes", (2, 512, 300), torch.complex64)])
def test_cuda_kernel_takes_unaligned_input(cuda, name, shape, dtype):
    """A view one element into its storage is no multiple of 16 bytes, so
    the register kernels copy it value by value; they must agree all the
    same."""
    gen = torch.Generator().manual_seed(2)
    flat = torch.randn(int(np.prod(shape)) + 1, generator=gen, dtype=dtype).to(cuda)
    x = flat[1:].view(shape)
    assert x.data_ptr() % 16 != 0
    got = getattr(uf, name)(x)
    torch.cuda.synchronize()
    ref = getattr(uf, name + "_plain")(x)
    assert (got - ref).abs().max().item() <= TOL * ref.abs().max().item()


@pytest.mark.cuda
def test_cuda_forward_path(cuda):
    """The forward kernels take the register path (1) exactly at n = 128,
    256, 512 and 1024 (b = 128); every other extent keeps the small-extent
    path (2) or the generic tile (0)."""
    lib = uf.LIBRARY.load()
    reg = [n for n in range(8, 1025) if uf.supported(n)
           and lib.mtt_fwd_path(n, uf.base(n)) == 1]
    assert reg == [128, 256, 512, 1024]


@pytest.mark.cuda
def test_cuda_inverse_path(cuda):
    """The inverse kernels take the register path at exactly the forward's
    extents, n = 128, 256, 512 and 1024 (b = 128)."""
    lib = uf.LIBRARY.load()
    reg = [n for n in range(8, 1025) if uf.supported(n)
           and lib.mtt_inv_path(n, uf.base(n)) == 1]
    assert reg == [128, 256, 512, 1024]


@pytest.mark.cuda
def test_cuda_roundtrip_register_path(cuda):
    """(8, 512, 512) forward and back, every launch on the register path."""
    lib = uf.LIBRARY.load()
    assert lib.mtt_fwd_path(512, 128) == lib.mtt_inv_path(512, 128) == 1
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((8, 512, 512), generator=gen).to(cuda)
    uf.reset_launches()
    back = uf.ifftn_unordered(uf.fftn_unordered(x), x.shape)
    torch.cuda.synchronize()
    assert uf.launches() == {"fwd_lanes": 1, "fwd_lanes_pre": 0, "inv_lanes": 1,
                             "fwd_sublanes": 2, "inv_sublanes": 2}
    assert (back - x).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_roundtrip_3d(cuda):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((64, 128, 256), generator=gen).to(cuda)
    back = uf.ifftn_unordered(uf.fftn_unordered(x), x.shape)
    assert (back - x).abs().max().item() <= 1e-4
