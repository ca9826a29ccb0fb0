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


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,dtype", _CASES)
def test_cuda_kernel_matches_twin(cuda, name, shape, dtype):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen, dtype=dtype).to(cuda)
    wrapper = getattr(uf, name)
    twin = getattr(uf, name + "_plain")
    before = wrapper.launches
    got = wrapper(x)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = twin(x)
    err = (got - ref).abs().max().item()
    assert err <= TOL * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [("fwd_lanes", (77, 512)),
                                        ("fwd_sublanes", (2, 512, 300))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
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
    """The forward kernels take the register path exactly at n = 128, 256,
    512 and 1024 (b = 128); every other extent keeps the generic tile."""
    lib = uf.LIBRARY.load()
    reg = [n for n in range(8, 1025) if uf.supported(n)
           and lib.mtt_fwd_path(n, uf.base(n))]
    assert reg == [128, 256, 512, 1024]


@pytest.mark.cuda
def test_cuda_roundtrip_3d(cuda):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((64, 128, 256), generator=gen).to(cuda)
    back = uf.ifftn_unordered(uf.fftn_unordered(x), x.shape)
    assert (back - x).abs().max().item() <= 1e-4
