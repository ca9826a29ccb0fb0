"""FFT_PENCIL in the port (marlin_tpu_torch/parallel.py fft_pencil and
ifft_pencil, the pencil layout of domain.py) against numpy, the port's
serial runs and the JAX package's pencil runs, on the CPU.

Mirrors tests/test_parallel.py TestPencilFFT (:61-96, meshes (2, 2),
(2, 4) and (1, 8)), :331 test_pencil, :361
test_pencil_tiny_grid_pad_disambiguates, :405 test_pencil_uneven, :211
test_gradient_pencil (on ``decks.GRADIENT_DECK``, the stand-in for the
reference's gradient.i) and tests/test_pallas_fft.py:387 (a 2-D pencil
refused).  Ranks are spawned over gloo (tests/torch_ranks.py): one spawn
of four ranks and one of eight; the JAX package runs on the conftest's
eight virtual CPU devices.

Tolerances, float64: the transforms 1e-12 of numpy's and the JAX
package's largest value; the Cahn-Hilliard deck 1e-11 (test_parallel.py
:351-357); the gradient deck's fields and CSV values 1e-10.
"""

import math

import numpy as np
import pytest
import torch

from marlin_tpu_torch import decks, hit, parallel
from marlin_tpu_torch.domain import Domain
from marlin_tpu_torch.executioner import run_deck
from marlin_tpu_torch.problem import TensorProblem

from tests import torch_ranks

FFT_TOL = 1e-12
CH_TOL = 1e-11
GRAD_TOL = 1e-10
N = (8, 8, 16)
TINY = (4, 8, 8)
MESHES = {4: [(2, 2)], 8: [(2, 4), (1, 8)]}
GRAD_N = 40
GRAD_BUFFERS = ("dcdx", "dcdy", "dcdz", "grad_sq")


def ch3d(mode):
    return decks.CH3D_DECK.format(n=16, substeps=4).replace(
        "[Domain]", f"[Domain]\n  parallel_mode = {mode}\n  floating_precision = DOUBLE")


#: the spectral postprocessors of a pencil run: k = 0 of c̄ (on the rank
#: whose block starts the spectrum), the largest |κ̄̄| (the pad rows left
#: out), c's mean and change
PPS = """
[Postprocessors]
  [mass]
    type = ReciprocalIntegral
    buffer = cbar
  []
  [dt_crit]
    type = SemiImplicitCriticalTimeStep
    buffer = kappabarbar
  []
  [c_mean]
    type = TensorAveragePostprocessor
    buffer = c
  []
  [change]
    type = TensorIntegralChangePostprocessor
    buffer = c
  []
[]
[Outputs]
  csv = true
[]
"""


def gradient(mode):
    return decks.GRADIENT_DECK.format(
        n=GRAD_N, domain_extra=f"parallel_mode = {mode}\n  floating_precision = DOUBLE")


def _cases(world, tmp):
    cases = []
    for shape in MESHES[world]:
        cases.append(("pencil_fft", dict(n=N, shape=shape, seed=3, kspace=True)))
        cases.append(("pencil_fft", dict(n=N, shape=shape, seed=4, complex_input=True)))
        cases.append(("deck_run", dict(text=gradient("FFT_PENCIL"), steps=2,
                                       mode="FFT_PENCIL", mesh_shape=shape,
                                       how="run_deck", buffers=GRAD_BUFFERS,
                                       output_dir=str(tmp / f"grad{shape}"))))
    if world == 4:
        cases.append(("pencil_fft", dict(n=TINY, shape=(2, 2), seed=6)))
        cases.append(("deck_run", dict(text=ch3d("FFT_PENCIL") + PPS, steps=2,
                                       mode="FFT_PENCIL", mesh_shape=(2, 2), how="run_deck",
                                       output_dir=str(tmp / "pps"))))
        cases.append(("named_error", dict(text=ch3d("FFT_PENCIL").replace(
            "nx = 16", "nx = 6"), mode="FFT_PENCIL", mesh_shape=(4, 1),
            output_dir=str(tmp / "err"))))
    else:
        cases.append(("deck_run", dict(text=ch3d("FFT_PENCIL"), steps=2, mode="FFT_PENCIL",
                                       mesh_shape=(2, 4), buffers=("c", "cbar"))))
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    out = {}
    for world in MESHES:
        cases = _cases(world, tmp)
        out[world] = (cases, torch_ranks.spawn(world, cases, tmp))
    return out


def _result(ranks, world, kind, **match):
    cases, results = ranks[world]
    for (k, kw), res in zip(cases, results):
        if k == kind and all(kw.get(a) == v for a, v in match.items()):
            return res
    raise KeyError((kind, match))


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from marlin_tpu import hit as jhit
    from marlin_tpu import parallel as jpar
    from marlin_tpu.domain import Domain as JDomain
    from marlin_tpu.domain import ParallelMode, Precision
    from marlin_tpu.problem import TensorProblem as JProblem

    return type("JX", (), dict(jax=jax, jnp=jnp, hit=jhit, par=jpar, Domain=JDomain,
                               Mode=ParallelMode, Precision=Precision, Problem=JProblem))


def _jax_mesh(jx, shape):
    return jx.par.make_mesh(jx.Mode.FFT_PENCIL, jx.jax.devices()[:math.prod(shape)],
                            shape=shape)


def _world(shape):
    return math.prod(shape)


def _field(n, seed, complex_input=False):
    rng = np.random.RandomState(seed)
    g = rng.rand(*n)
    return g + 1j * rng.rand(*n) if complex_input else g


# -- the transforms --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (1, 8)])
def test_pencil_fft_matches_numpy_and_jax(ranks, jx, shape):
    """TestPencilFFT (test_parallel.py:61-96): the round trip, the true rows
    of the padded half spectrum against numpy's (x halved) with the pad
    rows exact zeros, a pointwise k² operator between the transforms equal
    to the serial run's, the JAX package's pencil spectrum, and two
    all_to_all a transform, each within one mesh row or column."""
    res = _result(ranks, _world(shape), "pencil_fft", shape=shape, seed=3)
    g = _field(N, 3)
    rshape = res[0]["reciprocal_shape"]
    nxh = N[0] // 2 + 1
    assert rshape == (nxh + res[0]["pad"], N[1], N[2]) and rshape[0] % shape[0] == 0
    got = torch_ranks.assemble([r["spectrum"] for r in res], rshape)
    ref = np.fft.fftn(g)[:nxh]
    np.testing.assert_allclose(got[:nxh], ref, rtol=0, atol=FFT_TOL * np.abs(ref).max())
    assert np.all(got[nxh:] == 0)
    back = torch_ranks.assemble([r["back"] for r in res], N)
    np.testing.assert_allclose(back, g, rtol=0, atol=FFT_TOL)
    sdom = Domain(3, N, maxs=[1.0, 2.0, 3.0], floating_precision="DOUBLE", device="cpu")
    x = torch.from_numpy(g)
    want = sdom.ifft(sdom.fft(x) / (1.0 + 0.01 * sdom.k_square)).numpy()
    ks = torch_ranks.assemble([r["kspace"] for r in res], N)
    np.testing.assert_allclose(ks, want, rtol=0, atol=1e-10)
    assert all(r["calls"]["all_to_all"] == 4 for r in res)

    jdom = jx.Domain(3, list(N), maxs=[1.0, 2.0, 3.0], parallel_mode=jx.Mode.FFT_PENCIL,
                     floating_precision=jx.Precision.DOUBLE, mesh=_jax_mesh(jx, shape))
    assert jdom.reciprocal_shape == rshape and jdom.reciprocal_pad == res[0]["pad"]
    jz = np.asarray(jdom.fft(jx.jnp.asarray(g)))
    np.testing.assert_allclose(got, jz, rtol=0, atol=FFT_TOL * np.abs(jz).max())


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (1, 8)])
def test_pencil_complex_input_keeps_the_full_spectrum(ranks, jx, shape):
    """Complex input takes the full spectrum (marlin_tpu/parallel.py:447-460)
    and inverts to the real part, as the JAX package's does."""
    res = _result(ranks, _world(shape), "pencil_fft", shape=shape, seed=4)
    g = _field(N, 4, complex_input=True)
    got = torch_ranks.assemble([r["spectrum"] for r in res], N)
    ref = np.fft.fftn(g)
    np.testing.assert_allclose(got, ref, rtol=0, atol=FFT_TOL * np.abs(ref).max())
    back = torch_ranks.assemble([r["back"] for r in res], N)
    np.testing.assert_allclose(back, g.real, rtol=0, atol=FFT_TOL)
    jdom = jx.Domain(3, list(N), maxs=[1.0, 2.0, 3.0], parallel_mode=jx.Mode.FFT_PENCIL,
                     floating_precision=jx.Precision.DOUBLE, mesh=_jax_mesh(jx, shape))
    jz = np.asarray(jdom.fft(jx.jnp.asarray(g)))
    np.testing.assert_allclose(got, jz, rtol=0, atol=FFT_TOL * np.abs(jz).max())


def test_pencil_complex_input_needs_nx_divisible_by_p1(ranks, jx):
    """The full spectrum splits nx over p1: nx = 6 on a (4, 1) mesh is
    refused in the JAX package's words (marlin_tpu/parallel.py:450-455)."""
    res = _result(ranks, 4, "named_error")
    words = "FFT_PENCIL full-spectrum (complex-input) transform needs nx=6"
    # the deck's real transforms run; its complex ones do not exist, so
    # the refusal is held on the transform itself
    assert all(r is None for r in res), res
    dom = Domain(3, (6, 8, 8), parallel_mode="FFT_PENCIL", device="cpu",
                 mesh=_stub_mesh((4, 1)))
    with pytest.raises(ValueError, match=words.replace("(", r"\(").replace(")", r"\)")):
        dom.fft(torch.zeros(dom.shape, dtype=torch.complex128))
    jdom = jx.Domain(3, [6, 8, 8], maxs=[1.0, 1.0, 1.0], parallel_mode=jx.Mode.FFT_PENCIL,
                     mesh=_jax_mesh(jx, (4, 1)))
    with pytest.raises(ValueError, match=r"needs nx=6 divisible by the p1 mesh axis \(4\)"):
        jdom.fft(jx.jnp.zeros((6, 8, 8), jx.jnp.complex64))


def test_pencil_tiny_grid_pad_disambiguates(ranks, jx):
    """test_parallel.py:361: nx = 4 over p1 = 2 pads one more tile, so the
    half spectrum's extent (6) differs from nx and the inverse tells them
    apart; the round trip is exact and the layout the JAX package's."""
    res = _result(ranks, 4, "pencil_fft", n=TINY)
    g = _field(TINY, 6)
    assert res[0]["reciprocal_shape"][0] != TINY[0] and res[0]["pad"] == 3
    back = torch_ranks.assemble([r["back"] for r in res], TINY)
    np.testing.assert_allclose(back, g, rtol=0, atol=FFT_TOL)
    jdom = jx.Domain(3, list(TINY), maxs=[1.0, 2.0, 3.0],
                     parallel_mode=jx.Mode.FFT_PENCIL,
                     floating_precision=jx.Precision.DOUBLE, mesh=_jax_mesh(jx, (2, 2)))
    assert jdom.reciprocal_shape == res[0]["reciprocal_shape"]


# -- decks on the pencil ---------------------------------------------------------------------


def _serial(text, steps, dt=1.0):
    p = TensorProblem(hit.parse(text), device="cpu")
    s = p.init_state()
    for i in range(steps):
        s = p.step(s, i * dt, dt, dt, i == 0)
    return {k: v.numpy() for k, v in s["buffers"].items()}


def test_pencil(ranks, jx):
    """test_parallel.py:331: the semi-implicit Cahn-Hilliard deck (16³,
    ABM, the k-space update on the padded half spectrum) on a (2, 4)
    pencil equals the serial run and the JAX package's pencil run."""
    res = _result(ranks, 8, "deck_run", mode="FFT_PENCIL", mesh_shape=(2, 4),
                  buffers=("c", "cbar"))
    got = torch_ranks.assemble([(r["slice"], r["buffers"]["c"]) for r in res], (16,) * 3)
    np.testing.assert_allclose(got, _serial(ch3d("NONE"), 2)["c"], rtol=0, atol=CH_TOL)
    mesh = _jax_mesh(jx, (2, 4))
    p = jx.Problem(jx.hit.parse(ch3d("FFT_PENCIL")), mesh=mesh)
    s = jx.par.shard_state(p.domain, p.init_state())
    for i in range(2):
        s = p.step(s, float(i), 1.0, 1.0, i == 0)
    np.testing.assert_allclose(got, np.asarray(s["buffers"]["c"]), rtol=0, atol=CH_TOL)
    spec = torch_ranks.assemble([(r["reciprocal_slice"], r["buffers"]["cbar"]) for r in res],
                                p.domain.reciprocal_shape)
    jspec = np.asarray(s["buffers"]["cbar"])
    np.testing.assert_allclose(spec[:9], jspec[:9], rtol=0,
                               atol=CH_TOL * np.abs(jspec).max())


def test_spectral_postprocessors_on_the_pencil(ranks, jx, tmp_path):
    """ReciprocalIntegral's k = 0 slot (held by the rank whose block starts
    the spectrum), SemiImplicitCriticalTimeStep over the spectrum without
    the pad rows, c's mean and change on a (2, 2) pencil: every rank holds
    the serial run's values and the JAX package's pencil run's."""
    res = _result(ranks, 4, "deck_run", mesh_shape=(2, 2), how="run_deck",
                  text=ch3d("FFT_PENCIL") + PPS)
    serial = run_deck(hit.parse(ch3d("NONE") + PPS + "[Executioner]\n  num_steps = 2\n[]\n"),
                      device="cpu", output_dir=str(tmp_path / "s"))
    from marlin_tpu.executioner import run_deck as jax_run_deck

    jroot = jx.hit.parse(ch3d("FFT_PENCIL") + PPS)
    jroot.child("Executioner", create=True).set_param("num_steps", "2")
    jtr = jax_run_deck(jroot, output_dir=str(tmp_path / "j"), mesh=_jax_mesh(jx, (2, 2)))
    assert set(serial.pp_values) == {"mass", "dt_crit", "c_mean", "change"}
    for r in res:
        for key, want in serial.pp_values.items():
            assert r["pps"][key] == pytest.approx(want, rel=GRAD_TOL, abs=1e-14), key
            assert r["pps"][key] == pytest.approx(float(jtr.pp_values[key]), rel=GRAD_TOL,
                                                  abs=1e-14), key


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_gradient_pencil(ranks, jx, shape, tmp_path):
    """test_parallel.py:211 on ``GRADIENT_DECK`` (40³, the stand-in for
    the reference's gradient.i): the spectral gradients on the pencil and
    the CSV values equal the serial run's and the JAX package's pencil
    run's; rank 0 alone writes the CSV."""
    res = _result(ranks, _world(shape), "deck_run", mesh_shape=shape, how="run_deck",
                  buffers=GRAD_BUFFERS)
    root = hit.parse(gradient("NONE"))
    serial = run_deck(root, device="cpu", output_dir=str(tmp_path / "s"))
    for key in GRAD_BUFFERS:
        got = torch_ranks.assemble([(r["slice"], r["buffers"][key]) for r in res],
                                   (GRAD_N,) * 3)
        want = serial.state["buffers"][key].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=key)
    from marlin_tpu.executioner import run_deck as jax_run_deck

    jtr = jax_run_deck(jx.hit.parse(gradient("FFT_PENCIL")), output_dir=str(tmp_path / "j"),
                       mesh=_jax_mesh(jx, shape))
    for r in res:
        for key, want in serial.pp_values.items():
            assert r["pps"][key] == pytest.approx(want, rel=GRAD_TOL, abs=GRAD_TOL), key
            assert r["pps"][key] == pytest.approx(float(jtr.pp_values[key]), rel=GRAD_TOL,
                                                  abs=GRAD_TOL), key


# -- layouts and refusals ---------------------------------------------------------------------


def _stub_mesh(shape, names=("p1", "p2")):
    """A parallel.Mesh laid out without a process group (rank 0), for the
    layout rules alone."""
    mesh = parallel.Mesh.__new__(parallel.Mesh)
    mesh.shape, mesh.axis_names, mesh.group = tuple(shape), tuple(names), None
    mesh.size, mesh.rank, mesh.backend = math.prod(shape), 0, "gloo"
    mesh.axis_groups = {}
    return mesh


def test_pencil_uneven(jx):
    """test_parallel.py:405: (16, 16, 18) over (2, 4) is refused at build,
    in the JAX package's words; (16, 16, 16) over (2, 2) builds."""
    with pytest.raises(ValueError, match="does not divide evenly") as port:
        Domain(3, (16, 16, 18), parallel_mode="FFT_PENCIL", device="cpu",
               mesh=_stub_mesh((2, 4)))
    with pytest.raises(ValueError, match="does not divide evenly") as jax_err:
        jx.Domain(3, [16, 16, 18], maxs=[1, 1, 1], parallel_mode=jx.Mode.FFT_PENCIL,
                  mesh=_jax_mesh(jx, (2, 4)))
    assert str(port.value) == str(jax_err.value)
    dom = Domain(3, (16, 16, 16), parallel_mode="FFT_PENCIL", device="cpu",
                 mesh=_stub_mesh((2, 2)))
    assert dom.shape == (16, 8, 8) and dom.reciprocal_shape == (5, 8, 16)
    assert dom.reciprocal_pad == 1


def test_pencil_requires_3d(jx):
    """tests/test_pallas_fft.py:387: a 2-D pencil is refused with the
    reference's words, in both packages."""
    with pytest.raises(ValueError, match="must be 3 for pencil") as port:
        Domain(2, (8, 8), parallel_mode="FFT_PENCIL", device="cpu")
    with pytest.raises(ValueError, match="must be 3 for pencil") as jax_err:
        jx.Domain(2, [8, 8], maxs=[1.0, 1.0], parallel_mode=jx.Mode.FFT_PENCIL)
    assert str(port.value) == str(jax_err.value)


def test_pencil_refuses_pallas(jx):
    """The pencil is DEFAULT only: PALLAS under FFT_PENCIL is refused in the
    JAX package's words (marlin_tpu/domain.py:137-146)."""
    from marlin_tpu.domain import FFTBackend

    with pytest.raises(ValueError, match="supports serial mode and 3-D FFT_SLAB") as port:
        Domain(3, (16, 16, 16), parallel_mode="FFT_PENCIL", fft_backend="PALLAS",
               device="cpu")
    with pytest.raises(ValueError, match="supports serial mode and 3-D FFT_SLAB") as jax_err:
        jx.Domain(3, [16, 16, 16], maxs=[1, 1, 1], parallel_mode=jx.Mode.FFT_PENCIL,
                  fft_backend=FFTBackend.PALLAS)
    assert str(port.value) == str(jax_err.value)


def test_pencil_without_a_mesh_halves_x(jx):
    """Without a mesh a pencil deck runs the pencil's layout on one device,
    as the JAX package's mesh=None does: ``rfftn`` over the axes (1, 2, 0),
    no pad (marlin_tpu/domain.py:457-464, :524-532)."""
    dom = Domain(3, (8, 6, 10), parallel_mode="FFT_PENCIL", floating_precision="DOUBLE",
                 device="cpu")
    jdom = jx.Domain(3, [8, 6, 10], maxs=[1, 1, 1], parallel_mode=jx.Mode.FFT_PENCIL,
                     floating_precision=jx.Precision.DOUBLE)
    g = _field((8, 6, 10), 7)
    got = dom.fft(torch.from_numpy(g)).numpy()
    want = np.asarray(jdom.fft(jx.jnp.asarray(g)))
    assert got.shape == want.shape == dom.reciprocal_shape == (5, 6, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=FFT_TOL * np.abs(want).max())
    np.testing.assert_allclose(dom.ifft(torch.from_numpy(got)).numpy(), g, rtol=0,
                               atol=FFT_TOL)
    assert dom.reciprocal_pad == 0 and dom.half_axis == 0
