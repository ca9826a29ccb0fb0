"""The port's distributed modes on the CPU (marlin_tpu_torch/parallel.py,
the FFT_SLAB paths of domain.py, solvers/abm.py and spectral.py) against
numpy, the port's serial runs and the JAX package's sharded runs.

Ranks are spawned with torch.multiprocessing over gloo (tests/torch_ranks.py:
a file store, one thread a rank, a deadline): one spawn a world size, P = 2
and P = 4, runs every case of this file; the JAX package runs in this
process on the conftest's virtual CPU devices, Pallas in interpret mode.

Tolerances:
- slab transforms in float64: 1e-12 against numpy.fft and the JAX
  package's ``parallel.fft_slab``/``ifft_slab``;
- decks.CH3D_DECK at 16³ on FFT_SLAB, DEFAULT float64, 2 steps: 1e-11 of
  the port's serial run and of the JAX package's slab run
  (tests/test_parallel.py:306-336);
- the PALLAS slab runs (float32 twins) against the JAX package's sharded
  runs: c 2e-5, the carried spectra max(5e-4·max, 2e-5)
  (tests/test_pallas_spectral.py:392-425); the two-field deck 5e-5
  (test_multi_fused_sharded_slab_parity); against the port's serial PALLAS
  run the same;
- kernels 5-6's slab twin against the serial twin's rows: bit for bit.
"""

import math
import os

import numpy as np
import pytest
import torch

from marlin_tpu_torch import decks, hit, parallel
from marlin_tpu_torch import spectral as sp
from marlin_tpu_torch.domain import Domain
from marlin_tpu_torch.executioner import run_deck
from marlin_tpu_torch.problem import TensorProblem

from tests import torch_ranks

WORLDS = (2, 4)
FFT_TOL = 1e-12
CH_TOL = 1e-11
C_TOL = 2e-5
SPEC_REL, SPEC_ABS = 5e-4, 2e-5
MULTI_TOL = 5e-5
N = 16
FUSED = "carry_reciprocal = true\n  fused_spectral = true"

#: the slab transforms: (dim, extents by world size, complex input)
FFTS = {
    "3d_real": (3, {2: (8, 12, 10), 4: (8, 12, 10)}, False),
    "3d_complex": (3, {2: (8, 12, 10), 4: (8, 12, 10)}, True),
    "2d_real": (2, {2: (8, 12), 4: (8, 12)}, False),
    "2d_complex": (2, {2: (8, 12), 4: (8, 12)}, True),
    # grids the mesh does not divide: the gather path
    "3d_uneven": (3, {2: (6, 9, 10), 4: (6, 10, 10)}, False),
}


def ch3d(mode, backend="DEFAULT", extra=""):
    text = decks.CH3D_DECK.format(n=N, substeps=3)
    domain = f"[Domain]\n  parallel_mode = {mode}\n  fft_backend = {backend}"
    if backend == "DEFAULT":
        domain += "\n  floating_precision = DOUBLE"
    text = text.replace("[Domain]", domain)
    if extra:
        text = text.replace("[TensorSolver]", f"[TensorSolver]\n  {extra}")
    return text


def multi(mode):
    return decks.MULTI_3D_DECK.format(
        n=N, domain_extra=f"parallel_mode = {mode}\n  fft_backend = PALLAS",
        solver_extra=FUSED)


CSV_PPS = """
[Postprocessors]
  [c_mean]
    type = TensorAveragePostprocessor
    buffer = c
  []
  [c_max]
    type = TensorExtremeValuePostprocessor
    buffer = c
    value_type = MAX
  []
  [c_min]
    type = TensorExtremeValuePostprocessor
    buffer = c
    value_type = MIN
  []
  [change]
    type = TensorIntegralChangePostprocessor
    buffer = c
  []
  [mass]
    type = ReciprocalIntegral
    buffer = cbar
  []
  [dt_crit]
    type = SemiImplicitCriticalTimeStep
    buffer = kappabarbar
  []
[]
[Outputs]
  csv = true
[]
"""

SPECTRA = ("cbar", "Mbarmubar")
#: the Cahn-Hilliard deck from a seeded RandomTensor: each rank's own draw
RANDOM_IC = """    [c]
      type = RandomTensor
      buffer = c
      min = 0.45
      max = 0.55
      seed = 7
    []
"""


def ch3d_random(mode):
    text = ch3d(mode)
    start = text.index("    [c]\n")
    return text[:start] + RANDOM_IC + text[text.index("    []\n", start) + 7:]


#: the deck runs: name -> (deck text, steps, dt, buffers compared)
RUNS = {
    "ch3d_default": (lambda: ch3d("FFT_SLAB"), 2, 1.0, ("c",) + SPECTRA),
    "ch3d_pallas": (lambda: ch3d("FFT_SLAB", "PALLAS"), 2, 1.0, ("c",) + SPECTRA),
    "ch3d_fused": (lambda: ch3d("FFT_SLAB", "PALLAS", FUSED), 2, 1.0, ("c",) + SPECTRA),
    "multi_fused": (lambda: multi("FFT_SLAB"), 2, 0.05, ("c", "n1")),
    "ch3d_random": (lambda: ch3d_random("FFT_SLAB"), 1, 1.0, ("c",)),
}
#: the initial buffers a run sends back
INITIAL = {"ch3d_random": ("c",)}


def _cases(world, tmp):
    cases = [("slab_fft", dict(dim=d, n=n[world], complex_input=c))
             for d, n, c in FFTS.values()]
    cases += [("deck_run", dict(text=make(), steps=steps, mode="FFT_SLAB", dt=dt,
                                buffers=keys, initial=INITIAL.get(name, ())))
              for name, (make, steps, dt, keys) in RUNS.items()]
    cases.append(("deck_run", dict(text=ch3d("FFT_SLAB") + CSV_PPS, steps=2,
                                   mode="FFT_SLAB", how="run_deck",
                                   output_dir=str(tmp / f"csv{world}"))))
    cases += [("named_error", dict(text=t, mode="FFT_SLAB", output_dir=str(tmp / "err")))
              for t in ERRORS.values()]
    return cases


#: named errors under FFT_SLAB on a mesh: deck -> the words (None: a deck
#: that the port once refused on a mesh and that runs on one now, as it
#: does in the JAX package: the XDMF and checkpoint decks since the per-rank
#: writers and the sharded checkpoint, compared in
#: tests/test_torch_mesh_outputs.py and tests/test_torch_checkpoint_sharded.py)
ERRORS = {
    "xdmf": ch3d("FFT_SLAB") + "[TensorOutputs]\n  [x]\n    type = XDMFTensorOutput\n"
    "    buffer = c\n  []\n[]\n",
    "checkpoint": ch3d("FFT_SLAB") + "[Executioner]\n  checkpoint_interval = 1\n[]\n",
    "batch_fft": ch3d("FFT_SLAB").replace("[Problem]", "[Problem]\n  batch_fft = true"),
    "etdrk4": decks.CH3D_ETDRK4_DECK.format(n=N, substeps=2, solver_extra="").replace(
        "[Domain]", "[Domain]\n  parallel_mode = FFT_SLAB"),
    "mechanics": decks.MECH_DECK.format(
        n=N, domain_extra="parallel_mode = FFT_SLAB\n  fft_backend = PALLAS\n"
        "  floating_precision = SINGLE"),
    "stencil": ch3d("FFT_SLAB").replace("  [Solve]\n", """  [Solve]
    [lap]
      type = FiniteDifferenceLaplacian
      buffer = lap
      input = c
    []
""", 1),
}
ERROR_WORDS = {
    "xdmf": None,
    "checkpoint": None,
    "batch_fft": "batch_fft = true is serial-only",
    "etdrk4": None,
    # a tensor field on the PALLAS slab (marlin_tpu/domain.py:408-413)
    "mechanics": "fft_backend = PALLAS supports scalar fields only in FFT_SLAB mode",
    "stencil": None,
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's results on each world size: one spawn a world size."""
    tmp = tmp_path_factory.mktemp("ranks")
    out = {}
    for world in WORLDS:
        cases = _cases(world, tmp)
        res = torch_ranks.spawn(world, cases, tmp)
        out[world] = {"results": res, "cases": cases, "tmp": tmp}
    return out


def _result(ranks, world, name, kind="deck_run", **match):
    """The ranks' results of the first case of ``kind`` whose arguments
    hold ``match``."""
    block = ranks[world]
    for (k, kw), res in zip(block["cases"], block["results"]):
        if k == kind and all(kw.get(a) == v for a, v in match.items()):
            return res
    raise KeyError(name)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's parallel modules; Pallas in interpret mode."""
    import jax
    import jax.numpy as jnp

    import marlin_tpu.pallas_fft as pf
    from marlin_tpu import hit as jhit
    from marlin_tpu import parallel as jpar
    from marlin_tpu.domain import Domain as JDomain
    from marlin_tpu.domain import ParallelMode, Precision
    from marlin_tpu.problem import TensorProblem as JProblem

    old = pf._INTERPRET
    pf._INTERPRET = True
    yield type("JX", (), dict(jax=jax, jnp=jnp, hit=jhit, par=jpar, Domain=JDomain,
                              Mode=ParallelMode, Precision=Precision, Problem=JProblem))
    pf._INTERPRET = old


def _jax_run(jx, text, world, steps, dt):
    """The JAX package's sharded run of a deck, as its tests drive it."""
    mesh = jx.par.make_mesh(jx.Mode.FFT_SLAB, jx.jax.devices()[:world])
    p = jx.Problem(jx.hit.parse(text), mesh=mesh)
    s = jx.par.shard_state(p.domain, p.init_state())
    for i in range(steps):
        s = p.step(s, i * dt, dt, dt, i == 0)
    return {k: np.asarray(v) for k, v in s["buffers"].items()}


def _serial(text, steps, dt):
    text = text.replace("parallel_mode = FFT_SLAB", "parallel_mode = NONE")
    p = TensorProblem(hit.parse(text), device="cpu")
    s = p.init_state()
    for i in range(steps):
        s = p.step(s, i * dt, dt, dt, i == 0)
    return {k: v.numpy() for k, v in s["buffers"].items()}


def _assembled(res, key, shape):
    blocks = [((r["reciprocal_slice"] if np.iscomplexobj(r["buffers"][key])
                else r["slice"]), r["buffers"][key]) for r in res]
    return torch_ranks.assemble(blocks, shape)


# -- slab transforms ---------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(FFTS))
def test_slab_fft_matches_numpy_and_jax(ranks, jx, world, case):
    dim, extents, complex_input = FFTS[case]
    n = extents[world]
    res = _result(ranks, world, case, kind="slab_fft", dim=dim, n=n,
                  complex_input=complex_input)
    rng = np.random.RandomState(0)
    g = rng.randn(*n)
    if complex_input:
        g = g + 1j * rng.randn(*n)
    ref = np.fft.fftn(g) if (complex_input or dim == 2) else np.fft.rfftn(g)
    got = torch_ranks.assemble([r["spectrum"] for r in res], ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=FFT_TOL * np.abs(ref).max())
    back = torch_ranks.assemble([r["back"] for r in res], n)
    np.testing.assert_allclose(back, g.real, rtol=0, atol=FFT_TOL)
    assert all(r["uneven"] for r in res) == (case == "3d_uneven")

    mesh = jx.par.make_mesh(jx.Mode.FFT_SLAB, jx.jax.devices()[:world])
    jdom = jx.Domain(dim, n, maxs=[1, 1, 1], parallel_mode=jx.Mode.FFT_SLAB,
                     floating_precision=jx.Precision.DOUBLE, mesh=mesh)
    # inside jit, as tests/test_parallel.py drives the uneven path
    jz = np.asarray(jx.jax.jit(jdom.fft)(jx.jnp.asarray(g)))
    np.testing.assert_allclose(got, jz, rtol=0, atol=FFT_TOL * np.abs(jz).max())
    jb = np.asarray(jx.jax.jit(jdom.ifft)(jx.jnp.asarray(jz)))
    np.testing.assert_allclose(back, jb, rtol=0, atol=FFT_TOL)


# -- the Cahn-Hilliard deck on FFT_SLAB ---------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_ch3d_slab_default_matches_serial_and_jax(ranks, jx, world):
    make, steps, dt, keys = RUNS["ch3d_default"]
    res = _result(ranks, world, "ch3d_default", text=make())
    got = _assembled(res, "c", (N,) * 3)
    np.testing.assert_allclose(got, _serial(make(), steps, dt)["c"], rtol=0, atol=CH_TOL)
    ref = _jax_run(jx, make(), world, steps, dt)
    np.testing.assert_allclose(got, ref["c"], rtol=0, atol=CH_TOL)
    # the spectra on the slab layout: X-stacked blocks of the half spectrum
    for key in SPECTRA:
        spec = _assembled(res, key, ref[key].shape[:3])
        np.testing.assert_allclose(spec, ref[key], rtol=0,
                                   atol=CH_TOL * max(1.0, np.abs(ref[key]).max()))
    assert {r["n_advances"] for r in res} == {steps + 1}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("run", ["ch3d_pallas", "ch3d_fused"])
def test_ch3d_slab_pallas_matches_serial_and_jax(ranks, jx, world, run):
    """PALLAS on the slab, unfused and fused (kernels 1′, 3, 5 in its slab
    form, 4, 2 through their twins), against the JAX package's sharded run
    (interpret mode) and the port's serial PALLAS run."""
    make, steps, dt, keys = RUNS[run]
    res = _result(ranks, world, run, text=make())
    serial = _serial(make(), steps, dt)
    ref = _jax_run(jx, make(), world, steps, dt)
    for other in (ref, serial):
        np.testing.assert_allclose(_assembled(res, "c", (N,) * 3), other["c"], rtol=0,
                                   atol=C_TOL)
        for key in SPECTRA:
            a = other[key]
            np.testing.assert_allclose(_assembled(res, key, a.shape[:3]), a, rtol=0,
                                       atol=max(SPEC_REL * np.abs(a).max(), SPEC_ABS),
                                       err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_random_ic_draws_the_global_stream(ranks, jx, world):
    """A seeded RandomTensor on a mesh: every rank seeds and draws its own
    block's shape (reference RandomTensor.C:42-53), so the global field is
    rank 0's block tiled in rank order.  The draw equals the JAX package's
    sharded one bit for bit in float64, and c after a step within
    CH_TOL."""
    make, steps, dt, keys = RUNS["ch3d_random"]
    res = _result(ranks, world, "ch3d_random", text=make())
    blocks = [r["initial"]["c"] for r in res]
    for b in blocks[1:]:
        np.testing.assert_array_equal(b, blocks[0])
    drawn = torch_ranks.assemble([(r["slice"], r["initial"]["c"]) for r in res], (N,) * 3)
    assert drawn.dtype == np.float64
    np.testing.assert_array_equal(drawn, _jax_run(jx, make(), world, 0, dt)["c"])
    np.testing.assert_allclose(_assembled(res, "c", (N,) * 3),
                               _jax_run(jx, make(), world, steps, dt)["c"], rtol=0,
                               atol=CH_TOL)


@pytest.mark.parametrize("world", [2])
def test_multi_fused_slab_matches_serial_and_jax(ranks, jx, world):
    """decks.MULTI_3D_DECK fused on the slab (kernel 6 in its slab form)."""
    make, steps, dt, keys = RUNS["multi_fused"]
    res = _result(ranks, world, "multi_fused", text=make())
    serial = _serial(make(), steps, dt)
    ref = _jax_run(jx, make(), world, steps, dt)
    for key in keys:
        got = _assembled(res, key, (N,) * 3)
        np.testing.assert_allclose(got, ref[key], rtol=0, atol=MULTI_TOL, err_msg=key)
        np.testing.assert_allclose(got, serial[key], rtol=0, atol=MULTI_TOL, err_msg=key)


# -- kernels 5-6 in slab form, one process --------------------------------------------------


@pytest.mark.parametrize("form", ["lapsq_mobility", "sh_no_mobility", "poly"])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_slab_update_twin_equals_serial_rows(form, p):
    """The slab twin over P local x rows (transform along y, k² from the
    row's kx²+kz² table) equals the serial twin run row by row with that
    row's table, bit for bit."""
    rng = np.random.RandomState(p)
    rows, n, L = 8 // p, 8, 6
    c64 = lambda *s: torch.from_numpy((rng.randn(*s) + 1j * rng.randn(*s))
                                      .astype(np.complex64))
    ky2 = torch.from_numpy(rng.rand(n).astype(np.float32))
    kxz2 = torch.from_numpy(rng.rand(rows * L).astype(np.float32))
    args = (0.1, 1.5, -0.5)
    if form == "poly":
        coef = np.asarray([[0.0, -5.0, 0.0, 0.0, -10.0], [1.0, 0.0, 0.0, -15.0, 0.0]],
                          np.float32)
        rows8 = np.concatenate([np.tile(np.asarray(args, np.float32), (2, 1)), coef], 1)
        m, u, o = (c64(2, rows, n, L) for _ in range(3))
        got = sp.fwd_x_update_poly(m, u, o, ky2, kxz2, rows8)
        for r in range(rows):
            want = sp.fwd_x_update_poly(m[:, r].contiguous(), u[:, r].contiguous(),
                                        o[:, r].contiguous(), ky2,
                                        kxz2[r * L:(r + 1) * L].contiguous(), rows8)
            for g, w in zip(got, want):
                assert torch.equal(g[:, r], w)
        return
    mobility, lin = {"lapsq_mobility": (5.0, ("lapsq", -10.0)),
                     "sh_no_mobility": (None, ("sh", 0.025, 1.0))}[form]
    m, u, o = (c64(rows, n, L) for _ in range(3))
    got = sp.fwd_x_update(m, u, o, ky2, kxz2, *args, mobility, lin)
    for r in range(rows):
        want = sp.fwd_x_update(m[r].contiguous(), u[r].contiguous(), o[r].contiguous(),
                               ky2, kxz2[r * L:(r + 1) * L].contiguous(), *args,
                               mobility, lin)
        for g, w in zip(got, want):
            assert torch.equal(g[r], w)


# -- the executioner on a mesh: postprocessors reduced, rank 0 alone writes ---------------


@pytest.mark.parametrize("world", WORLDS)
def test_rank0_alone_writes_the_csv(ranks, world, tmp_path):
    block = ranks[world]
    res = _result(ranks, world, "csv", how="run_deck")
    out = block["tmp"] / f"csv{world}"
    written = sorted(p.name for p in out.iterdir() if (p / "out.csv").exists())
    assert written == ["rank0"]
    root = hit.parse(ch3d("NONE") + CSV_PPS)
    root.child("Executioner", create=True).set_param("num_steps", "2")
    serial = run_deck(root, device="cpu", output_dir=str(tmp_path))
    for r in res:
        for key, want in serial.pp_values.items():
            assert r["pps"][key] == pytest.approx(want, rel=1e-11, abs=1e-13), key
    sharded = (out / "rank0" / "out.csv").read_text().splitlines()
    reference = (tmp_path / "out.csv").read_text().splitlines()
    assert sharded[0] == reference[0] and len(sharded) == len(reference)
    for a, b in zip(sharded[1:], reference[1:]):
        np.testing.assert_allclose([float(v) for v in a.split(",")],
                                   [float(v) for v in b.split(",")], rtol=1e-11,
                                   atol=1e-13)


# -- named errors and layouts ------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(ERRORS))
def test_named_errors_on_a_mesh(ranks, world, case):
    res = _result(ranks, world, case, kind="named_error", text=ERRORS[case])
    if ERROR_WORDS[case] is None:
        assert all(r is None for r in res), res
        return
    assert all(r is not None and ERROR_WORDS[case] in r for r in res), res


def _stub_mesh(shape, names):
    """A parallel.Mesh laid out without a process group (rank 0), for the
    layout rules alone."""
    mesh = parallel.Mesh.__new__(parallel.Mesh)
    mesh.shape, mesh.axis_names, mesh.group = tuple(shape), tuple(names), None
    mesh.size, mesh.rank, mesh.backend = math.prod(shape), 0, "gloo"
    mesh.axis_groups = {}
    return mesh


class TestDivisibilityValidation:
    """tests/test_parallel.py::TestDivisibilityValidation's rules in the
    JAX package's words (marlin_tpu/parallel.py:162)."""

    def test_slab_uneven_accepted(self):
        dom = Domain(dim=2, n=[200, 200], parallel_mode="FFT_SLAB", device="cpu",
                     mesh=_stub_mesh((3,), ("sp",)))
        assert dom.uneven
        assert dom.shape == (200, 67) and dom.reciprocal_shape == (67, 200)

    def test_pallas_slab_uneven_rejected(self):
        with pytest.raises(ValueError, match="PALLAS"):
            Domain(dim=3, n=[128, 128, 128], parallel_mode="FFT_SLAB",
                   fft_backend="PALLAS", device="cpu", mesh=_stub_mesh((3,), ("sp",)))

    def test_pencil_uneven(self):
        dom = type("D", (), dict(dim=3, n_global=(16, 16, 18),
                                 global_reciprocal_shape=(9, 16, 18),
                                 parallel_mode="FFT_PENCIL", fft_backend="DEFAULT",
                                 mesh=_stub_mesh((2, 4), ("p1", "p2"))))()
        with pytest.raises(ValueError, match="does not divide evenly"):
            parallel.validate_mesh(dom)

    def test_even_passes(self):
        dom = Domain(dim=3, n=[16, 16, 16], parallel_mode="FFT_SLAB", device="cpu",
                     mesh=_stub_mesh((4,), ("sp",)))
        assert not dom.uneven
        assert dom.shape == (16, 4, 16) and dom.reciprocal_shape == (4, 16, 9)
        assert parallel.local_slices(dom) == [
            (slice(None), slice(4 * r, 4 * r + 4), slice(None)) for r in range(4)]

    def test_real_space_uneven_accepted(self):
        dom = Domain(dim=3, n=[10, 8, 8], parallel_mode="REAL_SPACE", device="cpu",
                     mesh=_stub_mesh((4,), ("p1",)))
        assert dom.uneven and dom.shape == (3, 8, 8)
        with pytest.raises(RuntimeError, match="FFT is not available in REAL_SPACE"):
            dom.fft(torch.zeros(dom.shape, dtype=torch.float64))


def test_pallas_slab_takes_scalar_fields_only():
    """The JAX package's scalar-only refusal of the PALLAS slab
    (marlin_tpu/domain.py:408-413), before any collective."""
    dom = Domain(dim=3, n=[16, 16, 16], parallel_mode="FFT_SLAB", fft_backend="PALLAS",
                 device="cpu", mesh=_stub_mesh((4,), ("sp",)))
    for fn, t in ((dom.fft, torch.zeros(16, 4, 16, 2)),
                  (dom.ifft, torch.zeros(4, 16, 16, 2, dtype=torch.complex64))):
        with pytest.raises(RuntimeError, match="supports scalar fields only in FFT_SLAB"):
            fn(t)


def test_fft_pencil_waits_for_the_next_slice():
    """FFT_PENCIL is ported (tests/test_torch_pencil.py): a 3-D pencil
    builds, a 2-D one is refused with the reference's words."""
    with pytest.raises(ValueError, match="Dimension must be 3 for pencil decomposition"):
        Domain(dim=2, n=[8, 8], parallel_mode="FFT_PENCIL", device="cpu")
    dom = Domain(dim=3, n=[8, 8, 8], parallel_mode="FFT_PENCIL", device="cpu",
                 mesh=_stub_mesh((2, 2), ("p1", "p2")))
    assert dom.shape == (8, 4, 4) and dom.reciprocal_shape == (3, 4, 8)


def test_real_space_mesh_that_cuts_z_waits_for_a_later_slice():
    """The z cut is ported (tests/test_torch_mesh_family.py): a 3-D
    REAL_SPACE mesh builds, its halos on all three axes."""
    dom = Domain(dim=3, n=[8, 8, 8], parallel_mode="REAL_SPACE", device="cpu",
                 mesh=_stub_mesh((2, 2, 2), ("p1", "p2", "p3")))
    assert dom.halo_dims() == (0, 1, 2) and dom.shape == (4, 4, 4)


@pytest.mark.parametrize("mode", ["FFT_SLAB", "REAL_SPACE"])
def test_parallel_deck_without_a_mesh_runs_its_layouts_on_one_device(jx, mode):
    """Without a mesh a parallel-mode deck runs on one device, as the JAX
    package's mesh=None (3-D slab: z halved as serial mode; 2-D slab: the
    full spectrum)."""
    if mode == "FFT_SLAB":
        for dim, n in ((3, (8, 6, 10)), (2, (8, 6))):
            dom = Domain(dim, n, parallel_mode=mode, device="cpu")
            jdom = jx.Domain(dim, n, maxs=[1, 1, 1], parallel_mode=jx.Mode.FFT_SLAB,
                             floating_precision=jx.Precision.DOUBLE)
            g = np.random.RandomState(dim).randn(*n)
            got = dom.fft(torch.from_numpy(g)).numpy()
            want = np.asarray(jdom.fft(jx.jnp.asarray(g)))
            assert got.shape == want.shape == dom.reciprocal_shape
            np.testing.assert_allclose(got, want, rtol=0, atol=FFT_TOL * np.abs(want).max())
            np.testing.assert_allclose(dom.ifft(torch.from_numpy(got)).numpy(), g,
                                       rtol=0, atol=FFT_TOL)
        p = TensorProblem(hit.parse(ch3d("FFT_SLAB")), device="cpu")
        s = p.init_state()
        for i in range(2):
            s = p.step(s, float(i), 1.0, 1.0, i == 0)
        np.testing.assert_allclose(s["buffers"]["c"].numpy(),
                                   _serial(ch3d("FFT_SLAB"), 2, 1.0)["c"], rtol=0,
                                   atol=CH_TOL)
    else:
        dom = Domain(3, (8, 6, 4), parallel_mode=mode, device="cpu")
        assert dom.shape == (8, 6, 4) and dom.reciprocal_shape == (0, 0, 0)
        assert dom.halo_dims() == ()
