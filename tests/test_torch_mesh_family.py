"""Every compute and solver of the port on a mesh, on the CPU: REAL_SPACE
stencils (``FiniteDifferenceLaplacian``, a z cut, ``LBMIsotropicGradient``
and ``LBMIsotropicLaplacian`` on cut axes), the solver family (ETDRK4,
forward Euler, Secant, Broyden, the coupled ABM) on FFT_SLAB and
FFT_PENCIL, and NEML2's ImplicitUpdate on FFT_SLAB, against the port's
serial runs and the JAX package's sharded runs; and the combinations the
JAX package refuses on a mesh, refused in its words.

Mirrors tests/test_parallel.py:178 test_laplacian_deck_sharded (on
``decks.LAPLACIAN_RS_DECK``, the stand-in for the reference's
real_space/laplacian.i, at (2, 2), and in 3-D with the z cut at (1, 1, 2)
and (2, 1, 2)), tests/test_solvers_parallel.py:39 (NEML2's ImplicitUpdate
on a slab, here ``decks.NEML2_PERZYNA_DECK``) and :98 (the coupled solver,
both configurations, on ``decks.COUPLED_DECK``, the stand-in for
coupled.i).  Ranks are spawned over gloo (tests/torch_ranks.py), one
spawn of two ranks and one of four; the JAX package runs on the
conftest's virtual CPU devices.

Tolerances, float64: 1e-10 of each field's largest value against serial
and the JAX package (the REAL_SPACE runs are bit for bit with serial:
the halo holds the same values the roll reads); the coupled solver 1e-11
(tests/test_solvers_parallel.py:113); the iterative solvers' iteration
counts equal to serial.
"""

import numpy as np
import pytest

from marlin_tpu_torch import decks, hit
from marlin_tpu_torch.problem import TensorProblem

from tests import torch_ranks

TOL = 1e-10
COUPLED_TOL = 1e-11
DOUBLE = "floating_precision = DOUBLE"
N = 16
SECANT = ("SecantSolver", "max_iterations = 30\n  relative_tolerance = 1e-8\n"
          "  absolute_tolerance = 1e-12", 0.5)
BROYDEN = ("BroydenSolver", "max_iterations = 60\n  relative_tolerance = 1e-6\n"
           "  absolute_tolerance = 1e-12\n  initial_jacobian_guess = -1", 0.05)
#: the coupled solver's configurations (tests/test_solvers_parallel.py:96-97)
COUPLED_CFGS = {"ss10_cs1_o2": (10, 1, 2), "ss4_cs2_o3": (4, 2, 3)}


def _domain(text, mode, extra=DOUBLE):
    return text.replace("[Domain]", f"[Domain]\n  parallel_mode = {mode}\n  {extra}", 1)


def ch3d_solver(mode, solver):
    name, extra, _ = solver
    return _domain(decks.CH3D_DECK.format(n=N, substeps=2).replace(
        "type = AdamsBashforthMoulton", f"type = {name}\n  {extra}"), mode)


def etdrk4(mode, backend="DEFAULT"):
    text = decks.CH3D_ETDRK4_DECK.format(n=N, substeps=2, solver_extra="cox_matthews = true")
    if backend == "PALLAS":
        return _domain(text, mode, "fft_backend = PALLAS\n  floating_precision = SINGLE")
    return _domain(text, mode)


def coupled(cfg):
    ss, cs, order = COUPLED_CFGS[cfg]
    return decks.COUPLED_DECK.format(n=32, h=decks.half_cell(32), substeps=ss, order=order,
                                     corrector_steps=cs, solver_extra="",
                                     domain_extra=f"{DOUBLE}\n  parallel_mode = FFT_SLAB")


def laplacian(dim, stencil=3, mode="REAL_SPACE"):
    n = 16 if dim == 2 else 12
    return decks.laplacian_rs(dim, n, stencil=stencil, domain_extra=DOUBLE).replace(
        "parallel_mode = REAL_SPACE", f"parallel_mode = {mode}")


def _dt(text):
    return float(text.split("\n  dt = ")[1].split()[0])


def twophase(mode="REAL_SPACE"):
    return decks.TWOPHASE2D_DECK.format(n=16, substeps=3, backend="JNP").replace(
        "[Domain]", f"[Domain]\n  parallel_mode = {mode}", 1)


def neml2(tmp, mode):
    model = tmp / "perzyna.i"
    spectral = tmp / "spectral.i"
    model.write_text(decks.NEML2_PERZYNA_MODEL)
    spectral.write_text(decks.NEML2_SPECTRAL_MODEL)
    return decks.NEML2_PERZYNA_DECK.format(
        n=8, dt=0.1, steps=3, model=str(model), spectral_model=str(spectral), cli_args="",
        domain_extra=f"{DOUBLE}\n  parallel_mode = {mode}")


def _runs(tmp):
    """name -> (world, deck_run arguments)."""
    runs = {
        "lap2d_2x2": (4, dict(text=laplacian(2), mode="REAL_SPACE", mesh_shape=(2, 2),
                              how="run_deck", output_dir=str(tmp / "lap"),
                              buffers=("u", "lap"))),
        "lap3d_1x1x2": (2, dict(text=laplacian(3, 5), mode="REAL_SPACE",
                                mesh_shape=(1, 1, 2), buffers=("u", "lap"))),
        "lap3d_2x1x2": (4, dict(text=laplacian(3, 5), mode="REAL_SPACE",
                                mesh_shape=(2, 1, 2), buffers=("u", "lap"))),
        "lap3d_pencil2x2": (4, dict(text=laplacian(3, 5, "FFT_PENCIL"), mode="FFT_PENCIL",
                                    mesh_shape=(2, 2), buffers=("u", "lap"))),
        "lap2d_slab2": (2, dict(text=laplacian(2, 3, "FFT_SLAB"), mode="FFT_SLAB",
                                buffers=("u", "lap"))),
        "twophase_2x2": (4, dict(text=twophase(), mode="REAL_SPACE", mesh_shape=(2, 2),
                                 buffers=("phi", "grad_phi", "laplacian_phi"))),
        "etdrk4_slab4": (4, dict(text=etdrk4("FFT_SLAB"), mode="FFT_SLAB", buffers=("c",))),
        "etdrk4_pencil2x2": (4, dict(text=etdrk4("FFT_PENCIL"), mode="FFT_PENCIL",
                                     mesh_shape=(2, 2), buffers=("c",))),
        "etdrk4_pallas_slab2": (2, dict(text=etdrk4("FFT_SLAB", "PALLAS"), mode="FFT_SLAB",
                                        buffers=("c",))),
        "explicit_slab4": (4, dict(text=decks.EXPLICIT_DECK.format(
            n=32, substeps=4, domain_extra=f"{DOUBLE}\n  parallel_mode = FFT_SLAB"),
            mode="FFT_SLAB", dt=0.1, buffers=("u",))),
        "secant_slab2": (2, dict(text=ch3d_solver("FFT_SLAB", SECANT), mode="FFT_SLAB",
                                 dt=SECANT[2], buffers=("c",))),
        "secant_pencil2x2": (4, dict(text=ch3d_solver("FFT_PENCIL", SECANT),
                                     mode="FFT_PENCIL", mesh_shape=(2, 2), dt=SECANT[2],
                                     buffers=("c",))),
        "broyden_slab4": (4, dict(text=ch3d_solver("FFT_SLAB", BROYDEN), mode="FFT_SLAB",
                                  dt=BROYDEN[2], buffers=("c",))),
        "broyden_pencil1x2": (2, dict(text=ch3d_solver("FFT_PENCIL", BROYDEN),
                                      mode="FFT_PENCIL", mesh_shape=(1, 2),
                                      dt=BROYDEN[2], buffers=("c",))),
        "neml2_z4": (4, dict(text=neml2(tmp, "REAL_SPACE"), mode="REAL_SPACE",
                             mesh_shape=(1, 1, 4), dt=0.1, buffers=("Ep", "ep", "S", "psi"),
                             counts=("perzyna",))),
    }
    for cfg in COUPLED_CFGS:
        runs[f"coupled_{cfg}"] = (4, dict(text=coupled(cfg), mode="FFT_SLAB", dt=0.1,
                                          buffers=("u", "v")))
    for name, (world, kw) in runs.items():
        kw.setdefault("steps", 3 if name.startswith(("coupled", "neml2")) else 2)
        if kw["mode"] == "REAL_SPACE" and name.startswith("lap"):
            kw.setdefault("dt", _dt(kw["text"]))
    return runs


#: combinations the JAX package refuses on a mesh: name -> (world, deck,
#: mode, mesh shape, the JAX package's words)
REFUSALS = {
    "fused_lbm_3d_mesh": (4, decks.POROUS_DECK.format(
        n=8, substeps=2, backend="PALLAS", media_h5="media.h5").replace(
            "[Domain]", "[Domain]\n  parallel_mode = REAL_SPACE", 1), "REAL_SPACE", (2, 1, 2),
        "REAL_SPACE requires a 1-D (x) or 2-D (x×y) mesh"),
    "fft_on_real_space": (2, _domain(decks.CH3D_DECK.format(n=8, substeps=1), "REAL_SPACE"),
                          "REAL_SPACE", (2,), "FFT is not available in REAL_SPACE parallel mode."),
    "mechanics_pallas_slab": (2, decks.MECH_DECK.format(
        n=8, domain_extra="parallel_mode = FFT_SLAB\n  fft_backend = PALLAS\n"
        "  floating_precision = SINGLE"), "FFT_SLAB", None,
        "fft_backend = PALLAS supports scalar fields only in FFT_SLAB mode"),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    runs = _runs(tmp)
    out = {}
    for world in (2, 4):
        names = [n for n, (w, _) in runs.items() if w == world]
        cases = [("deck_run", runs[n][1]) for n in names]
        refusals = [n for n, r in REFUSALS.items() if r[0] == world]
        cases += [("named_error", dict(
            text=REFUSALS[n][1], mode=REFUSALS[n][2], mesh_shape=REFUSALS[n][3],
            output_dir=str(tmp / "err"),
            arrays={"media": decks.porous_media(8)} if "lbm" in n else None))
            for n in refusals]
        res = torch_ranks.spawn(world, cases, tmp)
        out.update(zip(names + refusals, res))
    return {"results": out, "runs": runs}


@pytest.fixture(scope="module")
def jx():
    import jax

    jax.config.update("jax_enable_x64", True)
    import marlin_tpu.pallas_fft as pf
    from marlin_tpu import hit as jhit
    from marlin_tpu import parallel as jpar
    from marlin_tpu.domain import ParallelMode
    from marlin_tpu.problem import TensorProblem as JProblem

    old = pf._INTERPRET
    pf._INTERPRET = True
    yield type("JX", (), dict(jax=jax, hit=jhit, par=jpar, Mode=ParallelMode,
                              Problem=JProblem))
    pf._INTERPRET = old


def _jax_run(jx, kw, world):
    mesh = jx.par.make_mesh(getattr(jx.Mode, kw["mode"]), jx.jax.devices()[:world],
                            shape=kw.get("mesh_shape"))
    p = jx.Problem(jx.hit.parse(kw["text"]), mesh=mesh)
    s = jx.par.shard_state(p.domain, p.init_state())
    dt = kw.get("dt", 1.0)
    for i in range(kw["steps"]):
        s = p.step(s, i * dt, dt, dt, i == 0)
    return {k: np.asarray(v) for k, v in s["buffers"].items()}, s


def _serial(kw, arrays=None):
    """The port's run of the same deck on one device, without a mesh (a
    pencil deck in the pencil's layout)."""
    p = TensorProblem(hit.parse(kw["text"]), device="cpu", arrays=arrays)
    s = p.init_state()
    dt = kw.get("dt", 1.0)
    for i in range(kw["steps"]):
        s = p.step(s, i * dt, dt, dt, i == 0)
    return {k: v.numpy() for k, v in s["buffers"].items()}, torch_ranks.counts_of(
        p, kw.get("counts", ()))


def _assert_fields(res, want, keys, tol, what):
    for k in keys:
        got = torch_ranks.assemble([(r["slice"], r["buffers"][k]) for r in res],
                                   want[k].shape)
        scale = max(float(np.abs(want[k]).max()), 1e-300)
        err = float(np.abs(got - want[k]).max())
        assert err <= tol * scale, f"{k} against {what}: {err / scale:.3e}"


def _check(ranks, name, jx=None, tol=TOL, exact=False):
    res = ranks["results"][name]
    world, kw = ranks["runs"][name]
    serial, counts = _serial(kw)
    keys = kw["buffers"]
    _assert_fields(res, serial, keys, 0.0 if exact else tol, "the port's serial run")
    if jx is not None:
        _assert_fields(res, _jax_run(jx, kw, world)[0], keys, tol,
                       "the JAX package's sharded run")
    return res, counts


# -- REAL_SPACE ---------------------------------------------------------------------------


def test_laplacian_deck_sharded(ranks, jx, tmp_path):
    """test_parallel.py:178 on ``LAPLACIAN_RS_DECK`` (2-D, 16²) on a 2 × 2
    REAL_SPACE mesh: u and ∇²u bit for bit with serial, within 1e-10 of
    the JAX package's sharded run, the CSV values rank 0 writes equal to
    serial's."""
    res, _ = _check(ranks, "lap2d_2x2", jx, exact=True)
    from marlin_tpu_torch.executioner import run_deck

    serial = run_deck(hit.parse(laplacian(2)), device="cpu", output_dir=str(tmp_path))
    for r in res:
        for key, want in serial.pp_values.items():
            assert r["pps"][key] == pytest.approx(want, rel=1e-12, abs=1e-14), key


@pytest.mark.parametrize("name", ["lap3d_1x1x2", "lap3d_2x1x2"])
def test_laplacian_z_cut(ranks, jx, name):
    """The 3-D REAL_SPACE mesh (the z cut, marlin_tpu/parallel.py:46-70):
    the 5-point Laplacian's two-plane halos along x, y and z (the wrap of
    a one-rank axis its own planes), bit for bit with serial and within
    1e-10 of the JAX package's run on the same mesh."""
    _check(ranks, name, jx, exact=True)


@pytest.mark.parametrize("name", ["lap3d_pencil2x2", "lap2d_slab2"])
def test_laplacian_on_spectral_meshes(ranks, jx, name):
    """``FiniteDifferenceLaplacian`` and ``RealSpaceForwardEuler`` on a
    pencil (y and z cut) and a 2-D slab (y cut): the halos follow the
    real-space layout's cut axes, bit for bit with serial and within 1e-10
    of the JAX package's sharded run."""
    _check(ranks, name, jx, exact=True)


def test_isotropic_stencils_on_cut_axes(ranks):
    """``LBMIsotropicGradient``/``Laplacian`` of the two-phase chain
    (``decks.TWOPHASE2D_DECK``, 16²) on a 2 × 2 REAL_SPACE mesh: the
    edge-replicating pad takes the neighbour's plane inside the grid and
    the clamped plane at the grid's faces, so the run is bit for bit with
    serial (the chain is held against the JAX package serially in
    tests/test_torch_lbm_phase_bc.py)."""
    _check(ranks, "twophase_2x2", exact=True)


# -- the solver family --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["etdrk4_slab4", "etdrk4_pencil2x2"])
def test_etdrk4_on_a_mesh(ranks, jx, name):
    """ETDRK4 (Cox-Matthews) on the local reciprocal block: the phi tables
    a k-point, on the slab's z half and the pencil's x half, within 1e-10
    of serial and of the JAX package's sharded run."""
    _check(ranks, name, jx)


def test_etdrk4_on_the_pallas_slab(ranks, jx):
    """ETDRK4 on FFT_SLAB + PALLAS (float32): the slab forms of kernels 1-4
    through their twins, within 4e-5 of c's largest value (2e-5 on c ≈ 0.5,
    tests/test_torch_parallel.py's PALLAS slab tolerance) of the port's
    serial PALLAS run and of the JAX package's sharded PALLAS run (its
    kernels in interpret mode)."""
    _check(ranks, "etdrk4_pallas_slab2", jx, tol=4e-5)


def test_forward_euler_on_a_slab(ranks, jx):
    """ForwardEulerSolver on a 2-D slab (full spectrum), 4 ranks."""
    _check(ranks, "explicit_slab4", jx)


@pytest.mark.parametrize("name", ["secant_slab2", "secant_pencil2x2", "broyden_slab4",
                                  "broyden_pencil1x2"])
def test_iterative_solvers_on_a_mesh(ranks, jx, name):
    """Secant and Broyden on the 3-D Cahn-Hilliard deck: every rank runs
    the iterations serial runs, deciding on norms summed over the group
    (and without a pencil's pad rows); c within 1e-10 of serial and of the
    JAX package's sharded run."""
    res, counts = _check(ranks, name, jx)
    for r in res:
        assert r["counts"]["solver"] == counts["solver"], name
    assert counts["solver"]["iterations"] > 2 * counts["solver"]["substeps"]


@pytest.mark.parametrize("cfg", sorted(COUPLED_CFGS))
def test_coupled_solver_sharded_matches_serial(ranks, jx, cfg):
    """tests/test_solvers_parallel.py:98 on ``COUPLED_DECK`` (32², slab 4,
    both configurations): the pointwise small solves on each rank's block,
    u and v within 1e-11 of serial and of the JAX package's sharded run."""
    res, _ = _check(ranks, f"coupled_{cfg}", jx, tol=COUPLED_TOL)
    for r in res:
        assert all(np.isfinite(r["buffers"][k]).all() for k in ("u", "v"))


def test_neml2_implicit_update_sharded(ranks, jx):
    """tests/test_solvers_parallel.py:39 on ``NEML2_PERZYNA_DECK`` (8³, 3
    steps): ImplicitUpdate's field-wide Newton decides on a group maximum,
    so every rank runs serial's iterations; the fields within 1e-10 of
    serial and of the JAX package's sharded run.  The mesh cuts z, four
    ranks: the deck's strain ``dir*0.002*t*(1+x)`` broadcasts the aligned
    x axis (n, 1, 1) against the Mandel axis of (n, n, n, 6), so x runs
    along y in both packages, and only a block that keeps x and y whole
    gives it the shape it has on the whole grid."""
    res, counts = _check(ranks, "neml2_z4", jx)
    for r in res:
        assert r["counts"]["perzyna"] == counts["perzyna"]
    assert max(max(log) for log in counts["perzyna"] if log) > 1


# -- refusals -----------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_in_the_jax_words(ranks, jx, name):
    """A combination the JAX package refuses on a mesh is refused by the
    port in its words: the fused LBM on a 3-D REAL_SPACE mesh
    (marlin_tpu/pallas_lbm.py:1112-1114), a transform under REAL_SPACE,
    and a tensor field on the PALLAS slab (marlin_tpu/domain.py:408-413)."""
    world, text, mode, shape, words = REFUSALS[name]
    res = ranks["results"][name]
    assert all(r is not None and words in r for r in res), res
    mesh = jx.par.make_mesh(getattr(jx.Mode, mode), jx.jax.devices()[:world], shape=shape)
    if "lbm" in name:
        return  # the JAX words are held in tests/test_torch_lbm_sharded.py
    with pytest.raises(Exception, match=words.replace(".", r"\.")):
        p = jx.Problem(jx.hit.parse(text), mesh=mesh)
        s = jx.par.shard_state(p.domain, p.init_state())
        p.step(s, 0.0, 0.01, 0.01, True)
