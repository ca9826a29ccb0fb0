"""Sharded FFT micromechanics of the port (computes/mechanics.py on
FFT_SLAB and FFT_PENCIL) against the port's serial runs and the JAX
package's sharded runs, on the CPU.

Mirrors tests/test_mechanics_parallel.py on the port's stand-ins for its
reference decks: ``decks.MECH_DECK`` for mech3d.i, ``MECH_2D_DECK`` for
mech.i, ``COUPLED_PF_MECH_DECK`` for coupled_pf_mech.i, and the fracture
showcase as it is.  Four gloo ranks (tests/torch_ranks.py), one spawn for
every case; the JAX package runs on four of the conftest's virtual CPU
devices.

Tolerances (tests/test_mechanics_parallel.py:94-98 and :196-198): F and
stress within 1e-4 of the serial and the JAX sharded run (the Newton and
CG loops stop at converged iterates that a decomposition may move).  The
serial run is the same deck without a mesh: a pencil deck then keeps the
pencil's layout (x halved, ``rfftn`` over the axes (1, 2, 0)).  Against a
serial-mode run (z halved) the pencil differs by 3.3e-3 on F at 12³ in
both packages alike: at an even extent the Green operator is no
projection on the Nyquist planes, and which planes those are follows the
half axis (ROADMAP §3, kept for parity).  The
coupled chain's c within 1e-10 (a direct solve); fracture's d and H
within 5e-7.  The host loops' Newton and CG counts equal the port's
serial run's, the group reductions (``parallel.calls()``) counted.
"""

import os

import numpy as np
import pytest

from marlin_tpu_torch import decks, hit
from marlin_tpu_torch.problem import TensorProblem

from tests import torch_ranks

WORLD = 4
N = 12
MECH_DT = 0.02
FRACTURE_DT = 2e-3
FIELD_TOL = 1e-4
COUPLED_TOL = 1e-10
FRACTURE_TOL = 5e-7
DOUBLE = "floating_precision = DOUBLE"
MECH = "TensorComputes/Solve/root/mech/"
ANALYTIC = [MECH + "analytic_tangent=true"]
#: tests/test_mechanics_parallel.py:106-111's tolerances, with a Newton
#: budget of 4 (about 400 CG iterations a rank)
TIGHT = [MECH + "nl_rel_tol=1e-7", MECH + "nl_abs_tol=1e-9", MECH + "l_tol=1e-8",
         MECH + "l_max_its=200", MECH + "nl_max_its=4"]
HARD = [MECH + "nl_rel_tol=1e-14", MECH + "nl_abs_tol=1e-16", MECH + "nl_max_its=2"]
FRACTURE_OVER = ["Domain/nx=48", "Domain/ny=48", "Domain/floating_precision=DOUBLE",
                 "TensorComputes/Solve/mech/preconditioner=REFERENCE_MEDIUM"]


def mech(mode="NONE", two_d=False, n=N):
    deck = decks.MECH_2D_DECK if two_d else decks.MECH_DECK
    return deck.format(n=n, domain_extra=f"{DOUBLE}\n  parallel_mode = {mode}")


def coupled(mode="NONE", precision=DOUBLE):
    return decks.COUPLED_PF_MECH_DECK.format(
        n=16, substeps=2, domain_extra=f"{precision}\n  parallel_mode = {mode}")


def coupled_pallas(mode="NONE"):
    return coupled(mode, "fft_backend = PALLAS\n  floating_precision = SINGLE")


#: the sharded runs: name -> (deck, overrides, mode, mesh shape, steps, dt,
#: buffers compared); a deck None is the fracture showcase
SUB2 = ["TensorSolver/substeps=2"]
RUNS = {
    "mech3d_slab4": (mech, SUB2, "FFT_SLAB", None, 1, MECH_DT, ("F", "stress")),
    "mech3d_pencil2x2": (mech, SUB2, "FFT_PENCIL", (2, 2), 1, MECH_DT, ("F", "stress")),
    "mech3d_slab4_analytic": (mech, SUB2 + ANALYTIC, "FFT_SLAB", None, 1, MECH_DT,
                              ("F", "stress")),
    "mech2d_slab4": (lambda m: mech(m, two_d=True, n=32), SUB2, "FFT_SLAB", None, 1,
                     MECH_DT, ("F", "stress")),
    "guard": (mech, SUB2 + TIGHT, "FFT_SLAB", None, 1, MECH_DT, ("F",)),
    "newton_flag": (mech, SUB2 + HARD, "FFT_SLAB", None, 1, MECH_DT, ()),
    "coupled": (coupled, [], "FFT_SLAB", None, 2, MECH_DT, ("c", "disp_x")),
    "coupled_pallas": (coupled_pallas, [], "FFT_SLAB", None, 2, MECH_DT, ("c", "disp_x")),
    "fracture": (None, [], "FFT_SLAB", None, 2, FRACTURE_DT, ("d", "H")),
}


def _case(name):
    build, over, mode, shape, steps, dt, keys = RUNS[name]
    kw = dict(steps=steps, mode=mode, mesh_shape=shape, dt=dt, buffers=None,
              counts=() if name.startswith("coupled") else ("mech",), overrides=over)
    if build is None:
        kw.update(text="", path=decks.FRACTURE_DECK,
                  overrides=FRACTURE_OVER + [f"Domain/parallel_mode={mode}"],
                  deck_dir=os.path.dirname(decks.FRACTURE_DECK))
    else:
        kw["text"] = build(mode)
    return kw


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every sharded run on four ranks: one spawn."""
    tmp = tmp_path_factory.mktemp("ranks")
    res = torch_ranks.spawn(WORLD, [("deck_run", _case(n)) for n in RUNS], tmp)
    return dict(zip(RUNS, res))


def _serial(name):
    """The port's serial run of a case, the same deck on one device without
    a mesh (a pencil deck in the pencil's layout, its half spectrum along
    x): its state and its counts."""
    kw = _case(name)
    if kw.get("path"):
        root = hit.load(kw["path"], kw["overrides"])
    else:
        root = hit.parse(kw["text"])
        hit.apply_cli_args(root, list(kw["overrides"]))
    p = TensorProblem(root, device="cpu", deck_dir=kw.get("deck_dir"))
    s = p.init_state()
    dt = kw["dt"]
    for i in range(kw["steps"]):
        s = p.step(s, i * dt, dt, dt, i == 0)
    return {k: v.numpy() for k, v in s["buffers"].items()}, torch_ranks.counts_of(
        p, kw["counts"])


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


def _jax(jx, name):
    """The JAX package's sharded run of a case, as
    tests/test_mechanics_parallel.py drives it."""
    kw = _case(name)
    mesh = jx.par.make_mesh(getattr(jx.Mode, kw["mode"]), jx.jax.devices()[:WORLD],
                            shape=kw["mesh_shape"])
    if kw.get("path"):
        root = jx.hit.load(kw["path"], kw["overrides"])
    else:
        root = jx.hit.parse(kw["text"])
        jx.hit.apply_cli_args(root, list(kw["overrides"]))
    p = jx.Problem(root, mesh=mesh, deck_dir=kw.get("deck_dir"))
    s = jx.par.shard_state(p.domain, p.init_state())
    dt = kw["dt"]
    for i in range(kw["steps"]):
        s = p.step(s, i * dt, dt, dt, i == 0)
    return {k: np.asarray(v) for k, v in s["buffers"].items()}


def _global(res, key, shape):
    return torch_ranks.assemble([(r["slice"], r["buffers"][key]) for r in res], shape)


def _parity(res, other, keys, tol, what):
    for k in keys:
        got = _global(res, k, other[k].shape)
        err = float(np.abs(got - other[k]).max())
        assert err < tol, f"decomposition visible in '{k}' against {what}: {err:.3e}"


@pytest.mark.parametrize("name", ["mech3d_slab4", "mech3d_pencil2x2",
                                  "mech3d_slab4_analytic", "mech2d_slab4"])
def test_mechanics_sharded_matches_serial(ranks, jx, name):
    """tests/test_mechanics_parallel.py:94 (mech.i and mech3d.i on slab 4,
    mech3d.i on a 2 × 2 pencil, the analytic tangent on slab 4) on
    ``MECH_DECK``/``MECH_2D_DECK``: F and stress against the port's serial
    run and the JAX package's sharded run, the same Newton and CG
    iterations as serial, and the CG's dot products and norms reduced over
    the group."""
    res = ranks[name]
    serial, scounts = _serial(name)
    keys = RUNS[name][-1]
    _parity(res, serial, keys, FIELD_TOL, "serial")
    _parity(res, _jax(jx, name), keys, FIELD_TOL, "the JAX package's sharded run")
    want = scounts["mech"]
    for r in res:
        got = r["counts"]["mech"]
        assert got["cg_log"] == want["cg_log"] and got["newton"] == want["newton"]
        # every CG iteration reduces p·Ap, |r| and r·z over the group, and
        # every solve its |b| and |r0|; none is reduced without a mesh
        assert r["calls"]["all_reduce"] >= got["reductions"] >= 3 * got["cg_device"] > 0
        assert want["reductions"] == 0
    assert all(bool(r["buffers"]["__converged_mech__"]) for r in res)


def test_mechanics_sharded_cg_breakdown_guard(ranks):
    """tests/test_mechanics_parallel.py:101: tolerances below the operator's
    floor on slab 4; the guard decides on the reduced p·Ap and r·z, so F
    stays bounded and every rank runs the same iterations."""
    res = ranks["guard"]
    F = _global(res, "F", (N, N, N, 3, 3))
    assert np.isfinite(F).all() and np.abs(F).max() < 2.0
    logs = [r["counts"]["mech"]["cg_log"] for r in res]
    assert all(log == logs[0] for log in logs)


def test_mechanics_sharded_newton_flag_rides_state(ranks):
    """tests/test_mechanics_parallel.py:148: an unconvergeable Newton
    reports done = False through the sharded state, on every rank."""
    res = ranks["newton_flag"]
    assert all(not bool(r["buffers"]["__converged_mech__"]) for r in res)
    assert all(r["counts"]["mech"]["failed"] == 1 for r in res)


def test_quasistatic_coupled_sharded_matches_serial(ranks, jx):
    """tests/test_mechanics_parallel.py:124 on ``COUPLED_PF_MECH_DECK``
    (16³, slab 4): the direct reciprocal-space solve, k = 0 pinned by a
    mask on k², so c within 1e-10 of serial and of the JAX package's
    sharded run."""
    res = ranks["coupled"]
    serial, _ = _serial("coupled")
    _parity(res, serial, ("c", "disp_x"), COUPLED_TOL, "serial")
    _parity(res, _jax(jx, "coupled"), ("c",), COUPLED_TOL,
            "the JAX package's sharded run")


def test_quasistatic_coupled_on_the_pallas_slab(ranks, jx):
    """The same chain on FFT_SLAB + PALLAS (float32, scalar fields, which
    the JAX package's slab kernels take): the acoustic axes' Nyquist masks
    cut to each rank's block of the permuted spectrum, c and the
    displacements within 2e-5 of the port's serial PALLAS run and of the
    JAX package's sharded PALLAS run, its kernels in interpret mode
    (tests/test_pallas_fft.py's tolerance)."""
    res = ranks["coupled_pallas"]
    serial, _ = _serial("coupled_pallas")
    _parity(res, serial, ("c", "disp_x"), 2e-5, "serial")
    _parity(res, _jax(jx, "coupled_pallas"), ("c", "disp_x"), 2e-5,
            "the JAX package's sharded run")


def test_fracture_multiphysics_sharded_pcg_matches_serial(ranks, jx):
    """tests/test_mechanics_parallel.py:166: the fracture showcase at 48²
    with the REFERENCE_MEDIUM preconditioner on slab 4 (its volume-average
    moduli reduced over the group): d and H within 5e-7 of serial and of
    the JAX package's sharded run."""
    res = ranks["fracture"]
    serial, scounts = _serial("fracture")
    _parity(res, serial, ("d", "H"), FRACTURE_TOL, "serial")
    _parity(res, _jax(jx, "fracture"), ("d", "H"), FRACTURE_TOL,
            "the JAX package's sharded run")
    assert res[0]["counts"]["mech"]["newton"] == scounts["mech"]["newton"]
