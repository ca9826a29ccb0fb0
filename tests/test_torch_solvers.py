"""The port's non-iterative solvers against the JAX package's, on the
CPU: ETDRK4 (both phi tables; the Cox-Matthews order), forward Euler
(spectral and real space), the coupled ABM (against the JAX package and
the deck's exact solution).  The iterative ones: test_torch_iterative.py.

Tolerances (float64, of each buffer's largest magnitude): 1e-10, except
ETDRK4 with the reference's phi tables, 1e-8: their closed forms lose
~3·log10(1/|L·dt|) digits to cancellation (marlin_tpu/solvers/etdrk4.py
documents it), so the two packages' rounding of exp() is amplified.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from marlin_tpu_torch import decks, hit
from marlin_tpu_torch import state as port_state
from marlin_tpu_torch.problem import TensorProblem

F64_TOL = 1e-10
ETDRK4_REFERENCE_TOL = 1e-8
DOUBLE = "floating_precision = DOUBLE"


@pytest.fixture
def jx():
    """The JAX package, its Pallas FFT kernels in interpret mode."""
    pf = pytest.importorskip("marlin_tpu.pallas_fft")
    import jax.numpy as jnp

    from marlin_tpu import hit as jhit
    from marlin_tpu.problem import TensorProblem as JaxProblem

    old = pf._INTERPRET
    pf._INTERPRET = True
    yield SimpleNamespace(jnp=jnp, hit=jhit, Problem=JaxProblem)
    pf._INTERPRET = old


def run_port(text, steps, dt, device="cpu"):
    p = TensorProblem(hit.parse(text), device=device)
    s = p.init_state()
    for i in range(steps):
        s = p.step(s, i * dt, dt, dt, i == 0)
    return p, s


def run_jax(jx, text, steps, dt):
    p = jx.Problem(jx.hit.parse(text))
    s = p.init_state()
    for i in range(steps):
        d = jx.jnp.asarray(dt, p.domain.dtype)
        s = p.step(s, i * dt, d, d, i == 0)
    return p, s


def assert_jax_parity(js, ps, tol=F64_TOL):
    """Every buffer and history slot within ``tol`` of its largest
    magnitude; no solver state in either package."""
    ps = port_state.to_numpy(ps)
    for group in ("buffers", "old"):
        assert set(ps[group]) == set(js[group]), group
        for name, ref in js[group].items():
            ref = np.asarray(ref)
            got = ps[group][name]
            assert got.shape == ref.shape, (group, name)
            scale = max(float(np.abs(ref).max()), 1e-300)
            err = float(np.abs(got - ref).max())
            assert err <= tol * scale, (group, name, err / scale)
    assert set(ps["solver"]) == set(js.get("solver", {})) == set()


def ch3d_etdrk4(cm, domain=DOUBLE, n=16):
    return decks.CH3D_ETDRK4_DECK.format(
        n=n, substeps=10, solver_extra="cox_matthews = true" if cm else "").replace(
            "[Domain]", f"[Domain]\n  {domain}")


def coupled(substeps, corrector_steps, order, n=32, domain=DOUBLE, solver_extra=""):
    return decks.COUPLED_DECK.format(n=n, h=decks.half_cell(n), substeps=substeps,
                                     order=order, corrector_steps=corrector_steps,
                                     domain_extra=domain, solver_extra=solver_extra)


# -- ETDRK4 --------------------------------------------------------------------


@pytest.mark.parametrize("cox_matthews, tol", [(False, ETDRK4_REFERENCE_TOL),
                                               (True, F64_TOL)])
def test_etdrk4_ch3d_matches_jax(jx, cox_matthews, tol):
    """The 3-D Cahn-Hilliard stand-in under ETDRK4 at 16³, 2 steps of 10
    substeps (dt 1): four group evaluations a substep in both packages."""
    text = ch3d_etdrk4(cox_matthews)
    pj, js = run_jax(jx, text, 2, 1.0)
    pp, ps = run_port(text, 2, 1.0)
    assert torch.isfinite(ps["buffers"]["c"]).all()
    assert_jax_parity(js, ps, tol)
    assert pp.solver.group_evals_per_step() == pj.solver.group_evals_per_step() == 40


def test_etdrk4_reference_tables_fail_at_long_wavelengths():
    """The reference's phi tables divide by (L·dt)³: at 32³ the smallest
    |L·dt| of the deck is 1.5e-3 and the run turns non-finite in float64,
    while cox_matthews stays finite (why chip_smoke.py gates the 512³ runs
    on cox_matthews)."""
    _, ref = run_port(ch3d_etdrk4(False, n=32), 2, 1.0)
    _, cm = run_port(ch3d_etdrk4(True, n=32), 2, 1.0)
    assert not torch.isfinite(ref["buffers"]["c"]).all()
    assert torch.isfinite(cm["buffers"]["c"]).all()


def _order_run(substeps, cm="true", dt=0.5):
    p = TensorProblem(hit.parse(decks.ETDRK4_ORDER_DECK.format(substeps=substeps, cm=cm)),
                      device="cpu")
    s = p.init_state()
    return p.step(s, 0.0, dt, dt, True)["buffers"]["u"].numpy()


def test_etdrk4_cox_matthews_fourth_order():
    """tests/test_etdrk4_cox_matthews.py on the port: halving the substep
    cuts the error ~16x against a 64-substep reference."""
    ref = _order_run(64)
    e1 = np.abs(_order_run(4) - ref).max()
    e2 = np.abs(_order_run(8) - ref).max()
    order = np.log2(e1 / e2)
    assert 3.5 < order < 4.8, (e1, e2, order)


def test_etdrk4_order_deck_is_test_copy():
    from tests import test_etdrk4_cox_matthews as original

    assert decks.ETDRK4_ORDER_DECK == original.DECK


# -- forward Euler -------------------------------------------------------------


@pytest.mark.parametrize("deck", ["EXPLICIT_DECK", "EXPLICIT_REAL_SPACE_DECK"])
def test_forward_euler_matches_jax(jx, deck):
    text = getattr(decks, deck).format(n=32, substeps=5, domain_extra=DOUBLE)
    _, js = run_jax(jx, text, 3, 0.01)
    _, ps = run_port(text, 3, 0.01)
    assert_jax_parity(js, ps)


def test_forward_euler_decays_each_mode():
    """Spectral forward Euler: each mode is multiplied by (1 − 0.05k²·dt)
    a substep, exactly (ū' = −0.05k²ū)."""
    text = decks.EXPLICIT_DECK.format(n=32, substeps=5, domain_extra=DOUBLE)
    p, s0 = run_port(text, 1, 0.01)
    u0 = s0["buffers"]["u"]
    _, s = run_port(text, 2, 0.01)
    k2 = p.domain.k_square
    want = torch.fft.irfftn(torch.fft.rfftn(u0) * (1 - 0.05 * k2 * 0.002) ** 5,
                            s=u0.shape)
    assert (s["buffers"]["u"] - want).abs().max() <= 1e-12


# -- coupled ABM -------------------------------------------------------------------


@pytest.mark.parametrize("ss, cs, order", [(10, 0, 1), (10, 0, 2), (10, 0, 3), (20, 0, 4),
                                           (10, 1, 1), (10, 2, 1), (10, 2, 2)])
def test_coupled_abm_matches_jax(jx, ss, cs, order):
    """tests/test_solvers_gold.py's coupled cases (substeps, corrector
    steps, order) on the stand-in deck, 3 steps of dt 0.01."""
    text = coupled(ss, cs, order)
    _, js = run_jax(jx, text, 3, 0.01)
    _, ps = run_port(text, 3, 0.01)
    assert_jax_parity(js, ps)


@pytest.mark.parametrize("symmetric", [False, True])
def test_coupled_abm_against_exact_solution(symmetric):
    """Each Fourier mode of the coupled deck evolves as exp(E·t)
    (decks.coupled_exact): after 4 steps of 0.01 the predictor-corrector
    lands within 1e-4 of the largest exact value (first order in the
    implicit part), and its error shrinks as the substep does."""
    extra = "assume_symmetric = true" if symmetric else ""
    errs = []
    for ss in (10, 20):
        p, s = run_port(coupled(ss, 1, 2, solver_extra=extra), 4, 0.01)
        b0 = p.init_state()["buffers"]
        exact = decks.coupled_exact(b0["u"], b0["v"], 0.04, symmetric)
        errs.append(max(float((s["buffers"][k] - e).abs().max() / e.abs().max())
                        for k, e in zip("uv", exact)))
    assert errs[0] <= 1e-4 and errs[1] < errs[0], errs
