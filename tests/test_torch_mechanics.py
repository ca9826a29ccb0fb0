"""FFT micromechanics of the port (marlin_tpu_torch/computes/mechanics.py)
against the JAX package's, on the CPU.

Mirrors tests/test_cg.py's unit cases and the cases of
tests/test_mechanics_gold.py and tests/test_mechanics_parallel.py that need
no reference deck, on the port's decks (``decks.MECH_DECK``, the stand-in
for mech.i; ``MECH_2D_DECK``; ``COUPLED_PF_MECH_DECK``, the stand-in for
coupled_pf_mech.i) and the JAX package's fracture showcase
(``decks.FRACTURE_DECK``).

Tolerances: float64 on DEFAULT within 1e-10 of each buffer's largest
magnitude, with equal Newton and CG iteration counts (the JAX loop's counts
are read through a ``jax.debug.callback`` around its conjugate_gradient);
the preconditioned solve within test_cg.py's 2e-6 (F) and 2e-5 (stress) of
the plain one; the PALLAS twins in float32 within 2e-5 on F of DEFAULT
(tests/test_pallas_fft.py's tolerance), and one Green projection within
1e-5 of the JAX package's (PALLAS in interpret mode on an odd grid).
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from marlin_tpu_torch import decks, hit
from marlin_tpu_torch import state as port_state
from marlin_tpu_torch.computes import mechanics as M
from marlin_tpu_torch.domain import Domain
from marlin_tpu_torch.executioner import run_deck
from marlin_tpu_torch.problem import TensorProblem

F64_TOL = 1e-10
PALLAS_TOL = 2e-5
DOUBLE = "floating_precision = DOUBLE"
SINGLE_PALLAS = "fft_backend = PALLAS\n  floating_precision = SINGLE"
MECH = "TensorComputes/Solve/root/mech/"
MECH_DT = 0.01
FRACTURE_DT = 2e-3


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a case: the fields here are a few thousand cells,
    where more threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jx(monkeypatch):
    """The JAX package (float64 enabled, its Pallas FFT kernels in interpret
    mode), its CG wrapped to record each solve's iteration count."""
    import jax

    jax.config.update("jax_enable_x64", True)
    pf = pytest.importorskip("marlin_tpu.pallas_fft")
    import jax.numpy as jnp

    from marlin_tpu import hit as jhit
    from marlin_tpu.computes import mechanics as JM
    from marlin_tpu.domain import Domain as JaxDomain
    from marlin_tpu.problem import TensorProblem as JaxProblem

    solves = []
    plain = JM.conjugate_gradient

    def counted(*args, **kwargs):
        x, k, res = plain(*args, **kwargs)
        jax.debug.callback(lambda kk: solves.append(int(kk)), k, ordered=True)
        return x, k, res

    monkeypatch.setattr(JM, "conjugate_gradient", counted)
    monkeypatch.setattr(pf, "_INTERPRET", True)
    yield SimpleNamespace(jax=jax, jnp=jnp, hit=jhit, M=JM, Problem=JaxProblem,
                          Domain=JaxDomain, solves=solves)


def mech_root(h, n=16, domain=DOUBLE, over=(), two_d=False):
    text = (decks.MECH_2D_DECK if two_d else decks.MECH_DECK).format(n=n, domain_extra=domain)
    root = h.parse(text)
    h.apply_cli_args(root, list(over))
    return root


def coupled_root(h, n=16, domain=DOUBLE, over=()):
    root = h.parse(decks.COUPLED_PF_MECH_DECK.format(n=n, substeps=2, domain_extra=domain))
    h.apply_cli_args(root, list(over))
    return root


def fracture_root(h, n=48, over=()):
    return h.load(decks.FRACTURE_DECK, [f"Domain/nx={n}", f"Domain/ny={n}",
                                        "Domain/floating_precision=DOUBLE", *over])


def run_port(root, steps, dt):
    p = TensorProblem(root, device="cpu")
    s = p.init_state()
    for i in range(steps):
        s = p.step(s, i * dt, dt, dt, i == 0)
    return p, s


def run_jax(jx, root, steps, dt):
    p = jx.Problem(root)
    s = p.init_state()
    for i in range(steps):
        d = jx.jnp.asarray(dt, p.domain.dtype)
        s = p.step(s, i * dt, d, d, i == 0)
    jx.jax.effects_barrier()
    return p, s


def assert_close(js, ps, tol=F64_TOL, groups=("buffers", "old"), keys=None):
    """Every buffer (or those of ``keys``) within ``tol`` of its largest
    magnitude; a bool pseudo-buffer equal."""
    ps = port_state.to_numpy(ps)
    for group in groups:
        assert set(ps[group]) == set(js[group]), group
        for name, ref in js[group].items():
            if keys is not None and name not in keys:
                continue
            ref, got = np.asarray(ref), ps[group][name]
            assert got.shape == ref.shape, (group, name)
            if ref.dtype == np.bool_:
                assert np.array_equal(got, ref), (group, name)
                continue
            scale = max(float(np.abs(ref).max()), 1e-300)
            err = float(np.abs(got - ref).max())
            assert err <= tol * scale, (group, name, err / scale)


def mech_counts(problem):
    return problem.get_compute("mech").counts


# -- conjugate_gradient (tests/test_cg.py) ------------------------------------------


def _cg(A_np, b_np, tol=1e-12, maxiter=50):
    A = torch.tensor(A_np, dtype=torch.float64)
    b = torch.tensor(b_np, dtype=torch.float64)
    res = M.conjugate_gradient(lambda v: A @ v, b, torch.zeros_like(b), tol, maxiter)
    return res, np.asarray(A_np), np.asarray(b_np)


SPD4 = [[4.0, 1.0, 2.0, 3.0], [1.0, 5.0, 1.0, 2.0], [2.0, 1.0, 6.0, 1.0],
        [3.0, 2.0, 1.0, 7.0]]


@pytest.mark.parametrize("A,b,iterations,atol", [
    ([[4.0, 1.0], [1.0, 3.0]], [1.0, 2.0], 2, 1e-9),
    (SPD4, [1.0, 2.0, 3.0, 4.0], 4, 1e-6),
], ids=["solve2d", "solve4d"])
def test_cg_solves_exactly(A, b, iterations, atol, jx):
    """Exact SPD systems converge in n iterations (reference
    ConjugateGradientTest.C), with the JAX loop's iterate and count."""
    res, A, b = _cg(A, b)
    assert res.iterations == iterations
    assert float(res.residual) < atol
    np.testing.assert_allclose(A @ res.x.numpy(), b, atol=atol)
    Aj = jx.jnp.asarray(A)
    xj, kj, _ = jx.M.conjugate_gradient(lambda v: Aj @ v, jx.jnp.asarray(b),
                                        jx.jnp.zeros(len(b)), 1e-12, 50)
    assert int(kj) == res.iterations
    np.testing.assert_allclose(res.x.numpy(), np.asarray(xj), rtol=0, atol=1e-12)
    # one fetch an iteration
    assert res.fetches == res.device_iterations == iterations


@pytest.mark.parametrize("start", ["zeros", "none"])
def test_cg_zero_rhs_exits_immediately(start):
    A = torch.eye(3, dtype=torch.float64)
    b = torch.zeros(3, dtype=torch.float64)
    x0 = torch.zeros(3, dtype=torch.float64) if start == "zeros" else None
    res = M.conjugate_gradient(lambda v: A @ v, b, x0, 1e-12, 50)
    assert res.iterations == 0
    np.testing.assert_array_equal(res.x.numpy(), np.zeros(3))
    # the one iteration that ran to learn it is discarded, one fetch
    assert res.device_iterations == res.fetches == 1


def test_spectral_gradient_unit_parity(jx):
    """Reference TensorBufferTest.C Gradient: d/dx, d/dy of sin(2x)sin(3y)
    on the asymmetric 20×100 box [-π,π]×[-π,3π] within 1e-12, and the
    port's domain equal to the JAX package's."""
    from marlin_tpu.domain import Precision

    kw = dict(mins=(-np.pi, -np.pi), maxs=(np.pi, 3 * np.pi))
    dom = Domain(2, (20, 100), floating_precision="DOUBLE", device="cpu", **kw)
    jdom = jx.Domain(2, (20, 100), floating_precision=Precision.DOUBLE, **kw)
    x, y = dom.axis(0), dom.axis(1)
    a = torch.sin(2.0 * x) * torch.sin(3.0 * y)
    dadx = 2.0 * torch.cos(2.0 * x) * torch.sin(3.0 * y)
    dady = torch.sin(2.0 * x) * 3.0 * torch.cos(3.0 * y)
    abar = dom.fft(a)
    gx = dom.ifft(abar * dom.reciprocal_axis(0) * 1j)
    gy = dom.ifft(abar * dom.reciprocal_axis(1) * 1j)
    torch.testing.assert_close(gx, dadx, atol=1e-12, rtol=0)
    torch.testing.assert_close(gy, dady, atol=1e-12, rtol=0)
    jbar = jdom.fft(jx.jnp.asarray(a.numpy()))
    np.testing.assert_allclose(gx.numpy(), np.asarray(
        jdom.ifft(jbar * jdom.reciprocal_axis(0) * 1j)), atol=1e-13)


def test_preconditioned_cg_small_spd(jx):
    """PCG on an ill-conditioned SPD system (condition ~1e4): plain CG and
    CG with the exact inverse as preconditioner give the direct solve's
    answer, the latter in at most 2 iterations, the JAX loop's count.
    (test_cg.py's Jacobi case is left out: its residual climbs past the
    breakdown guard's 100× cap on this system under numpy's and torch's
    rounding, 1185 against 460, and stays under it by the JAX package's.)"""
    rng = np.random.RandomState(7)
    n = 24
    Q = rng.randn(n, n)
    Mx = Q @ np.diag(np.logspace(0, 4, n)) @ Q.T
    Mx = 0.5 * (Mx + Mx.T)
    b = rng.randn(n)
    x_direct = np.linalg.solve(Mx, b)
    Mt, bt, x0 = torch.tensor(Mx), torch.tensor(b), torch.zeros(n, dtype=torch.float64)
    Mj, bj, x0j = jx.jnp.asarray(Mx), jx.jnp.asarray(b), jx.jnp.zeros(n)
    inv = np.linalg.inv(Mx)
    plain = M.conjugate_gradient(lambda v: Mt @ v, bt, x0, 1e-10, 500)
    np.testing.assert_allclose(plain.x.numpy(), x_direct, rtol=1e-5, atol=1e-7)
    _, kj, _ = jx.M.conjugate_gradient(lambda v: Mj @ v, bj, x0j, 1e-10, 500)
    # plain CG at this condition number parts from the JAX count by a few
    # iterations: the products' summation order
    assert abs(plain.iterations - int(kj)) <= 4
    exact = M.preconditioned_conjugate_gradient(
        lambda v: Mt @ v, lambda r: torch.tensor(inv) @ r, bt, x0, 1e-10, 500)
    np.testing.assert_allclose(exact.x.numpy(), x_direct, rtol=1e-5, atol=1e-7)
    _, kj, _ = jx.M.preconditioned_conjugate_gradient(
        lambda v: Mj @ v, lambda r: jx.jnp.asarray(inv) @ r, bj, x0j, 1e-10, 500)
    assert exact.iterations == int(kj) <= 2


# -- the constitutive model and the gate (tests/test_mechanics_gold.py) --------------


def test_analytic_tangent_contract_matches_k4(jx):
    """tangent_contract == trans2(ddot42(K4, trans2(dF))) on random fields
    (1e-10); the JAX file's component sums and the JAX package's contract
    agree with it."""
    rng = np.random.RandomState(0)
    shp = (3, 4, 5)
    F = torch.tensor(np.eye(3) + 0.1 * rng.randn(*shp, 3, 3))
    dF = torch.tensor(rng.randn(*shp, 3, 3))
    K = torch.tensor(1.0 + rng.rand(*shp))
    mu = torch.tensor(0.5 + rng.rand(*shp))
    ti, tI4, tI4rt, tI4s, tII = M._identity_tensors(3, F.dtype)
    C4 = K[..., None, None, None, None] * tII + 2.0 * mu[..., None, None, None, None] * (
        tI4s - tII / 3.0)
    S = M.ddot42(C4, 0.5 * (M.dot22(M.trans2(F), F) - ti))
    K4 = M.dot24(S, tI4) + M.ddot44(M.ddot44(tI4rt, M.dot42(M.dot24(F, C4), M.trans2(F))),
                                    tI4rt)
    ref = M.trans2(M.ddot42(K4, M.trans2(dF)))

    obj = M.HyperElasticIsotropic.__new__(M.HyperElasticIsotropic)
    obj.F, obj.K, obj.mu = "F", "K", "mu"
    scope = {"F": F, "K": K, "mu": mu}
    got = obj.tangent_contract(scope, dF)
    torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-10)
    for form in (M.tangent_apply_components, M.tangent_apply_matmul):
        torch.testing.assert_close(form(obj.tangent_fields(scope), dF), ref, rtol=1e-10,
                                   atol=1e-10)

    jobj = jx.M.HyperElasticIsotropic.__new__(jx.M.HyperElasticIsotropic)
    jobj.F, jobj.K, jobj.mu = "F", "K", "mu"
    jobj.domain = SimpleNamespace(dim=3)
    jgot = jobj.tangent_contract({k: jx.jnp.asarray(v.numpy()) for k, v in scope.items()},
                                 jx.jnp.asarray(dF.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-10, atol=1e-10)


def _find_mech(problem):
    return next(c for c in problem.get_compute("root").members
                if isinstance(c, M.FFTMechanics))


def test_gate_requires_methods_actually_called(monkeypatch):
    """analytic_tangent = true falls back to the materialised tangent when
    the constitutive model lacks the tangent_fields/tangent_apply pair that
    apply() calls (MECH_DECK at 16³ in place of the absent mech3d.i)."""

    def build():
        p = TensorProblem(mech_root(hit, over=[MECH + "analytic_tangent=true"]), device="cpu")
        s = p.init_state()
        return _find_mech(p), s

    mech, s = build()
    assert mech.analytic_tangent is True and "dstressdstrain" not in s["buffers"]
    monkeypatch.delattr(M.HyperElasticIsotropic, "tangent_fields")
    mech, s = build()
    assert mech.analytic_tangent is False and "dstressdstrain" in s["buffers"]


def test_newton_nonconvergence_raises(jx):
    """Exhausting nl_max_its raises at the step's transfer with the JAX
    package's words (reference FFTMechanics.C), not silently."""
    over = [MECH + "nl_max_its=1", MECH + "nl_rel_tol=1e-30", MECH + "nl_abs_tol=1e-30",
            "TensorSolver/substeps=2"]
    assert M.newton_exhausted_message("mech") == jx.M.newton_exhausted_message("mech")
    p = TensorProblem(mech_root(hit, over=over), device="cpu")
    s = p.init_state()
    with pytest.raises(RuntimeError, match="[Nn]onlinear iterations") as err:
        p.step_with_pps(s, 0.0, MECH_DT, 0.0, first_step=True)
    assert str(err.value) == jx.M.newton_exhausted_message("mech")
    assert mech_counts(p).failed == 1


def test_cg_breakdown_guard_serial():
    """Tolerances below the semi-definite operator's floor
    (tests/test_mechanics_parallel.py:101-122, serial): the fields stay
    finite with |F| < 2, and the solve reports that it did not converge."""
    tight = [MECH + "nl_rel_tol=1e-7", MECH + "nl_abs_tol=1e-9", MECH + "l_tol=1e-8",
             MECH + "l_max_its=100", MECH + "nl_max_its=20",
             MECH + "analytic_tangent=true", "TensorSolver/substeps=2"]
    p = TensorProblem(mech_root(hit, domain="floating_precision = SINGLE", over=tight),
                      device="cpu")
    s = p.step(p.init_state(), 0.0, MECH_DT, MECH_DT, True)
    F = s["buffers"]["F"]
    assert bool(torch.isfinite(F).all())
    assert float(F.abs().max()) < 2.0
    assert not bool(s["buffers"]["__converged_mech__"])
    assert mech_counts(p).failed >= 1


TIGHT = [MECH + "l_tol=1e-8", MECH + "nl_rel_tol=1e-8", MECH + "nl_abs_tol=1e-10",
         MECH + "analytic_tangent=true", "TensorSolver/substeps=2"]


def test_fftmechanics_reference_medium_preconditioner(jx):
    """preconditioner = REFERENCE_MEDIUM converges to the unpreconditioned
    solution under test_cg.py's tight tolerances (F 2e-6, stress 2e-5) in
    fewer CG iterations, and equals the JAX package's preconditioned run
    within 1e-10 with its counts; without `mu` it is the JAX package's
    named error.  At 15³: on an even grid neither solve converges under
    these tolerances (the next case)."""
    tight, pre = TIGHT, [MECH + "preconditioner=REFERENCE_MEDIUM"]
    p0, s0 = run_port(mech_root(hit, n=15, over=tight), 1, MECH_DT)
    p1, s1 = run_port(mech_root(hit, n=15, over=tight + pre), 1, MECH_DT)
    torch.testing.assert_close(s1["buffers"]["F"], s0["buffers"]["F"], rtol=0, atol=2e-6)
    torch.testing.assert_close(s1["buffers"]["stress"], s0["buffers"]["stress"], rtol=0,
                               atol=2e-5)
    assert mech_counts(p1).cg < mech_counts(p0).cg
    _, js = run_jax(jx, mech_root(jx.hit, n=15, over=tight + pre), 1, MECH_DT)
    assert_close(js, s1)
    assert jx.solves[2:] == mech_per_solve(p1)[2:]
    root = mech_root(hit, n=8, over=pre)
    root.child("TensorComputes").child("Solve").child("root").child("mech").params.pop("mu")
    with pytest.raises(Exception, match="REFERENCE_MEDIUM needs the `mu` buffer"):
        run_port(root, 1, MECH_DT)


@pytest.mark.parametrize("n,converges", [(15, True), (16, False)], ids=["15^3", "16^3"])
def test_tight_newton_converges_only_on_odd_grids(n, converges, jx):
    """The fault of ROADMAP §3 (the JAX package's, kept for parity): on an
    even grid the Green operator is no projection on the Nyquist planes,
    and under test_cg.py's tight tolerances Newton exhausts nl_max_its
    (here cut to 12) in both packages; on an odd grid it converges in 3."""
    over = TIGHT + [MECH + "nl_max_its=12"]
    pp, _ = run_port(mech_root(hit, n=n, over=over), 1, MECH_DT)
    run_jax(jx, mech_root(jx.hit, n=n, over=over), 1, MECH_DT)
    c = mech_counts(pp)
    assert c.failed == (0 if converges else 1)
    assert jx.solves[2:] == mech_per_solve(pp)[2:]
    if converges:
        assert c.newton == 2 + 3


def mech_per_solve(problem):
    """The CG count of each Newton iteration, in order.  On an odd grid the
    JAX package's first substep (t = 0, F = I) solves a right-hand side of
    rounding (|b| ~ 7e-15 at 15³, its compiled program's; the port's is 0),
    so there its first two counts are compared no further."""
    return problem.get_compute("mech").cg_log


# -- whole decks against the JAX package --------------------------------------------


DECKS = {
    # name: (root builder over a hit module, steps, dt)
    "mech_16_materialised": (lambda h: mech_root(h, over=["TensorSolver/substeps=2"]), 2,
                             MECH_DT),
    "mech_16_analytic": (lambda h: mech_root(h, over=["TensorSolver/substeps=2",
                                                      MECH + "analytic_tangent=true"]), 2,
                         MECH_DT),
    "mech_32x32": (lambda h: mech_root(h, n=32, two_d=True, over=["TensorSolver/substeps=2"]),
                   1, MECH_DT),
    "coupled_pf_mech_16": (coupled_root, 2, 1.0),
    "fracture_48": (fracture_root, 2, FRACTURE_DT),
}


@pytest.mark.parametrize("name", list(DECKS))
def test_deck_matches_jax(name, jx):
    build, steps, dt = DECKS[name]
    _, js = run_jax(jx, build(jx.hit), steps, dt)
    pp, ps = run_port(build(hit), steps, dt)
    assert_close(js, ps)
    if name.startswith("coupled"):
        u = ps["buffers"]["disp_x"]
        assert bool(torch.isfinite(u).all()) and 0 < float(u.abs().max()) < 0.1
        return
    assert bool(ps["buffers"]["__converged_mech__"])
    # the same Newton iterations, each with the same CG iterations
    assert jx.solves == mech_per_solve(pp)
    c = mech_counts(pp)
    assert c.newton == len(jx.solves) and c.cg == sum(jx.solves)
    # one fetch a CG iteration that ran and one a Newton iteration after
    # the first
    assert c.fetches == c.cg_device + c.newton - c.solves


def _jax_green(jx, jdom, A):
    """The JAX package's Green projection G (marlin_tpu/computes/
    mechanics.py:429-455) on its domain: its q, 1/|q|² and q/|q|², the
    contraction and the inverse."""
    jnp = jx.jnp
    qvec = jnp.stack([jnp.broadcast_to(jnp.asarray(jdom.reciprocal_axis(d)),
                                       jdom.reciprocal_shape) for d in range(jdom.dim)], -1)
    k2 = jdom.k_square
    inv_k2 = jnp.where(k2 == 0, 0.0, 1.0 / jnp.where(k2 == 0, 1.0, k2))
    s = (jdom.fft(jnp.asarray(A)) * qvec[..., None, :]).sum(-1)
    return np.asarray(jdom.ifft(s[..., :, None] * (qvec * inv_k2[..., None])[..., None, :]))


def _port_green(dom, A):
    mech = M.FFTMechanics.__new__(M.FFTMechanics)
    mech.domain, mech._green, mech.counts = dom, None, M.MechanicsCounts()
    return mech.project(torch.tensor(A)).numpy()


@pytest.mark.parametrize("shape", [(15, 9, 25), (16, 16, 16)], ids=["odd", "16^3"])
def test_green_projection_matches_jax(shape, jx):
    """One application of the Green projection on a random (…, 3, 3) field
    in float32 (JAX's interpreted Newton loop on PALLAS takes ~50 s at
    16³, so the whole-deck check below holds the twins against the port's
    DEFAULT instead).  On an odd grid, where no extent has a Nyquist index,
    the port's PALLAS (twins) equals the JAX package's PALLAS (interpret
    mode); on an even one it equals DEFAULT, the JAX package's and its own,
    while the JAX package's PALLAS parts from DEFAULT on the Nyquist planes
    (ROADMAP §3: the projection there averages two modes' projections)."""
    from marlin_tpu.domain import FFTBackend, Precision

    A = np.random.RandomState(1).randn(*shape, 3, 3).astype(np.float32)
    doms = {be: (Domain(3, shape, floating_precision="SINGLE", fft_backend=be, device="cpu"),
                 jx.Domain(3, shape, floating_precision=Precision.SINGLE,
                           fft_backend=FFTBackend[be])) for be in ("DEFAULT", "PALLAS")}
    port = {be: _port_green(dom, A) for be, (dom, _) in doms.items()}
    jax_g = {be: _jax_green(jx, jdom, A) for be, (_, jdom) in doms.items()}
    scale = float(np.abs(jax_g["DEFAULT"]).max())
    err = lambda a, b: float(np.abs(a - b).max()) / scale
    assert err(port["DEFAULT"], jax_g["DEFAULT"]) <= 1e-5
    assert err(port["PALLAS"], jax_g["DEFAULT"]) <= 1e-5
    if shape[0] % 2:
        assert err(port["PALLAS"], jax_g["PALLAS"]) <= 1e-5
    else:
        assert err(jax_g["PALLAS"], jax_g["DEFAULT"]) > 1e-2


def test_pallas_twins_match_default():
    """MECH_DECK at 16³ on fft_backend = PALLAS in float32 (the kernels'
    twins), 1 step × 2 substeps with the analytic tangent, as
    tests/test_pallas_fft.py:317-337 runs it, against DEFAULT in float32: F
    within 2e-5, the same Newton and CG iterations.  (Longer runs here meet
    the float32 floor of ROADMAP §3: at 16³ the seventh substep's second
    CG on the twins runs to its 4096-iteration cap.)"""
    over = [MECH + "analytic_tangent=true", "TensorSolver/substeps=2"]
    runs = {}
    for name, domain in (("PALLAS", SINGLE_PALLAS), ("DEFAULT", "floating_precision = SINGLE")):
        runs[name] = run_port(mech_root(hit, domain=domain, over=over), 1, MECH_DT)
    (pp, ps), (pd, sd) = runs["PALLAS"], runs["DEFAULT"]
    assert float((ps["buffers"]["F"] - sd["buffers"]["F"]).abs().max()) <= PALLAS_TOL
    assert mech_per_solve(pp) == mech_per_solve(pd)
    assert bool(ps["buffers"]["__converged_mech__"])


# -- the domain's grids and ComputeDisplacements --------------------------------------


@pytest.mark.parametrize("backend", ["DEFAULT", "PALLAS"])
@pytest.mark.parametrize("shape", [(16, 16, 16), (24, 16)], ids=["16^3", "24x16"])
def test_domain_grids_match_jax(shape, backend, jx):
    """x_grid, k_grid (the permuted order under PALLAS), np_k_square, sum
    and average as the JAX package's."""
    from marlin_tpu.domain import FFTBackend, Precision

    prec = "SINGLE" if backend == "PALLAS" else "DOUBLE"
    kw = dict(maxs=(2.0, 3.0, 1.5)[:len(shape)])
    dom = Domain(len(shape), shape, floating_precision=prec, fft_backend=backend,
                 device="cpu", **kw)
    jdom = jx.Domain(len(shape), shape, floating_precision=Precision[prec],
                     fft_backend=FFTBackend[backend], **kw)
    np.testing.assert_array_equal(dom.x_grid.numpy(), jdom.x_grid)
    np.testing.assert_array_equal(dom.k_grid.numpy(), jdom.k_grid)
    np.testing.assert_array_equal(dom.np_k_square(), jdom.np_k_square())
    t = np.random.RandomState(3).randn(*shape, 2, 2).astype(dom.x_grid.numpy().dtype)
    # float32 sums of 4096 cells in another order: 1e-6 of the sum of |t|
    for got, ref, scale in ((dom.average(torch.tensor(t)), jdom.average(jx.jnp.asarray(t)),
                             np.abs(t).mean()),
                            (dom.sum(torch.tensor(t)), jdom.sum(jx.jnp.asarray(t)),
                             np.abs(t).sum())):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6 * scale)


def _postprocess_deck(n, two_d, domain):
    text = (decks.MECH_2D_DECK if two_d else decks.MECH_DECK).format(n=n, domain_extra=domain)
    return text.replace("  [Solve]", """  [Postprocess]
    [u]
      type = ComputeDisplacements
      buffer = u
      F = F
    []
    [sV]
      type = ComputeVonMisesStress
      buffer = sV
      stress = stress
    []
  []
  [Solve]""")


@pytest.mark.parametrize("shape,domain,tol", [
    ((16, 16, 16), DOUBLE, F64_TOL),
    ((24, 16), DOUBLE, F64_TOL),
    ((16, 16, 16), SINGLE_PALLAS, 5e-5),
], ids=["16^3", "24x16", "16^3_pallas"])
def test_displacements_and_von_mises_match_jax(shape, domain, tol, jx):
    """ComputeDisplacements (the node grid by torch's interpolate with
    align_corners against the JAX package's map_coordinates) and
    ComputeVonMisesStress as [Postprocess] computes on a random F and
    stress, against the JAX package's in float64 on DEFAULT.  The port's
    PALLAS (twins, float32) holds to it too (DEFAULT float32 itself 7.5e-6
    of max|u|), while the JAX package's PALLAS drops the Nyquist components
    (more than 1e-2 of max|u| here; ROADMAP §3)."""
    two_d = len(shape) == 2
    dim = len(shape)

    def text(dom):
        return _postprocess_deck(shape[0], two_d, dom).replace(
            "  ny = {}\n".format(shape[0]), "  ny = {}\n".format(shape[1]))

    rng = np.random.RandomState(5)
    F = np.eye(dim) + 0.05 * rng.randn(*shape, dim, dim)
    stress = rng.randn(*shape, dim, dim)

    def port(dom):
        p = TensorProblem(hit.parse(text(dom)), device="cpu")
        s = p.init_state()
        dtype = s["buffers"]["F"].dtype
        buffers = {**s["buffers"], "F": torch.tensor(F).to(dtype),
                   "stress": torch.tensor(stress).to(dtype)}
        return p.run_postprocess_computes({**s, "buffers": buffers}, 0.0)["buffers"]

    def jax(dom):
        jp = jx.Problem(jx.hit.parse(text(dom)))
        js = jp.init_state()
        dtype = js["buffers"]["F"].dtype
        jb = {**js["buffers"], "F": jx.jnp.asarray(F, dtype), "stress": jx.jnp.asarray(stress, dtype)}
        return jp.run_postprocess_computes({**js, "buffers": jb}, 0.0)["buffers"]

    out, ref = port(domain), jax(DOUBLE)
    assert tuple(out["u"].shape) == tuple(n + 1 for n in shape) + (dim,)
    for k in ("u", "sV"):
        want = np.asarray(ref[k])
        err = float(np.abs(out[k].double().numpy() - want).max())
        assert err <= tol * float(np.abs(want).max()), (k, err)
    if domain == SINGLE_PALLAS:
        want = np.asarray(ref["u"])
        err = float(np.abs(np.asarray(jax(domain)["u"], dtype=float) - want).max())
        assert err > 1e-2 * float(np.abs(want).max())


def test_mechanics_types_register():
    from marlin_tpu_torch.registry import computes

    for name in ("FFTMechanics", "HyperElasticIsotropic", "RankTwoIdentity",
                 "ComputeVonMisesStress", "ComputeDisplacements",
                 "FFTQuasistaticElasticity", "FFTElasticChemicalPotential",
                 "MacroscopicShearTensor", "PhaseMechanicsTest"):
        assert name in computes


def test_mech_deck_runs_through_run_deck(tmp_path):
    """MECH_DECK through the entry point on the CPU: the volume average of F
    is the last substep's applied strain I + t·e01 (CG's correction lies in
    range(G), which has zero mean), every substep converged."""
    root = mech_root(hit, n=8, over=["Executioner/num_steps=2", "TensorSolver/substeps=2"])
    tr = run_deck(root, device="cpu", output_dir=str(tmp_path))
    F = tr.state["buffers"]["F"]
    want = torch.eye(3, dtype=F.dtype)
    want[0, 1] = MECH_DT + MECH_DT / 2
    torch.testing.assert_close(F.mean((0, 1, 2)), want, rtol=0, atol=1e-12)
    assert bool(tr.state["buffers"]["__converged_mech__"])
    assert math.isclose(tr.time, 2 * MECH_DT)
