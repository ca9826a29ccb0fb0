"""The port's iterative solvers against the JAX package's, on the CPU:
SecantSolver and BroydenSolver on the 2a stand-ins
(decks.OSTWALD_2A_SECANT_DECK, OSTWALD_2A_BROYDEN_DECK), alone and through
the iteration-adaptive time loop, LinearTensorPredictor, batched against
unbatched, Broyden's M through a checkpoint, RunningMaximum's refusal.

Tolerances (float64, of each buffer's largest magnitude), with equal
iteration counts, ``converged`` flags, dt sequences and rejected steps:
- the secant solver: 1e-10;
- Broyden's fields: 1e-10 over 2 steps of 2 substeps, 1e-6 through the
  time loop; its inverse Jacobians M: 1e-3 of the largest entry.
  Where a point's residual is at rounding level, s and y are rounding and
  |sᵀy| sits just above the 1e-12 cut, so the rank-one update amplifies
  each package's rounding into M (one iteration agrees to 1e-12, two
  substeps to 8e-7); the iterates it steers stop at other points of the
  same tolerance band (relative 1e-4 of |R0|), a few 1e-8 apart.
Batched against unbatched: bit for bit on PALLAS's twins (float32).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from marlin_tpu_torch import decks, hit
from marlin_tpu_torch import state as port_state
from marlin_tpu_torch.computes.base import ComputeError
from marlin_tpu_torch.executioner import Transient, run_deck
from marlin_tpu_torch.problem import TensorProblem

F64_TOL = 1e-10
BROYDEN_TRANSIENT_TOL = 1e-6
BROYDEN_M_TOL = 1e-3
DOUBLE = "floating_precision = DOUBLE"
SINGLE_PALLAS = "fft_backend = PALLAS\n  floating_precision = SINGLE"


@pytest.fixture
def jx():
    """The JAX package, its Pallas FFT kernels in interpret mode."""
    pf = pytest.importorskip("marlin_tpu.pallas_fft")
    import jax.numpy as jnp

    from marlin_tpu import hit as jhit
    from marlin_tpu.executioner import Transient as JaxTransient
    from marlin_tpu.problem import TensorProblem as JaxProblem

    old = pf._INTERPRET
    pf._INTERPRET = True
    yield SimpleNamespace(jnp=jnp, hit=jhit, Problem=JaxProblem, Transient=JaxTransient)
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


def assert_jax_parity(js, ps, tol=F64_TOL, solver_tol=None):
    """Every buffer and history slot within ``tol`` of its largest
    magnitude; the solver's counts equal, its arrays within
    ``solver_tol`` (default ``tol``)."""
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
    assert set(ps["solver"]) == set(js["solver"])
    for name, ref in js["solver"].items():
        ref, got = np.asarray(ref), np.asarray(ps["solver"][name])
        if ref.ndim == 0:
            assert got == ref, (name, got, ref)
        else:
            scale = max(float(np.abs(ref).max()), 1e-300)
            err = float(np.abs(got - ref).max())
            assert err <= (solver_tol or tol) * scale, (name, err / scale)


def assert_equal_states(a, b):
    for group in ("buffers", "old", "solver"):
        assert set(a[group]) == set(b[group]), group
        for name, t in a[group].items():
            if isinstance(t, torch.Tensor):
                assert torch.equal(t, b[group][name]), (group, name)
            else:
                assert t == b[group][name], (group, name)


def ostwald(solver, precision="DOUBLE", domain=DOUBLE, n=32, substeps=2, steps=2,
            problem="", solver_extra="", dt=None):
    deck = (decks.OSTWALD_2A_SECANT_DECK if solver == "SecantSolver"
            else decks.OSTWALD_2A_BROYDEN_DECK)
    return deck.format(n=n, substeps=substeps, num_steps=steps,
                       dt=dt or decks.OSTWALD_2A_DT[solver][0], domain_extra=domain,
                       problem_extra=problem, solver_extra=solver_extra,
                       relative_tolerance=decks.OSTWALD_2A_TOL[(solver, precision)])


def test_secant_ostwald_matches_jax(jx):
    text = ostwald("SecantSolver")
    pj, js = run_jax(jx, text, 2, decks.OSTWALD_2A_DT["SecantSolver"][0])
    pp, ps = run_port(text, 2, decks.OSTWALD_2A_DT["SecantSolver"][0])
    assert ps["solver"]["converged"] and ps["solver"]["iterations"] > 3
    assert_jax_parity(js, ps)
    # one fetch an iteration
    assert pp.solver.counts.syncs == pp.solver.counts.iterations
    assert pp.solver.counts.substeps == 4 and pp.solver.counts.failed == 0


def test_broyden_ostwald_matches_jax(jx):
    text = ostwald("BroydenSolver")
    dt = decks.OSTWALD_2A_DT["BroydenSolver"][0]
    _, js = run_jax(jx, text, 2, dt)
    pp, ps = run_port(text, 2, dt)
    assert ps["solver"]["converged"]
    assert_jax_parity(js, ps, solver_tol=BROYDEN_M_TOL)
    # one fetch before the first iteration and one after each
    c = pp.solver.counts
    assert c.syncs == c.iterations + c.substeps


@pytest.mark.parametrize("solver", ["SecantSolver", "BroydenSolver"])
def test_iterative_transient_matches_jax(jx, tmp_path, solver):
    """The 2a stand-ins through the time loop, float64: the same dt
    sequence, rejected steps, iteration and group-evaluation counts
    (TensorSolverIterations, ComputeGroupExecutionCount) and fields.  The
    too-large start dt (decks.OSTWALD_2A_DT) is rejected and re-attempted
    at a quarter; dt does not grow on the next step."""
    for dt in decks.OSTWALD_2A_DT[solver]:
        # at 32² the secant converges even at the larger dt: 64², where it
        # fails as at 200²; Broyden at 32², 2 substeps a step, before its
        # M's amplified rounding (see above) reaches a convergence decision
        n, substeps, steps = (64, 5, 2) if solver == "SecantSolver" else (32, 2, 2)
        text = ostwald(solver, substeps=substeps, steps=steps, dt=dt, n=n)
        runs = {}
        for name, make in (("jax", lambda r: jx.Transient(
                jx.Problem(r), exec_node=r.children.get("Executioner"),
                output_dir=str(tmp_path))),
                           ("port", lambda r: Transient(
                               TensorProblem(r, device="cpu"),
                               exec_node=r.children.get("Executioner"),
                               output_dir=str(tmp_path)))):
            tr = make((jx.hit if name == "jax" else hit).parse(text))
            dts = []
            step = tr.problem.step_with_pps

            def recorded(*args, step=step, dts=dts, **kw):
                dts.append(float(args[2]))
                return step(*args, **kw)

            tr.problem.step_with_pps = recorded
            tr.run()
            runs[name] = (tr, dts)
        (jt, jdts), (pt, pdts) = runs["jax"], runs["port"]
        assert pdts == pytest.approx(jdts, rel=1e-12, abs=0), (pdts, jdts)
        assert pt.rejected_steps == jt.rejected_steps
        assert pt.time == pytest.approx(jt.time, rel=1e-12)
        assert pt.pp_values["c_total"] == pytest.approx(jt.pp_values["c_total"], rel=1e-10)
        if dt == decks.OSTWALD_2A_DT[solver][1]:
            # a failed attempt is re-attempted at dt/4, and the next step
            # does not grow
            assert pt.rejected_steps >= 1
            cuts = [i for i in range(1, len(pdts))
                    if pdts[i] == pytest.approx(pdts[i - 1] * 0.25)]
            assert cuts, pdts
            assert all(pdts[i + 1] <= pdts[i] for i in cuts if i + 1 < len(pdts)), pdts
            if solver == "BroydenSolver":
                # after the failed attempt's 60 iterations the retry's
                # counts part by one (M's amplified rounding, see above)
                continue
        else:
            assert pt.rejected_steps == 0
        for k in ("iterations", "group_evals"):
            assert pt.pp_values[k] == jt.pp_values[k], k
        tol = F64_TOL if solver == "SecantSolver" else BROYDEN_TRANSIENT_TOL
        for k in ("c", "n1", "n2", "n3", "n4"):
            ref = np.asarray(jt.state["buffers"][k])
            got = pt.state["buffers"][k].numpy()
            assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), (dt, k)


def test_linear_predictor_matches_jax(jx):
    """LinearTensorPredictor on the secant 2a stand-in: inactive until two
    old states exist, then the same iterates as the JAX package."""
    text = ostwald("SecantSolver", substeps=3, steps=3).replace(
        "  absolute_tolerance = 1e-9\n", """  absolute_tolerance = 1e-9
  [Predictors]
    [c]
      type = LinearTensorPredictor
      buffer = c
      scale = 1.0
    []
  []
""")
    pj, js = run_jax(jx, text, 3, decks.OSTWALD_2A_DT["SecantSolver"][0])
    pp, ps = run_port(text, 3, decks.OSTWALD_2A_DT["SecantSolver"][0])
    assert len(pp.solver.predictors) == 1 and ps["old"]["c"].shape[0] == 2
    assert_jax_parity(js, ps)


def test_broyden_predictors_are_built_but_inert():
    """Only SecantSolver applies predictors (the reference's
    SecantSolver.C:100): Broyden's are built, request their history, and
    change nothing."""
    dt = decks.OSTWALD_2A_DT["BroydenSolver"][0]
    plain = ostwald("BroydenSolver", steps=3)
    text = plain.replace("  absolute_tolerance = 1e-9\n", """  absolute_tolerance = 1e-9
  [Predictors]
    [c]
      type = LinearTensorPredictor
      buffer = c
    []
  []
""")
    p, a = run_port(text, 3, dt)
    _, b = run_port(plain, 3, dt)
    assert len(p.solver.predictors) == 1 and a["old"]["c"].shape[0] == 2
    for name, t in b["buffers"].items():
        assert torch.equal(t, a["buffers"][name]), name


@pytest.mark.parametrize("solver", ["SecantSolver", "BroydenSolver"])
def test_iterative_batched_equals_unbatched(solver):
    """batch_fft on PALLAS's twins: every buffer, history slot and solver
    entry bit for bit (Broyden's stacked inverse is one batched call)."""
    dt = decks.OSTWALD_2A_DT[solver][0]
    kw = dict(precision="SINGLE", domain=SINGLE_PALLAS)
    _, a = run_port(ostwald(solver, **kw), 2, dt)
    _, b = run_port(ostwald(solver, problem="batch_fft = true", **kw), 2, dt)
    assert_equal_states(a, b)


def test_broyden_jacobian_through_checkpoint(tmp_path):
    """A checkpoint after step 1, resumed to step 2, equals the whole run
    bit for bit, M among the solver entries."""
    text = ostwald("BroydenSolver")
    whole = run_deck(hit.parse(text), output_dir=str(tmp_path / "whole"), device="cpu")
    part = run_deck(hit.parse(text.replace("num_steps = 2", "num_steps = 1\n  "
                                           "checkpoint_interval = 1")),
                    output_dir=str(tmp_path / "part"), device="cpu")
    resumed = run_deck(hit.parse(text), output_dir=str(tmp_path / "resumed"),
                       device="cpu", recover=part.checkpoint_path)
    assert "M" in resumed.state["solver"]
    assert_equal_states(whole.state, resumed.state)
    # ComputeGroupExecutionCount's static part counts this process's steps
    # (no checkpoint holds it, in either package); the rest equal
    assert resumed.pp_values["group_evals"] < whole.pp_values["group_evals"]
    for name in ("c_total", "iterations"):
        assert resumed.pp_values[name] == whole.pp_values[name], name


def test_running_maximum_refuses_iterative_solvers():
    text = ostwald("SecantSolver").replace("  [Solve]\n", """  [Solve]
    [H]
      type = RunningMaximum
      buffer = H
      input = c
    []
""", 1)
    with pytest.raises(ComputeError, match="trial iterates"):
        TensorProblem(hit.parse(text), device="cpu").init_state()
