"""The port's time loop against the JAX package's: step rejection and the
iteration rules of (Tensor)IterationAdaptiveDT (reference
src/timesteppers/TensorSolveIterationAdaptiveDT.C), on the self-contained
decks of tests/test_timestepper.py, float64 on the CPU.  Each case runs
both packages and asserts the same dt sequence (every attempt, rejected
ones included), the same rejected_steps and time, and fields within 1e-10
of their largest magnitude."""

import math

import numpy as np
import pytest

from marlin_tpu import hit as jhit
from marlin_tpu.executioner import IterationAdaptiveDT as JaxIterationAdaptiveDT
from marlin_tpu.executioner import Transient as JaxTransient
from marlin_tpu.params import Params as JaxParams
from marlin_tpu.problem import TensorProblem as JaxProblem
from marlin_tpu_torch import hit
from marlin_tpu_torch.executioner import IterationAdaptiveDT, Transient
from marlin_tpu_torch.params import ParamError, Params
from marlin_tpu_torch.problem import TensorProblem
from tests.test_timestepper import _LIMIT_DECK, _SECANT_DECK

F64_TOL = 1e-10


def _transient(pkg, deck, outputs=None):
    """(Transient, its recorded dt of every attempt) of one package."""
    h, Problem, T = ((jhit, JaxProblem, JaxTransient) if pkg == "jax"
                     else (hit, lambda r: TensorProblem(r, device="cpu"), Transient))
    root = h.parse(deck)
    problem = Problem(root)
    kw = {} if outputs is None else {"outputs_node": h.parse(outputs).children["Outputs"]}
    tr = T(problem, exec_node=root.children.get("Executioner"), **kw)
    dts = []
    step = problem.step_with_pps

    def recorded(*args, **kwargs):
        dts.append(float(args[2]))
        return step(*args, **kwargs)

    problem.step_with_pps = recorded
    return tr, dts


def run_both(deck, expect_error=None):
    """Both packages' runs of ``deck``: dt sequences, rejected steps and
    time equal, u within 1e-10.  Returns the port's Transient."""
    out = {}
    for pkg in ("jax", "port"):
        tr, dts = _transient(pkg, deck)
        if expect_error:
            with pytest.raises(RuntimeError, match=expect_error):
                tr.run()
        else:
            tr.run()
        out[pkg] = (tr, dts)
    (jt, jdts), (pt, pdts) = out["jax"], out["port"]
    assert pdts == pytest.approx(jdts, rel=1e-12, abs=0), (pdts, jdts)
    assert pt.rejected_steps == jt.rejected_steps
    assert pt.step_count == jt.step_count
    assert pt.time == pytest.approx(jt.time, rel=1e-12)
    if not expect_error:
        ref = np.asarray(jt.state["buffers"]["u"])
        got = pt.state["buffers"]["u"].numpy()
        assert np.abs(got - ref).max() <= F64_TOL * np.abs(ref).max()
        assert int(pt.state["solver"]["iterations"]) == int(jt.state["solver"]["iterations"])
    return pt, pdts


def secant(dt, cutback, max_its=10, num_steps=2, growth=None, extra=""):
    deck = _SECANT_DECK.format(dt=dt, cutback=cutback, max_its=max_its, num_steps=num_steps)
    if growth is not None:
        deck = deck.replace("growth_factor = 2.0", f"growth_factor = {growth}")
    return deck.replace("    min_iterations = 1000\n", f"    min_iterations = 1000\n{extra}")


def test_failed_step_is_reattempted_with_cut_dt():
    """A solve that does not converge repeats the same step at the cut dt;
    time advances only by the accepted dt."""
    tr, dts = run_both(secant(1.0, 0.001, num_steps=1))
    assert tr.rejected_steps >= 1 and tr.step_count == 1
    assert math.isclose(tr.time, 1e-3, rel_tol=1e-12)
    assert dts == [1.0, 1e-3]


def test_converged_run_has_no_rejections():
    tr, dts = run_both(secant(1e-3, 0.5, max_its=30, growth=1.0))
    assert tr.rejected_steps == 0 and tr.step_count == 2
    assert math.isclose(tr.time, 2e-3, rel_tol=1e-12)


def test_dtmin_failure_raises():
    """'Solve failed and timestep already at dtmin, cannot continue!'
    (computeFailedDT :115-117), in both packages' words."""
    deck = secant(1.0, 0.5, max_its=2, num_steps=1).replace(
        "  num_steps = 1\n", "  num_steps = 1\n  dtmin = 1.0\n")
    run_both(deck, expect_error="Solve failed and timestep already at dtmin, "
                                "cannot continue!")


def test_no_growth_after_cutback():
    """dt does not grow on the step right after a failure cutback
    (computeDT :76-94); min_iterations = 1000 would grow it otherwise."""
    tr, dts = run_both(secant(1.0, 0.001, num_steps=2))
    assert tr.rejected_steps >= 1
    assert math.isclose(tr.time, 2e-3, rel_tol=1e-10)
    assert dts[-1] == dts[-2] == pytest.approx(1e-3)


def test_iterations_above_max_cut_dt():
    """optimal_iterations 2 ± 1: a solve of more than 3 iterations cuts
    the next dt by cutback_factor, every step."""
    deck = secant(1e-3, 0.5, max_its=30, num_steps=3, extra=(
        "    optimal_iterations = 2\n    iteration_window = 1\n    cutback_factor = 0.5\n"))
    deck = deck.replace("    min_iterations = 1000\n", "")
    tr, dts = run_both(deck)
    assert tr.rejected_steps == 0
    assert dts == pytest.approx([1e-3, 5e-4, 2.5e-4])


def test_timestep_limiting_postprocessor():
    """dt is capped at the smallest limiting postprocessor from step 2 on."""
    out = {}
    for pkg in ("jax", "port"):
        tr, dts = _transient(pkg, _LIMIT_DECK)
        tr.run()
        out[pkg] = (tr.time, dts)
    assert out["port"][1] == pytest.approx(out["jax"][1], rel=1e-12)
    assert math.isclose(out["port"][0], 1.0 + 2.0 / 64.0, rel_tol=1e-9)


def test_perf_graph(capsys):
    tr, _ = _transient("port", secant(1e-3, 0.5, max_its=30), outputs=(
        "[Outputs]\n  perf_graph = true\n[]\n"))
    tr.run()
    out = capsys.readouterr().out
    assert "solver::step (first; incl. compile)" in out
    assert "problem::init_state" in out


@pytest.mark.parametrize("its, want", [(8, 1.0), (3, 2.0)])
def test_min_iterations_only_holds_dt(its, want):
    """With only min_iterations set, dt grows below it and holds at or
    above it (reference computeAdaptiveDT)."""
    text = "[TimeStepper]\n  dt = 1\n  min_iterations = 5\n  growth_factor = 2\n[]"
    info = {"iterations": its, "converged": True}
    jax_ts = JaxIterationAdaptiveDT(JaxParams(jhit.parse(text).children["TimeStepper"]))
    ts = IterationAdaptiveDT(Params(hit.parse(text).children["TimeStepper"]))
    assert ts.dt(2, 1.0, info) == jax_ts.dt(2, 1.0, info) == want


@pytest.mark.parametrize("solver", ["SecantSolver", "BroydenSolver", "ETDRK4Solver",
                                    "AdamsBashforthMoultonCoupled"])
def test_carry_reciprocal_rejected_for_non_abm(solver):
    """carry_reciprocal is ABM's alone: every other solver is refused with
    the JAX package's words (marlin_tpu/solvers/base.py:255-262)."""
    deck = secant(1e-3, 0.5, max_its=5, num_steps=1).replace(
        "type = SecantSolver", f"type = {solver}").replace(
            "  substeps = 1\n", "  substeps = 1\n  carry_reciprocal = true\n")
    if solver not in ("SecantSolver", "BroydenSolver"):
        deck = deck.replace("  max_iterations = 5\n  absolute_tolerance = 1e-10\n"
                            "  relative_tolerance = 1e-10\n", "")
    with pytest.raises(ParamError, match="carry_reciprocal") as port_error:
        TensorProblem(hit.parse(deck), device="cpu")
    with pytest.raises(Exception, match="carry_reciprocal") as jax_error:
        JaxProblem(jhit.parse(deck))
    assert str(port_error.value) == str(jax_error.value)
