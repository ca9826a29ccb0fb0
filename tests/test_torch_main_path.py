"""The port's main path (marlin_tpu_torch) against the JAX package, end to
end, on the CPU.

Both packages parse the same deck text and run it; the port on
``device="cpu"``, where the unordered-FFT wrappers compute their plain
twins, and the JAX package with its Pallas kernels in interpret mode.

Tolerances:
- float64 DEFAULT path (torch.fft against jnp.fft, same operation order
  elsewhere): 1e-10 on ``c`` and on every postprocessor value;
- float32 PALLAS path (twins against interpret-mode kernels, float32
  sums in different orders): 5e-5 on ``c`` after 2 steps, the tolerance of
  tests/test_pallas_fft.py::test_ch_solver_physics_parity, and 1e-4 of the
  scale of each spectrum (see test_pallas_f32_matches_jax_interpret);
- benchmark 1a's fused float32 path against the JAX package's: 5e-5 on
  ``c`` (tests/test_torch_spectral.py's fused-deck tolerance) and 5e-5 of
  each postprocessor value's magnitude (at least 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marlin_tpu.pallas_fft as pf
from __graft_entry__ import _CH_DECK
from marlin_tpu import hit as jhit
from marlin_tpu.executioner import run_deck as jax_run_deck
from marlin_tpu.problem import TensorProblem as JaxProblem
from marlin_tpu_torch import hit, state as port_state
from marlin_tpu_torch.decks import BENCH_1A_DECK, CH3D_DECK
from marlin_tpu_torch.executioner import run_deck
from marlin_tpu_torch.problem import TensorProblem

F64_TOL = 1e-10

_TRANSIENT = """
[Executioner]
  type = Transient
  num_steps = 3
  [TimeStepper]
    type = IterationAdaptiveDT
    dt = 0.5
    growth_factor = 1.5
  []
[]
[Postprocessors]
  [c_mean]
    type = TensorAveragePostprocessor
    buffer = c
  []
  [c_integral]
    type = TensorIntegralPostprocessor
    buffer = c
  []
  [c_min]
    type = TensorExtremeValuePostprocessor
    buffer = c
    value_type = MIN
  []
  [c_max]
    type = TensorExtremeValuePostprocessor
    buffer = c
  []
[]
"""


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pf._INTERPRET
    pf._INTERPRET = True
    yield
    pf._INTERPRET = old


def _deck_2d(n, substeps):
    return _CH_DECK.format(nx=n, ny=n, substeps=substeps)


def _deck_3d(n, substeps):
    return CH3D_DECK.format(n=n, substeps=substeps)


def _single_pallas(deck):
    return deck.replace(
        "[Domain]", "[Domain]\n  fft_backend = PALLAS\n  floating_precision = SINGLE")


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("deck", [_deck_2d(64, 3), _deck_3d(32, 2)],
                         ids=["ch2d_64", "ch3d_32"])
def test_transient_f64_default_matches_jax(deck, tmp_path):
    """(a), (b): Transient with adaptive dt and postprocessors, float64."""
    deck = deck + _TRANSIENT
    jt = jax_run_deck(jhit.parse(deck), output_dir=str(tmp_path / "jax"))
    pt = run_deck(hit.parse(deck), output_dir=str(tmp_path / "port"),
                  device="cpu")
    assert pt.step_count == jt.step_count == 3
    assert pt.time == pytest.approx(jt.time, abs=1e-12)
    c_port = pt.state["buffers"]["c"].numpy()
    c_jax = np.asarray(jt.state["buffers"]["c"])
    assert c_port.dtype == c_jax.dtype == np.float64
    np.testing.assert_allclose(c_port, c_jax, rtol=0, atol=F64_TOL)
    assert set(pt.pp_values) == set(jt.pp_values)
    for k, v in jt.pp_values.items():
        assert pt.pp_values[k] == pytest.approx(v, rel=0, abs=F64_TOL), k


@pytest.mark.parametrize("deck", [_deck_3d(32, 3), _deck_2d(128, 3)],
                         ids=["ch3d_32", "ch2d_128"])
def test_pallas_f32_matches_jax_interpret(deck):
    """(c): the PALLAS backend in float32, 2 steps."""
    deck = _single_pallas(deck)
    jp = JaxProblem(jhit.parse(deck))
    js = jp.init_state()
    step = jax.jit(jp._step_impl)
    js = step(js, 0.0, 1.0, 1.0, jnp.asarray(True))
    js = _to_np(step(js, 1.0, 1.0, 1.0, jnp.asarray(False)))

    pp = TensorProblem(hit.parse(deck), device="cpu")
    ps = pp.init_state()
    ps = pp.step(ps, 0.0, 1.0, 1.0, True)
    ps = port_state.to_numpy(pp.step(ps, 1.0, 1.0, 1.0, False))

    assert ps["buffers"]["c"].dtype == np.float32
    np.testing.assert_allclose(ps["buffers"]["c"], js["buffers"]["c"],
                               rtol=0, atol=5e-5)
    # each spectrum element by element, at 1e-4 of the scale that bounds
    # its error: its own largest magnitude for the transforms, and
    # max|M̄|·max|µ̄| for the product M̄µ̄, whose high-k entries carry µ̄'s
    # float32 error times |M̄| = 5k² (up to 148 at 32³) while its largest
    # magnitude sits at low k
    jb = js["buffers"]
    scale = {"mubar": np.abs(jb["mubar"]).max(),
             "cbar": np.abs(jb["cbar"]).max(),
             "Mbarmubar": np.abs(jb["Mbar"]).max() * np.abs(jb["mubar"]).max()}
    for name, s in scale.items():
        got, ref = ps["buffers"][name], jb[name]
        assert got.shape == ref.shape and got.dtype == np.complex64
        assert np.abs(got - ref).max() <= 1e-4 * s, name
    assert ps["n_advances"] == js["n_advances"]


def test_state_from_jax_one_step_f64():
    """(d): start both packages from the JAX package's init_state."""
    deck = _deck_2d(64, 4)
    jp = JaxProblem(jhit.parse(deck))
    js0 = _to_np(jp.init_state())
    pp = TensorProblem(hit.parse(deck), device="cpu")
    ps0 = port_state.from_numpy(js0, "cpu")

    js = _to_np(jax.jit(jp._step_impl)(js0, 0.0, 1.0, 0.0, jnp.asarray(False)))
    ps = port_state.to_numpy(pp.step(ps0, 0.0, 1.0, 0.0, False))
    assert set(ps["buffers"]) == set(js["buffers"])
    assert set(ps["old"]) == set(js["old"])
    for name in js["buffers"]:
        np.testing.assert_allclose(ps["buffers"][name], js["buffers"][name],
                                   rtol=0, atol=F64_TOL, err_msg=name)
    for name in js["old"]:
        np.testing.assert_allclose(ps["old"][name], js["old"][name],
                                   rtol=0, atol=F64_TOL, err_msg=name)
    assert ps["n_advances"] == js["n_advances"]
    np.testing.assert_array_equal(ps["old_dt"], js["old_dt"])


@pytest.mark.parametrize("deck", [_deck_2d(64, 2), _single_pallas(_deck_3d(32, 2))],
                         ids=["ch2d_64_f64", "ch3d_32_pallas_f32"])
def test_init_state_matches_jax(deck):
    """The port's init_state has the JAX package's layout, shapes, dtypes
    and values (ICs evaluated in float64 / float32 alike)."""
    js = _to_np(JaxProblem(jhit.parse(deck)).init_state())
    ps = port_state.to_numpy(TensorProblem(hit.parse(deck), device="cpu").init_state())
    assert set(ps) == set(js)
    for part in ("buffers", "old"):
        assert set(ps[part]) == set(js[part])
        for name, ref in js[part].items():
            got = ps[part][name]
            assert got.shape == ref.shape and got.dtype == ref.dtype, name
            tol = F64_TOL if ref.dtype in (np.float64, np.complex128) else 1e-6
            np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=name)
    assert ps["old_dt"].shape == js["old_dt"].shape
    assert ps["n_advances"] == js["n_advances"]


def test_roundtrip_state_conversion():
    deck = _deck_2d(64, 2)
    pp = TensorProblem(hit.parse(deck), device="cpu")
    s = pp.step(pp.init_state(), 0.0, 1.0, 0.0, True)
    back = port_state.from_numpy(port_state.to_numpy(s), "cpu")
    assert back["n_advances"] == s["n_advances"]
    assert back["old_dt"] == s["old_dt"]
    for name, t in s["buffers"].items():
        assert back["buffers"][name].equal(t), name


_SYMBOLS = """
[TensorComputes]
  [Solve]
    [phase]
      type = ParsedCompute
      buffer = phase
      extra_symbols = true
      expression = 'cos(kx*t) + i*ky'
    []
    [kfield]
      type = ParsedCompute
      buffer = kfield
      extra_symbols = true
      expression = 'k2 * kz'
    []
    [level]
      type = ParsedCompute
      buffer = level
      extra_symbols = true
      expand = REAL
      expression = 'pi'
    []
    [count]
      type = ParsedCompute
      buffer = count
      is_integer = true
      inputs = c
      expression = 'c*10'
    []
    [back]
      type = InverseFFT
      buffer = back
      input = phase
    []
  []
[]
"""


@pytest.mark.parametrize("deck", [
    _deck_2d(16, 1), _single_pallas(_deck_3d(32, 1)),
    _deck_3d(8, 1).split("[TensorComputes]")[0] + _SYMBOLS,
], ids=["ch2d_f64", "ch3d_pallas_f32", "symbols"])
def test_shape_rules_match_evaluation(deck):
    """Each compute's output_specs (used by init_state instead of running
    the chain) agrees with what apply gives."""
    from marlin_tpu_torch.computes.base import Spec

    pp = TensorProblem(hit.parse(deck), device="cpu")
    state = pp.init_state()
    buffers = dict(state["buffers"])
    buffers.setdefault("c", torch.rand(pp.domain.shape, dtype=pp.domain.dtype))
    ctx = {"t": 0.5, "old": state["old"], "n_advances": 0}
    for m in pp.solve_computes:
        specs = {k: Spec(tuple(v.shape), v.dtype) for k, v in buffers.items()}
        want = m.output_specs(specs)
        got = m.apply(buffers, ctx)
        assert {k: Spec(tuple(v.shape), v.dtype) for k, v in got.items()} == want, m.name
        buffers.update(got)


_TERMINATE = """
[Executioner]
  type = Transient
  num_steps = 6
  [TimeStepper]
    type = IterationAdaptiveDT
    dt = 1
    growth_factor = 2
    cutback_factor_at_failure = 0.25
    timestep_limiting_postprocessor = {cap}
  []
[]
[Postprocessors]
  [c_max]
    type = TensorExtremeValuePostprocessor
    buffer = c
  []
  [c_mean]
    type = TensorAveragePostprocessor
    buffer = c
    execute_on = 'INITIAL TIMESTEP_END'
  []
  [dt_cap]
    type = TensorIntegralPostprocessor
    buffer = c
  []
[]
[UserObjects]
  [{name}]
    type = Terminator
    expression = '{expr}'
    fail_mode = {mode}
  []
[]
"""


@pytest.mark.parametrize("name,expr,mode,cap", [
    ("stop", "c_max > 0.5515", "HARD", "dt_cap"),
    ("retry", "c_max > 0.5525", "SOFT", "dt_cap"),
    # c_max, not c_mean, as the cap: the solver compares dt with dt_old
    # exactly, and jnp.sum's c_mean wobbles in its last bit from step to
    # step where torch's does not, which would flip the AB order fallback
    ("never", "0", "HARD", "c_max"),
])
def test_terminators_and_cutback_match_jax(name, expr, mode, cap, tmp_path):
    """HARD ends the run (step 3), SOFT re-attempts steps at a cut dt, and a
    limiting postprocessor caps dt from step 2 (c_max ≈ 0.55); step counts,
    times and values as in JAX."""
    deck = _deck_2d(64, 2) + _TERMINATE.format(name=name, expr=expr, mode=mode,
                                               cap=cap)
    jt = jax_run_deck(jhit.parse(deck), output_dir=str(tmp_path / "jax"))
    pt = run_deck(hit.parse(deck), output_dir=str(tmp_path / "port"),
                  device="cpu")
    assert pt.step_count == jt.step_count
    assert pt.time == pytest.approx(jt.time, abs=1e-12)
    for k, v in jt.pp_values.items():
        assert pt.pp_values[k] == pytest.approx(v, rel=0, abs=F64_TOL), k
    np.testing.assert_allclose(pt.state["buffers"]["c"].numpy(),
                               np.asarray(jt.state["buffers"]["c"]),
                               rtol=0, atol=F64_TOL)


# -- benchmark 1a's deck (decks.BENCH_1A_DECK) ---------------------------------------

BENCH_1A_STEPS = 12


def _bench_1a(change_tol="1e-4", domain_extra="", solver_extra=""):
    """BENCH_1A_DECK at 64², 10 substeps, cut to 12 steps."""
    text = BENCH_1A_DECK.format(n=64, substeps=10, domain_extra=domain_extra,
                                solver_extra=solver_extra)
    return text.replace("'change < 1e-4'", f"'change < {change_tol}'").replace(
        "  end_time = 10500\n", f"  end_time = 10500\n  num_steps = {BENCH_1A_STEPS}\n")


def _assert_rows_match(pt, jt, tol):
    """Every CSV row (INITIAL, then each step) in both packages, each
    value within ``tol`` of its magnitude (at least 1)."""
    assert len(pt.csv.rows) == len(jt.csv.rows) == pt.step_count + 1
    for a, b in zip(jt.csv.rows, pt.csv.rows):
        assert set(a) == set(b)
        for k, v in a.items():
            assert b[k] == pytest.approx(v, rel=0, abs=tol * max(1.0, abs(v))), k


@pytest.mark.parametrize("change_tol,steps", [("1e-4", BENCH_1A_STEPS), ("1", 2)],
                         ids=["runs_out", "terminator_fires"])
def test_bench_1a_f64_default_matches_jax(change_tol, steps, tmp_path, capsys):
    """BENCH_1A_DECK through both packages' run_deck: every postprocessor
    column and c within 1e-10 in float64, equal step counts and times; with
    ``change < 1`` the Terminator fires at step 2 in both (change is
    Σ|c − c_old|·Πh over the last substep: 0.63 at step 2, then above 0.9)."""
    deck = _bench_1a(change_tol)
    jt = jax_run_deck(jhit.parse(deck), output_dir=str(tmp_path / "jax"))
    pt = run_deck(hit.parse(deck), output_dir=str(tmp_path / "port"), device="cpu")
    assert pt.step_count == jt.step_count == steps
    assert pt.time == jt.time
    _assert_rows_match(pt, jt, F64_TOL)
    np.testing.assert_allclose(pt.state["buffers"]["c"].numpy(),
                               np.asarray(jt.state["buffers"]["c"]), rtol=0, atol=F64_TOL)
    row0 = pt.csv.rows[0]
    # CSV row 0: F(0) and the starting mass; TIMESTEP_END-only values 0
    assert row0["F"] > 0 and row0["c_integral"] > 0 and row0["change"] == 0.0
    assert pt.pp_values["F_per_cell"] == pytest.approx(pt.pp_values["F"] / 64**2)
    assert pt.pp_values["mass"] == pytest.approx(pt.pp_values["c_integral"], rel=1e-12)
    assert capsys.readouterr().out.count("Performance Graph:") == 2


_FUSED_1A = ("fft_backend = PALLAS\n  floating_precision = SINGLE",
             "carry_reciprocal = true\n  fused_spectral = true")


def test_bench_1a_fused_pallas_f32_matches_jax(tmp_path):
    """The 1a deck on the fused path (kernels 1′ and 5 in the port, their
    Pallas counterparts in interpret mode) against the JAX package's fused
    path, float32."""
    deck = _bench_1a("1e-4", *_FUSED_1A)
    jt = jax_run_deck(jhit.parse(deck), output_dir=str(tmp_path / "jax"))
    pt = run_deck(hit.parse(deck), output_dir=str(tmp_path / "port"), device="cpu")
    assert pt.step_count == jt.step_count == BENCH_1A_STEPS
    assert pt.time == jt.time
    assert pt.state["n_advances"] == int(jt.state["n_advances"])
    _assert_rows_match(pt, jt, 5e-5)
    np.testing.assert_allclose(pt.state["buffers"]["c"].numpy(),
                               np.asarray(jt.state["buffers"]["c"]), rtol=0, atol=5e-5)


@pytest.mark.parametrize("extra", [("", ""), _FUSED_1A], ids=["default_f64", "fused_f32"])
def test_bench_1a_change_reads_the_last_substep(extra):
    """On both paths change compares c with the start of the step's last
    substep (c's depth-1 history, advanced between substeps and, on the
    fused path, once after the fused loop), as in the JAX package; not with
    the start of the step."""
    p = TensorProblem(hit.parse(_bench_1a("1e-4", *extra)), device="cpu")
    s = p.step(p.init_state(), 0.0, 1.0, 0.0, True)
    start = s["buffers"]["c"]
    s, vals = p.step_with_pps(s, 1.0, 1.1, 1.0, False)
    c, old = s["buffers"]["c"], s["old"]["c"][0]
    cell = 1.0  # xmax = nx
    last = torch.sum(torch.abs(c - old)).item() * cell
    whole = torch.sum(torch.abs(c - start)).item() * cell
    assert vals["change"] == pytest.approx(last, rel=1e-6)
    assert not torch.equal(old, start) and whole > 5 * last


@pytest.mark.parametrize("n", [200, 64])
def test_bench_1a_pallas_operators_equal_default(n):
    """M̄ and κ̄̄ of the 1a deck under PALLAS, unpermuted along both axes,
    equal DEFAULT's on its half spectrum bit for bit, and are even in k: the
    permuted layout, with every Nyquist frequency negative, gives the solve
    the same operator as the half spectrum (only a gradient sees the
    Nyquist sign)."""
    from marlin_tpu_torch import unordered_fft as uf

    def buffers(domain_extra):
        deck = BENCH_1A_DECK.format(n=n, substeps=2, domain_extra=domain_extra,
                                    solver_extra="")
        return TensorProblem(hit.parse(deck), device="cpu").init_state()["buffers"]

    half = buffers("floating_precision = SINGLE")
    full = buffers("fft_backend = PALLAS\n  floating_precision = SINGLE")
    order = uf.true_k_order(n)
    mirror = (-np.arange(n)) % n
    for name in ("Mbar", "kappabarbar"):
        natural = np.empty((n, n), np.float32)
        natural[np.ix_(order, order)] = full[name].numpy()
        np.testing.assert_array_equal(natural[:, : n // 2 + 1], half[name].numpy())
        np.testing.assert_array_equal(natural, natural[np.ix_(mirror, mirror)])
