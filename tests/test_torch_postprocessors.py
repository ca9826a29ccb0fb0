"""The port's postprocessors, the computes of benchmark 1a's deck, the perf
graph and the CLI flags (marlin_tpu_torch/postprocessors.py,
computes/core.py, perf.py, executioner.py, main.py) against the JAX
package's, on the CPU.

Both packages build the same deck text; the port on ``device="cpu"``, the
JAX package with its Pallas kernels in interpret mode.  Cases mirror
tests/test_review_r02.py (ParsedPostprocessor, RandomTensor) and
tests/test_timestepper.py (SemiImplicitCriticalTimeStep, the perf graph);
tests/test_solvers_gold.py runs only decks of the absent reference
checkout, so nothing of it is mirrored here.

Tolerances:
- float64 DEFAULT: 1e-10 on every value and buffer;
- float32 PALLAS (the port's plain twins against interpret-mode kernels):
  1e-5 of each output's largest magnitude, as
  tests/test_torch_unordered_fft.py and test_torch_spectral.py hold
  kernel 1, and 5e-5 of each postprocessor value's magnitude (at least 1)
  after a run, the field tolerance of tests/test_torch_main_path.py;
- RandomTensor on the CPU stream: bit for bit.
"""

import math

import numpy as np
import pytest
import torch

import marlin_tpu.pallas_fft as pf
from marlin_tpu import hit as jhit
from marlin_tpu.executioner import run_deck as jax_run_deck
from marlin_tpu.problem import TensorProblem as JaxProblem
from marlin_tpu_torch import hit
from marlin_tpu_torch import main as port_main
from marlin_tpu_torch.decks import BENCH_1A_DECK
from marlin_tpu_torch.executioner import run_deck
from marlin_tpu_torch.params import ParamError
from marlin_tpu_torch.problem import TensorProblem

F64_TOL = 1e-10
PALLAS = "fft_backend = PALLAS\n  floating_precision = SINGLE"


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pf._INTERPRET
    pf._INTERPRET = True
    yield
    pf._INTERPRET = old


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _both(text):
    """(JAX problem, port problem) of one deck text."""
    return JaxProblem(jhit.parse(text)), TensorProblem(hit.parse(text), device="cpu")


# -- postprocessors over a short transient ---------------------------------------

_CH = BENCH_1A_DECK.format(n=32, substeps=4, domain_extra="{domain_extra}",
                           solver_extra="")
_TRANSIENT = """
[Executioner]
  type = Transient
  num_steps = 4
  [TimeStepper]
    type = IterationAdaptiveDT
    dt = 0.5
    growth_factor = 1.5
  []
[]
"""


_TERMINATOR = """[UserObjects]
  [terminator]
    type = Terminator
    expression = 'change < 1e-4'
  []
[]
"""


def _pp_deck(block, domain_extra=""):
    """The 1a deck at 32², 4 substeps, with ``block`` as its only
    [Postprocessors], a 4-step schedule, no Terminator and no perf graph."""
    text = _CH.format(domain_extra=domain_extra)
    head, tail = text.split("[Postprocessors]", 1)
    tail = tail.split(_TERMINATOR, 1)[1].split("[Outputs]", 1)[0]
    assert tail.startswith("[Executioner]")
    return (head + "[Postprocessors]" + block + "\n[]\n" + _TRANSIENT
            + "[Outputs]\n  csv = true\n[]\n")


_PP_BLOCKS = {
    "change": """
  [change]
    type = TensorIntegralChangePostprocessor
    buffer = c
    execute_on = 'INITIAL TIMESTEP_END'
  []""",
    "reciprocal_integral": """
  [mass]
    type = ReciprocalIntegral
    buffer = cbar
  []""",
    "critical_dt": """
  [dt_crit]
    type = SemiImplicitCriticalTimeStep
    buffer = kappabarbar
    execute_on = 'INITIAL TIMESTEP_END'
  []""",
    "interface_velocity": """
  [velocity]
    type = TensorInterfaceVelocityPostprocessor
    buffer = c
  []""",
    "parsed": """
  [scaled]
    type = ParsedPostprocessor
    expression = 'a * pi + t / e'
    pp_names = F
    pp_symbols = a
  []
  [F]
    type = TensorIntegralPostprocessor
    buffer = f
    execute_on = 'INITIAL TIMESTEP_END'
  []""",
}


def _runs(text, tmp_path):
    jt = jax_run_deck(jhit.parse(text), output_dir=str(tmp_path / "jax"))
    pt = run_deck(hit.parse(text), output_dir=str(tmp_path / "port"), device="cpu")
    return jt, pt


@pytest.mark.parametrize("name", list(_PP_BLOCKS))
def test_postprocessor_matches_jax_f64(name, tmp_path):
    """Each new postprocessor over a 4-step transient with dt growing, at
    every output point, within 1e-10 in float64."""
    text = _pp_deck(_PP_BLOCKS[name])
    jt, pt = _runs(text, tmp_path)
    assert pt.step_count == jt.step_count == 4
    assert pt.time == pytest.approx(jt.time, rel=1e-14)
    jr, pr = jt.csv.rows, pt.csv.rows
    assert len(pr) == len(jr) == 5
    for a, b in zip(jr, pr):
        assert set(a) == set(b)
        for k in a:
            assert b[k] == pytest.approx(a[k], rel=0, abs=F64_TOL * max(1.0, abs(a[k]))), k
    assert any(v != 0.0 for r in pr[1:] for k, v in r.items() if k != "time")


def test_history_requests_match_jax():
    """The change postprocessor's request on c merges with the solver's, in
    both packages alike, on the default and the fused path."""
    for extra, solver in (("", ""), (PALLAS, "carry_reciprocal = true\n  fused_spectral = true")):
        text = BENCH_1A_DECK.format(n=16, substeps=2, domain_extra=extra,
                                    solver_extra=solver)
        jp, pp = _both(text)
        assert pp.history_requests() == jp.history_requests() == {"Mbarmubar": 1, "c": 1}


def test_critical_dt_limits_the_step_like_jax(tmp_path):
    """tests/test_timestepper.py::test_timestep_limiting_postprocessor: dt
    capped by 1/max|L̄| from step 2 on (L̄ = −k² on 16 points over 2π:
    dt_crit = 1/64)."""
    from tests.test_timestepper import _LIMIT_DECK

    jt, pt = _runs(_LIMIT_DECK, tmp_path)
    assert pt.step_count == jt.step_count == 3
    assert pt.time == pytest.approx(jt.time, rel=1e-14)
    assert math.isclose(pt.time, 1.0 + 2.0 / 64.0, rel_tol=1e-9)
    assert pt.pp_values["dt_crit"] == pytest.approx(1.0 / 64.0, rel=1e-12)


def test_critical_dt_of_zero_operator_is_1e30():
    text = _pp_deck(_PP_BLOCKS["critical_dt"]).replace(
        "factor = -10", "factor = 0")
    for p in _both(text):
        vals = p.execute_postprocessors(p.init_state(), "INITIAL", 0.0, 0.0)
        assert vals["dt_crit"] == 1e30


def test_change_before_first_advance_is_the_integral():
    """Before the first advance change is Σ|u|·Πh (no old state yet)."""
    text = _pp_deck(_PP_BLOCKS["change"])
    for p in _both(text):
        s = p.init_state()
        vals = p.execute_postprocessors(s, "INITIAL", 0.0, 0.0)
        c = _np(s["buffers"]["c"])
        assert vals["change"] == pytest.approx(np.abs(c).sum() * 1.0, rel=1e-13)


# -- the PALLAS backend in float32 ---------------------------------------------------


@pytest.mark.parametrize("compute", ["FFTGradient_X", "FFTGradient_Y",
                                     "FFTGradientSquare", "FFTGradientSquare_reciprocal"])
def test_gradient_pallas_f32_matches_jax_interpret(compute):
    """FFTGradient(Square) through the domain's unordered transforms (the
    port's twins against the interpret-mode Pallas kernels), permuted axes."""
    text = _gradient_deck(compute, PALLAS)
    jp, pp = _both(text)
    ref = _np(jp.init_state()["buffers"]["g"])
    got = _np(pp.init_state()["buffers"]["g"])
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(ref).max() > 0


def test_reciprocal_integral_pallas_f32_matches_jax(tmp_path):
    """The k = 0 slot of the permuted spectrum is the mass, under PALLAS as
    under DEFAULT, in both packages."""
    block = _PP_BLOCKS["reciprocal_integral"] + """
  [c_integral]
    type = TensorIntegralPostprocessor
    buffer = c
  []"""
    text = _pp_deck(block, PALLAS)
    jt, pt = _runs(text, tmp_path)
    for k in ("mass", "c_integral"):
        assert pt.pp_values[k] == pytest.approx(jt.pp_values[k], rel=5e-5)
    assert pt.pp_values["mass"] == pytest.approx(pt.pp_values["c_integral"], rel=1e-5)
    default = run_deck(hit.parse(_pp_deck(block)), output_dir=str(tmp_path / "d"),
                       device="cpu")
    assert pt.pp_values["mass"] == pytest.approx(default.pp_values["mass"], rel=1e-5)


# -- computes ----------------------------------------------------------------------

_IC_DECK = """
[Domain]
  dim = 2
  nx = 24
  ny = 16
  xmax = 6
  ymax = 4
  {domain_extra}
[]
[TensorComputes]
  [Initialize]
    [c]
      type = ParsedCompute
      buffer = c
      extra_symbols = true
      expression = 'sin(pi*x/3) * cos(pi*y/2) + 0.2*cos(2*pi*x/3)'
    []
{members}
  []
[]
[Problem]
  type = TensorProblem
[]
"""

_GRADIENTS = {
    "FFTGradient_X": "type = FFTGradient\n      input = c\n      direction = X",
    "FFTGradient_Y": "type = FFTGradient\n      input = c\n      direction = Y",
    "FFTGradientSquare": "type = FFTGradientSquare\n      input = c\n      factor = 2",
    "FFTGradientSquare_reciprocal": ("type = FFTGradientSquare\n      input = cbar\n"
                                     "      input_is_reciprocal = true"),
}


def _gradient_deck(compute, domain_extra=""):
    members = """
    [cbar]
      type = ForwardFFT
      buffer = cbar
      input = c
    []
    [g]
      buffer = g
      {body}
    []""".format(body=_GRADIENTS[compute])
    return _IC_DECK.format(domain_extra=domain_extra, members=members)


_COMPUTES = {
    **{k: _gradient_deck(k) for k in _GRADIENTS},
    "ConstantReciprocalTensor": _IC_DECK.format(domain_extra="", members="""
    [g]
      type = ConstantReciprocalTensor
      buffer = g
      real = 1.5
      imaginary = -0.25
    []"""),
    "ParsedTensor": _IC_DECK.format(domain_extra="", members="""
    [g]
      type = ParsedTensor
      buffer = g
      function = 'x*y + sin(pi*x) + t'
    []"""),
    "RandomTensor_seeded": _IC_DECK.format(domain_extra="", members="""
    [g]
      type = RandomTensor
      buffer = g
      min = -0.5
      max = 2
      seed = 7
    []"""),
}


@pytest.mark.parametrize("name", list(_COMPUTES))
def test_compute_matches_jax_f64(name):
    jp, pp = _both(_COMPUTES[name])
    ref = _np(jp.init_state()["buffers"]["g"])
    got = _np(pp.init_state()["buffers"]["g"])
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if name.startswith("RandomTensor"):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=F64_TOL)
    assert np.abs(ref).max() > 0


def test_gradient_square_is_the_sum_of_squared_gradients():
    """factor · Σ_d (∂u/∂x_d)², against the port's own FFTGradient."""
    p = TensorProblem(hit.parse(_IC_DECK.format(domain_extra="", members="""
    [gx]
      type = FFTGradient
      buffer = gx
      input = c
    []
    [gy]
      type = FFTGradient
      buffer = gy
      input = c
      direction = Y
    []
    [g2]
      type = FFTGradientSquare
      buffer = g2
      input = c
      factor = 3
    []""")), device="cpu")
    b = p.init_state()["buffers"]
    torch.testing.assert_close(b["g2"], 3 * (b["gx"] ** 2 + b["gy"] ** 2),
                               rtol=0, atol=F64_TOL)


_RANDOM = """
    [a]
      type = RandomTensor
      buffer = a
      min = 0
      max = 1
      {a}
    []
    [b]
      type = RandomTensor
      buffer = b
      min = 0
      max = 1
      {b}
    []"""


def test_random_tensor_float32_is_the_float64_field():
    """A float32 buffer holds the float64 stream's field rounded, bit for
    bit the JAX package's (a float32 draw would be another field)."""
    f32 = _COMPUTES["RandomTensor_seeded"].replace(
        "[Domain]", "[Domain]\n  floating_precision = SINGLE")
    jp, pp = _both(f32)
    got = _np(pp.init_state()["buffers"]["g"])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, _np(jp.init_state()["buffers"]["g"]))
    f64 = _np(TensorProblem(hit.parse(_COMPUTES["RandomTensor_seeded"]),
                            device="cpu").init_state()["buffers"]["g"])
    np.testing.assert_allclose(got, f64, rtol=0, atol=1e-6)


@pytest.mark.parametrize("on_cpu", ["true", "false"])
def test_random_tensor_unseeded_draws_are_independent(on_cpu):
    """Two unseeded RandomTensors draw independent noise on both settings
    of generate_on_cpu (tests/test_review_r02.py, the device case)."""
    opt = f"generate_on_cpu = {on_cpu}"
    text = _IC_DECK.format(domain_extra="", members=_RANDOM.format(a=opt, b=opt))
    b = TensorProblem(hit.parse(text), device="cpu").init_state()["buffers"]
    a_, b_ = _np(b["a"]), _np(b["b"])
    assert not np.allclose(a_, b_)
    for u in (a_, b_):
        assert 0.0 <= u.min() and u.max() < 1.0 and 0.3 < u.mean() < 0.7


def test_random_tensor_device_stream_is_seeded():
    """generate_on_cpu = false: the same seed draws the same field, another
    seed another; the global RNG is left alone."""
    def field(seed):
        opt = f"generate_on_cpu = false\n      seed = {seed}"
        text = _IC_DECK.format(domain_extra="", members=_RANDOM.format(a=opt, b=opt))
        return TensorProblem(hit.parse(text), device="cpu").init_state()["buffers"]

    state = torch.get_rng_state()
    one, again, other = field(3), field(3), field(4)
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(one["a"], one["b"]) and torch.equal(one["a"], again["a"])
    assert not torch.equal(one["a"], other["a"])


# -- ParsedPostprocessor (tests/test_review_r02.py) ------------------------------------

_PP_ONLY = """
[Domain]
  dim = 2
  nx = 8
  ny = 8
  xmax = 1
  ymax = 1
[]
[TensorComputes]
  [Initialize]
    [c]
      type = ConstantTensor
      buffer = c
      real = 2
    []
  []
[]
[Problem]
  type = TensorProblem
[]
[Postprocessors]
{pps}
[]
"""


def test_parsed_pp_forward_reference():
    text = _PP_ONLY.format(pps="""
  [doubled]
    type = ParsedPostprocessor
    expression = '2*avg'
    pp_names = 'avg'
  []
  [avg]
    type = TensorAveragePostprocessor
    buffer = c
  []""")
    for p in _both(text):
        _, vals = p.step_with_pps(p.init_state(), 0.0, 0.1, 0.1, first_step=True)
        assert vals["avg"] == pytest.approx(2.0)
        assert vals["doubled"] == pytest.approx(4.0)


def test_parsed_pp_misspelled_name_errors():
    text = _PP_ONLY.format(pps="""
  [avg]
    type = TensorAveragePostprocessor
    buffer = c
  []
  [bad]
    type = ParsedPostprocessor
    expression = '2*agv'
    pp_names = 'agv'
  []""")
    with pytest.raises(ParamError, match="postprocessor 'agv' does not exist"):
        TensorProblem(hit.parse(text), device="cpu")
    with pytest.raises(Exception, match="does not exist"):
        JaxProblem(jhit.parse(text))


def test_parsed_pp_symbols_must_match_names():
    text = _PP_ONLY.format(pps="""
  [avg]
    type = TensorAveragePostprocessor
    buffer = c
  []
  [bad]
    type = ParsedPostprocessor
    expression = 'a'
    pp_names = 'avg'
    pp_symbols = 'a b'
  []""")
    with pytest.raises(ParamError, match="must have equal length"):
        TensorProblem(hit.parse(text), device="cpu")


def test_parsed_pp_pi_and_e_constants():
    text = _PP_ONLY.format(pps="""
  [avg]
    type = TensorAveragePostprocessor
    buffer = c
  []
  [scaled]
    type = ParsedPostprocessor
    expression = 'avg*pi + e'
    pp_names = 'avg'
  []""")
    for p in _both(text):
        _, vals = p.step_with_pps(p.init_state(), 0.0, 0.1, 0.1, first_step=True)
        assert vals["scaled"] == pytest.approx(2.0 * np.pi + np.e, rel=1e-14)


def test_parsed_pp_cross_flag_reference_reports_zero():
    text = _PP_ONLY.format(pps="""
  [avg]
    type = TensorAveragePostprocessor
    buffer = c
  []
  [onflag]
    type = ParsedPostprocessor
    expression = '1 + avg'
    pp_names = 'avg'
    execute_on = 'INITIAL TIMESTEP_END'
  []""")
    for p in _both(text):
        vals = p.execute_postprocessors(p.init_state(), "INITIAL", 0.0, 0.0)
        assert vals == {"onflag": pytest.approx(1.0)}


def test_one_transfer_a_step(monkeypatch):
    """The tensor values of a step reach the host in one transfer; the
    ParsedPostprocessor pass reads them there."""
    text = _PP_ONLY.format(pps="""
  [avg]
    type = TensorAveragePostprocessor
    buffer = c
  []
  [top]
    type = TensorExtremeValuePostprocessor
    buffer = c
  []
  [ratio]
    type = ParsedPostprocessor
    expression = 'top / avg'
    pp_names = 'avg top'
  []""")
    p = TensorProblem(hit.parse(text), device="cpu")
    s = p.init_state()
    calls = []
    orig = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda self: calls.append(self.shape) or orig(self))
    _, vals = p.step_with_pps(s, 0.0, 0.1, 0.1, first_step=True)
    assert calls == [torch.Size([2])]
    assert vals == {"avg": 2.0, "top": 2.0, "ratio": 1.0}


# -- perf graph and the CLI ----------------------------------------------------------


def test_perf_graph_prints_the_report(tmp_path, capsys):
    """`[Outputs] perf_graph = true` prints the JAX executioner's sections
    (tests/test_timestepper.py::test_perf_graph)."""
    text = BENCH_1A_DECK.format(n=16, substeps=2, domain_extra="", solver_extra="")
    tr = run_deck(hit.parse(text + "[Executioner]\n  num_steps = 2\n[]\n"),
                  output_dir=str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert "Performance Graph:" in out
    for section in ("solver::step (first; incl. compile)", "solver::step ",
                    "problem::init_state (build + ICs)", "outputs"):
        assert section in out, section
    assert tr.perf.sections["solver::step"][1] == 1
    assert tr.perf.sections["outputs"][1] == 4  # row 0, two steps, the end


_CLI_DECK = """
[Domain]
  dim = 2
  nx = 24
  ny = 16
  xmax = 6
  ymax = 4
[]
[TensorComputes]
  [Initialize]
    [c]
      type = ParsedTensor
      buffer = c
      function = '0.5 + 0.05*sin(pi*x/3)'
    []
    [noise]
      type = RandomTensor
      buffer = noise
      min = -0.01
      max = 0.01
      seed = 3
    []
    [L]
      type = ReciprocalLaplacianFactor
      buffer = L
      factor = 0.1
    []
  []
  [Solve]
    [cbar]
      type = ForwardFFT
      buffer = cbar
      input = c
    []
    [Nbar]
      type = ConstantReciprocalTensor
      buffer = Nbar
    []
  []
  [Postprocess]
    [grad2]
      type = FFTGradientSquare
      buffer = grad2
      input = c
    []
  []
[]
[TensorSolver]
  type = AdamsBashforthMoulton
  buffer = c
  reciprocal_buffer = cbar
  linear_reciprocal = L
  nonlinear_reciprocal = Nbar
  substeps = 2
[]
[Problem]
  type = TensorProblem
[]
[Postprocessors]
  [change]
    type = TensorIntegralChangePostprocessor
    buffer = c
  []
  [G]
    type = TensorIntegralPostprocessor
    buffer = grad2
  []
  [ratio]
    type = ParsedPostprocessor
    expression = 'change / G'
    pp_names = 'change G'
  []
  [noise_max]
    type = TensorExtremeValuePostprocessor
    buffer = noise
  []
[]
[Executioner]
  type = Transient
  num_steps = 3
  dt = 0.5
[]
[Outputs]
  csv = true
  perf_graph = true
[]
"""


def test_cli_runs_the_new_types_on_cpu(tmp_path, monkeypatch, capsys):
    """`python -m marlin_tpu_torch` on a deck with ParsedPostprocessor,
    TensorIntegralChangePostprocessor, RandomTensor, FFTGradientSquare and
    perf_graph runs with --compute-device cpu, and raises without a card
    and without it."""
    deck = tmp_path / "new_types.i"
    deck.write_text(_CLI_DECK)
    monkeypatch.delenv("MARLIN_TORCH_DEVICE", raising=False)
    args = [str(deck), "--output-dir", str(tmp_path)]
    assert port_main.main(args + ["--compute-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Finished after 3 steps" in out and "Performance Graph:" in out
    rows = (tmp_path / "new_types_out.csv").read_text().splitlines()
    assert rows[0] == "time,G,change,noise_max,ratio" and len(rows) == 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            port_main.main(args)


def test_cli_timing_flag_prints_the_report(tmp_path, monkeypatch, capsys):
    deck = tmp_path / "ch.i"
    deck.write_text(_CLI_DECK.replace("  perf_graph = true\n", ""))
    monkeypatch.delenv("MARLIN_TORCH_DEVICE", raising=False)
    args = [str(deck), "--output-dir", str(tmp_path), "--compute-device", "cpu"]
    assert port_main.main(args) == 0
    assert "Performance Graph:" not in capsys.readouterr().out
    assert port_main.main(args + ["--timing"]) == 0
    assert "Performance Graph:" in capsys.readouterr().out


@pytest.mark.parametrize("given,want", [
    (None, "DOUBLE"), ("DEVICE_DEFAULT", "DOUBLE"), ("SINGLE", "SINGLE"),
    ("DOUBLE", "DOUBLE")])
def test_x64_makes_device_default_double(given, want):
    """--x64: DEVICE_DEFAULT (set or left out) resolves to float64 on every
    device, the card too; an explicit precision stays."""
    text = _IC_DECK.format(domain_extra="" if given is None else
                           f"floating_precision = {given}", members="")
    root = hit.parse(text)
    port_main.force_x64(root)
    assert root.child("Domain").get("floating_precision") == want
    dtype = TensorProblem(root, device="cpu").domain.dtype
    assert dtype == (torch.float32 if want == "SINGLE" else torch.float64)
