"""The spectral family's computes of the port (marlin_tpu_torch/computes/
core.py, ``[Functions]`` in problem.py, FunctionElementIntegral) against
the JAX package's, on the CPU.

On ``fft_backend = PALLAS`` the port's wrappers compute the kernels' plain
twins and the JAX package's Pallas kernels run in interpret mode.

Tolerances:
- float64 (DEFAULT): 1e-10 of each buffer's largest magnitude, computes on
  the same input and whole decks (decks.SMOOTHED_BOUNDARY_DECK at 64², 2
  steps); SmoothRectangleCompute, the function samples and the SHARP mask
  1e-14 (the same numpy or float64 arithmetic);
- float32 (PALLAS): 2e-6 of each output's largest magnitude for a compute
  on the same input (a few float32 roundings of transforms summed in other
  orders); for the deck after 2 steps 1e-5 of the largest on the
  integrated fields c and η and their spectra, and 5e-3 on every buffer
  derived from them: those difference nearly equal float32 values (the
  finite-difference Laplacians, the gradients and their squares, the flux
  divergence), so c's float32 difference comes back times the stencil's
  gain over a small magnitude (the same deck on DEFAULT float32, torch.fft
  against XLA's FFT, differs by up to 2.6e-3 there);
- postprocessor values: 1e-10 relative.
The `cuda` case holds the deck on the card against the CPU port, float64,
within 1e-10 of each buffer's largest.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from marlin_tpu_torch import decks, hit
from marlin_tpu_torch import state as port_state
from marlin_tpu_torch.executioner import run_deck
from marlin_tpu_torch.problem import ProblemError, TensorProblem

F64_TOL = 1e-10
EXACT_TOL = 1e-14
F32_TOL = 2e-6
DECK_F32_FIELD_TOL = 1e-5
DECK_F32_TOL = 5e-3
FIELDS = ("c", "eta", "cbar", "etabar")
SINGLE_PALLAS = "fft_backend = PALLAS\n  floating_precision = SINGLE"
DOUBLE = "floating_precision = DOUBLE"


@pytest.fixture
def jx():
    """The JAX package, its Pallas FFT kernels in interpret mode."""
    pf = pytest.importorskip("marlin_tpu.pallas_fft")
    import jax.numpy as jnp

    from marlin_tpu import hit as jhit
    from marlin_tpu.executioner import run_deck as jax_run_deck
    from marlin_tpu.problem import TensorProblem as JaxProblem

    old = pf._INTERPRET
    pf._INTERPRET = True
    yield SimpleNamespace(jnp=jnp, hit=jhit, Problem=JaxProblem, run_deck=jax_run_deck)
    pf._INTERPRET = old


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def sbm_deck(n=64, substeps=5, domain=DOUBLE, dt=0.05):
    return decks.SMOOTHED_BOUNDARY_DECK.format(n=n, lo=n // 8, hi=7 * n // 8,
                                               substeps=substeps, dt=dt,
                                               domain_extra=domain)


def assert_close(got, ref, rel, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    d = float(np.abs(got - ref).max())
    assert d <= rel * scale, f"{name}: max|Δ| {d:.3e} > {rel:g} × {scale:.3e}"


# -- each compute on the same input ------------------------------------------------

GRID = """
[Domain]
  dim = {dim}
  nx = 32
  ny = 16
  nz = 8
  xmin = -1.5
  xmax = 30.5
  ymax = 16
  zmax = 4
  {domain}
[]
[Functions]
  [wave]
    type = ParsedFunction
    expression = 'a*cos(2*pi*x/32) + b*y - z*t'
    symbol_names = 'a b'
    symbol_values = '0.7 0.01'
  []
[]
[TensorComputes]
  [Solve]
{block}  []
[]
[Problem]
  type = TensorProblem
[]
"""


def _block(name, ctype, **params):
    lines = "".join(f"      {k} = {v}\n" for k, v in params.items())
    return f"    [{name}]\n      type = {ctype}\n      buffer = {name}\n{lines}    []\n"


def compute_pair(jx, text, name, inputs, t=0.25):
    """The output of compute ``name`` in both packages on the same numpy
    ``inputs``, at time ``t``."""
    pp = TensorProblem(hit.parse(text), device="cpu")
    jp = jx.Problem(jx.hit.parse(text))
    pc = next(c for c in pp.solve_computes if c.name == name)
    jc = next(c for c in jp.solve_computes if c.name == name)
    pc.check()
    ours = pc.apply({k: torch.from_numpy(v) for k, v in inputs.items()},
                    {"t": t, "old": {}, "n_advances": 0})
    ref = jc.apply({k: jx.jnp.asarray(v) for k, v in inputs.items()},
                   {"t": t, "old": {}, "n_advances": 0})
    return ours[name].numpy(), np.asarray(ref[name])


def _field(rng, shape, dtype, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * rng.random(shape)).astype(dtype)


def _grid(dim, backend, block):
    domain = SINGLE_PALLAS if backend == "PALLAS" else DOUBLE
    return GRID.format(dim=dim, domain=domain, block=block)


def _shape(dim):
    return (32, 16, 8)[:dim]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("profile", ["SHARP", "COS", "TANH"])
def test_smooth_rectangle(jx, dim, profile):
    width = {"SHARP": 0, "COS": 3, "TANH": 2.5}[profile]
    params = dict(x1=4.2, x2=20, y1=3, y2=12.5, z1=0.5, z2=3, int_width=width,
                  inside=2, outside=-0.5)
    if profile != "SHARP":
        params["profile"] = profile
    text = _grid(dim, "DEFAULT", _block("psi", "SmoothRectangleCompute", **params))
    ours, ref = compute_pair(jx, text, "psi", {})
    assert_close(ours, ref, EXACT_TOL, "psi")
    assert ours.shape == _shape(dim) and ours.min() < 0 < ours.max()


@pytest.mark.parametrize("backend", ["DEFAULT", "PALLAS"])
@pytest.mark.parametrize("method", ["SHARP", "HOULI"])
def test_dealiasing(jx, backend, method):
    """Both filters from the domain's reciprocal axes: under PALLAS the
    permuted ones, so the filter lines up with the kernels' spectrum."""
    text = _grid(2, backend, _block("filter", "DeAliasingTensor", method=method, p=8,
                                    alpha=30))
    ours, ref = compute_pair(jx, text, "filter", {})
    tol = EXACT_TOL if method == "SHARP" else F32_TOL if backend == "PALLAS" else F64_TOL
    assert_close(ours, ref, tol, "filter")
    if method == "SHARP":
        assert set(np.unique(ours)) == {0.0, 1.0}


@pytest.mark.parametrize("backend", ["DEFAULT", "PALLAS"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("width", [3, 5])
def test_finite_difference_laplacian(jx, backend, dim, width):
    text = _grid(dim, backend, _block("lap", "FiniteDifferenceLaplacian", input="u",
                                      stencil_width=width, factor=1.5))
    dtype = np.float32 if backend == "PALLAS" else np.float64
    u = _field(np.random.default_rng(1), _shape(dim), dtype)
    ours, ref = compute_pair(jx, text, "lap", {"u": u})
    assert_close(ours, ref, F32_TOL if backend == "PALLAS" else F64_TOL, "lap")


@pytest.mark.parametrize("backend", ["DEFAULT", "PALLAS"])
@pytest.mark.parametrize("dim", [2, 3])
def test_gradient_tensor(jx, backend, dim):
    """Always three components, zeros past the grid's dimension."""
    text = _grid(dim, backend, _block("grad", "GradientTensor", input="u"))
    dtype = np.float32 if backend == "PALLAS" else np.float64
    u = _field(np.random.default_rng(2), _shape(dim), dtype)
    ours, ref = compute_pair(jx, text, "grad", {"u": u})
    assert ours.shape == _shape(dim) + (3,)
    assert_close(ours, ref, F32_TOL if backend == "PALLAS" else F64_TOL, "grad")
    assert not ours[..., dim:].any()


@pytest.mark.parametrize("backend", ["DEFAULT", "PALLAS"])
def test_reciprocal_allen_cahn(jx, backend):
    """fft(−L·dF/dη) where ψ > 0, zero where ψ ≤ 0."""
    text = _grid(2, backend, _block("rate", "ReciprocalAllenCahn", dF_chem_deta="dF",
                                    L="L", psi="psi"))
    dtype = np.float32 if backend == "PALLAS" else np.float64
    rng = np.random.default_rng(3)
    inputs = {"dF": _field(rng, (32, 16), dtype, -1, 1),
              "L": _field(rng, (32, 16), dtype, 0.5, 2),
              "psi": _field(rng, (32, 16), dtype, -0.3, 1)}
    ours, ref = compute_pair(jx, text, "rate", inputs)
    assert_close(ours, ref, F32_TOL if backend == "PALLAS" else F64_TOL, "rate")


@pytest.mark.parametrize("backend", ["DEFAULT", "PALLAS"])
@pytest.mark.parametrize("with_psi", [False, True])
def test_reciprocal_mat_diffusion(jx, backend, with_psi):
    """div(M∇µ) in k-space, with the no-flux term of a ψ that is ≤ 0 in
    places (the masked branch)."""
    params = dict(chemical_potential="mu", mobility="M")
    if with_psi:
        params["psi"] = "psi"
    text = _grid(2, backend, _block("flux", "ReciprocalMatDiffusion", **params))
    dtype = np.float32 if backend == "PALLAS" else np.float64
    rng = np.random.default_rng(4)
    x = np.linspace(0, 2 * np.pi, 32, endpoint=False)[:, None]
    y = np.linspace(0, 2 * np.pi, 16, endpoint=False)[None, :]
    inputs = {"mu": (np.sin(x) * np.cos(2 * y)).astype(dtype),
              "M": _field(rng, (32, 16), dtype, 0.5, 1.5),
              "psi": (0.6 + 0.5 * np.cos(x) * np.cos(y)).astype(dtype)}
    ours, ref = compute_pair(jx, text, "flux", inputs)
    assert_close(ours, ref, 5 * F32_TOL if backend == "PALLAS" else F64_TOL, "flux")


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_moose_function_tensor_samples_from_zero(jx, dim):
    """The samples sit at i·dx + dx/2 from zero, whatever xmin (here −1.5),
    evaluated at the compute's t."""
    text = _grid(dim, "DEFAULT", _block("w", "MooseFunctionTensor", function="wave"))
    ours, ref = compute_pair(jx, text, "w", {}, t=0.75)
    assert_close(ours, ref, EXACT_TOL, "w")
    expect = 0.7 * np.cos(2 * np.pi * (np.arange(32) + 0.5) / 32)
    idx = (slice(None),) + (0,) * (dim - 1)
    np.testing.assert_allclose(ours[idx] - ours[idx][0] + expect[0], expect, atol=1e-12)


# -- [Functions] ------------------------------------------------------------------

FUNCTION_BLOCKS = """  [base]
    type = ParsedFunction
    expression = 'k*x*x + y - t'
    vars = k
    vals = 3
  []
  [composed]
    type = ParsedFunction
    expression = 'inner*2 + c'
    symbol_names = 'inner c'
    symbol_values = 'base 0.25'
  []
  [shifted]
    type = ShiftedFunction
    function = composed
    shift = '0.5 -1'
    delta_t = 2
  []
"""


def _with_functions(dim, extra=""):
    return GRID.format(dim=dim, domain=DOUBLE, block="").replace(
        "[Functions]\n", "[Functions]\n" + FUNCTION_BLOCKS, 1) + extra


def test_functions_compose_and_shift(jx):
    """symbol_values naming another function composes (evaluated at the same
    point), the legacy vars/vals spelling reads constants, ShiftedFunction
    moves x, y and t; float64 on the host in both packages."""
    text = _with_functions(2)
    pp = TensorProblem(hit.parse(text), device="cpu")
    jp = jx.Problem(jx.hit.parse(text))
    x = np.linspace(0, 1, 5)[:, None]
    y = np.linspace(-1, 1, 3)[None, :]
    for name in ("base", "composed", "shifted"):
        ours = pp.get_function(name)({"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                                      "z": torch.zeros(1, 1, dtype=torch.float64),
                                      "t": 0.5})
        ref = jp.get_function(name)({"x": x, "y": y, "z": np.zeros((1, 1)), "t": 0.5})
        assert_close(np.asarray(ours), np.asarray(ref), EXACT_TOL, name)
    xs, ys = x + 0.5, y - 1
    want = 2 * (3 * xs * xs + ys - 2.5) + 0.25
    np.testing.assert_allclose(np.asarray(pp.get_function("shifted")(
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y), "z": 0.0, "t": 0.5})),
        want, rtol=1e-14)
    with pytest.raises(ProblemError, match="Function 'nope' not found"):
        pp.get_function("nope")
    with pytest.raises(Exception, match="Function 'nope' not found"):
        jp.get_function("nope")


INTEGRAL = """
[Postprocessors]
  [integral]
    type = FunctionElementIntegral
    function = {function}
  []
[]
[Executioner]
  type = Transient
  num_steps = 2
  dt = 0.5
[]
"""


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("function", ["wave", "shifted"])
def test_function_element_integral(jx, dim, function, tmp_path):
    """2-point Gauss quadrature an element of a deck function, at each
    step's time."""
    text = _with_functions(dim, INTEGRAL.format(function=function))
    ours = run_deck(hit.parse(text), device="cpu", output_dir=str(tmp_path / "p")).pp_values
    ref = jx.run_deck(jx.hit.parse(text), output_dir=str(tmp_path / "j")).pp_values
    assert ours["integral"] == pytest.approx(ref["integral"], rel=F64_TOL)


# -- whole decks -----------------------------------------------------------------


def _run_port(text, steps, dt, device="cpu"):
    p = TensorProblem(hit.parse(text), device=device)
    s = p.init_state()
    for i in range(steps):
        s = p.step(s, i * dt, dt, dt, i == 0)
    return p, s


def _run_jax(jx, text, steps, dt):
    p = jx.Problem(jx.hit.parse(text))
    s = p.init_state()
    for i in range(steps):
        d = jx.jnp.asarray(dt, p.domain.dtype)
        s = p.step(s, i * dt, d, d, i == 0)
    return p, s


@pytest.mark.parametrize("backend", ["DEFAULT", "PALLAS"])
def test_smoothed_boundary_deck_matches_jax(jx, backend):
    """decks.SMOOTHED_BOUNDARY_DECK at 64², 2 steps of 5 substeps: ψ
    (TANH), c from [Functions] through MooseFunctionTensor, the flux of
    ReciprocalMatDiffusion with ψ and a c-dependent mobility, η by
    ReciprocalAllenCahn, the HOULI filter on both nonlinear terms,
    FiniteDifferenceLaplacian in µ, GradientTensor into RunningMaximum."""
    text = sbm_deck(domain=SINGLE_PALLAS if backend == "PALLAS" else DOUBLE)
    if backend == "PALLAS":
        # the JAX package's carried c̄ turns complex128 in its substep loop
        # under x64 (ReciprocalMatDiffusion's 1j·Σ), which its fori_loop
        # refuses: hold this route without the carry
        text = text.replace("  carry_reciprocal = true\n", "")
    _, ps = _run_port(text, 2, 0.05)
    _, js = _run_jax(jx, text, 2, 0.05)
    ps = port_state.to_numpy(ps)
    def tol(name):
        if backend == "DEFAULT":
            return F64_TOL
        return DECK_F32_FIELD_TOL if name in FIELDS else DECK_F32_TOL

    assert set(ps["buffers"]) == set(js["buffers"])
    for name, ref in js["buffers"].items():
        assert_close(ps["buffers"][name], ref, tol(name), name)
    for name, ref in js["old"].items():
        assert_close(ps["old"][name], ref, tol(name), f"old {name}")
    assert ps["buffers"]["grad_c_peak"].max() > 0


def test_smoothed_boundary_deck_postprocessors(jx, tmp_path):
    text = sbm_deck()
    ours = run_deck(hit.parse(text), device="cpu", output_dir=str(tmp_path / "p")).pp_values
    ref = jx.run_deck(jx.hit.parse(text), output_dir=str(tmp_path / "j")).pp_values
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k] == pytest.approx(v, rel=F64_TOL), k


# -- RunningMaximum: tests/test_examples.py's cases --------------------------------

RUNNING_MAX = """
[Domain]
  dim = 1
  nx = 8
  xmax = 8
  mesh_mode = DUMMY
[]
[TensorBuffers]
  {buffers}
[]
[TensorComputes]
{init}  [Solve]
    [src]
      type = ParsedCompute
      buffer = src
      expression = '{source}'
      extra_symbols = true
    []
    [H]
      type = RunningMaximum
      buffer = H
      input = src
    []
  []
[]
[Postprocessors]
  [max_H]
    type = TensorExtremeValuePostprocessor
    buffer = H
    value_type = MAX
  []
  [min_H]
    type = TensorExtremeValuePostprocessor
    buffer = H
    value_type = MIN
  []
[]
[Problem]
  type = TensorProblem
[]
[Executioner]
  type = Transient
  num_steps = {steps}
  dt = 1.0
[]
"""
SEEDED = RUNNING_MAX.format(
    buffers="[H]\n  []\n  [src]\n  []", steps=4, source="2.0*exp(-t)",
    init="  [Initialize]\n    [seed]\n      type = ParsedCompute\n      buffer = H\n"
         "      expression = '(x < 2) * 5.0'\n      extra_symbols = true\n    []\n  []\n")
UNDECLARED = RUNNING_MAX.format(buffers="[src]\n  []", steps=2, source="1.0 + 0*x", init="")


@pytest.mark.parametrize("case", ["envelope", "undeclared_buffer"])
def test_running_maximum(jx, case, tmp_path):
    """The envelope holds the peak of a decaying source, seeded by the
    buffer's initial condition; an undeclared output buffer is created
    from the compute's result (tests/test_examples.py:357-433)."""
    text = SEEDED if case == "envelope" else UNDECLARED
    tr = run_deck(hit.parse(text), device="cpu", output_dir=str(tmp_path / "p"))
    jt = jx.run_deck(jx.hit.parse(text), output_dir=str(tmp_path / "j"))
    H = tr.state["buffers"]["H"].numpy()
    np.testing.assert_array_equal(H, np.asarray(jt.state["buffers"]["H"]))
    assert tr.pp_values == pytest.approx(jt.pp_values, rel=1e-15)
    if case == "envelope":
        assert H.max() == 5.0
        np.testing.assert_allclose(H.min(), 2.0, rtol=1e-6)
    else:
        assert H.max() == 1.0


def test_running_maximum_refuses_iterative_solvers():
    """The iterative solvers are not ported yet; the refusal is kept for
    them: a solver with the ``iterative`` trait fails check()."""
    p = TensorProblem(hit.parse(UNDECLARED), device="cpu")
    H = next(c for c in p.solve_computes if c.name == "H")
    H.check()
    p.solver = SimpleNamespace(iterative=True)
    with pytest.raises(Exception, match="trial iterates"):
        H.check()


@pytest.mark.cuda
def test_card_matches_cpu(cuda):
    """decks.SMOOTHED_BOUNDARY_DECK on the card against the CPU port,
    float64 (DEFAULT), 2 steps of 5 substeps at 64²."""
    text = sbm_deck()
    _, a = _run_port(text, 2, 0.05)
    _, b = _run_port(text, 2, 0.05, device=cuda)
    a, b = port_state.to_numpy(a), port_state.to_numpy(b)
    for name, ref in a["buffers"].items():
        assert_close(b["buffers"][name], ref, F64_TOL, name)
