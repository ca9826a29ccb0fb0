"""The port's fused semi-implicit substep (marlin_tpu_torch/spectral.py,
kernel 1's fused read in unordered_fft.py) against the JAX package's
(marlin_tpu/pallas_spectral.py, pallas_fft.py).

On the CPU the port's wrappers compute their plain twins and the Pallas
kernels run in interpret mode, as tests/test_pallas_spectral.py runs them;
the JAX package is imported inside a fixture, so the `cuda` cases (each
kernel against its twin on the card) run where there is no jax.

Tolerances:
- kernel 1 with `pre`: 1e-5 of the largest output (float32 sums in other
  orders, as tests/test_torch_unordered_fft.py);
- kernels 5 and 6: 2e-5 of the scale, test_fused_substep_kernel_exact's;
  the poly-versus-single lock at 2e-6 and 2e-5, as
  test_poly_kernel_matches_single_var_kernel;
- decks end to end, port fused against JAX fused: 5e-5 on the fields
  (float32 with sums in other orders, tests/test_torch_main_path.py) and
  5e-4 of the scale on the carried spectra and the old-N̄ ring
  (test_fused_matches_unfused_pallas).
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from marlin_tpu_torch import decks, hit
from marlin_tpu_torch import spectral as sp
from marlin_tpu_torch import unordered_fft as uf
from marlin_tpu_torch.expression import CompiledExpression, CudaSourceError
from marlin_tpu_torch.params import ParamError
from marlin_tpu_torch.problem import TensorProblem

FUSED = "carry_reciprocal = true\n  fused_spectral = true"
PALLAS = "fft_backend = PALLAS"


@pytest.fixture
def jx():
    """The JAX package's fused-spectral modules, Pallas in interpret mode."""
    pf = pytest.importorskip("marlin_tpu.pallas_fft")
    import jax
    import jax.numpy as jnp

    from marlin_tpu import hit as jhit
    from marlin_tpu import pallas_spectral as ps
    from marlin_tpu.problem import TensorProblem as JaxProblem

    old = pf._INTERPRET
    pf._INTERPRET = True
    yield SimpleNamespace(jax=jax, jnp=jnp, hit=jhit, pf=pf, ps=ps,
                          Problem=JaxProblem)
    pf._INTERPRET = old


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _ch3d(n=16, substeps=4):
    return decks.CH3D_DECK.format(n=n, substeps=substeps).replace(
        "[Domain]", f"[Domain]\n  {PALLAS}").replace(
        "[TensorSolver]", f"[TensorSolver]\n  {FUSED}")


DECKS = {
    "ch3d": (lambda: _ch3d(), "c"),
    "ch": (lambda: decks.CH_DECK.format(domain_extra=PALLAS, solver_extra=FUSED), "c"),
    "sh": (lambda: decks.SH_DECK.format(domain_extra=PALLAS, solver_extra=FUSED), "psi"),
}


def _port_plan(text):
    p = TensorProblem(hit.parse(text), device="cpu")
    return p, sp.match_chain(p.solver)


def _jax_plan(jx, text):
    p = jx.Problem(jx.hit.parse(text))
    return p, jx.ps.match_chain(p.solver)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


# -- kernel 1's fused read: pre = µ ---------------------------------------------


@pytest.mark.parametrize("n", [64, 128, 200])
@pytest.mark.parametrize("deck", list(DECKS))
def test_pre_twin_matches_pallas(jx, deck, n):
    text, _ = DECKS[deck]
    _, plan = _port_plan(text())
    _, jplan = _jax_plan(jx, text())
    rng = np.random.default_rng(n)
    x = (0.5 + 0.2 * rng.standard_normal((8, n))).astype(np.float32)
    rr, ri = jx.pf.fft_lanes(x, None, n, pre=jplan.mu_fn)
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    got = uf.fwd_lanes(torch.from_numpy(x), pre=plan.pre)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) <= 1e-5


def _run_printed(body, x):
    """Evaluates the printed CUDA statements with numpy float32 (the
    printer's output for these decks is straight-line +, -, * and /)."""
    env = {"x": x, "np": np}
    for line in body.splitlines():
        code = re.sub(r"(\d[\d.]*(?:e[+-]?\d+)?)f\b", r"np.float32(\1)", line)
        m = re.fullmatch(r"const float (t\d+) = (.*);", code)
        if m:
            env[m.group(1)] = eval(m.group(2), env)
        else:
            return eval(re.fullmatch(r"return (.*);", code).group(1), env)


@pytest.mark.parametrize("deck", list(DECKS))
def test_printed_pre_computes_mu(deck):
    """The CUDA printer emits the deck's µ as straight-line float32 code
    that computes what the torch twin computes."""
    text, var = DECKS[deck]
    _, plan = _port_plan(text())
    assert "mtt_fwd_lanes_pre" in plan.pre.source
    assert '#include "fft_tile.cuh"' in plan.pre.source
    body = plan.pre.expr.cuda_source(var)
    x = np.linspace(-0.2, 1.2, 1001, dtype=np.float32)
    got = _run_printed(body, x)
    ref = plan.pre(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize("expression,match", [
    ("besselj(c)", "besselj"),
    ("c*i", "complex"),
], ids=["unknown_function", "complex_constant"])
def test_printer_raises_by_name(expression, match):
    consts = {"i": 1j}
    e = CompiledExpression(expression, ["c"], constants=consts).compile()
    with pytest.raises(CudaSourceError, match=match):
        e.cuda_source("c")


def test_printer_integer_powers_are_products():
    e = CompiledExpression("c^5 + c^(0-2)", ["c"]).compile()
    body = e.cuda_source("c")
    assert "powf" not in body
    assert "t1 = t0 * t0" in body and "1.0f / " in body


# -- kernels 5 and 6 -------------------------------------------------------------


class _Plan:
    def __init__(self, mobility, lin):
        self.mobility, self.lin = mobility, lin


FORMS = {"lapsq_mobility": (5.0, ("lapsq", -10.0)),
         "sh_no_mobility": (None, ("sh", 0.025, 1.3))}


def _update_inputs(seed, n, L, fields=None):
    rng = np.random.RandomState(seed)
    lead = () if fields is None else (fields,)
    mk = lambda: rng.randn(*lead, n, L).astype(np.float32)
    arrays = [mk() for _ in range(6)]  # µ̄, ū, old N̄ as (re, im) pairs
    kx2 = np.abs(rng.randn(n)).astype(np.float32)
    kyz2 = np.abs(rng.randn(L)).astype(np.float32)
    return arrays, kx2, kyz2


def _c(re, im):
    return torch.from_numpy((re + 1j * im).astype(np.complex64))


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("form", list(FORMS))
def test_update_twin_matches_pallas(jx, form, n):
    mobility, lin = FORMS[form]
    L = 64
    (mr, mi, cr, ci, onr, oni), kx2, kyz2 = _update_inputs(n, n, L)
    scal = np.asarray([[0.05, 1.5, -0.5, 0.0]], np.float32)
    jnp = jx.jnp
    ur, ui, nr, ni = jx.ps._call_update(
        *(jnp.asarray(a) for a in (mr, mi, cr, ci, onr, oni)),
        jnp.asarray(kx2.reshape(n, 1)), jnp.asarray(kyz2.reshape(1, L)),
        jnp.asarray(scal), _Plan(mobility, lin))
    u, nn = sp.fwd_x_update(_c(mr, mi), _c(cr, ci), _c(onr, oni),
                            torch.from_numpy(kx2), torch.from_numpy(kyz2),
                            0.05, 1.5, -0.5, mobility, lin)
    for got, (re, im) in ((u, (ur, ui)), (nn, (nr, ni))):
        ref = np.asarray(re) + 1j * np.asarray(im)
        assert np.abs(got.numpy() - ref).max() <= 2e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n", [64, 128])
def test_poly_twin_matches_pallas(jx, n):
    L, N = 64, 2
    (mr, mi, cr, ci, onr, oni), kx2, kyz2 = _update_inputs(7 + n, n, L, N)
    rows = np.asarray([[0.05, 1.5, -0.5, 0.0, -5.0, 0.0, 0.0, -10.0],
                       [0.05, 1.5, -0.5, 1.0, 0.0, -0.975, 2.0, -1.0]],
                      np.float32)
    jnp = jx.jnp
    u, nn = sp.fwd_x_update_poly(_c(mr, mi), _c(cr, ci), _c(onr, oni),
                                 torch.from_numpy(kx2), torch.from_numpy(kyz2),
                                 rows)
    for f in range(N):
        ur, ui, nr, ni = jx.ps._call_update_poly(
            *(jnp.asarray(a[f]) for a in (mr, mi, cr, ci, onr, oni)),
            jnp.asarray(kx2.reshape(n, 1)), jnp.asarray(kyz2.reshape(1, L)),
            jnp.asarray(rows[f:f + 1]))
        for got, (re, im) in ((u[f], (ur, ui)), (nn[f], (nr, ni))):
            ref = np.asarray(re) + 1j * np.asarray(im)
            assert np.abs(got.numpy() - ref).max() <= 2e-5 * np.abs(ref).max()


@pytest.mark.parametrize("form", list(FORMS))
def test_poly_twin_matches_single_twin(form):
    """The N-field update and the single-field update compute the same
    predictor formula (test_poly_kernel_matches_single_var_kernel)."""
    mobility, lin = FORMS[form]
    n = L = 64
    (mr, mi, cr, ci, onr, oni), kx2, kyz2 = _update_inputs(3, n, L)
    args = (_c(mr, mi), _c(cr, ci), _c(onr, oni), torch.from_numpy(kx2),
            torch.from_numpy(kyz2))
    ref = sp.fwd_x_update(*args, 0.05, 1.5, -0.5, mobility, lin)
    if lin[0] == "lapsq":
        coef, tol = [0.0, -mobility, 0.0, 0.0, lin[1]], 2e-6
    else:
        r, a = lin[1], lin[2]
        coef, tol = [1.0, 0.0, r - a * a, 2 * a * a, -a * a], 2e-5
    rows = np.asarray([[0.05, 1.5, -0.5, *coef]], np.float32)
    got = sp.fwd_x_update_poly(*(t[None] for t in args[:3]), *args[3:], rows)
    for g, r_ in zip(got, ref):
        assert (g[0] - r_).abs().max().item() <= tol * max(1.0, r_.abs().max().item())


def test_update_wrappers_reject_bad_inputs():
    z = torch.zeros(64, 8, dtype=torch.complex64)
    k = torch.zeros(64), torch.zeros(8)
    with pytest.raises(TypeError, match="complex64"):
        sp.fwd_x_update(z.real.contiguous(), z, z, *k, 0.1, 1, 0, None, ("lapsq", 1))
    with pytest.raises(TypeError, match="kyz2"):
        sp.fwd_x_update(z, z, z, k[0], torch.zeros(9), 0.1, 1, 0, None, ("lapsq", 1))
    with pytest.raises(ValueError, match="rows"):
        sp.fwd_x_update_poly(z[None], z[None], z[None], *k, np.zeros((2, 8)))


# -- one substep, and decks end to end ---------------------------------------------


def test_ch_substep_matches_pallas(jx):
    """One fused substep of the port against the JAX package's on _CH
    (mirrors test_fused_substep_kernel_exact)."""
    jnp = jx.jnp
    text = decks.CH_DECK.format(domain_extra=PALLAS, solver_extra=FUSED)
    jp, jplan = _jax_plan(jx, text)
    pp, plan = _port_plan(text)
    c = np.asarray(jp.init_state()["buffers"]["c"], np.float32)
    nx, L = c.shape[0], int(np.prod(c.shape[1:]))
    cbar = np.asarray(jx.pf.fftn_unordered(jnp.asarray(c)))
    cr = np.real(cbar).astype(np.float32).reshape(nx, L)
    ci = np.imag(cbar).astype(np.float32).reshape(nx, L)
    onr = np.full((nx, L), 0.3, np.float32)
    oni = np.full((nx, L), -0.1, np.float32)
    scal = jnp.asarray([[0.2, 1.5, -0.5, 0.0]], jnp.float32)
    c2, ur, ui, nr, ni = jx.jax.jit(lambda *a: jx.ps.ch_substep(*a, jplan))(
        jnp.asarray(c), jnp.asarray(cr), jnp.asarray(ci), jnp.asarray(onr),
        jnp.asarray(oni), scal)
    pc2, pu, pn = sp.ch_substep(torch.from_numpy(c), _c(cr, ci), _c(onr, oni),
                                0.2, 1.5, -0.5, plan)
    for got, ref in ((pu, np.asarray(ur) + 1j * np.asarray(ui)),
                     (pn, np.asarray(nr) + 1j * np.asarray(ni))):
        assert np.abs(got.numpy() - ref).max() <= 2e-5 * np.abs(ref).max()
    np.testing.assert_allclose(pc2.numpy(), np.asarray(c2), rtol=0, atol=1e-5)


def _run_port(text, steps, dt):
    p = TensorProblem(hit.parse(text), device="cpu")
    s = p.init_state()
    for i in range(steps):
        s = p.step(s, i * dt, dt, dt, i == 0)
    return s


def _run_jax(jx, text, steps, dt):
    p = jx.Problem(jx.hit.parse(text))
    s = p.init_state()
    step = jx.jax.jit(p._step_impl)
    for i in range(steps):
        s = step(s, i * dt, dt, dt, jx.jnp.asarray(i == 0))
    return s


def _multi3d(domain_extra, solver_extra):
    return decks.MULTI_3D_DECK.format(n=16, domain_extra=domain_extra,
                                      solver_extra=solver_extra)


def _ch(extra):
    return decks.CH_DECK.format(domain_extra=PALLAS, solver_extra=extra)


END_TO_END = {
    # name: (deck text, steps, dt, fields, carried spectra)
    "ch": (_ch(FUSED), 3, 1.0, ["c", "mu"], ["cbar", "Mbarmubar", "mubar"]),
    "sh": (decks.SH_DECK.format(domain_extra=PALLAS, solver_extra=FUSED), 3,
           1.0, ["psi"], ["psibar", "psi3bar"]),
    "multi": (decks.MULTI_DECK.format(domain_extra=PALLAS, solver_extra=FUSED),
              3, 0.05, ["c", "n1", "mu_c", "mu_n1"],
              ["c_bar", "n1_bar", "Mbar_mu_c_bar", "mu_n1_bar"]),
    "multi_3d": (_multi3d(PALLAS, FUSED), 2, 0.05, ["c", "n1"],
                 ["c_bar", "n1_bar", "Mbar_mu_c_bar", "mu_n1_bar"]),
    "ab1": (_ch(FUSED + "\n  predictor_order = 1\n  corrector_order = 1"), 3,
            1.0, ["c"], ["cbar", "Mbarmubar"]),
    "corrector_1": (_ch(FUSED + "\n  corrector_steps = 1"), 3, 1.0, ["c"],
                    ["cbar", "Mbarmubar"]),
    "corrector_2": (_ch(FUSED + "\n  corrector_steps = 2"), 3, 1.0, ["c"],
                    ["cbar", "Mbarmubar"]),
    "corrector_order_1": (_ch(FUSED + "\n  corrector_steps = 1\n"
                              "  corrector_order = 1"), 3, 1.0, ["c"],
                          ["cbar", "Mbarmubar"]),
    "first_step": (_ch(FUSED), 1, 1.0, ["c"], ["cbar", "Mbarmubar"]),
}


@pytest.mark.parametrize("case", list(END_TO_END))
def test_fused_deck_matches_jax(jx, case):
    text, steps, dt, fields, spectra = END_TO_END[case]
    js = jx.jax.tree.map(np.asarray, _run_jax(jx, text, steps, dt))
    ps_ = _run_port(text, steps, dt)
    for name in fields:
        np.testing.assert_allclose(ps_["buffers"][name].numpy(),
                                   js["buffers"][name], rtol=0, atol=5e-5,
                                   err_msg=name)
    for name in spectra:
        ref = js["buffers"][name]
        got = ps_["buffers"][name].numpy()
        assert got.shape == ref.shape, name
        assert np.abs(got - ref).max() <= 5e-4 * np.abs(ref).max(), name
    assert set(ps_["old"]) == set(js["old"])
    for name, ref in js["old"].items():
        got = ps_["old"][name].numpy()
        assert np.abs(got - ref).max() <= 5e-4 * max(np.abs(ref).max(), 1e-30), name
    assert ps_["n_advances"] == int(js["n_advances"])
    if case == "first_step":
        assert ps_["n_advances"] == 0
    if case == "ab1":
        assert "Mbarmubar" not in ps_["old"]


_GROWTH = """
[Executioner]
  type = Transient
  num_steps = 4
  [TimeStepper]
    type = IterationAdaptiveDT
    dt = {dt}
    growth_factor = 1.5
  []
[]
"""


@pytest.mark.parametrize("substeps", [1, 2])
@pytest.mark.parametrize("name", ["ch", "multi"])
def test_fused_deck_with_dt_growth_matches_jax(jx, name, substeps, tmp_path):
    """dt grows 1.5× a step (IterationAdaptiveDT), so every step after the
    second sees dt ≠ dt_old and the fused path's AB order fallback runs;
    the port against JAX fused, run_deck in both, at this file's deck
    tolerances (5e-5 on the fields, 5e-4 of the scale on the spectra)."""
    from marlin_tpu.executioner import run_deck as jax_run_deck

    from marlin_tpu_torch.executioner import run_deck

    template = decks.CH_DECK if name == "ch" else decks.MULTI_DECK
    text = template.replace("substeps = 5", f"substeps = {substeps}").format(
        domain_extra=PALLAS, solver_extra=FUSED)
    dt0 = 1.0 if name == "ch" else 0.02
    text += _GROWTH.format(dt=dt0)
    jt = jax_run_deck(jx.hit.parse(text), output_dir=str(tmp_path / "jax"))
    pt = run_deck(hit.parse(text), output_dir=str(tmp_path / "port"), device="cpu")
    assert pt.step_count == jt.step_count == 4
    assert pt.time == pytest.approx(jt.time, rel=1e-12)
    assert pt.time == pytest.approx(dt0 * (1 + 1.5 + 1.5**2 + 1.5**3), rel=1e-12)
    js, ps_ = jt.state, pt.state
    assert ps_["n_advances"] == int(js["n_advances"])
    fields = ["c"] if name == "ch" else ["c", "n1"]
    spectra = ["cbar", "Mbarmubar"] if name == "ch" else ["c_bar", "n1_bar"]
    for f in fields:
        np.testing.assert_allclose(ps_["buffers"][f].numpy(),
                                   np.asarray(js["buffers"][f]), rtol=0, atol=5e-5,
                                   err_msg=f)
    for f in spectra:
        ref = np.asarray(js["buffers"][f])
        assert np.abs(ps_["buffers"][f].numpy() - ref).max() <= 5e-4 * np.abs(ref).max(), f


def test_fused_multi_launches_one_update_per_substep():
    """On the CPU nothing launches; the plan of _MULTI is the N-field one,
    and the fused loop goes through ch_substep_multi once a substep."""
    text = decks.MULTI_DECK.format(domain_extra=PALLAS, solver_extra=FUSED)
    p = TensorProblem(hit.parse(text), device="cpu")
    calls = []
    orig = sp.ch_substep_multi
    try:
        sp.ch_substep_multi = lambda *a: calls.append(1) or orig(*a)
        p.step(p.init_state(), 0.0, 0.05, 0.05, True)
    finally:
        sp.ch_substep_multi = orig
    assert isinstance(p.solver._fused_plan, sp.SpectralPlanMulti)
    assert len(calls) == p.solver.substeps - 1
    assert sp.launches() == {"fwd_x_update": 0, "fwd_x_update_poly": 0}


# -- named rejections ------------------------------------------------------------


def _edit(template, *pairs, **fmt):
    """The deck ``template`` with each (old, new) pair replaced once."""
    for old, new in pairs:
        assert old in template, old
        template = template.replace(old, new, 1)
    return template.format(**fmt)


CH = dict(domain_extra=PALLAS, solver_extra=FUSED)
MU = "      derivatives = c\n      inputs = c"
MBAR = "expression = 'Mbar*mubar'\n      inputs = 'Mbar mubar'"
MUC = "      derivatives = c\n      inputs = 'c n1'"
BEFORE_CBAR = "    [cbar]\n      type = ForwardFFT"
BEFORE_C_BAR = "    [c_bar]\n      type = ForwardFFT"

REJECTIONS = {
    # name: (deck text, dt) — every _reject path the port's decks can reach
    "no_pallas": (decks.CH_DECK.format(domain_extra="", solver_extra=FUSED), 1.0),
    "dim_1": (_edit(decks.CH_DECK, ("dim = 2", "dim = 1"), **CH), 1.0),
    "high_predictor_order": (_ch(FUSED + "\n  predictor_order = 3"), 1.0),
    "high_corrector_order": (_ch(FUSED + "\n  corrector_steps = 1\n"
                                 "  corrector_order = 3"), 1.0),
    "forwarding": (_ch(FUSED + "\n  forward_buffer = mu\n"
                       "  forward_buffer_new = Mbarmubar"), 1.0),
    "no_linear": (_edit(decks.CH_DECK, ("linear_reciprocal = kappabarbar",
                                        "linear_reciprocal = 0"), **CH), 1.0),
    "unfusable_compute": (_edit(decks.CH_DECK, (BEFORE_CBAR, """    [again]
      type = ForwardFFT
      buffer = again
      input = mu
    []
""" + BEFORE_CBAR), **CH), 1.0),
    "no_mu": (_edit(decks.SH_DECK, ("expression = '0.20*psi^2-psi^3'\n"
                                    "      inputs = psi",
                                    "expression = '0.20*psi^2-psi^3+0*linear'\n"
                                    "      inputs = 'psi linear'"), **CH), 1.0),
    "fft_not_of_mu": (_edit(decks.CH_DECK, ("buffer = mubar\n      input = mu",
                                            "buffer = mubar\n      input = c"),
                            **CH), 1.0),
    "sh_fft_not_nonlinear": (_edit(decks.SH_DECK, (
        "nonlinear_reciprocal = psi3bar", "nonlinear_reciprocal = linear"),
        **CH), 1.0),
    "second_parsed_not_nonlinear": (_edit(decks.CH_DECK, (
        "nonlinear_reciprocal = Mbarmubar", "nonlinear_reciprocal = mubar"),
        **CH), 1.0),
    "nbar_two_factors": (_edit(decks.CH_DECK, (MBAR, "expression = "
                                               "'Mbar*mubar*kappabarbar'\n"
                                               "      inputs = 'Mbar mubar "
                                               "kappabarbar'"), **CH), 1.0),
    "no_mbar_initializer": (_edit(decks.CH_DECK, (MBAR, "expression = 'M2*mubar'\n"
                                                  "      inputs = 'M2 mubar'"),
                                  **CH), 1.0),
    "mbar_producer": (_edit(decks.CH_DECK, (
        "type = ReciprocalLaplacianFactor\n      factor = 5",
        "type = ReciprocalLaplacianSquareFactor\n      factor = 5"), **CH), 1.0),
    "lbar_producer": (_edit(decks.CH_DECK, (
        "type = ReciprocalLaplacianSquareFactor\n      factor = -10",
        "type = ConstantTensor\n      real = -10"), **CH), 1.0),
    "not_a_product": (_edit(decks.CH_DECK, ("expression = 'Mbar*mubar'",
                                            "expression = 'Mbar*mubar*2'"),
                            **CH), 1.0),
    "mu_with_symbols": (_edit(decks.CH_DECK, (MU, MU + "\n      extra_symbols = true"),
                              **CH), 1.0),
    "history_depth": (_ch(FUSED + "\n  predictor_order = 2\n"
                          "  corrector_order = 3"), 1.0),
    "multi_non_variable": (_edit(decks.MULTI_DECK, ("inputs = 'c n1'",
                                                    "inputs = 'c n1 Lbar'"),
                                 **CH), 0.05),
    "multi_extra": (_edit(decks.MULTI_DECK, (BEFORE_C_BAR, """    [extra]
      type = ParsedCompute
      buffer = extra
      expression = 'c*2'
      inputs = c
    []
""" + BEFORE_C_BAR), **CH), 0.05),
    "multi_no_linear": (_edit(decks.MULTI_DECK, (
        "linear_reciprocal = 'MkappaL2bar kappaLbar'",
        "linear_reciprocal = 'MkappaL2bar 0'"), **CH), 0.05),
    "multi_no_producer": (_edit(decks.MULTI_DECK, (
        "nonlinear_reciprocal = 'Mbar_mu_c_bar mu_n1_bar'",
        "nonlinear_reciprocal = 'Mbar_mu_c_bar nothing'"), **CH), 0.05),
    "multi_nbar_two_factors": (_edit(decks.MULTI_DECK, (
        "expression = 'Lbar*mu_c_bar'\n      inputs = 'Lbar mu_c_bar'",
        "expression = 'Lbar*mu_c_bar*kappaLbar'\n"
        "      inputs = 'Lbar mu_c_bar kappaLbar'"), **CH), 0.05),
    "multi_producer_unfusable": (_edit(decks.MULTI_DECK, (
        BEFORE_C_BAR, """    [nl_inv]
      type = InverseFFT
      buffer = nl_inv
      input = mu_n1_bar
    []
""" + BEFORE_C_BAR), ("nonlinear_reciprocal = 'Mbar_mu_c_bar mu_n1_bar'",
                      "nonlinear_reciprocal = 'Mbar_mu_c_bar nl_inv'"),
        **CH), 0.05),
    "multi_mu_not_parsed": (_edit(decks.MULTI_DECK, (
        "buffer = mu_n1_bar\n      input = mu_n1",
        "buffer = mu_n1_bar\n      input = n1"), **CH), 0.05),
    "multi_mu_with_symbols": (_edit(decks.MULTI_DECK, (
        MUC, MUC + "\n      extra_symbols = true"), **CH), 0.05),
    "multi_two_writers": (_edit(decks.MULTI_DECK, (BEFORE_C_BAR, """    [mu_c_again]
      type = ParsedCompute
      buffer = mu_c
      expression = 'c'
      inputs = c
    []
""" + BEFORE_C_BAR), **CH), 0.05),
    "multi_lbar_producer": (_edit(decks.MULTI_DECK, (
        "type = ReciprocalLaplacianSquareFactor\n      factor = -15",
        "type = ConstantTensor\n      real = -15"), **CH), 0.05),
}


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_named_rejections_match_jax(jx, case):
    """Every chain the JAX package refuses raises SpectralChainError in the
    port with the same message (test_fused_requires_pallas_backend,
    test_fused_rejects_high_corrector_order, test_multi_fused_named_rejections
    and the rest of match_chain's _reject paths)."""
    text, dt = REJECTIONS[case]
    jp = jx.Problem(jx.hit.parse(text))
    with pytest.raises(jx.ps.SpectralChainError) as jerr:
        jp.solver.step(jp.init_state(), 0.0, dt, dt, True)
    pp = TensorProblem(hit.parse(text), device="cpu")
    with pytest.raises(sp.SpectralChainError) as perr:
        pp.solver.step(pp.init_state(), 0.0, dt, dt, True)
    assert str(perr.value) == str(jerr.value)


def test_fused_requires_carry():
    with pytest.raises(ParamError, match="carry_reciprocal"):
        TensorProblem(hit.parse(decks.CH_DECK.format(
            domain_extra=PALLAS, solver_extra="fused_spectral = true")),
            device="cpu")


# -- SwiftHohenbergLinear ----------------------------------------------------------


def test_swift_hohenberg_linear_matches_jax(jx):
    text = decks.SH_DECK.format(domain_extra="floating_precision = DOUBLE",
                                solver_extra="")
    js = jx.Problem(jx.hit.parse(text)).init_state()
    ps_ = TensorProblem(hit.parse(text), device="cpu").init_state()
    ref = np.asarray(js["buffers"]["linear"])
    got = ps_["buffers"]["linear"].numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


# -- on the card: each kernel against its twin ------------------------------------


def _gen(shape, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=dtype).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 200, 512, 128, 256, 1024])
def test_cuda_pre_matches_twin(cuda, n):
    """The generated library of kernel 1's fused read builds and agrees; at
    the register path's extents (128 to 1024) with B = 1001 rows, not a
    multiple of a tile's rows."""
    _, plan = _port_plan(_ch3d())
    rows = 1024 if n in (64, 200, 512) else 1001
    x = 0.5 + 0.1 * _gen((rows, n), torch.float32, n, cuda)
    before = uf.fwd_lanes_pre.launches
    got = uf.fwd_lanes(x, pre=plan.pre)
    torch.cuda.synchronize()
    assert uf.fwd_lanes_pre.launches == before + 1
    assert plan.pre.library.path().endswith(".so")
    ref = uf.fwd_lanes_plain(plan.pre(x))
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,L", [(64, 300), (200, 128), (512, 4096), (128, 300),
                                 (256, 77), (512, 300), (1024, 300)])
@pytest.mark.parametrize("form", list(FORMS))
def test_cuda_update_matches_twin(cuda, form, n, L):
    mobility, lin = FORMS[form]
    m, u, o = (_gen((n, L), torch.complex64, s, cuda) for s in range(3))
    kx2 = _gen((n,), torch.float32, 3, cuda).abs()
    kyz2 = _gen((L,), torch.float32, 4, cuda).abs()
    before = sp.fwd_x_update.launches
    got = sp.fwd_x_update(m, u, o, kx2, kyz2, 0.05, 1.5, -0.5, mobility, lin)
    torch.cuda.synchronize()
    assert sp.fwd_x_update.launches == before + 1
    ref = sp.fwd_x_update_plain(m, u, o, kx2, kyz2, 0.05, 1.5, -0.5, mobility, lin)
    for g, r in zip(got, ref):
        assert (g - r).abs().max().item() <= 1e-5 * r.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,L", [(64, 300), (512, 4096), (128, 300), (256, 77),
                                 (1024, 300)])
def test_cuda_poly_matches_twin(cuda, n, L):
    m, u, o = (_gen((2, n, L), torch.complex64, s, cuda) for s in range(3))
    kx2 = _gen((n,), torch.float32, 3, cuda).abs()
    kyz2 = _gen((L,), torch.float32, 4, cuda).abs()
    rows = np.asarray([[0.05, 1.5, -0.5, 0.0, -5.0, 0.0, 0.0, -10.0],
                       [0.05, 1.5, -0.5, 1.0, 0.0, -0.975, 2.0, -1.0]],
                      np.float32)
    before = sp.fwd_x_update_poly.launches
    got = sp.fwd_x_update_poly(m, u, o, kx2, kyz2, rows)
    torch.cuda.synchronize()
    assert sp.fwd_x_update_poly.launches == before + 1
    ref = sp.fwd_x_update_poly_plain(m, u, o, kx2, kyz2, rows)
    for g, r in zip(got, ref):
        assert (g - r).abs().max().item() <= 1e-5 * r.abs().max().item()
