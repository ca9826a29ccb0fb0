"""``[Problem] batch_fft = true`` in the port, tensor-valued transforms
under ``fft_backend = PALLAS``, and the legacy ``[TensorTimeIntegrators]``
block, against the JAX package's (the self-contained cases of
tests/test_batch_fft.py) on the CPU.

Tolerances:
- batched against unbatched in the port: equal, bit for bit, in float64 on
  DEFAULT and in float32 on PALLAS's twins (each field transforms as a
  contiguous block of the same arithmetic);
- the port against the JAX package, float64: 1e-10 of each buffer's
  largest magnitude;
- the legacy integrator deck against its [TensorSolver] form: bit for bit
  (the same solver); against the JAX package 1e-10 as above.
The `cuda` case runs the 2a stand-in batched on the card against the CPU
port, float64, within 1e-10 of each buffer's largest.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from marlin_tpu_torch import decks, hit
from marlin_tpu_torch import state as port_state
from marlin_tpu_torch import unordered_fft as uf
from marlin_tpu_torch.domain import Domain
from marlin_tpu_torch.problem import TensorProblem

F64_TOL = 1e-10
BATCH = "batch_fft = true"
DOUBLE = "floating_precision = DOUBLE"
SINGLE_PALLAS = "fft_backend = PALLAS\n  floating_precision = SINGLE"


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def ostwald(domain=DOUBLE, problem="", n=64, substeps=5):
    return decks.OSTWALD_2A_DECK.format(n=n, substeps=substeps, domain_extra=domain,
                                        problem_extra=problem)


def with_problem(text, line):
    return text.replace("[Problem]\n  type = TensorProblem\n",
                        f"[Problem]\n  type = TensorProblem\n  {line}\n", 1)


def run_port(text, steps=2, dt=0.01, device="cpu"):
    p = TensorProblem(hit.parse(text), device=device)
    s = p.init_state()
    for i in range(steps):
        s = p.step(s, i * dt, dt, dt, i == 0)
    return p, s


def run_jax(jx, text, steps=2, dt=0.01):
    p = jx.Problem(jx.hit.parse(text))
    s = p.init_state()
    for i in range(steps):
        d = jx.jnp.asarray(dt, p.domain.dtype)
        s = p.step(s, i * dt, d, d, i == 0)
    return p, s


def assert_equal_states(a, b):
    assert set(a["buffers"]) == set(b["buffers"])
    for group in ("buffers", "old"):
        for name, t in a[group].items():
            assert torch.equal(t, b[group][name]), (group, name)


def assert_jax_parity(js, ps, tol=F64_TOL):
    ps = port_state.to_numpy(ps)
    for group in ("buffers", "old"):
        for name, ref in js[group].items():
            ref = np.asarray(ref)
            got = ps[group][name]
            assert got.shape == ref.shape, (group, name)
            scale = max(float(np.abs(ref).max()), 1e-300)
            assert float(np.abs(got - ref).max()) <= tol * scale, (group, name)


# -- the 2a stand-in -----------------------------------------------------------


@pytest.mark.parametrize("backend", ["DEFAULT", "PALLAS"])
def test_ostwald_batched_equals_unbatched(backend):
    """Ten forward transforms a substep as one batch, five inverse as one:
    every buffer equal, bit for bit."""
    domain = SINGLE_PALLAS if backend == "PALLAS" else DOUBLE
    _, a = run_port(ostwald(domain))
    p, b = run_port(ostwald(domain, BATCH))
    assert_equal_states(a, b)
    order = p.solver.compute.execution_order()
    batches = [n for n in order if n.startswith("batch_fft(")]
    assert len(batches) == 1 and batches[0].count(",") == 9, order


@pytest.mark.parametrize("problem", ["", BATCH])
def test_ostwald_matches_jax(jx, problem):
    """The 2a stand-in (c and four order parameters, PFHub benchmark 2's
    free energy) against the JAX package, unbatched and batched."""
    text = ostwald(problem=problem)
    _, js = run_jax(jx, text)
    _, ps = run_port(text)
    assert_jax_parity(js, ps)


def test_execution_order_is_the_jax_order(jx):
    text = ostwald(problem=BATCH)
    pp = TensorProblem(hit.parse(text), device="cpu")
    jp = jx.Problem(jx.hit.parse(text))
    assert pp.solver.compute.execution_order() == jp.solver.compute.execution_order()


def _count_wrappers(monkeypatch):
    """Calls of each FFT wrapper (the CPU runs their twins; on the card each
    call is one launch)."""
    calls = {w.__name__: 0 for w in uf.WRAPPERS}
    for w in uf.WRAPPERS:
        def counted(*a, _w=w, **k):
            calls[_w.__name__] += 1
            return _w(*a, **k)
        monkeypatch.setattr(uf, w.__name__, counted)
    return calls


@pytest.mark.parametrize("problem", ["", BATCH])
def test_pallas_wrapper_calls_per_substep(problem, monkeypatch):
    """Under PALLAS a batched transform is one call of each wrapper an
    axis whatever the number of fields: per substep of the 2-D deck, one
    forward lanes and sublanes call a batch group (10 without batching),
    one inverse sublanes and lanes call (5 without); nothing takes a
    scalar-path fallback."""
    calls = _count_wrappers(monkeypatch)
    steps, substeps = 3, 4
    run_port(ostwald(SINGLE_PALLAS, problem, substeps=substeps), steps=steps)
    n = steps * substeps  # a spectral solver runs its substeps in the first step too
    fwd, inv = (1, 1) if problem else (10, 5)
    assert calls == {"fwd_lanes": fwd * n, "fwd_lanes_pre": 0, "fwd_sublanes": fwd * n,
                     "inv_sublanes": inv * n, "inv_lanes": inv * n}, calls


# -- tensor-valued transforms under PALLAS ------------------------------------------


@pytest.mark.parametrize("dim,values", [(2, (5,)), (2, (2, 2)), (3, (3,))])
def test_tensor_valued_pallas_equals_per_field(dim, values):
    """Value axes moved to the front join the lanes kernels' rows and the
    sublanes kernels' prefix; each field gets the bits it has alone,
    forward (real and complex input) and inverse."""
    n = (24, 16, 8)[:dim]
    dom = Domain(dim=dim, n=list(n), fft_backend="PALLAS", floating_precision="SINGLE",
                 device="cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.rand(n + values, generator=g, dtype=torch.float32)
    z = torch.complex(x, torch.rand(n + values, generator=g, dtype=torch.float32))
    for t in (x, z):
        u = dom.fft(t)
        flat = t.reshape(n + (-1,))
        per = torch.stack([dom.fft(flat[..., i].contiguous()) for i in range(flat.shape[-1])], -1)
        assert u.shape == t.shape and u.dtype == torch.complex64
        assert torch.equal(u.reshape(per.shape), per)
        back = dom.ifft(u)
        per_back = torch.stack([dom.ifft(per[..., i].contiguous())
                                for i in range(per.shape[-1])], -1)
        assert back.shape == t.shape and back.dtype == torch.float32
        assert torch.equal(back.reshape(per_back.shape), per_back)
    np.testing.assert_allclose(dom.ifft(dom.fft(x)).numpy(), x.numpy(), atol=2e-6)


# -- tests/test_batch_fft.py's self-contained cases --------------------------------

FFT_OF_FFT = """
[Domain]
  dim = 2
  nx = 8
  ny = 8
  xmax = 1
  ymax = 1
  floating_precision = DOUBLE
[]
[TensorComputes]
  [Initialize]
    [a]
      type = ConstantTensor
      buffer = a
      real = 1.0
    []
  []
  [Solve]
    [abar]
      type = ForwardFFT
      buffer = abar
      input = a
    []
    [abarbar]
      type = ForwardFFT
      buffer = abarbar
      input = abar
    []
    [nbar]
      type = ParsedCompute
      buffer = nbar
      expression = 'abar*0'
      inputs = abar
    []
  []
[]
[TensorSolver]
  type = AdamsBashforthMoulton
  buffer = a
  reciprocal_buffer = abar
  nonlinear_reciprocal = nbar
[]
[Problem]
  type = TensorProblem
  batch_fft = true
[]
"""


def test_fft_of_fft_chain_not_fused(jx):
    """A ForwardFFT consuming another's output keeps its order: the run
    splits instead of batching a dependency (the JAX test's deck with the
    port's AdamsBashforthMoulton in place of ForwardEulerSolver)."""
    order = TensorProblem(hit.parse(FFT_OF_FFT), device="cpu").solver.compute.execution_order()
    assert not any(n.startswith("batch_fft(") for n in order), order
    assert order.index("abar") < order.index("abarbar")
    assert order == jx.Problem(jx.hit.parse(FFT_OF_FFT)).solver.compute.execution_order()


SOLVERLESS_DECK = """
[Domain]
  dim = 2
  nx = 8
  ny = 8
  xmax = 1
  ymax = 1
  floating_precision = DOUBLE
[]
[TensorComputes]
  [Initialize]
    [a]
      type = RandomTensor
      buffer = a
      min = 0
      max = 1
      seed = 1
    []
    [b]
      type = RandomTensor
      buffer = b
      min = 0
      max = 1
      seed = 2
    []
  []
  [Solve]
{solve}  []
[]
[Problem]
  type = TensorProblem
[]
"""
FLAT = """    [abar]
      type = ForwardFFT
      buffer = abar
      input = a
    []
    [bbar]
      type = ForwardFFT
      buffer = bbar
      input = b
    []
    [mix]
      type = ParsedCompute
      buffer = a
      expression = 'a*0.5 + b*0.5'
      inputs = 'a b'
    []
"""
NESTED = """    [ffts]
      type = ComputeGroup
      [abar]
        type = ForwardFFT
        buffer = abar
        input = a
      []
      [bbar]
        type = ForwardFFT
        buffer = bbar
        input = b
      []
    []
    [mix]
      type = ParsedCompute
      buffer = a
      expression = 'a*0.5 + b*0.5'
      inputs = 'a b'
    []
"""
NESTED_DEP = """    [grp]
      type = ComputeGroup
      [c]
        type = ParsedCompute
        buffer = c
        expression = 'd*2'
        inputs = d
      []
      [d]
        type = ParsedCompute
        buffer = d
        expression = 'a+1'
        inputs = a
      []
    []
"""


def solverless(solve, batch):
    text = SOLVERLESS_DECK.format(solve=solve)
    return with_problem(text, BATCH) if batch else text


@pytest.mark.parametrize("solve", [FLAT, NESTED], ids=["flat", "nested"])
def test_solverless_deck_fuses_and_matches(jx, solve):
    """A deck without a solver block still fuses (its top-level computes in
    declared order); a nested group's fusion survives init_state, which
    wraps the same members in a fresh group and sorts it; equal bit for bit
    to the unbatched run and to JAX within 1e-10."""
    pa, a = run_port(solverless(solve, False), steps=3, dt=0.1)
    pb, b = run_port(solverless(solve, True), steps=3, dt=0.1)
    assert not any(n.startswith("batch_fft(")
                   for n in pa._solverless_group.execution_order())
    order = pb._solverless_group.execution_order()
    assert any(n.startswith("batch_fft(") for n in order), order
    assert_equal_states(a, b)
    _, js = run_jax(jx, solverless(solve, True), steps=3, dt=0.1)
    assert_jax_parity(js, b)


def test_solverless_nested_group_is_sorted(jx):
    """Nested groups are dependency-sorted even where the top level runs in
    declared order: c = 2(a + 1), batched or not."""
    for batch in (False, True):
        _, s = run_port(solverless(NESTED_DEP, batch), steps=1, dt=0.1)
        b = s["buffers"]
        assert torch.equal(b["d"], b["a"] + 1.0)
        assert torch.equal(b["c"], 2.0 * (b["a"] + 1.0))


@pytest.mark.parametrize("case", ["solver", "solverless"])
def test_batch_fft_rejected_in_parallel_mode(jx, case):
    text = ostwald(problem=BATCH) if case == "solver" else solverless(FLAT, True)
    text = text.replace("[Domain]", "[Domain]\n  parallel_mode = FFT_SLAB", 1)
    with pytest.raises(Exception, match="serial-only") as ours:
        TensorProblem(hit.parse(text), device="cpu")
    with pytest.raises(Exception, match="serial-only") as ref:
        jx.Problem(jx.hit.parse(text))
    assert str(ours.value) == str(ref.value)


def test_batch_fft_rejected_for_lbm(jx):
    """decks.CHANNEL2D_DECK stands in for the reference's channel2D.i."""
    text = decks.CHANNEL2D_DECK.format(nx=8, ny=6, substeps=2, backend="JNP").replace(
        "  type = LatticeBoltzmannProblem\n", f"  type = LatticeBoltzmannProblem\n  {BATCH}\n")
    with pytest.raises(Exception, match="does not apply to") as ours:
        TensorProblem(hit.parse(text), device="cpu")
    with pytest.raises(Exception, match="does not apply to") as ref:
        jx.Problem(jx.hit.parse(text))
    assert str(ours.value) == str(ref.value)


# -- legacy [TensorTimeIntegrators] ----------------------------------------------


@pytest.mark.parametrize("extra", ["", "carry_reciprocal = true"], ids=["plain", "carry"])
def test_legacy_integrators_are_the_solver(jx, extra):
    """decks.BENCH_1A_LEGACY_DECK (FFTSemiImplicit, history_size 1, with
    [Problem] spectral_solve_substeps and carry_reciprocal forwarded from
    [Problem]) equals BENCH_1A_DECK bit for bit, and the JAX package's run
    of the same legacy deck within 1e-10."""
    fmt = dict(n=32, substeps=5, domain_extra=DOUBLE, solver_extra=extra)
    _, legacy = run_port(decks.BENCH_1A_LEGACY_DECK.format(**fmt), steps=3, dt=1.0)
    p, solver = run_port(decks.BENCH_1A_DECK.format(**fmt), steps=3, dt=1.0)
    assert_equal_states(legacy, solver)
    _, js = run_jax(jx, decks.BENCH_1A_LEGACY_DECK.format(**fmt), steps=3, dt=1.0)
    assert_jax_parity(js, legacy)


def test_legacy_integrator_solver_settings():
    text = decks.BENCH_1A_LEGACY_DECK.format(n=16, substeps=7, domain_extra=DOUBLE,
                                             solver_extra="")
    text = text.replace("history_size = 1", "history_size = 3")
    solver = TensorProblem(hit.parse(text), device="cpu").solver
    assert type(solver).__name__ == "AdamsBashforthMoulton"
    assert (solver.substeps, solver.predictor_order, solver.corrector_steps) == (7, 3, 0)


@pytest.mark.cuda
def test_card_matches_cpu(cuda):
    """The 2a stand-in batched, float64, on the card against the CPU."""
    text = ostwald(problem=BATCH)
    _, a = run_port(text)
    _, b = run_port(text, device=cuda)
    a, b = port_state.to_numpy(a), port_state.to_numpy(b)
    for name, ref in a["buffers"].items():
        scale = max(float(np.abs(ref).max()), 1e-300)
        assert float(np.abs(b["buffers"][name] - ref).max()) <= F64_TOL * scale, name
