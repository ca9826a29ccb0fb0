"""`[TensorSolver] carry_reciprocal = true` in the port
(marlin_tpu_torch/solvers/base.py, abm.py): the redundant ForwardFFT(u) → ū
is pruned from the solve group and ū is carried across substeps.  Mirrors
tests/test_carry_reciprocal.py, plus port-against-JAX parity.

Tolerances: carry against recompute in float64, 1e-12 (fft(ifft(ū)) = ū up
to rounding, test_carry_matches_recompute's); the port against the JAX
package on the DEFAULT backend in float64, 1e-10 (torch.fft against
jnp.fft, the same operation order elsewhere, as
tests/test_torch_main_path.py).
"""

import numpy as np
import pytest

from __graft_entry__ import _CH_DECK
from marlin_tpu_torch import hit
from marlin_tpu_torch.problem import TensorProblem
from marlin_tpu_torch.solvers.base import SplitOperatorBase
from marlin_tpu_torch.params import ParamError, Params

CARRY = "carry_reciprocal = true"


def _deck(n, substeps, extra="", precision=None):
    text = _CH_DECK.format(nx=n, ny=n, substeps=substeps)
    if extra:
        text = text.replace(f"substeps = {substeps}",
                            f"substeps = {substeps}\n  {extra}")
    if precision:
        text = text.replace("[Domain]",
                            f"[Domain]\n  floating_precision = {precision}")
    return text


def _run(text, steps=2):
    p = TensorProblem(hit.parse(text), device="cpu")
    s = p.init_state()
    for k in range(steps):
        s = p.step(s, k * 1.0, 1.0, 1.0, k == 0)
    return s


def test_carry_matches_recompute():
    c1 = _run(_deck(64, 50))["buffers"]["c"].numpy()
    c2 = _run(_deck(64, 50, CARRY))["buffers"]["c"].numpy()
    assert c1.dtype == np.float64
    np.testing.assert_allclose(c1, c2, rtol=0, atol=1e-12)


def test_carry_prunes_the_fft():
    p = TensorProblem(hit.parse(_deck(16, 2, CARRY)), device="cpu")
    names = [m.name for m in p.solver.compute.sorted_members]
    full = TensorProblem(hit.parse(_deck(16, 2)), device="cpu")
    full_names = [m.name for m in full.solver.compute.sorted_members]
    assert "cbar" in full_names  # the ForwardFFT producing ū ...
    assert names == [n for n in full_names if n != "cbar"]  # ... alone went


def test_carry_requires_forward_fft_producer():
    bad = _deck(16, 2, CARRY).replace(
        """    [cbar]
      type = ForwardFFT
      buffer = cbar
      input = c
    []""",
        """    [cbar]
      type = ParsedCompute
      buffer = cbar
      expression = 'mubar*0'
      inputs = 'mubar'
    []""",
    )
    with pytest.raises(ValueError, match="carry_reciprocal"):
        TensorProblem(hit.parse(bad), device="cpu")


def test_carry_on_a_solver_without_write_back_is_a_param_error():
    class NoWriteBack(SplitOperatorBase):
        pass

    root = hit.parse(_deck(16, 2, CARRY))
    p = TensorProblem(root, device="cpu")
    with pytest.raises(ParamError, match="not supported by NoWriteBack"):
        NoWriteBack("s", Params(root.child("TensorSolver")), p)


def test_carry_f32_tracks_f64_better_than_recompute():
    """In float32 the carried ū is the accurate trajectory: the recompute
    path's per-substep fft(ifft(.)) round trip adds noise
    (test_carry_f32_tracks_f64_better_than_recompute)."""
    def run(extra, precision):
        s = _run(_deck(64, 200, extra, precision))
        return s["buffers"]["c"].numpy().astype(np.float64)

    truth = run("", "DOUBLE")
    err_recompute = np.abs(run("", "SINGLE") - truth).max()
    err_carry = np.abs(run(CARRY, "SINGLE") - truth).max()
    assert err_carry * 3 < err_recompute, (err_carry, err_recompute)


@pytest.mark.parametrize("substeps,steps", [(1, 3), (7, 3)])
def test_carry_matches_jax_f64(substeps, steps):
    """The port's carry path on the DEFAULT backend against the JAX
    package's, float64, every buffer and the old-state ring."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from marlin_tpu import hit as jhit
    from marlin_tpu.problem import TensorProblem as JaxProblem

    text = _deck(64, substeps, CARRY)
    jp = JaxProblem(jhit.parse(text))
    js = jp.init_state()
    step = jax.jit(jp._step_impl)
    for k in range(steps):
        js = step(js, k * 1.0, 1.0, 1.0, jnp.asarray(k == 0))
    js = jax.tree.map(np.asarray, js)
    ps = _run(text, steps)
    assert set(ps["buffers"]) == set(js["buffers"])
    for name, ref in js["buffers"].items():
        got = ps["buffers"][name].numpy()
        assert got.dtype == ref.dtype, name
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10, err_msg=name)
    for name, ref in js["old"].items():
        np.testing.assert_allclose(ps["old"][name].numpy(), ref, rtol=0,
                                   atol=1e-10, err_msg=name)
    assert ps["n_advances"] == int(js["n_advances"])
