"""The NN Gibbs surrogate of the port (marlin_tpu_torch/computes/nn.py)
against the JAX package's (marlin_tpu/computes/nn.py), on the CPU.

Inputs are drawn from numpy seeds; both packages load the same saved
TorchScript file.  Tolerances:

- a graph the JAX package lifts (every MLP-style module of
  tests/test_torchscript_lift.py that maps an (N, n_in) input to one value
  a row): G and both jacobian groups within 1e-10 of their largest
  magnitude in float64 (``F64_TOL``), both packages running the module in
  the domain's dtype;
- a graph it cannot lift (floor division, tests/test_torchscript_lift.py:32)
  runs on its host in the model's own dtype (float32 here), the port in
  the domain's: the two differ by float32's rounding, within 1e-5 of the
  largest magnitude (``FALLBACK_TOL``: float32's epsilon, 1.2e-7, over the
  graph's ~100 operations) and by more than 1e-10 (ROADMAP §3's witness);
- ``decks.KKS_NN_3D_DECK`` at 16³, 2 steps × 2 substeps, float64, within
  1e-10 of the JAX package's run and of ``decks.KKS_PARSED_3D_DECK`` (the
  same G as parsed expressions) in the port, for both surrogates.
"""

import numpy as np
import pytest
import torch

from marlin_tpu_torch import decks
from marlin_tpu_torch import hit as port_hit
from marlin_tpu_torch.computes import nn as PNN
from marlin_tpu_torch.computes.base import ComputeError
from marlin_tpu_torch.executioner import run_deck as port_run_deck
from marlin_tpu_torch.params import Params as PortParams
from marlin_tpu_torch.problem import TensorProblem as PortProblem

F64_TOL = 1e-10
FALLBACK_TOL = 1e-5
N = 16
KKS_STEPS = "[Executioner]\n  type = Transient\n  num_steps = 2\n  dt = 0.05\n[]\n"

DOMAIN = """[Domain]
  dim = 2
  nx = 8
  ny = 6
  floating_precision = DOUBLE
[]
[Problem]
  type = TensorProblem
[]
"""


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_x64():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def numpy_weights(model, seed):
    """Every parameter drawn from numpy's generator seeded with ``seed``."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.uniform(-0.5, 0.5, tuple(p.shape))))
    return model


class FloorDivGibbs(torch.nn.Module):
    """An MLP with a floor-divided term: a graph the JAX package's lifter
    refuses (aten::div with a rounding mode), so its host runs it."""

    def __init__(self):
        super().__init__()
        self.mlp = torch.nn.Sequential(torch.nn.Linear(3, 8), torch.nn.Tanh(),
                                       torch.nn.Linear(8, 1))

    def forward(self, x):
        return self.mlp(x).squeeze(1) + torch.div(x[:, 0] * 7.0, 2.0, rounding_mode="floor")


MODULES = {
    # test_mlp_lifts_and_matches
    "mlp": (lambda: torch.nn.Sequential(torch.nn.Linear(3, 8), torch.nn.Tanh(),
                                        torch.nn.Linear(8, 1)), 2, 1),
    # test_two_hidden_layer_mlp_mixed_activations
    "mlp_gelu_layernorm_softplus": (lambda: torch.nn.Sequential(
        torch.nn.Linear(4, 16), torch.nn.GELU(), torch.nn.LayerNorm(16),
        torch.nn.Linear(16, 8), torch.nn.Softplus(), torch.nn.Linear(8, 1)), 2, 2),
    # the deck's surrogates
    "analytic": (decks.AnalyticGibbs, 1, 1),
    "kks_mlp": (lambda: decks.MLPGibbs(3), 1, 1),
    # test_floor_division_takes_host_fallback
    "floor_div": (FloorDivGibbs, 2, 1),
}
LIFTED = ["mlp", "mlp_gelu_layernorm_softplus", "analytic", "kks_mlp"]


def compute_block(path, n_phases, n_conc):
    etas = " ".join(f"eta{i}" for i in range(n_phases))
    cs = " ".join(f"c{i}" for i in range(n_conc))
    return (f"[g]\n  type = LibtorchGibbsEnergy\n  buffer = G\n  phase_fractions = '{etas}'\n"
            f"  concentrations = '{cs}'\n"
            f"  domega_detas = '{' '.join(f'dG_deta{i}' for i in range(n_phases))}'\n"
            f"  chem_pots = '{' '.join(f'mu{i}' for i in range(n_conc))}'\n"
            f"  libtorch_model_file = {path}\n[]\n")


def both_computes(path, n_phases, n_conc, tmp_path):
    """The compute of each package on the 8×6 float64 domain, built from the
    same block, and the numpy-seeded inputs (values in (0, 1))."""
    from marlin_tpu import hit as jhit
    from marlin_tpu.computes.nn import LibtorchGibbsEnergy as JaxGibbs
    from marlin_tpu.params import Params
    from marlin_tpu.problem import TensorProblem as JaxProblem

    block = compute_block(path, n_phases, n_conc)
    jc = JaxGibbs("g", Params(jhit.parse(block).children["g"]), JaxProblem(jhit.parse(DOMAIN)))
    pc = PNN.LibtorchGibbsEnergy("g", PortParams(port_hit.parse(block).children["g"]),
                                 PortProblem(port_hit.parse(DOMAIN), device="cpu"))
    rng = np.random.RandomState(7)
    state = {n: rng.uniform(0.05, 0.95, (8, 6)) for n in jc.inputs}
    return jc, pc, state


def run_both(jc, pc, state):
    import jax.numpy as jnp

    jout = jc.apply({k: jnp.asarray(v) for k, v in state.items()}, {})
    pout = pc.apply({k: torch.as_tensor(v) for k, v in state.items()}, {})
    assert sorted(jout) == sorted(pout) == sorted(pc.outputs)
    return {k: np.asarray(v) for k, v in jout.items()}, pout


def rel_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - want).max() / np.abs(want).max())


def save(name, tmp_path):
    make, n_phases, n_conc = MODULES[name]
    model = make()
    if name not in ("analytic", "kks_mlp"):
        numpy_weights(model, 11)
    path = str(tmp_path / f"{name}.pt")
    torch.jit.save(torch.jit.script(model.eval()), path)
    return path, n_phases, n_conc


@pytest.mark.parametrize("name", LIFTED)
def test_gibbs_energy_matches_lifted(name, jax_x64, tmp_path):
    """G and both jacobian groups within 1e-10 of the JAX package's lifted
    graph; the jacobian columns split into domega_detas then chem_pots."""
    from marlin_tpu.computes.nn import torchscript_to_jax

    path, n_phases, n_conc = save(name, tmp_path)
    jc, pc, state = both_computes(path, n_phases, n_conc, tmp_path)
    assert jc._jax_fn is not None, "the JAX package must lift this graph"
    assert torchscript_to_jax(torch.jit.load(path), np.float64) is not None
    jout, pout = run_both(jc, pc, state)
    for k, v in jout.items():
        assert pout[k].dtype == torch.float64 and pout[k].shape == v.shape
        assert pout[k].grad_fn is None and not pout[k].requires_grad
        assert rel_err(pout[k], v) <= F64_TOL, (k, rel_err(pout[k], v))
    # the model runs in the domain's dtype, on the compute's device
    assert all(p.dtype == torch.float64 and p.device.type == "cpu"
               for p in pc.model.parameters())


def test_gibbs_energy_fallback_dtype_difference(jax_x64, tmp_path):
    """A graph the JAX package cannot lift runs on its host in the model's
    float32; the port runs it in the domain's float64.  They differ by
    float32's rounding: more than 1e-10 and within 1e-5 of the largest
    magnitude.  Each package equals its own rule bit for bit: the JAX
    package the float32 module, the port the float64 one."""
    path, n_phases, n_conc = save("floor_div", tmp_path)
    jc, pc, state = both_computes(path, n_phases, n_conc, tmp_path)
    assert jc._jax_fn is None, "the JAX package must fall back for this graph"
    jout, pout = run_both(jc, pc, state)
    names = jc.phase_fractions + jc.concentrations
    X = np.stack([state[n] for n in names], -1).reshape(-1, len(names))
    for dtype in (torch.float32, torch.float64):
        model = torch.jit.load(path).to(dtype)
        x = torch.tensor(X, dtype=dtype, requires_grad=True)
        G = model(x).squeeze()
        (jac,) = torch.autograd.grad(G.sum(), x)
        want = {"G": G.detach(), **{k: jac[:, i].detach() for i, k in
                                    enumerate(jc.domega_detas + jc.chem_pots)}}
        for k, v in want.items():
            v = v.double().numpy().reshape(8, 6)
            if dtype == torch.float32:
                np.testing.assert_array_equal(jout[k], v, err_msg=k)
            else:
                np.testing.assert_array_equal(pout[k].numpy(), v, err_msg=k)
    errs = {k: rel_err(pout[k], v) for k, v in jout.items()}
    assert max(errs.values()) > F64_TOL, errs
    assert max(errs.values()) <= FALLBACK_TOL, errs


def test_gibbs_energy_repeat_is_bit_identical(tmp_path):
    """Three evaluations of one input are equal bit for bit (the graph
    executor's optimisation is off for the call); TF32 is off."""
    path, n_phases, n_conc = save("kks_mlp", tmp_path)
    pc = PNN.LibtorchGibbsEnergy(
        "g", PortParams(port_hit.parse(compute_block(path, n_phases, n_conc)).children["g"]),
        PortProblem(port_hit.parse(DOMAIN), device="cpu"))
    X = torch.from_numpy(np.random.RandomState(1).uniform(0, 1, (300, 2)))
    runs = [pc.evaluate(X) for _ in range(3)]
    for G, jac in runs[1:]:
        assert torch.equal(G, runs[0][0]) and torch.equal(jac, runs[0][1])
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("kind", ["analytic", "mlp"])
def test_kks_nn_deck_matches_jax_and_parsed(kind, jax_x64, tmp_path):
    """decks.KKS_NN_3D_DECK at 16³, 2 steps × 2 substeps, float64: c, n1
    and the surrogate's outputs within 1e-10 of the JAX package's run; with
    the analytic surrogate also within 1e-10 of decks.KKS_PARSED_3D_DECK
    (the same G parsed, its derivatives symbolic) and of
    decks.MULTI_3D_DECK, whose µ's the surrogate's jacobian reproduces."""
    from marlin_tpu import hit as jhit
    from marlin_tpu.executioner import run_deck as jax_run_deck

    model = decks.gibbs_surrogate(kind, str(tmp_path / f"{kind}.pt"), seed=5)

    def text(deck):
        return deck.format(n=N, model=model, domain_extra="floating_precision = DOUBLE",
                           solver_extra="").replace("substeps = 5", "substeps = 2") + KKS_STEPS

    jtr = jax_run_deck(jhit.parse(text(decks.KKS_NN_3D_DECK)), output_dir=str(tmp_path))
    ptr = port_run_deck(port_hit.parse(text(decks.KKS_NN_3D_DECK)), output_dir=str(tmp_path),
                        device="cpu")
    assert ptr.step_count == jtr.step_count == 2
    pb = ptr.state["buffers"]
    for k in ("c", "n1", "G", "dGdn1", "mu_c", "mu_n1"):
        want = np.asarray(jtr.state["buffers"][k])
        assert pb[k].shape == want.shape and torch.isfinite(pb[k]).all()
        assert rel_err(pb[k], want) <= F64_TOL, (k, rel_err(pb[k], want))
        assert pb[k].grad_fn is None
    if kind == "analytic":
        for twin in (decks.KKS_PARSED_3D_DECK, decks.MULTI_3D_DECK):
            ttr = port_run_deck(port_hit.parse(text(twin)), output_dir=str(tmp_path),
                                device="cpu")
            for k in ("c", "n1", "mu_c", "mu_n1"):
                assert rel_err(pb[k], ttr.state["buffers"][k].numpy()) <= F64_TOL, k


def test_kks_nn_deck_fused_refusal_words(jax_x64, tmp_path):
    """The fused spectral path refuses the surrogate deck (its µ is not a
    ParsedCompute: the matcher meets the surrogate's three outputs) with
    the JAX package's words; on PALLAS with carry_reciprocal alone it
    runs."""
    from marlin_tpu import hit as jhit
    from marlin_tpu import pallas_fft
    from marlin_tpu.executioner import run_deck as jax_run_deck

    model = decks.gibbs_surrogate("analytic", str(tmp_path / "g.pt"))
    pallas = "fft_backend = PALLAS\n  floating_precision = SINGLE"

    def text(solver_extra):
        return decks.KKS_NN_3D_DECK.format(
            n=N, model=model, domain_extra=pallas, solver_extra=solver_extra).replace(
            "substeps = 5", "substeps = 2") + KKS_STEPS.replace("num_steps = 2", "num_steps = 1")

    fused = text("carry_reciprocal = true\n  fused_spectral = true")
    pallas_fft._INTERPRET = True
    try:
        with pytest.raises(Exception) as jerr:
            jax_run_deck(jhit.parse(fused), output_dir=str(tmp_path))
    finally:
        pallas_fft._INTERPRET = False
    with pytest.raises(ComputeError) as perr:
        port_run_deck(port_hit.parse(fused), output_dir=str(tmp_path), device="cpu")
    assert type(jerr.value).__name__ == "ComputeError"
    assert str(perr.value) == str(jerr.value) == (
        "Compute 'gibbs' has outputs ['G', 'dGdn1', 'mu_c']")
    tr = port_run_deck(port_hit.parse(text("carry_reciprocal = true")),
                       output_dir=str(tmp_path), device="cpu")
    assert torch.isfinite(tr.state["buffers"]["c"]).all()


@pytest.mark.parametrize("path,where", [
    ("nnapp:missing/model.pt", "under"),
    ("missing_model.pt", "relative"),
])
def test_resolve_data_file_errors(path, where, tmp_path, monkeypatch):
    """resolve_data_file raises the JAX package's words for a missing
    ``app:path`` and a missing relative path, with the same data roots."""
    from marlin_tpu.computes import nn as JNN

    roots = [str(tmp_path / "data")]
    monkeypatch.setattr(PNN, "DATA_ROOTS", roots)
    monkeypatch.setattr(JNN, "DATA_ROOTS", roots)
    with pytest.raises(Exception) as jerr:
        JNN.resolve_data_file(path, str(tmp_path))
    with pytest.raises(ComputeError) as perr:
        PNN.resolve_data_file(path, str(tmp_path))
    assert str(perr.value) == str(jerr.value)


def test_resolve_data_file_finds(tmp_path, monkeypatch):
    """The search rule: an absolute path as is; a relative one under the
    deck's directory; a bare name anywhere under a data root; both packages
    alike."""
    from marlin_tpu.computes import nn as JNN

    (tmp_path / "deck").mkdir()
    (tmp_path / "deck" / "m.pt").write_bytes(b"")
    (tmp_path / "root" / "sub").mkdir(parents=True)
    (tmp_path / "root" / "sub" / "deep.pt").write_bytes(b"")
    monkeypatch.setattr(PNN, "DATA_ROOTS", [str(tmp_path / "root")])
    monkeypatch.setattr(JNN, "DATA_ROOTS", [str(tmp_path / "root")])
    for path, deck_dir in (("/abs/never.pt", None), ("m.pt", str(tmp_path / "deck")),
                           ("deep.pt", None), ("app:sub/deep.pt", None)):
        assert PNN.resolve_data_file(path, deck_dir) == JNN.resolve_data_file(path, deck_dir)


@pytest.mark.parametrize("key,block", [
    ("domega_detas", "  domega_detas = 'a b'\n  chem_pots = mu\n"),
    ("chem_pots", "  domega_detas = a\n  chem_pots = 'mu nu'\n"),
])
def test_gibbs_energy_parameter_errors(key, block, tmp_path):
    """Mismatched buffer counts are the JAX package's named errors."""
    from marlin_tpu import hit as jhit
    from marlin_tpu.computes.nn import LibtorchGibbsEnergy as JaxGibbs
    from marlin_tpu.params import Params
    from marlin_tpu.problem import TensorProblem as JaxProblem

    text = ("[g]\n  type = LibtorchGibbsEnergy\n  buffer = G\n  phase_fractions = eta\n"
            "  concentrations = c\n" + block + "  libtorch_model_file = m.pt\n[]\n")
    with pytest.raises(Exception) as jerr:
        JaxGibbs("g", Params(jhit.parse(text).children["g"]), JaxProblem(jhit.parse(DOMAIN)))
    with pytest.raises(Exception) as perr:
        PNN.LibtorchGibbsEnergy("g", PortParams(port_hit.parse(text).children["g"]),
                                PortProblem(port_hit.parse(DOMAIN), device="cpu"))
    assert key in str(perr.value)
    assert str(perr.value) == str(jerr.value)
