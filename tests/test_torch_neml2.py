"""NEML2 of the port (marlin_tpu_torch/computes/neml2.py) against the JAX
package's (marlin_tpu/computes/neml2.py), on the CPU.

Every case of tests/test_neml2.py that needs no reference deck (all but
``test_neml2_scalar_gold``) runs as parity: the JAX test runs as written,
and each NEML2 model it loads, each deck it runs, each problem it builds
and each geometry helper it calls also runs through the port on the same
inputs (``parity``).  What the two give is compared where it is made:

- each model output within 1e-10 of its largest magnitude in float64
  (``F64_TOL``), the same output keys, NaN where the JAX package has NaN;
- each Newton solve (ImplicitUpdate, J2RadialReturn) with the same
  iteration count: the JAX package's while_loop counts are read through a
  ``jax.debug.callback``, the port's from each model's ``counts``;
- each deck's buffers, shapes and values, and the problem's initial state;
- each error with the same type name and words.

A forward call made under a JAX transformation (``jax.jvp``) runs in the
JAX package only; the port's tangents at the same points are held by
``test_neml2_jvp_parity``.  Then the creep example (examples/neml2_creep)
whole, its CSV within 1e-10, the registry's 56 types, and the port's three
deliberate departures (ROADMAP §3), each beside the JAX package accepting
what the port refuses.
"""

import inspect
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from marlin_tpu_torch import hit as port_hit
from marlin_tpu_torch.computes import neml2 as PN
from marlin_tpu_torch.executioner import run_deck as port_run_deck
from marlin_tpu_torch.params import ParamError as PortParamError
from marlin_tpu_torch.params import Params as PortParams
from marlin_tpu_torch.problem import TensorProblem as PortProblem

from . import test_neml2 as jax_cases

F64_TOL = 1e-10
ROUNDING = 1e-15
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CREEP = os.path.join(ROOT, "examples", "neml2_creep", "creep.i")

#: cases whose every forward call runs under jax.jvp (test_neml2_jvp_parity
#: holds the port's tangents at the same points)
JVP_ONLY = {"test_neml2_spectral_split_jvp_finite_at_degeneracy"}
CASES = [name for name, fn in sorted(
    ((n, f) for n, f in vars(jax_cases).items() if n.startswith("test_") and callable(f)),
    key=lambda nf: nf[1].__code__.co_firstlineno) if name != "test_neml2_scalar_gold"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, label):
    """got (port) within F64_TOL of want's largest magnitude, plus
    ROUNDING (float64's rounding at unit scale, for outputs that are zero
    up to rounding, such as a converged flow rate of an elastic point);
    NaN and inf where want has them."""
    got = np.asarray(got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=label)
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=label)
    if finite.any():
        scale = max(float(np.abs(want[finite]).max()), 1e-300)
        np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                                   atol=F64_TOL * scale + ROUNDING, err_msg=label)


def same_error(port_call, jax_error):
    """The port raises what the JAX package raised: the same type name and
    the same words."""
    with pytest.raises(Exception) as got:
        port_call()
    assert type(got.value).__name__ == type(jax_error).__name__, (got.value, jax_error)
    assert str(got.value) == str(jax_error)


def newton_logs(model):
    return [m.counts.log for m in PN.walk_models(model) if hasattr(m, "counts")]


@pytest.fixture
def parity(monkeypatch):
    """The JAX package with its NEML2 entry points wrapped to run the port
    beside it and compare (module docstring)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from marlin_tpu import executioner as jexec
    from marlin_tpu import hit as jhit
    from marlin_tpu import problem as jproblem
    from marlin_tpu.computes import neml2 as JN

    seen = SimpleNamespace(models=0, outputs=0, decks=0, errors=0, solves=0,
                           geometry=0, jax_solves=[])
    sources = {}

    real_while = jax.lax.while_loop

    def counted_while(cond, body, init):
        out = real_while(cond, body, init)
        if (isinstance(init, tuple) and len(init) == 3
                and getattr(init[2], "dtype", None) == jnp.int32 and jnp.ndim(init[2]) == 0):
            jax.debug.callback(lambda k: seen.jax_solves.append(int(k)), out[2],
                               ordered=True)
        return out

    def jax_solves_since(start):
        jax.effects_barrier()
        return seen.jax_solves[start:]

    def to_torch(env):
        return {k: torch.as_tensor(np.asarray(v)) for k, v in env.items()}

    class ModelProxy:
        def __init__(self, jm, pm):
            self._jm, self._pm = jm, pm

        def __getattr__(self, key):
            value = getattr(self._jm, key)
            if key in ("P", "dirs", "normals"):
                close(getattr(self._pm, key), value, f"{self._jm.name}.{key}")
                seen.geometry += 1
            elif key in ("from_var", "to_var"):
                assert getattr(self._pm, key) == value, key
            return value

        def forward(self, env):
            if any(isinstance(v, jax.core.Tracer) for v in env.values()):
                return self._jm.forward(env)  # under jax.jvp: JAX alone
            start = len(seen.jax_solves)
            logs = [len(log) for log in newton_logs(self._pm)]
            try:
                out = self._jm.forward(env)
            except Exception as e:
                same_error(lambda: self._pm.forward(to_torch(env)), e)
                seen.errors += 1
                raise
            port_out = self._pm.forward(to_torch(env))
            assert sorted(port_out) == sorted(out), (sorted(port_out), sorted(out))
            for k, v in out.items():
                close(port_out[k], v, f"{self._jm.name}: {k}")
                seen.outputs += 1
            port_solves = [n for log, n0 in zip(newton_logs(self._pm), logs) for n in log[n0:]]
            assert sorted(port_solves) == sorted(jax_solves_since(start)), self._jm.name
            seen.solves += len(port_solves)
            return out

    real_load = JN.load_neml2_model

    def load(path, model_name, cli_args=()):
        try:
            jm = real_load(path, model_name, cli_args)
        except Exception as e:
            same_error(lambda: PN.load_neml2_model(path, model_name, cli_args, device="cpu"), e)
            seen.errors += 1
            raise
        seen.models += 1
        return ModelProxy(jm, PN.load_neml2_model(path, model_name, cli_args, device="cpu"))

    def port_root(root):
        how, args, kwargs = sources[id(root)]
        return getattr(port_hit, how)(*args, **kwargs)

    def hit_recorder(how, real):
        def call(*args, **kwargs):
            node = real(*args, **kwargs)
            sources[id(node)] = (how, args, kwargs)
            return node
        return call

    real_run = jexec.run_deck

    def run_deck(root, file_base=None, output_dir=".", mesh=None, deck_stem=None,
                 deck_dir=None):
        port_dir = os.path.join(output_dir, "port")

        def port_run():
            return port_run_deck(port_root(root), file_base=file_base, output_dir=port_dir,
                                 device="cpu", deck_dir=deck_dir, deck_stem=deck_stem)

        start = len(seen.jax_solves)
        try:
            tr = real_run(root, file_base=file_base, output_dir=output_dir, mesh=mesh,
                          deck_stem=deck_stem, deck_dir=deck_dir)
        except Exception as e:
            same_error(port_run, e)
            seen.errors += 1
            raise
        ptr = port_run()
        compare_decks(ptr, tr, jax_solves_since(start))
        seen.decks += 1
        return tr

    def compare_decks(ptr, tr, jax_solves):
        jb, pb = tr.state["buffers"], ptr.state["buffers"]
        assert sorted(pb) == sorted(jb)
        for k, v in jb.items():
            close(pb[k], v, f"buffer {k}")
        assert ptr.step_count == tr.step_count
        solves = [n for m in neml2_computes(ptr.problem)
                  for log in newton_logs(m.model) for n in log]
        assert sorted(solves) == sorted(jax_solves)
        seen.solves += len(solves)

    class Problem(jproblem.TensorProblem):
        def __init__(self, root, *args, **kwargs):
            super().__init__(root, *args, **kwargs)
            self._port = PortProblem(port_root(root), device="cpu")

        def init_state(self):
            state = super().init_state()
            port = self._port.init_state()
            for k, v in state["buffers"].items():
                close(port["buffers"][k], v, f"initial {k}")
            seen.decks += 1
            return state

    real_mrp, real_slip = JN._mrp_rotation, JN._slip_geometry

    def mrp(r):
        R = real_mrp(r)
        if not isinstance(r, jax.core.Tracer):
            close(PN._mrp_rotation(torch.as_tensor(np.asarray(r))), R, "_mrp_rotation")
            seen.geometry += 1
        return R

    def slip(params):
        d, n = real_slip(params)
        pd, pn = PN._slip_geometry(PortParams(params.node))
        close(pd, d, "slip directions")
        close(pn, n, "slip normals")
        seen.geometry += 1
        return d, n

    monkeypatch.setattr(jax.lax, "while_loop", counted_while)
    monkeypatch.setattr(JN, "load_neml2_model", load)
    monkeypatch.setattr(JN, "_mrp_rotation", mrp)
    monkeypatch.setattr(JN, "_slip_geometry", slip)
    monkeypatch.setattr(jexec, "run_deck", run_deck)
    monkeypatch.setattr(jproblem, "TensorProblem", Problem)
    monkeypatch.setattr(jhit, "load", hit_recorder("load", jhit.load))
    monkeypatch.setattr(jhit, "parse", hit_recorder("parse", jhit.parse))
    yield seen


def neml2_computes(problem):
    """The port problem's NEML2TensorCompute objects, in every group."""
    def flat(m):
        members = getattr(m, "members", None)
        if members is None:
            yield m
        else:
            for sub in members:
                yield from flat(sub)

    groups = [problem.ic_computes, *problem.solve_computes, problem.pp_computes]
    return [m for g in groups for m in flat(g) if isinstance(m, PN.NEML2TensorCompute)]


@pytest.mark.parametrize("case", CASES)
def test_neml2_parity(case, parity, tmp_path):
    """tests/test_neml2.py's case, with every NEML2 model, deck, problem
    and geometry helper it touches also run through the port and compared
    (module docstring).  The case must reach the port at least once."""
    fn = getattr(jax_cases, case)
    if "tmp_path" in inspect.signature(fn).parameters:
        fn(tmp_path)
    else:
        fn()
    reached = parity.models if case in JVP_ONLY else (
        parity.outputs + parity.decks + parity.errors + parity.geometry)
    assert reached > 0, vars(parity)


def test_model_types_are_the_jax_packages():
    from marlin_tpu.computes import neml2 as JN

    assert len(PN._MODEL_TYPES) == 56
    assert sorted(PN._MODEL_TYPES) == sorted(JN._MODEL_TYPES)


def _write(tmp_path, text, name="model.i"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


JVP_MODELS = {
    "spectral": ("[Models]\n  [m]\n    type = StrainEnergyDensity\n    lambda = 100.0\n"
                 "    mu = 50.0\n    decomposition = SPECTRAL\n  []\n[]\n",
                 ["forces/E"]),
    "kocks_mecking": ("[Models]\n  [m]\n    type = KocksMeckingActivationEnergy\n"
                      "    shear_modulus = 5e10\n    burgers_vector = 2.5e-10\n"
                      "    reference_strain_rate = 1e10\n  []\n[]\n",
                      ["state/internal/ep_rate"]),
    "power_law_virgin": ("[Models]\n  [m]\n    type = PowerLawIsotropicHardening\n"
                         "    hardening_modulus = 500\n    exponent = 0.3\n  []\n[]\n",
                         ["state/internal/ep"]),
    "fb_corner": ("[Models]\n  [m]\n    type = RateIndependentPlasticFlowConstraint\n  []\n[]\n",
                  ["state/internal/gamma_rate", "state/internal/fp"]),
}


@pytest.mark.parametrize("case", sorted(JVP_MODELS))
def test_neml2_jvp_parity(case, tmp_path):
    """The port's forward-mode tangents (torch.func.jvp) equal the JAX
    package's (jax.jvp) at the points where the guards matter: repeated
    eigenvalues of the spectral split (E = 0, uniaxial, hydrostatic), a
    zero strain rate under the Kocks-Mecking floor, a virgin ep = 0 under
    the safe pow, the Fischer-Burmeister corner g = f = 0; every tangent
    finite."""
    import jax
    import jax.numpy as jnp
    from marlin_tpu.computes import neml2 as JN

    jax.config.update("jax_enable_x64", True)
    text, keys = JVP_MODELS[case]
    path = _write(tmp_path, text)
    jm = JN.load_neml2_model(path, "m")
    pm = PN.load_neml2_model(path, "m", device="cpu")
    if case == "spectral":
        points = [{"forces/E": np.asarray(e, float)} for e in
                  ([0.0] * 6, [0.01, 0, 0, 0, 0, 0], [0.01, 0.01, 0.01, 0, 0, 0])]
    elif case == "kocks_mecking":
        points = [{"forces/T": np.full(3, 900.0), "state/internal/ep_rate": np.zeros(3)}]
    elif case == "power_law_virgin":
        points = [{"state/internal/ep": np.asarray([0.0, 1e-3, 0.2])}]
    else:
        points = [{"state/internal/gamma_rate": np.zeros(2), "state/internal/fp": np.zeros(2),
                   "old_state/internal/gamma_rate": np.zeros(2)}]
    for env in points:
        for key in keys:
            def jf(x):
                return jm.forward({**{k: jnp.asarray(v) for k, v in env.items()}, key: x})

            def pf(x):
                return pm.forward({**{k: torch.as_tensor(v) for k, v in env.items()}, key: x})

            x = env[key]
            jval, jtan = jax.jvp(jf, (jnp.asarray(x),), (jnp.ones_like(jnp.asarray(x)),))
            pval, ptan = torch.func.jvp(pf, (torch.as_tensor(x),),
                                        (torch.ones_like(torch.as_tensor(x)),))
            assert sorted(ptan) == sorted(jtan)
            for k in jtan:
                assert np.isfinite(ptan[k].numpy()).all(), (case, k)
                close(pval[k], jval[k], f"{case} {k}")
                close(ptan[k], jtan[k], f"{case} d{k}/d{key}")


def _creep_csv(out_dir):
    (name,) = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
    return np.genfromtxt(os.path.join(out_dir, name), delimiter=",", names=True)


@pytest.mark.parametrize("nx", [16, 64])
def test_neml2_creep_example_both_packages(nx, tmp_path):
    """examples/neml2_creep/creep.i (its shipped 64², and 16²) for its 20
    steps in both packages, float64: ep and sm within 1e-10, the CSV's
    columns within 1e-10, the Newton iteration counts equal step by step,
    and the physics tests/test_examples.py asserts of it."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from marlin_tpu import hit as jhit
    from marlin_tpu.executioner import run_deck as jax_run_deck

    over = [f"Domain/nx={nx}", f"Domain/ny={nx}", "Domain/floating_precision=DOUBLE"]
    deck_dir = os.path.dirname(CREEP)
    jtr = jax_run_deck(jhit.load(CREEP, over), output_dir=str(tmp_path / "jax"),
                       deck_dir=deck_dir)
    ptr = port_run_deck(port_hit.load(CREEP, over), output_dir=str(tmp_path / "port"),
                        deck_dir=deck_dir, device="cpu")
    assert ptr.step_count == jtr.step_count == 20
    for k in ("ep", "sm", "ep_old"):
        close(ptr.state["buffers"][k], jtr.state["buffers"][k], k)
    jcsv, pcsv = _creep_csv(tmp_path / "jax"), _creep_csv(tmp_path / "port")
    assert jcsv.dtype.names == pcsv.dtype.names
    for col in jcsv.dtype.names:
        close(pcsv[col], jcsv[col], f"csv {col}")
    (creep,) = neml2_computes(ptr.problem)
    assert creep.model.counts.solves == 20 and creep.model.counts.log[0] > 1
    sm = ptr.state["buffers"]["sm"].numpy()
    ep = ptr.state["buffers"]["ep"].numpy()
    e = np.broadcast_to(ptr.state["buffers"]["e"].numpy(), sm.shape)
    assert np.all(sm <= 1000.0 * e + 1e-6)
    assert np.all(ep >= -1e-12) and np.all(ep <= e + 1e-9)
    cold = (1000.0 * e - sm)[: nx // 4].mean()
    hot = (1000.0 * e - sm)[-nx // 4:].mean()
    assert hot > 10 * max(cold, 1e-9), (hot, cold)


def test_neml2_creep_newton_counts_match(tmp_path, monkeypatch):
    """The creep example's field-wide Newton takes the same number of
    iterations in both packages at every step (JAX's counted through a
    ``jax.debug.callback`` around its while_loop)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from marlin_tpu import hit as jhit
    from marlin_tpu.executioner import run_deck as jax_run_deck

    counts = []
    real = jax.lax.while_loop

    def counted(cond, body, init):
        out = real(cond, body, init)
        if isinstance(init, tuple) and len(init) == 3 and jnp.ndim(init[2]) == 0:
            jax.debug.callback(lambda k: counts.append(int(k)), out[2], ordered=True)
        return out

    monkeypatch.setattr(jax.lax, "while_loop", counted)
    over = ["Domain/nx=16", "Domain/ny=16", "Domain/floating_precision=DOUBLE",
            "Executioner/num_steps=6"]
    deck_dir = os.path.dirname(CREEP)
    jax_run_deck(jhit.load(CREEP, over), output_dir=str(tmp_path / "jax"), deck_dir=deck_dir)
    jax.effects_barrier()
    ptr = port_run_deck(port_hit.load(CREEP, over), output_dir=str(tmp_path / "port"),
                        deck_dir=deck_dir, device="cpu")
    (creep,) = neml2_computes(ptr.problem)
    assert creep.model.counts.log == counts[-6:], (creep.model.counts.log, counts)
    assert creep.model.counts.fetches == sum(creep.model.counts.log) + 6


# -- the port's deliberate departures (ROADMAP §3) ----------------------------------


def _params(text, jax_package):
    if jax_package:
        from marlin_tpu import hit as jhit
        from marlin_tpu.params import Params

        return Params(jhit.parse(text).children["Models"].children["m"])
    return PortParams(port_hit.parse(text).children["Models"].children["m"])


def test_departure_missing_optional_float_or_var():
    """A missing optional float-or-variable parameter: the JAX package's
    _float_or_var raises a TypeError (float(None)); the port's gives
    (None, None)."""
    from marlin_tpu.computes import neml2 as JN

    text = "[Models]\n  [m]\n    type = YieldFunction\n  []\n[]\n"
    with pytest.raises(TypeError):
        JN._float_or_var(_params(text, True), "exponent", required=False)
    assert PN._float_or_var(_params(text, False), "exponent", required=False) == (None, None)


@pytest.mark.parametrize("literal", ["nan", "inf", "-inf"])
def test_departure_non_finite_literal(literal, tmp_path):
    """A non-finite literal for a float-or-variable parameter: the JAX
    package takes it as a constant (and the flow rate is NaN); the port
    refuses it at load with a named parameter error."""
    import jax.numpy as jnp
    from marlin_tpu.computes import neml2 as JN

    path = _write(tmp_path, "[Models]\n  [m]\n    type = PerzynaPlasticFlowRate\n"
                            f"    reference_stress = {literal}\n    exponent = 2\n  []\n[]\n")
    jm = JN.load_neml2_model(path, "m")
    assert jm.eta_var is None and not np.isfinite(jm.eta)
    out = jm.forward({"state/internal/fp": jnp.asarray(10.0)})["state/internal/gamma_rate"]
    assert not np.isfinite(float(out)) or float(out) == 0.0
    with pytest.raises(PortParamError, match=f"'{literal}' is not a finite number"):
        PN.load_neml2_model(path, "m", device="cpu")


@pytest.mark.parametrize("model", ["KocksMeckingRateSensitivity", "KocksMeckingFlowViscosity",
                                   "KocksMeckingFlowSwitch"])
def test_departure_positive_kocks_mecking_slope(model, tmp_path):
    """A Kocks-Mecking slope A > 0: the JAX package loads it (and the rate
    sensitivity comes out negative); the port refuses it at load."""
    import jax.numpy as jnp
    from marlin_tpu.computes import neml2 as JN

    path = _write(tmp_path, f"[Models]\n  [m]\n    type = {model}\n    shear_modulus = 5e10\n"
                            "    burgers_vector = 2.5e-10\n    A = 0.4\n    B = -3.0\n"
                            "    C = -4.0\n    reference_strain_rate = 1e10\n  []\n[]\n")
    jm = JN.load_neml2_model(path, "m")
    assert jm.A == 0.4
    if model == "KocksMeckingRateSensitivity":
        n = jm.forward({"forces/T": jnp.asarray(900.0)})["state/internal/n"]
        assert float(n) < 0.0
    with pytest.raises(PortParamError, match="slope must be negative"):
        PN.load_neml2_model(path, "m", device="cpu")


def test_load_defaults_to_cuda(tmp_path):
    """load_neml2_model's default device is cuda: without a card it raises
    and names the CPU switch."""
    path = _write(tmp_path, "[Models]\n  [m]\n    type = ScalarParameterToState\n"
                            "    to_var = state/b\n    value = 3\n  []\n[]\n")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PN.load_neml2_model(path, "m")
    assert PN.load_neml2_model(path, "m", device="cpu").forward({})["state/b"].item() == 3.0


def test_newton_host_loop_counts(tmp_path):
    """ImplicitUpdate's host loop: one fetch a condition test (iterations
    + 1 while under miter), the condition first (a solve that starts
    converged takes 0 iterations and 1 fetch)."""
    m = PN.load_neml2_model(os.path.join(os.path.dirname(CREEP), "model.i"), "impl",
                            device="cpu")
    env = {"forces/e": torch.full((4,), 0.004, dtype=torch.float64),
           "forces/T": torch.linspace(600, 1200, 4, dtype=torch.float64),
           "old_state/internal/ep": torch.zeros(4, dtype=torch.float64),
           "forces/t": torch.tensor(0.1, dtype=torch.float64),
           "old_forces/t": torch.tensor(0.0, dtype=torch.float64)}
    m.forward(env)
    its = m.counts.log[-1]
    assert its > 1 and m.counts.fetches == its + 1
    m.forward({**env, "forces/e": torch.zeros(4, dtype=torch.float64)})
    assert m.counts.log[-1] == 0 and m.counts.fetches == its + 2


@pytest.mark.parametrize("prec", ["DOUBLE", "SINGLE"])
def test_neml2_perzyna_deck_both_packages(prec, tmp_path, monkeypatch):
    """decks.NEML2_PERZYNA_DECK (NEML2_PERZYNA_MODEL's implicit Perzyna
    update, n = 7 unknowns a point, and NEML2_SPECTRAL_MODEL's split) at
    8³, 3 steps, in both packages: in float64 every buffer within 1e-10
    and the Newton iteration counts equal step by step; in float32 (the
    model's tolerance at 1e-8, as phase 17 runs it) within 1e-4 of float64
    (chip_smoke.py's NEML2_TOL), every solve converged."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from marlin_tpu import hit as jhit
    from marlin_tpu.executioner import run_deck as jax_run_deck
    from marlin_tpu_torch import decks

    counts = []
    real = jax.lax.while_loop

    def counted(cond, body, init):
        out = real(cond, body, init)
        if isinstance(init, tuple) and len(init) == 3 and jnp.ndim(init[2]) == 0:
            jax.debug.callback(lambda k: counts.append(int(k)), out[2], ordered=True)
        return out

    monkeypatch.setattr(jax.lax, "while_loop", counted)
    model = _write(tmp_path, decks.NEML2_PERZYNA_MODEL, "perzyna.i")
    spectral = _write(tmp_path, decks.NEML2_SPECTRAL_MODEL, "spectral.i")

    def text(precision, cli_args=""):
        return decks.NEML2_PERZYNA_DECK.format(
            n=8, domain_extra=f"floating_precision = {precision}", dt=0.1, steps=3,
            model=model, spectral_model=spectral, cli_args=cli_args)

    ptr = port_run_deck(port_hit.parse(text("DOUBLE")), output_dir=str(tmp_path),
                        device="cpu")
    perzyna = ptr.problem.get_compute("perzyna").model
    if prec == "DOUBLE":
        jtr = jax_run_deck(jhit.parse(text("DOUBLE")), output_dir=str(tmp_path))
        jax.effects_barrier()
        for k, v in jtr.state["buffers"].items():
            close(ptr.state["buffers"][k], v, k)
        assert perzyna.counts.log == counts[-3:] and max(counts) > 2, (perzyna.counts, counts)
        assert (ptr.state["buffers"]["psi_inactive"] > 0).any()
        return
    ftr = port_run_deck(port_hit.parse(text("SINGLE", "cli_args = 'Models/impl/"
                                                      "absolute_tolerance=1e-8'")),
                        output_dir=str(tmp_path), device="cpu")
    f32 = ftr.problem.get_compute("perzyna").model
    assert f32.abs_tol == 1e-8 and max(f32.counts.log) < f32.miter, f32.counts
    for k in ("Ep", "ep", "S", "psi", "psi_inactive"):
        want = ptr.state["buffers"][k]
        err = (ftr.state["buffers"][k].double() - want).abs().max() / want.abs().max()
        assert err <= 1e-4, (k, float(err))
