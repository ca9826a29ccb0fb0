"""The port's copies of the deck front end (marlin_tpu_torch/hit.py,
params.py, registry.py) against marlin_tpu's originals: the same deck text
gives the same tree in both packages."""

import os

import pytest

import bench
from __graft_entry__ import _CH_DECK
from marlin_tpu import hit as jhit
from marlin_tpu import params as jparams
from marlin_tpu_torch import hit, params, registry
from marlin_tpu_torch import decks
from marlin_tpu_torch.decks import CH3D_DECK
from tests import test_pallas_spectral as tps


def _tree(node):
    """A HIT node as nested plain data, in declaration order."""
    return {
        "name": node.name,
        "params": dict(node.params),
        "order": list(node._order),
        "children": {k: _tree(v) for k, v in node.children.items()},
        "blocks": [b.name for b in node.blocks()],
    }


_BRACES = """
L = 100
ss = 4
[Domain]
  dim = 2
  nx = ${ss}
  xmax = '${fparse L / 4}'
  ymax = '${fparse pi*2}'
[]
[G]
  active = 'a c'
  [a][]
  [b][]
  [c]
    v = 'a b
         c d'
  [../]
[]
"""


@pytest.mark.parametrize("text", [
    _CH_DECK.format(nx=200, ny=200, substeps=1000),
    CH3D_DECK.format(n=512, substeps=10),
    _BRACES,
], ids=["ch_deck", "ch3d_deck", "braces"])
def test_parse_gives_same_tree(text):
    a, b = hit.parse(text), jhit.parse(text)
    assert _tree(a) == _tree(b)
    hit.expand_braces(a)
    jhit.expand_braces(b)
    assert _tree(a) == _tree(b)


def test_load_with_overrides_gives_same_tree(tmp_path):
    path = tmp_path / "ch.i"
    path.write_text(_CH_DECK.format(nx="${n}", ny=32, substeps=5))
    over = ["n=48", "TensorSolver/substeps=7", "Domain/fft_backend=PALLAS"]
    a, b = hit.load(str(path), over), jhit.load(str(path), over)
    assert _tree(a) == _tree(b)
    assert a.child("Domain").get("nx") == "48"
    assert a.child("TensorSolver").get("substeps") == "7"


def test_ch3d_deck_is_bench_copy():
    assert CH3D_DECK == bench._CH3D_DECK


def test_mech_deck_is_bench_copy():
    """MECH_DECK at n = 32 is bench's _MECH_DECK with its box 2π written
    out, which is what ${fparse 2*pi} gives; n sets every extent."""
    text = decks.MECH_DECK.format(n=32, domain_extra="")
    lines = [line for line in text.splitlines() if line.strip()]
    want = bench._MECH_DECK.replace("${fparse 2*pi}", "6.283185307179586")
    assert lines == [line for line in want.splitlines() if line.strip()]
    root = jhit.parse(bench._MECH_DECK)
    jhit.expand_braces(root)
    assert root.child("Domain").get("xmax") == "6.283185307179586"


@pytest.mark.parametrize("name,original", [
    ("CH_DECK", "_CH"), ("SH_DECK", "_SH"), ("MULTI_DECK", "_MULTI")])
def test_spectral_decks_are_test_copies(name, original):
    assert getattr(decks, name) == getattr(tps, original)


def test_multi_3d_deck_is_test_copy():
    """At n = 16 the 3-D copy is _mk_multi_3d_deck(); n sets every extent."""
    keep = {"domain_extra": "{domain_extra}", "solver_extra": "{solver_extra}"}
    assert decks.MULTI_3D_DECK.format(n=16, **keep) == tps._mk_multi_3d_deck()
    text = decks.MULTI_3D_DECK.format(n=512, domain_extra="", solver_extra="")
    domain = hit.parse(text).child("Domain")
    assert [domain.get(k) for k in ("nx", "ny", "nz", "xmax", "ymax", "zmax")
            ] == ["512"] * 6


@pytest.mark.parametrize("path", ["TensorComputes/Initialize", "TensorComputes/Solve",
                                  "TensorSolver"])
def test_bench_1a_deck_holds_the_ch_deck(path):
    """BENCH_1A_DECK's physics is __graft_entry__._CH_DECK's, block for
    block, at every extent."""
    a = hit.parse(decks.BENCH_1A_DECK.format(n=200, substeps=1000,
                                             domain_extra="", solver_extra=""))
    b = jhit.parse(_CH_DECK.format(nx=200, ny=200, substeps=1000))
    assert _tree(a.child(path)) == _tree(b.child(path))
    assert _tree(a.child("Domain")) == _tree(b.child("Domain"))


def test_bench_1a_deck_schedule_is_bench_run():
    """dt0 1, growth 1.1, dtmax 300, end 10500, change < 1e-4: the
    arguments bench.py gives build_run for benchmark 1a."""
    root = hit.parse(decks.BENCH_1A_DECK.format(n=200, substeps=1000,
                                                domain_extra="", solver_extra=""))
    ex = root.child("Executioner")
    ts = ex.child("TimeStepper")
    assert (ts.get("dt"), ts.get("growth_factor"), ex.get("dtmax"),
            ex.get("end_time")) == ("1", "1.1", "300", "10500")
    assert root.child("UserObjects/terminator").get("expression") == "change < 1e-4"
    src = open(bench.__file__).read()
    assert ("build_run(problem, num_steps=1000, dt0=1.0, growth=1.1,\n"
            "                            dtmax=300.0, end_time=10500.0, "
            "change_tol=1e-4)") in src


def test_unbalanced_deck_raises_in_both():
    with pytest.raises(hit.HitError):
        hit.parse("[A]\n x = 1\n")
    with pytest.raises(jhit.HitError):
        jhit.parse("[A]\n x = 1\n")


@pytest.mark.parametrize("getter,raw,ok", [
    ("get_int", "3", True), ("get_int", "2.7", False), ("get_float", "x", False),
    ("get_bool", "yes", True), ("get_bool", "maybe", False),
    ("get_int_vector", "1 2 3", True), ("get_int_vector", "1 2.5", False),
])
def test_params_accept_and_reject_alike(getter, raw, ok):
    results = []
    for h, p in ((hit, params), (jhit, jparams)):
        node = h.parse(f"[B]\n k = '{raw}'\n[]").child("B")
        try:
            results.append(("ok", getattr(p.Params(node), getter)("k")))
        except p.ParamError as e:
            results.append(("error", str(e)))
    assert results[0] == results[1]
    assert (results[0][0] == "ok") == ok


def test_unused_params_reported_alike():
    text = "[Domain]\n dim = 2\n nxx = 3\n[]\n[A]\n b = 1\n[]"
    a, b = hit.parse(text), jhit.parse(text)
    params.Params(a.child("Domain")).get_int("dim")
    jparams.Params(b.child("Domain")).get_int("dim")
    assert params.find_unused(a) == jparams.find_unused(b) == [
        "Domain/nxx", "A/b"]


def test_registry_names_and_errors():
    reg = registry.Registry()

    @reg.register("Foo", "Bar")
    class Foo:
        pass

    assert reg.get("Bar") is Foo and "Foo" in reg
    with pytest.raises(KeyError, match="Unknown object type 'Baz'"):
        reg.get("Baz")
    with pytest.raises(ValueError, match="Duplicate"):
        reg.register("Foo")(type("Other", (), {}))


def test_copied_modules_match_originals():
    """hit.py, params.py and registry.py are copies: the port changes only
    its warning prefix."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("hit.py", "params.py", "registry.py"):
        with open(os.path.join(here, "marlin_tpu", name)) as f:
            orig = f.read()
        with open(os.path.join(here, "marlin_tpu_torch", name)) as f:
            port = f.read()
        assert port.replace("[marlin_tpu_torch]", "[marlin_tpu]") == orig, name
