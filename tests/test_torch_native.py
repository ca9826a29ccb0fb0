"""The port's native ``${fparse}`` evaluator (marlin_tpu_torch/native.py):
built by g++ from native/expr_eval.cpp into marlin_tpu_torch/_build/,
bound with ctypes, and differentially tested against the port's Python
engine and against the JAX package's ``fparse`` on the corpus and the
fuzz of tests/test_native.py; fparse takes the native value and falls
back to the Python engine where the native one refuses an expression,
with the JAX package's error."""

import math
import os
import random

import pytest

from marlin_tpu_torch import expression, native
from marlin_tpu_torch.expression import Ops, parse

from tests.test_native import CORPUS


def python_eval(expr, env):
    scope = {"pi": math.pi, "e": math.e, **env}
    return float(parse(expr).evaluate(scope, Ops()))


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("the native library could not be built (no g++)")
    return True


def test_library_is_built_into_the_ports_build_directory(lib):
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert os.path.basename(os.path.dirname(os.path.dirname(path))) == "marlin_tpu_torch"
    assert os.path.exists(path) and native.build() == path  # built once
    assert native.SOURCE.endswith(os.path.join("native", "expr_eval.cpp"))


@pytest.mark.parametrize("expr,env", CORPUS, ids=[c[0][:25] for c in CORPUS])
def test_native_matches_python(lib, expr, env):
    assert native.eval_scalar(expr, env) == pytest.approx(
        python_eval(expr, env), rel=1e-14, abs=1e-14)


def fuzz_cases(n=200, seed=42):
    """tests/test_native.py's fuzz: (expression, x) pairs."""
    rng = random.Random(seed)
    ops = ["+", "-", "*", "/"]
    fns = ["sin", "cos", "exp", "tanh", "abs", "sqrt"]
    for _ in range(n):
        x = rng.uniform(0.1, 3.0)
        expr = f"{rng.uniform(0.1, 2):.4f}"
        for _ in range(rng.randint(1, 6)):
            fn = rng.choice(fns)
            expr = f"{fn}(({expr}) {rng.choice(ops)} {rng.uniform(0.1, 2):.4f})"
        yield expr, x


def test_native_fuzz(lib):
    for expr, x in fuzz_cases():
        try:
            p = python_eval(expr, {"x": x})
        except ValueError:
            # a domain error (the square root of a negative): native gives nan
            assert math.isnan(native.eval_scalar(expr, {"x": x})), expr
            continue
        n = native.eval_scalar(expr, {"x": x})
        if math.isnan(p):
            assert math.isnan(n), expr
        else:
            assert n == pytest.approx(p, rel=1e-12, abs=1e-12), expr


def _same(got, want, tol):
    if math.isnan(want):
        return math.isnan(got)
    return got == pytest.approx(want, rel=tol, abs=tol)


@pytest.mark.parametrize("expr,env", CORPUS, ids=[c[0][:25] for c in CORPUS])
def test_native_matches_the_jax_fparse(lib, expr, env):
    """The native engine and the port's fparse against the JAX package's
    fparse, the entry its decks evaluate ``${fparse}`` through."""
    from marlin_tpu import expression as jexpression

    want = jexpression.fparse(expr, env)
    assert _same(native.eval_scalar(expr, {"pi": math.pi, "e": math.e, **env}), want, 1e-14)
    assert _same(expression.fparse(expr, env), want, 1e-14)


def test_native_fuzz_matches_the_jax_fparse(lib):
    from marlin_tpu import expression as jexpression

    for expr, x in fuzz_cases():
        want = jexpression.fparse(expr, {"x": x})
        got = native.eval_scalar(expr, {"pi": math.pi, "e": math.e, "x": x})
        assert _same(got, want, 1e-12), (expr, got, want)
        assert _same(expression.fparse(expr, {"x": x}), want, 1e-12), expr


def test_native_errors(lib):
    with pytest.raises(native.NativeError):
        native.eval_scalar("nosuchfn(1)", {})
    with pytest.raises(native.NativeError):
        native.eval_scalar("x +", {"x": 1.0})


def test_fparse_takes_the_native_value(lib, monkeypatch):
    calls = []
    real = native.eval_scalar

    def counted(text, env=None):
        calls.append(text)
        return real(text, env)

    monkeypatch.setattr(native, "eval_scalar", counted)
    assert expression.fparse("a := x + 1; a^2", {"x": 2.0}) == 9.0
    assert calls == ["a := x + 1; a^2"]


@pytest.mark.parametrize("text", ["nosuchfn(1)", "x +"])
def test_fparse_falls_back_with_the_jax_error(lib, text):
    """An expression the native engine refuses goes to the Python
    engine, whose error is the JAX package's fparse's."""
    from marlin_tpu import expression as jexpression

    with pytest.raises(Exception) as pe:
        expression.fparse(text, {"x": 1.0})
    with pytest.raises(Exception) as je:
        jexpression.fparse(text, {"x": 1.0})
    assert type(pe.value).__name__ == type(je.value).__name__
    assert str(pe.value) == str(je.value)


def test_fparse_without_the_library_is_the_python_engine(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    assert expression.fparse("2^3^2") == python_eval("2^3^2", {}) == 512.0
