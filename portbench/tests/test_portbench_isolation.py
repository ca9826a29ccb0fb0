"""No file of the benchmark imports JAX or the JAX package, whose names
are compared whole by their top-level part (the port's name begins with
the JAX package's), and the plain references import nothing of the
program."""

import ast
import os

import pytest

from portbench import run as bench_run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(HERE) for f in fs
               if f.endswith(".py"))


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                pkg = os.path.relpath(os.path.dirname(path), os.path.dirname(HERE))
                parts = pkg.split(os.sep)[: len(pkg.split(os.sep)) - node.level + 1]
                yield ".".join(parts + ([node.module] if node.module else []))
            else:
                yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    tops = {m.split(".", 1)[0] for m in imported(path)}
    assert not tops & set(bench_run.FORBIDDEN), (path, tops)


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_references_import_nothing_of_the_program(path):
    tops = {m.split(".", 1)[0] for m in imported(path)}
    assert tops <= {"__future__", "math", "dataclasses", "typing", "torch"}, tops


def test_forbidden_names_are_compared_whole():
    mods = ["marlin_tpu_torch", "marlin_tpu_torch.problem", "jaxtyping", "numpy",
            "marlin_tpu", "marlin_tpu.problem", "jax.numpy", "jaxlib", "flax.linen"]
    assert bench_run.forbidden_modules(mods) == [
        "flax.linen", "jax.numpy", "jaxlib", "marlin_tpu", "marlin_tpu.problem"]
