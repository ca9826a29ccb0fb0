"""marlin_tpu_torch.smallsolve.small_solve against marlin_tpu.smallsolve
and LAPACK: the cases of tests/test_smallsolve.py, on the CPU.

Tolerances: against LAPACK 1e-11 (random) and 1e-12 (a grid batch), as the
JAX package's tests; against the JAX package's unrolled solve 1e-13 of the
largest entry (the same eliminations in the same order: rounding only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlin_tpu.smallsolve import small_solve as jax_small_solve
from marlin_tpu_torch.smallsolve import small_solve


def _solve(A, b):
    return small_solve(torch.from_numpy(np.asarray(A)), torch.from_numpy(np.asarray(b))).numpy()


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_matches_lapack_and_jax_random(n, dtype):
    rng = np.random.RandomState(n)
    A = rng.randn(40, n, n).astype(np.float64)
    b = rng.randn(40, n).astype(np.float64)
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.randn(40, n, n)
        b = b + 1j * rng.randn(40, n)
    x = _solve(A, b)
    ref = np.linalg.solve(A, b[..., None])[..., 0]
    np.testing.assert_allclose(x, ref, rtol=1e-11, atol=1e-11)
    xj = np.asarray(jax_small_solve(jnp.asarray(A), jnp.asarray(b)))
    assert np.abs(x - xj).max() <= 1e-13 * np.abs(xj).max()


def test_pivoting_handles_zero_diagonal():
    # leading minors singular: without pivoting the elimination divides by 0
    A = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    b = np.array([2.0, 3.0, 4.0])
    np.testing.assert_allclose(_solve(A, b), [3.0, 2.0, 4.0], atol=1e-14)


def test_batch_points_pivot_independently():
    # one batch point needs a swap, the other does not
    A = np.stack([np.array([[0.0, 1.0], [1.0, 0.0]]),
                  np.array([[2.0, 0.0], [0.0, 2.0]])])
    b = np.array([[1.0, 2.0], [2.0, 4.0]])
    np.testing.assert_allclose(_solve(A, b), [[2.0, 1.0], [1.0, 2.0]], atol=1e-14)


def test_grid_batch_and_pivots_match_jax():
    """A (6, 5) grid of 3×3 systems, diagonally weighted as the coupled
    ABM's I − dt·L: the same answer as LAPACK, and the JAX package's
    within rounding (the same pivots and operations)."""
    rng = np.random.RandomState(7)
    A = rng.randn(6, 5, 3, 3) + np.eye(3) * 4.0
    b = rng.randn(6, 5, 3)
    x = _solve(A, b)
    ref = np.linalg.solve(A, b[..., None])[..., 0]
    np.testing.assert_allclose(x, ref, rtol=1e-12, atol=1e-12)
    xj = np.asarray(jax_small_solve(jnp.asarray(A), jnp.asarray(b)))
    assert np.abs(x - xj).max() <= 1e-13 * np.abs(xj).max()


def test_rejects_large_n():
    with pytest.raises(ValueError, match="small_solve"):
        small_solve(torch.eye(16), torch.ones(16))
