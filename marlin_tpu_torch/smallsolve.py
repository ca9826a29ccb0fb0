"""Batched dense solves of small trailing (n, n) systems, unrolled into
plain elementwise operations.

The counterpart of marlin_tpu/smallsolve.py: the coupled ABM solves one
N×N system per grid point (N = the number of variables), and an unrolled
Gauss-Jordan with the JAX package's pivot rule gives the same pivot
choices, so the two packages agree to rounding where ``torch.linalg.solve``
(LAPACK's or cuSOLVER's own pivoting and blocking) would not.

Pivoting: partial pivoting by compare-swap chains of ``torch.where``; each
batch point picks its own pivot, so systems with singular leading minors
solve as LAPACK would.  Singular systems give inf/NaN.
"""

import torch

__all__ = ["small_solve"]

_MAX_UNROLL = 12


def small_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for trailing square systems, batched over leading axes.

    A: (..., n, n), b: (..., n) -> x: (..., n), with n <= 12 (the unrolled
    elimination grows as n³)."""
    n = A.shape[-1]
    if A.shape[-2] != n or b.shape[-1] != n:
        raise ValueError(f"shape mismatch: A {tuple(A.shape)}, b {tuple(b.shape)}")
    if n > _MAX_UNROLL:
        raise ValueError(
            f"small_solve unrolls the elimination; n = {n} > {_MAX_UNROLL} "
            "would bloat the program — use jnp.linalg.solve"
        )
    dtype = torch.promote_types(A.dtype, b.dtype)
    # augmented rows, each (..., n+1)
    rows = [torch.cat([A[..., i, :].to(dtype), b[..., i:i + 1].to(dtype)], dim=-1)
            for i in range(n)]
    for k in range(n):
        # compare-swap the largest |column-k| entry of rows k..n-1 into k
        piv = rows[k]
        for r in range(k + 1, n):
            better = (rows[r][..., k].abs() > piv[..., k].abs())[..., None]
            piv, rows[r] = (torch.where(better, rows[r], piv),
                            torch.where(better, piv, rows[r]))
        piv = piv / piv[..., k:k + 1]
        rows[k] = piv
        for r in range(n):
            if r != k:
                rows[r] = rows[r] - rows[r][..., k:k + 1] * piv
    return torch.stack([rows[i][..., n] for i in range(n)], dim=-1)
