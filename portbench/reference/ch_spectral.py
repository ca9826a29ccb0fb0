"""Plain semi-implicit Cahn-Hilliard on a periodic 3-D grid.

The benchmark's yardstick for the spectral cells: the PFHub benchmark 1
free energy f(c) = rho_s (c - c_alpha)^2 (c_beta - c)^2 with gradient
energy kappa, mobility M, advanced by substeps of

    mu      = f'(c)
    N       = -M k^2 fft(mu)
    u_new   = (fft(c) + h (b0 N + b1 N_old)) / (1 + h M kappa k^4)
    c       = ifft(u_new)

with Adams-Bashforth weights (b0, b1) = (1, 0) where no older N exists and
(3/2, -1/2) after, h = dt / substeps.  In the first time step no older N
is pushed, so every substep of it is first order; from the second step on
the N of the substep before is the older one.  Everything is worked out
here from the configuration's constants and the grid: the wavenumbers,
the two reciprocal factors, the initial field and the history.

It imports only torch and math.  ``store`` rounds every field the
substep stores; the float64 reference stores exactly, the control rounds
to bfloat16 (``to_bfloat16``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

Rounding = Callable[[torch.Tensor], torch.Tensor]


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def to_bfloat16(t: torch.Tensor) -> torch.Tensor:
    """A stored field in bfloat16: real and imaginary parts each rounded,
    carried on in float32 arithmetic."""
    if t.is_complex():
        return torch.complex(t.real.to(torch.bfloat16).float(),
                             t.imag.to(torch.bfloat16).float())
    return t.to(torch.bfloat16).float()


@dataclass(frozen=True)
class Constants:
    n: int  # cells along each axis; the box is n long (spacing 1)
    dt: float
    substeps: int
    rho_s: float
    c_alpha: float
    c_beta: float
    mobility: float
    kappa: float


@dataclass(frozen=True)
class InitialField:
    """c(0) = c0 + epsilon * (the deck's fixed cosines) + delta * the sum
    of the seed's modes cos(a x + b y + g z + p), at cell centres."""

    c0: float
    epsilon: float
    delta: float
    modes: Tuple[Tuple[float, float, float, float], ...]


def initial_field(n: int, ic: InitialField, device, dtype=torch.float64) -> torch.Tensor:
    x = (torch.arange(n, device=device, dtype=dtype) + 0.5)
    X, Y, Z = x[:, None, None], x[None, :, None], x[None, None, :]
    fixed = (torch.cos(0.105 * X) * torch.cos(0.11 * Y) * torch.cos(0.09 * Z)
             + (torch.cos(0.13 * X) * torch.cos(0.087 * Y)) ** 2
             + torch.cos(0.025 * X - 0.15 * Z) * torch.cos(0.07 * X - 0.02 * Y))
    c = ic.c0 + ic.epsilon * fixed
    for a, b, g, p in ic.modes:
        c = c + ic.delta * torch.cos(a * X + b * Y + g * Z + p)
    return c


class Solver:
    """The substep loop above at one grid, its tables built once."""

    def __init__(self, k: Constants, device, dtype=torch.float64,
                 store: Rounding = exact):
        self.k = k
        self.dtype = dtype
        self.store = store
        n = k.n
        freq = torch.fft.fftfreq(n, d=1.0, dtype=torch.float64) * 2 * math.pi
        half = torch.fft.rfftfreq(n, d=1.0, dtype=torch.float64) * 2 * math.pi
        k2 = (freq[:, None, None] ** 2 + freq[None, :, None] ** 2
              + half[None, None, :] ** 2).to(device=device, dtype=dtype)
        self.mbar = store(-k.mobility * k2)
        self.denominator = 1.0 + (k.dt / k.substeps) * k.mobility * k.kappa * k2 * k2
        del k2

    def chemical_potential(self, c: torch.Tensor) -> torch.Tensor:
        k = self.k
        return 2.0 * k.rho_s * (c - k.c_alpha) * (k.c_beta - c) * (
            k.c_alpha + k.c_beta - 2.0 * c)

    def nonlinear(self, mu: torch.Tensor) -> torch.Tensor:
        return self.store(self.mbar * torch.fft.rfftn(mu))

    def step(self, c: torch.Tensor, n_old: Optional[torch.Tensor], first: bool):
        """One time step from c; ``n_old`` is the N of the substep before
        (None on the first step).  Returns (c, mu, N) of its last
        substep: mu and N of the field that substep started from."""
        s = self.store
        h = self.k.dt / self.k.substeps
        c = s(c.to(self.dtype))
        for _ in range(self.k.substeps):
            mu = s(self.chemical_potential(c))
            n_new = self.nonlinear(mu)
            if first or n_old is None:
                acc = n_new
            else:
                acc = 1.5 * n_new - 0.5 * n_old
            u = s((s(torch.fft.rfftn(c)) + h * acc) / self.denominator)
            del acc
            c = s(torch.fft.irfftn(u, s=c.shape))
            del u
            if not first:
                n_old = n_new
        return c, mu, n_new

    def history_from(self, mu: torch.Tensor) -> torch.Tensor:
        """The N a step starts from, worked out from the mu of the last
        substep before it."""
        return self.nonlinear(self.store(mu.to(self.dtype)))


def run_from_start(solver: Solver, c0: torch.Tensor, steps: int):
    """``steps`` time steps from c(0), the first one first order."""
    c, n_old, mu = c0, None, None
    for i in range(steps):
        c, mu, n_old = solver.step(c, n_old, first=(i == 0))
    return c, mu


def postprocessors(c: torch.Tensor) -> Dict[str, float]:
    """The deck's TIMESTEP_END values: the mean and the largest c."""
    return {"mean": float(c.double().mean()), "max": float(c.max())}
