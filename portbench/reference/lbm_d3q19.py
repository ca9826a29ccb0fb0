"""Plain D3Q19 BGK lattice Boltzmann through a binary medium.

The benchmark's yardstick for the lattice Boltzmann cells.  A substep:

- stream: f_q(x) = f*_q(x - e_q) over the periodic grid (f* the
  post-collision populations of the substep before), 0 in solid cells;
- halfway bounce-back: where x is fluid and x - e_q is solid,
  f_q(x) = f*_opp(q)(x);
- moments: rho = sum_q f_q, u = sum_q e_q f_q / rho + F / (2 rho);
- equilibrium: feq_q = w_q rho (1 + 3 e.u + 4.5 (e.u)^2 - 1.5 u.u);
- BGK: f*_q = feq_q + (f_q - feq_q)(1 - 1/tau);

every field 0 in solid cells, |u| the speed.  The start is the
equilibrium at rest with rho = 1.  The velocity set, its order and its
weights are the D3Q19 lattice of Marlin's LBMD3Q19 stencil.

It imports only torch.  ``store`` rounds every stored field; the float64
reference stores exactly, the control rounds to bfloat16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

EX = (0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, 1, -1, -1, 1, 1, -1, -1)
EY = (0, 0, 0, 1, -1, 0, 0, 1, 1, -1, -1, 0, 0, 0, 0, 1, -1, 1, -1)
EZ = (0, 1, -1, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1, -1, 0, 0, 0, 0)
WEIGHTS = (1 / 3,) + (1 / 18,) * 6 + (1 / 36,) * 12
Q = 19


def opposite(q: int) -> int:
    e = (-EX[q], -EY[q], -EZ[q])
    return next(p for p in range(Q) if (EX[p], EY[p], EZ[p]) == e)


OPPOSITE = tuple(opposite(q) for q in range(Q))

Rounding = Callable[[torch.Tensor], torch.Tensor]


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def to_bfloat16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


@dataclass(frozen=True)
class Constants:
    tau: float
    force: tuple  # (Fx, Fy, Fz)
    substeps: int


class Lattice:
    """The medium's masks, built once: ``fluid`` (nx, ny, nz) and the
    cells each direction bounces at."""

    def __init__(self, fluid: torch.Tensor, k: Constants, dtype=torch.float64,
                 store: Rounding = exact):
        self.k = k
        self.dtype = dtype
        self.store = store
        self.fluid = fluid
        solid = ~fluid
        self.bounce = [None] + [
            fluid & torch.roll(solid, (EX[q], EY[q], EZ[q]), (0, 1, 2))
            for q in range(1, Q)]

    def at_rest(self) -> torch.Tensor:
        """f* of the equilibrium at rho = 1, u = 0: (19, nx, ny, nz)."""
        w = torch.tensor(WEIGHTS, dtype=self.dtype, device=self.fluid.device)
        return torch.where(self.fluid[None], w[:, None, None, None], 0.0).to(self.dtype)

    def substep(self, fpc: torch.Tensor) -> Dict[str, torch.Tensor]:
        s, fluid = self.store, self.fluid
        f = torch.empty_like(fpc)
        for q in range(Q):
            streamed = torch.roll(fpc[q], (EX[q], EY[q], EZ[q]), (0, 1, 2))
            if q:
                streamed = torch.where(self.bounce[q], fpc[OPPOSITE[q]], streamed)
            f[q] = torch.where(fluid, streamed, 0.0)
        f = s(f)
        rho = s(torch.where(fluid, f.sum(0), 0.0))
        inv = torch.where(fluid, 1.0 / torch.where(fluid, rho, 1.0), 0.0)
        u = []
        for axis, e in enumerate((EX, EY, EZ)):
            m = sum(e[q] * f[q] for q in range(Q) if e[q])
            u.append(s(torch.where(fluid, m * inv + self.k.force[axis] * 0.5 * inv, 0.0)))
        usq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
        omega = 1.0 / self.k.tau
        out = torch.empty_like(f)
        for q in range(Q):
            eu = EX[q] * u[0] + EY[q] * u[1] + EZ[q] * u[2]
            feq = s(WEIGHTS[q] * rho * (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * usq))
            out[q] = torch.where(fluid, feq + (f[q] - feq) * (1.0 - omega), 0.0)
        return {"fpc": s(out), "f": f, "density": rho,
                "velocity": torch.stack(u, -1), "speed": torch.sqrt(usq)}

    def step(self, fpc: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One time step of ``substeps`` substeps from f*."""
        out = {"fpc": self.store(fpc.to(self.dtype))}
        for _ in range(self.k.substeps):
            out = self.substep(out["fpc"])
        return out


def postprocessors(speed: torch.Tensor) -> Dict[str, float]:
    """The deck's TIMESTEP_END values: the mean and the largest speed."""
    return {"speed_mean": float(speed.double().mean()), "speed_max": float(speed.max())}
