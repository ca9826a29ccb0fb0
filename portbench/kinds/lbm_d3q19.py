"""The lattice Boltzmann cells: the medium from the seed, what the timed
path produced, and its comparison with ``reference/lbm_d3q19.py``.

Inputs: the seed draws the medium, random periodic spheres (the sphere
pack of the porous benchmark: max(8, (n // r)^3 // 24) spheres of radius
r = max(2, n // 16)), handed to the program as the deck's media array
and to the reference as its fluid mask.

Compared (each against the float64 reference, as a share of the
reference field's largest magnitude, or of the value itself):

- ``start_fpc``: the post-collision populations after the warm-up steps,
  from the equilibrium at rest (the first step runs no substeps), on
  populations drawn from the seed;
- ``last_fpc``, ``last_density``, ``last_velocity``: the window's last
  step, from the populations the program held when it began, over the
  whole grid;
- ``pp_speed_mean``, ``pp_speed_max``: the postprocessor values the last
  step fetched, against the reference's from its own speed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import widest_gap
from ..reference import lbm_d3q19 as ref

FLOAT_BYTES = 4  # float32 in the configuration
MASK_BYTES = 1
#: a D3Q19 BGK cell: the moments (18 adds for rho, 30 for the momenta, 3
#: multiplies and a reciprocal, 3 force terms), u.u (5), per direction
#: e.u, the equilibrium polynomial and its weight (145 in all) and the
#: relaxation (3 each, 57)
FLOPS_PER_CELL = 18 + 37 + 5 + 145 + 57


def medium(n: int, rng: np.random.Generator) -> np.ndarray:
    """(n, n, n) uint8, 1 fluid and 0 solid: max(8, (n // r)^3 // 24)
    spheres of radius r = max(2, n // 16) at centres drawn from ``rng``,
    periodic."""
    r = max(2, n // 16)
    off = np.arange(-r, r + 1)
    ox, oy, oz = np.meshgrid(off, off, off, indexing="ij")
    ball = ox * ox + oy * oy + oz * oz <= r * r
    ox, oy, oz = ox[ball], oy[ball], oz[ball]
    count = max(8, (n // r) ** 3 // 24)
    centres = rng.integers(0, n, size=(count, 3))
    flat = ((((centres[:, 0, None] + ox) % n) * n + (centres[:, 1, None] + oy) % n) * n
            + (centres[:, 2, None] + oz) % n)
    media = np.ones(n ** 3, dtype=np.uint8)
    media[flat.reshape(-1)] = 0
    return media.reshape(n, n, n)


class Cell:
    def __init__(self, config: Dict, seed: int, device):
        self.device = device
        self.dt = float(config["sizes"]["dt"])
        sizes, c = config["sizes"], config["constants"]
        self.n = int(sizes["n"])
        self.constants = ref.Constants(tau=float(c["tau"]),
                                       force=tuple(float(v) for v in c["body_force"]),
                                       substeps=int(sizes["substeps"]))
        rng = np.random.default_rng(seed)
        self.media = medium(self.n, rng)
        self.samples = rng.integers(0, ref.Q * self.n ** 3, size=int(config["samples"]))
        self.start = None
        self.last = None
        self._ref = None

    # -- inputs ------------------------------------------------------------
    def deck_fields(self) -> Dict[str, str]:
        return {"n": str(self.n), "substeps": str(self.constants.substeps),
                "dt": repr(self.dt)}

    def arrays(self) -> Optional[Dict[str, np.ndarray]]:
        return {"media": self.media}

    def _fluid(self) -> torch.Tensor:
        return torch.as_tensor(self.media, device=self.device) == 1

    # -- what the timed path produced ----------------------------------------
    def _index(self):
        return torch.as_tensor(self.samples, device=self.device)

    @staticmethod
    def _q_major(f: torch.Tensor) -> torch.Tensor:
        return f.movedim(-1, 0)

    def capture_start(self, state: Dict, steps: int):
        fpc = self._q_major(state["buffers"]["fpc"]).reshape(-1)
        self.start = {"steps": steps, "fpc": fpc.index_select(0, self._index()).clone()}

    def capture_last(self, state_in: Dict, state_out: Dict, values: Dict[str, float]):
        b = state_out["buffers"]
        self.last = {"fpc_in": self._q_major(state_in["buffers"]["fpc"]),
                     "fpc": self._q_major(b["fpc"]), "density": b["density"],
                     "velocity": b["velocity"],
                     "pp": {k: float(values[k]) for k in ("speed_mean", "speed_max")}}

    # -- the comparison ------------------------------------------------------
    def _outputs(self, lattice: ref.Lattice, steps: int) -> Dict:
        """What ``lattice`` gives in the program's place: the populations
        after the warm-up steps on the sampled entries, the last step's
        fields from the program's populations where it began, and its
        postprocessors."""
        fpc = lattice.at_rest()
        for _ in range(steps - 1):  # the first step runs no substeps
            fpc = lattice.step(fpc)["fpc"]
        out = {"start_fpc": fpc.reshape(-1).index_select(0, self._index())}
        del fpc
        last = lattice.step(self.last["fpc_in"])
        out.update(fpc=last["fpc"], density=last["density"], velocity=last["velocity"],
                   pp=ref.postprocessors(last["speed"]))
        return out

    def _reference(self) -> Dict:
        if self._ref is None:
            self._ref = self._outputs(ref.Lattice(self._fluid(), self.constants),
                                      self.start["steps"])
        return self._ref

    def readings(self, got: Optional[Dict] = None) -> Dict[str, float]:
        if got is None:
            got = {"start_fpc": self.start["fpc"], "fpc": self.last["fpc"],
                   "density": self.last["density"], "velocity": self.last["velocity"],
                   "pp": self.last["pp"]}
        want = self._reference()
        out = {"start_fpc": widest_gap(got["start_fpc"], want["start_fpc"])}
        for key in ("fpc", "density", "velocity"):
            out[f"last_{key}"] = widest_gap(got[key], want[key])
        for key in ("speed_mean", "speed_max"):
            out[f"pp_{key}"] = abs(got["pp"][key] - want["pp"][key]) / abs(want["pp"][key])
        return out

    def control(self) -> Dict[str, float]:
        """The readings of the reference in the program's place, stored in
        bfloat16 (the precision below the configuration's float32)."""
        lattice = ref.Lattice(self._fluid(), self.constants, dtype=torch.float32,
                              store=ref.to_bfloat16)
        return self.readings(self._outputs(lattice, self.start["steps"]))

    def release(self):
        self.start = self.last = self._ref = None

    # -- the work a substep of the configuration needs -------------------------
    def work_per_substep(self):
        return work_per_substep(self.n, self.constants.substeps)


def work_per_substep(n: int, substeps: int):
    """(bytes, flops) a substep of the n³ float32 D3Q19 deck needs at
    least: the 19 populations read and written, the medium's mask read
    (a byte a cell), and density, velocity and speed written once a step;
    ``FLOPS_PER_CELL`` a cell."""
    cells = n ** 3
    n_bytes = cells * (2 * ref.Q * FLOAT_BYTES + MASK_BYTES) \
        + cells * 5 * FLOAT_BYTES / substeps
    return n_bytes, FLOPS_PER_CELL * cells
