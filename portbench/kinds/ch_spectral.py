"""The spectral Cahn-Hilliard cells: inputs from the seed, what the timed
path produced, and its comparison with ``reference/ch_spectral.py``.

Inputs: the seed draws the modes of c(0)'s perturbation, written into
the deck as constants, so the program evaluates c(0) itself and the
reference works it out again from the same numbers.

Compared (each against the float64 reference, as a share of the
reference field's largest magnitude, or of the value itself):

- ``start_c``, ``start_mu``: c and mu after the warm-up steps, from
  c(0) (the first step first order, then the history it builds), on
  cells drawn from the seed;
- ``last_c``, ``last_mu``: the window's last step, from the c and mu the
  program held when it began (the N of the step before is worked out
  again from that mu), over the whole grid;
- ``pp_mean``, ``pp_max``: the postprocessor values the last step
  fetched, against the reference's from its own c.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import widest_gap
from ..reference import ch_spectral as ref

HBM_BYTES = 4  # float32 in the configuration
COMPLEX_BYTES = 8


class Cell:
    def __init__(self, config: Dict, seed: int, device):
        self.device = device
        sizes, c = config["sizes"], config["constants"]
        self.n = int(sizes["n"])
        self.constants = ref.Constants(
            n=self.n, dt=float(sizes["dt"]), substeps=int(sizes["substeps"]),
            rho_s=c["rho_s"], c_alpha=c["c_alpha"], c_beta=c["c_beta"],
            mobility=c["mobility"], kappa=c["kappa"])
        rng = np.random.default_rng(seed)
        pert = config["perturbation"]
        top = int(pert["max_wavenumber"])
        modes = []
        for _ in range(int(pert["modes"])):
            m = rng.integers(1, top + 1, size=3) * rng.choice([-1, 1], size=3)
            modes.append(tuple(float(2 * math.pi * v / self.n) for v in m)
                         + (float(rng.uniform(0, 2 * math.pi)),))
        self.initial = ref.InitialField(c0=c["c0"], epsilon=c["epsilon"],
                                        delta=float(pert["delta"]), modes=tuple(modes))
        self.samples = rng.integers(0, self.n ** 3, size=int(config["samples"]))
        self.start = None
        self.last = None
        self._ref = None

    # -- inputs ------------------------------------------------------------
    def deck_fields(self) -> Dict[str, str]:
        names, values, terms = [], [], []
        for i, (a, b, g, p) in enumerate(self.initial.modes):
            names += [f"a{i}", f"b{i}", f"g{i}", f"p{i}"]
            values += [repr(a), repr(b), repr(g), repr(p)]
            terms.append(f"cos(a{i}*x+b{i}*y+g{i}*z+p{i})")
        return {"n": str(self.n), "substeps": str(self.constants.substeps),
                "dt": repr(self.constants.dt), "seed_names": " ".join(names),
                "seed_values": " ".join(values), "delta": repr(self.initial.delta),
                "seed_terms": "+".join(terms)}

    def arrays(self) -> Optional[Dict[str, np.ndarray]]:
        return None

    # -- what the timed path produced ----------------------------------------
    def _index(self):
        return torch.as_tensor(self.samples, device=self.device)

    def capture_start(self, state: Dict, steps: int):
        idx = self._index()
        b = state["buffers"]
        self.start = {"steps": steps,
                      "c": b["c"].reshape(-1).index_select(0, idx).clone(),
                      "mu": b["mu"].reshape(-1).index_select(0, idx).clone()}

    def capture_last(self, state_in: Dict, state_out: Dict, values: Dict[str, float]):
        self.last = {"c_in": state_in["buffers"]["c"], "mu_in": state_in["buffers"]["mu"],
                     "c": state_out["buffers"]["c"], "mu": state_out["buffers"]["mu"],
                     "pp": {k: float(values[k]) for k in ("mean", "max")}}

    # -- the comparison ------------------------------------------------------
    def _outputs(self, solver, c0, start_steps, last) -> Dict:
        """What ``solver`` gives in the program's place: mu and c after the
        warm-up steps on the sampled cells, c and mu after the last step
        from the program's state where it began, and its postprocessors."""
        idx = self._index()
        c, mu = ref.run_from_start(solver, c0, start_steps)
        out = {"start_c": c.reshape(-1).index_select(0, idx),
               "start_mu": mu.reshape(-1).index_select(0, idx)}
        del c, mu
        n_old = solver.history_from(last["mu_in"])
        c, mu, _ = solver.step(last["c_in"], n_old, first=False)
        del n_old
        out.update(c=c, mu=mu, pp=ref.postprocessors(c))
        return out

    def _reference(self) -> Dict:
        if self._ref is None:
            solver = ref.Solver(self.constants, self.device)
            c0 = ref.initial_field(self.n, self.initial, self.device)
            self._ref = self._outputs(solver, c0, self.start["steps"], self.last)
        return self._ref

    def readings(self, got: Optional[Dict] = None) -> Dict[str, float]:
        """The compared numbers for the program's outputs, or for others in
        their place (the control's)."""
        if got is None:
            got = {"start_c": self.start["c"], "start_mu": self.start["mu"],
                   "c": self.last["c"], "mu": self.last["mu"], "pp": self.last["pp"]}
        want = self._reference()
        out = {k: widest_gap(got[k], want[k]) for k in ("start_c", "start_mu")}
        out["last_c"] = widest_gap(got["c"], want["c"])
        out["last_mu"] = widest_gap(got["mu"], want["mu"])
        for key in ("mean", "max"):
            out[f"pp_{key}"] = abs(got["pp"][key] - want["pp"][key]) / abs(want["pp"][key])
        return out

    def control(self) -> Dict[str, float]:
        """The readings of the reference in the program's place, stored in
        bfloat16 (the precision below the configuration's float32)."""
        solver = ref.Solver(self.constants, self.device, dtype=torch.float32,
                            store=ref.to_bfloat16)
        c0 = ref.initial_field(self.n, self.initial, self.device).float()
        return self.readings(self._outputs(solver, c0, self.start["steps"], self.last))

    def release(self):
        self.start = self.last = self._ref = None

    # -- the work a substep of the configuration needs -------------------------
    def work_per_substep(self):
        return work_per_substep(self.n)


def work_per_substep(n: int):
    """(bytes, flops) a substep of the n³ float32 deck needs at least:
    c read and written, the older N read and the new one written, the two
    reciprocal factors read, each over the half spectrum; two real 3-D
    transforms (mu forward, the update inverse) at 2.5 N log2 N each, mu
    at 7 flops a cell and the update at 14 a spectral point."""
    cells = n ** 3
    half = n * n * (n // 2 + 1)
    n_bytes = 2 * HBM_BYTES * cells + 2 * COMPLEX_BYTES * half + 2 * HBM_BYTES * half
    flops = 2 * 2.5 * cells * math.log2(cells) + 7 * cells + 14 * half
    return n_bytes, flops
