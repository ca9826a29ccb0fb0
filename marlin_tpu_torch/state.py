"""Carry a state between marlin_tpu and marlin_tpu_torch.

``from_numpy`` turns the JAX package's state pytree, as numpy arrays (or
anything ``numpy.asarray`` takes), into the port's state; ``to_numpy`` does
the reverse.  A test can then start both packages from one state and diff
them after a step.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if torch.device(device).type == "cpu":
        # the state owns its memory; on another device the move copies
        a = np.array(a, copy=True)
    return torch.as_tensor(a, device=device)


def from_numpy(tree: Dict, device) -> Dict:
    """The port's state from a JAX-package state pytree of arrays."""
    return {
        "buffers": {k: _tensor(v, device) for k, v in tree["buffers"].items()},
        "old": {k: _tensor(v, device) for k, v in tree["old"].items()},
        "n_advances": int(np.asarray(tree["n_advances"])),
        "old_dt": tuple(float(x) for x in np.asarray(tree["old_dt"]).ravel()),
        "solver": {k: _solver_entry(v, device)
                   for k, v in tree.get("solver", {}).items()},
    }


def _solver_entry(a, device):
    """An iterative solver's 0-d integer or bool counts become the host
    values the port keeps; arrays (Broyden's M, the LBM residual) tensors."""
    a = np.asarray(a)
    if a.ndim == 0 and a.dtype == np.bool_:
        return bool(a)
    if a.ndim == 0 and np.issubdtype(a.dtype, np.integer):
        return int(a)
    return _tensor(a, device)


def as_numpy(v) -> np.ndarray:
    """A state entry as numpy: a tensor fetched, an iterative solver's host
    count (int or bool) in the JAX package's dtype."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v, dtype=bool if isinstance(v, bool) else np.int32)


def to_numpy(state: Dict) -> Dict:
    """The JAX-package layout of a port state, as numpy arrays; ``old_dt``
    takes the dtype of the real buffers."""
    reals = [as_numpy(v[:0]) for v in state["buffers"].values()
             if v.is_floating_point()]
    float_dtype = reals[0].dtype if reals else np.float64
    return {
        "buffers": {k: as_numpy(v) for k, v in state["buffers"].items()},
        "old": {k: as_numpy(v) for k, v in state["old"].items()},
        "n_advances": np.asarray(state["n_advances"], dtype=np.int32),
        "old_dt": np.asarray(state["old_dt"], dtype=float_dtype),
        "solver": {k: as_numpy(v) for k, v in state["solver"].items()},
    }
