"""Checkpoint / resume of the full state.

A port of marlin_tpu/checkpoint.py, in its ``.npz`` layout, so a checkpoint
written by either package resumes in the other:

    buffers/<name>, old/<name>, solver/<name>   the state's arrays
    <dict>/__empty__                            marks an empty dict
    n_advances                                  int32, 0-d
    old_dt                                      the old-dt ring
    __aux__/<variable>                          INITIAL-only aux samples
    __meta__                                    JSON: time, step, dt, pp_values

The reference never serializes the tensor buffers (SURVEY §5.4); here the
whole state and the time loop's position are saved, so a run resumes bit
for bit.  Complex buffers (a carried ū, in the PALLAS kernels' permuted
order) are saved as they are.  The port keeps ``old_dt`` as Python floats
and the solvers compare dt with it exactly, so it is written in float64
whatever the buffers' precision (the JAX package writes the buffers'
dtype; either is read).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

from .state import as_numpy, from_numpy


def _flatten(tree: Dict, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            if not v:
                # an EMPTY dict (e.g. state['old'] on history-free decks)
                # must survive the round-trip or resume loses the key
                out[key + "/__empty__"] = np.zeros(0, dtype=np.uint8)
            else:
                out.update(_flatten(v, key + "/"))
        else:
            out[key] = as_numpy(v)
    return out


def _unflatten(arrays: Dict[str, np.ndarray]) -> Dict:
    root: Dict = {}
    for key, arr in arrays.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        if parts[-1] == "__empty__":
            continue  # marker: the parent dict exists but is empty
        d[parts[-1]] = arr
    return root


def save(path: str, state: Dict, time: float, step: int, dt: float,
         pp_values=None, aux_cache=None):
    """Write ``state`` (tensors fetched to the host, one transfer each) and
    the time loop's position to ``path``."""
    payload = _flatten({
        "buffers": state["buffers"],
        "old": state["old"],
        "solver": state["solver"],
    })
    payload["n_advances"] = np.asarray(state["n_advances"], dtype=np.int32)
    payload["old_dt"] = np.asarray(state["old_dt"], dtype=np.float64)
    meta = {"time": time, "step": step, "dt": dt, "pp_values": pp_values or {}}
    # host-side INITIAL-only aux-kernel samples (aux.AuxSystem._initial_cache):
    # they cannot be reconstructed after resume (the t=0 state is gone), so
    # they ride the checkpoint under a reserved prefix
    for var, arr in (aux_cache or {}).items():
        payload[f"__aux__/{var}"] = np.asarray(arr)
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    ).copy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **payload)


def load(path: str, device) -> Tuple[Dict, Dict]:
    """Returns (state, meta): the state's tensors on ``device``, its
    ``old_dt`` as Python floats; meta['aux_cache'] holds the INITIAL-only
    aux samples as numpy arrays (empty for checkpoints written without)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as f:
        arrays = {k: f[k] for k in f.files
                  if k != "__meta__" and not k.startswith("__aux__/")}
        aux = {k[len("__aux__/"):]: f[k] for k in f.files
               if k.startswith("__aux__/")}
        meta = json.loads(bytes(f["__meta__"]).decode())
    meta["aux_cache"] = aux
    return from_numpy(_unflatten(arrays), device), meta
