"""Checkpoint / resume of the full state.

A port of marlin_tpu/checkpoint.py, in its ``.npz`` layout, so a checkpoint
written by either package resumes in the other:

    buffers/<name>, old/<name>, solver/<name>   the state's arrays
    <dict>/__empty__                            marks an empty dict
    n_advances                                  int32, 0-d
    old_dt                                      the old-dt ring
    __aux__/<variable>                          INITIAL-only aux samples
    __meta__                                    JSON: time, step, dt, pp_values

On a mesh the file is the same: rank 0 writes the global arrays that
``TensorProblem.gathered_state`` puts together, and on resume every rank
reads the file and keeps its block (``TensorProblem.load_checkpoint``), so
a checkpoint resumes at any mesh size, serially, and in either package.

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
import struct
import zipfile
import zlib
from typing import Dict, Iterator, Tuple

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


def _stored_array(fh, info: zipfile.ZipInfo):
    """The array of an uncompressed member (np.savez's), read from the
    file in one call and checked against the member's CRC-32 as zipfile
    checks it; None where the member is another kind (compressed, object
    dtype, a header version numpy does not expose), for zipfile to read."""
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    fh.seek(info.header_offset)
    local = fh.read(30)
    if len(local) != 30 or local[:4] != b"PK\x03\x04":
        return None
    start = info.header_offset + 30 + sum(struct.unpack("<HH", local[26:30]))
    fh.seek(start)
    version = np.lib.format.read_magic(fh)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(fh)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(fh)
    else:
        return None
    if dtype.hasobject:
        return None
    head = fh.tell() - start
    count = int(np.prod(shape, dtype=np.int64))
    if head + count * dtype.itemsize != info.file_size:
        return None
    fh.seek(start)
    crc = zlib.crc32(fh.read(head))
    arr = np.empty(count, dtype=dtype)
    view = memoryview(arr).cast("B")
    if fh.readinto(view) != len(view):
        raise zipfile.BadZipFile(f"truncated member {info.filename!r}")
    if zlib.crc32(view, crc) != info.CRC:
        raise zipfile.BadZipFile(f"Bad CRC-32 for file {info.filename!r}")
    return arr.reshape(shape[::-1]).T if fortran else arr.reshape(shape)


def _members(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """(key, array) of each member of the ``.npz`` at ``path``, one at a
    time: what np.load gives, read straight from the file (a checkpoint's
    arrays are hundreds of MB: zipfile's reads in small pieces take twice
    as long)."""
    with zipfile.ZipFile(path) as z, open(path, "rb") as fh:
        for info in z.infolist():
            key = info.filename[:-4] if info.filename.endswith(".npy") else info.filename
            arr = _stored_array(fh, info)
            if arr is None:
                with z.open(info) as member:
                    arr = np.lib.format.read_array(member)
            yield key, arr


def load(path: str, device, select=None) -> Tuple[Dict, Dict]:
    """Returns (state, meta): the state's tensors on ``device``, its
    ``old_dt`` as Python floats; meta['aux_cache'] holds the INITIAL-only
    aux samples as numpy arrays (empty for checkpoints written without).
    ``select(key, array)`` gives the part of each state array to keep (a
    rank's block of a sharded checkpoint's global array), read one array
    at a time so that only one whole array is held at once."""
    arrays, aux, meta = {}, {}, None
    for k, a in _members(path if path.endswith(".npz") else path + ".npz"):
        if k == "__meta__":
            meta = json.loads(bytes(a).decode())
        elif k.startswith("__aux__/"):
            aux[k[len("__aux__/"):]] = a
        else:
            if select is not None:
                b = select(k, a)
                a = b.copy() if b.shape != a.shape else b
            arrays[k] = a
    if meta is None:
        raise KeyError(f"__meta__ is not a file in the archive {path!r}")
    meta["aux_cache"] = aux
    return from_numpy(_unflatten(arrays), device), meta
