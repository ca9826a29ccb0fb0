"""Structured-grid VTK export for tensor buffers.

A copy of marlin_tpu/vtk.py, the analog of the reference's
``scripts/create_vtk.py`` (which builds a
``vtkStructuredGrid`` from 2-D/3-D numpy arrays via the ``vtk`` package).
This writer emits the legacy ASCII VTK format directly — plain text, no
VTK dependency — readable by ParaView/VisIt, and supports 1-D/2-D/3-D
grids (the reference script is 2-D only).

Usage::

    from marlin_tpu_torch.vtk import write_structured_vtk
    write_structured_vtk("out.vtk", {"c": c, "mu": mu}, spacing=(h, h))

or from a problem state, whose tensors are fetched to the host::

    write_state_vtk("out.vtk", problem, state, ["c", "mu"])
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def write_structured_vtk(
    path: str,
    fields: Dict[str, np.ndarray],
    spacing: Optional[Sequence[float]] = None,
    origin: Optional[Sequence[float]] = None,
    grid_shape: Optional[Sequence[int]] = None,
):
    """Write point-centered scalar/vector fields on a uniform structured
    grid as a legacy-ASCII VTK (STRUCTURED_POINTS) file.

    fields: name -> array of shape (nx[, ny[, nz]]) for scalars or
    (*grid, dim) for vectors; every field must share the same grid shape
    (taken from the shortest-rank field, or given explicitly via
    `grid_shape` when a lone vector field would be ambiguous).
    spacing/origin default to unit cells at the origin.
    """
    if not fields:
        raise ValueError("write_structured_vtk: no fields given")
    arrays = {k: np.asarray(v) for k, v in fields.items()}
    base = grid_shape or min((a.shape for a in arrays.values()), key=len)
    base = tuple(base)
    dim = len(base)
    if dim not in (1, 2, 3):
        raise ValueError(f"unsupported grid rank {dim}")
    for name in list(arrays):
        a = arrays[name]
        if np.iscomplexobj(a):
            raise ValueError(
                f"field '{name}' is complex; legacy VTK has no complex "
                "type — export np.real/np.imag separately"
            )
        if a.ndim > dim + 1 and a.shape[:dim] == base:
            # rank-2+ tensor values: flatten the trailing value axes to
            # one component axis (emitted as per-component scalars below)
            arrays[name] = a.reshape(base + (-1,))
            continue
        if a.shape != base and a.shape[:-1] != base:
            raise ValueError(
                f"field '{name}' shape {a.shape} does not match grid {base}"
            )

    n = tuple(base) + (1,) * (3 - dim)
    spacing = tuple(spacing or ()) + (1.0,) * (3 - len(spacing or ()))
    origin = tuple(origin or ()) + (0.0,) * (3 - len(origin or ()))

    def x_fastest(a):
        """Pad an (nx[,ny[,nz]][,comp]) array to 3-D grid rank and flatten
        with x varying fastest (VTK's iteration order)."""
        comp = a.shape[dim:]  # () for scalars, (d,) for vectors
        full = a.reshape(base + (1,) * (3 - dim) + comp)
        perm = (2, 1, 0) + tuple(range(3, full.ndim))
        return full.transpose(perm).reshape((-1,) + comp)

    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("marlin_tpu tensor buffers\n")
        f.write("ASCII\n")
        f.write("DATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {n[0]} {n[1]} {n[2]}\n")
        f.write(f"ORIGIN {origin[0]} {origin[1]} {origin[2]}\n")
        f.write(f"SPACING {spacing[0]} {spacing[1]} {spacing[2]}\n")
        f.write(f"POINT_DATA {int(np.prod(n))}\n")
        for name, a in arrays.items():
            if a.shape[:-1] == base and a.ndim == dim + 1 and a.shape[-1] <= 3:
                vecs = np.zeros(a.shape[:-1] + (3,))
                vecs[..., : a.shape[-1]] = a
                f.write(f"VECTORS {name} double\n")
                for row in x_fastest(vecs):
                    f.write(f"{row[0]:.12g} {row[1]:.12g} {row[2]:.12g}\n")
            elif a.shape[:-1] == base and a.ndim == dim + 1:
                # >3 trailing components (e.g. a flattened rank-2 tensor):
                # VTK VECTORS holds exactly 3, so emit per-component scalars
                for c in range(a.shape[-1]):
                    f.write(f"SCALARS {name}_{c} double 1\n")
                    f.write("LOOKUP_TABLE default\n")
                    f.write("\n".join(f"{v:.12g}" for v in x_fastest(a[..., c])))
                    f.write("\n")
            else:
                f.write(f"SCALARS {name} double 1\n")
                f.write("LOOKUP_TABLE default\n")
                f.write("\n".join(f"{v:.12g}" for v in x_fastest(a)))
                f.write("\n")


def write_state_vtk(path: str, problem, state, buffer_names: Sequence[str]):
    """Export named buffers of a problem state (cell-centered values as
    VTK points, grid geometry from the problem's Domain); each tensor is
    fetched to the host once."""
    dom = problem.domain
    fields = {}
    for name in buffer_names:
        if name not in state["buffers"]:
            raise KeyError(f"buffer '{name}' not in state")
        fields[name] = state["buffers"][name].detach().cpu().numpy()
    write_structured_vtk(
        path, fields,
        spacing=dom.grid_spacing,
        origin=[dom.mins[d] + dom.grid_spacing[d] / 2 for d in range(dom.dim)],
        grid_shape=dom.n_global,
    )
