"""Minimal Exodus II writer/reader (pure Python, scipy netCDF3).

A copy of marlin_tpu/exodus.py; ``ExodusOutput`` fetches the buffers its
aux variables read to the host once per output (``AuxSystem.fetch``).  On
a mesh the fetch gathers the whole grid's fields to rank 0, which alone
keeps the series and writes ``<file_base>.e`` over the whole grid.

Exodus II is netCDF3-classic underneath; this module writes the subset MOOSE
emits for `[Outputs] exodus = true` (reference uses libMesh's ExodusII_IO):
conforming uniform mesh (EDGE2/QUAD4/HEX8, one element per grid cell), nodal
and elemental variables per timestep, and postprocessors as global
variables.  The reader is the test-side "exodiff" used to compare against
the reference's gold .e files (reference test/tests/cahnhilliard/tests
map_to_aux_2d/map_to_aux_3d/project_tensor specs).
"""

from __future__ import annotations

import numpy as np

LEN_NAME = 256


def _pad_names(names, width=LEN_NAME):
    out = np.zeros((len(names), width), dtype="S1")
    for i, n in enumerate(names):
        b = n.encode()[: width - 1]
        out[i, : len(b)] = np.frombuffer(b, dtype="S1")
    return out


def _grid_mesh(domain):
    """Nodes + connectivity of the conforming mesh (x-fastest node order,
    matching libMesh's generated mesh as seen in the reference golds)."""
    dim = domain.dim
    n = tuple(domain.n_global)
    h = domain.grid_spacing
    mins = domain.mins if hasattr(domain, "mins") else [0.0] * dim
    nn = [x + 1 for x in n]

    axes = [mins[d] + h[d] * np.arange(nn[d]) for d in range(dim)]
    # node coordinates, x fastest
    grids = np.meshgrid(*axes, indexing="ij") if dim > 1 else [axes[0]]
    coords = [g.flatten(order="F") for g in grids]

    def nid(idx):  # 1-based node id from (i[,j[,k]])
        i = idx[0]
        r = i
        if dim > 1:
            r += idx[1] * nn[0]
        if dim > 2:
            r += idx[2] * nn[0] * nn[1]
        return r + 1

    elems = []
    if dim == 1:
        elem_type = "EDGE2"
        for i in range(n[0]):
            elems.append([nid((i,)), nid((i + 1,))])
    elif dim == 2:
        elem_type = "QUAD4"
        for j in range(n[1]):
            for i in range(n[0]):
                elems.append(
                    [nid((i, j)), nid((i + 1, j)), nid((i + 1, j + 1)), nid((i, j + 1))]
                )
    else:
        elem_type = "HEX8"
        for k in range(n[2]):
            for j in range(n[1]):
                for i in range(n[0]):
                    base = [
                        nid((i, j, k)), nid((i + 1, j, k)),
                        nid((i + 1, j + 1, k)), nid((i, j + 1, k)),
                    ]
                    top = [
                        nid((i, j, k + 1)), nid((i + 1, j, k + 1)),
                        nid((i + 1, j + 1, k + 1)), nid((i, j + 1, k + 1)),
                    ]
                    elems.append(base + top)
    return coords, np.asarray(elems, dtype=np.int32), elem_type


def write_exodus(path, domain, times, nodal=None, elem=None, glo=None, title=None):
    """Write an Exodus II file.

    nodal: {name: list of (n0+1, ..) arrays per frame} (x-fastest flattened)
    elem:  {name: list of (n0, ..) arrays per frame}
    glo:   {name: list of scalars per frame}
    """
    from scipy.io import netcdf_file

    nodal = nodal or {}
    elem = elem or {}
    glo = glo or {}
    coords, connect, elem_type = _grid_mesh(domain)
    num_nodes = len(coords[0])
    num_elem = connect.shape[0]

    f = netcdf_file(path, "w", version=2, maskandscale=False)
    f.title = (title or path).encode()
    f.api_version = np.float32(8.11)
    f.version = np.float32(8.11)
    f.floating_point_word_size = np.int32(8)
    f.file_size = np.int32(1)
    f.int64_status = np.int32(0)
    # names live in a 256-wide len_name dimension; advertising 32
    # here would make ex_get_names readers truncate longer names
    f.maximum_name_length = np.int32(255)

    f.createDimension("time_step", None)  # scipy: unlimited dim must be first
    f.createDimension("len_name", LEN_NAME)
    f.createDimension("num_dim", domain.dim)
    f.createDimension("num_nodes", num_nodes)
    f.createDimension("num_elem", num_elem)
    f.createDimension("num_el_blk", 1)
    f.createDimension("num_el_in_blk1", num_elem)
    f.createDimension("num_nod_per_el1", connect.shape[1])

    v = f.createVariable("time_whole", "d", ("time_step",))
    v[:] = np.asarray(times, dtype=np.float64)

    eb = f.createVariable("eb_status", "i", ("num_el_blk",))
    eb[:] = [1]
    ebp = f.createVariable("eb_prop1", "i", ("num_el_blk",))
    ebp[:] = [1]
    ebp.name = b"ID"

    names = "xyz"[: domain.dim]
    for d, ax in enumerate(names):
        cv = f.createVariable("coord" + ax, "d", ("num_nodes",))
        cv[:] = coords[d]
    cn = f.createVariable("coor_names", "c", ("num_dim", "len_name"))
    cn[:] = _pad_names(list(names))
    ebn = f.createVariable("eb_names", "c", ("num_el_blk", "len_name"))
    ebn[:] = _pad_names([""])

    nm = f.createVariable("node_num_map", "i", ("num_nodes",))
    nm[:] = np.arange(1, num_nodes + 1, dtype=np.int32)
    cv = f.createVariable("connect1", "i", ("num_el_in_blk1", "num_nod_per_el1"))
    cv[:] = connect
    cv.elem_type = elem_type.encode()
    em = f.createVariable("elem_num_map", "i", ("num_elem",))
    em[:] = np.arange(1, num_elem + 1, dtype=np.int32)

    nod_names = sorted(nodal)
    elem_names = sorted(elem)
    glo_names = sorted(glo)
    n_frames = len(times)

    if nod_names:
        f.createDimension("num_nod_var", len(nod_names))
        nv = f.createVariable("name_nod_var", "c", ("num_nod_var", "len_name"))
        nv[:] = _pad_names(nod_names)
        for i, name in enumerate(nod_names):
            var = f.createVariable(
                f"vals_nod_var{i + 1}", "d", ("time_step", "num_nodes")
            )
            for t in range(n_frames):
                var[t] = np.asarray(nodal[name][t], dtype=np.float64).flatten(order="F")
    if elem_names:
        f.createDimension("num_elem_var", len(elem_names))
        ev = f.createVariable("name_elem_var", "c", ("num_elem_var", "len_name"))
        ev[:] = _pad_names(elem_names)
        for i, name in enumerate(elem_names):
            var = f.createVariable(
                f"vals_elem_var{i + 1}eb1", "d", ("time_step", "num_el_in_blk1")
            )
            for t in range(n_frames):
                var[t] = np.asarray(elem[name][t], dtype=np.float64).flatten(order="F")
        tab = f.createVariable("elem_var_tab", "i", ("num_el_blk", "num_elem_var"))
        tab[:] = np.ones((1, len(elem_names)), dtype=np.int32)
    if glo_names:
        f.createDimension("num_glo_var", len(glo_names))
        gv = f.createVariable("name_glo_var", "c", ("num_glo_var", "len_name"))
        gv[:] = _pad_names(glo_names)
        var = f.createVariable("vals_glo_var", "d", ("time_step", "num_glo_var"))
        for t in range(n_frames):
            var[t] = [float(glo[name][t]) for name in glo_names]
    f.close()


def read_exodus(path):
    """Read the variable data out of an Exodus II file (test-side exodiff)."""
    from scipy.io import netcdf_file

    f = netcdf_file(path, mmap=False, maskandscale=False)

    def names(var):
        if var not in f.variables:
            return []
        return [
            bytes(row).decode().split("\x00", 1)[0] for row in f.variables[var][:]
        ]

    out = {
        "time": np.array(f.variables["time_whole"][:], dtype=np.float64),
        "coords": {
            ax: np.array(f.variables["coord" + ax][:], dtype=np.float64)
            for ax in "xyz"
            if "coord" + ax in f.variables
        },
        "connect": np.array(f.variables["connect1"][:])
        if "connect1" in f.variables
        else None,
        "nodal": {},
        "elem": {},
        "glo": {},
    }
    for i, n in enumerate(names("name_nod_var")):
        out["nodal"][n] = np.array(f.variables[f"vals_nod_var{i + 1}"][:], dtype=np.float64)
    for i, n in enumerate(names("name_elem_var")):
        out["elem"][n] = np.array(
            f.variables[f"vals_elem_var{i + 1}eb1"][:], dtype=np.float64
        )
    gnames = names("name_glo_var")
    if gnames:
        g = np.array(f.variables["vals_glo_var"][:], dtype=np.float64)
        for i, n in enumerate(gnames):
            out["glo"][n] = g[:, i]
    f.close()
    return out


class ExodusOutput:
    """`[Outputs] exodus = true`: accumulate aux-variable frames during the
    transient and write <file_base>.e at finalize (the reference streams via
    libMesh ExodusII_IO; the content is equivalent)."""

    wants_pp_values = True

    def __init__(self, path, problem, title=None):
        self.path = path
        self.problem = problem
        self.title = title or path.rsplit("/", 1)[-1]
        self.times = []
        self.nodal = {}
        self.elem = {}
        self.glo = {}

    def output(self, problem, state, time, initial=False, pp_values=None):
        aux = problem.aux
        dim = problem.domain.dim
        state = {"buffers": aux.fetch(state)}  # every rank: the gathers
        if not aux.samples_here:
            return
        self.times.append(float(time))
        for var in aux.variables:
            vals = aux.values(state, var)
            target = self.nodal if aux.is_nodal(var) else self.elem
            if vals.ndim == dim + 1:  # vector variable -> per-component
                comps = "xyz" if vals.shape[-1] <= 3 else None
                for i in range(vals.shape[-1]):
                    suffix = comps[i] if comps else str(i)
                    target.setdefault(f"{var}_{suffix}", []).append(vals[..., i])
            else:
                target.setdefault(var, []).append(vals)
        for name, val in (pp_values or {}).items():
            self.glo.setdefault(name, []).append(float(val))

    def finalize(self):
        if not self.times:
            return
        # pad global-variable series that appeared late
        for name, series in self.glo.items():
            while len(series) < len(self.times):
                series.insert(0, 0.0)
        write_exodus(
            self.path,
            self.problem.domain,
            self.times,
            nodal=self.nodal,
            elem=self.elem,
            glo=self.glo,
            title=self.title,
        )
