"""Aux-variable coupling surface.

A port of marlin_tpu/aux.py.  The reference maps tensor buffers onto MOOSE
aux variables on a conforming mesh (one FE element per grid cell) so MOOSE
postprocessors and the Exodus writer can consume spectral fields:

 - fast path `map_to_aux_variable` on a [TensorBuffers] block — direct
   solution-vector writes (reference src/problems/TensorProblem.C:250-379,
   mapBuffersToAux + updateDOFMap);
 - flexible path [AuxKernels] ProjectTensorAux — per-node/element sampling
   (reference src/auxkernels/ProjectTensorAux.C:36-71).

There is no external FE library: the "aux variable" is the sampled grid
field itself.  A nodal (LAGRANGE) variable lives on the (n+1)^dim corner
lattice, filled with the periodic wrap buffer[i % nx, j % ny, k % nz]
(exactly mapBuffersToAux' index arithmetic); an elemental (CONSTANT
MONOMIAL) variable is the raw cell field.  Both sampling paths produce
identical values on the conforming mesh, so they share one implementation.
Sampling runs on the host: ``fetch`` copies the buffers the variables read
off the device once per output.  On a mesh ``fetch`` gathers each of them
to rank 0 first (the nodal wrap indexes the whole grid, which no rank's
block holds), and rank 0 alone samples; the other ranks take part in the
gathers and keep None for an INITIAL-only sample, so that every rank
gathers the same buffers at every output.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .params import Params


class AuxError(Exception):
    pass


def _host(a) -> np.ndarray:
    """A tensor fetched to the host as numpy; numpy passes through."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class AuxVariable:
    def __init__(self, name: str, params: Params):
        self.name = name
        family = params.get_str("family", "LAGRANGE").upper()
        order = params.get_str("order", None)
        if family == "LAGRANGE":
            self.nodal = True
        elif family == "MONOMIAL":
            if order is not None and order.upper() not in ("CONSTANT", "0"):
                raise AuxError(
                    f"AuxVariable '{name}': only CONSTANT MONOMIAL is supported "
                    "(reference updateDOFMap handles nodal LAGRANGE or constant "
                    "MONOMIAL only, TensorProblem.C:511-535)"
                )
            self.nodal = False
        else:
            raise AuxError(
                f"AuxVariable '{name}': unsupported family '{family}' "
                "(LAGRANGE or MONOMIAL)"
            )


class AuxSystem:
    """Parsed [AuxVariables] + [AuxKernels] + buffer map_to_aux_variable."""

    def __init__(self, problem, root):
        self.problem = problem
        self.variables: Dict[str, AuxVariable] = {}
        self._map: Dict[str, str] = {}  # var -> buffer
        self.kernel_execute_on: Dict[str, set] = {}
        self.kernel_type: Dict[str, str] = {}
        self._initial_cache: Dict[str, np.ndarray] = {}

        av = root.children.get("AuxVariables")
        if av is not None:
            for b in av.blocks():
                self.variables[b.name] = AuxVariable(b.name, Params(b, problem.global_params))

        # buffer names that can exist at runtime: declared + any compute
        # output (implicit buffers are auto-created on first write)
        known_buffers = set(problem.buffer_specs)
        for group in (
            problem.ic_computes.members
            + problem.solve_computes
            + problem.pp_computes.members
            + problem.bc_computes
        ):
            stack = [group]
            while stack:
                m = stack.pop()
                known_buffers.update(getattr(m, "outputs", []))
                stack.extend(getattr(m, "members", []))

        # fast path: map_to_aux_variable on buffers
        for bname, spec in problem.buffer_specs.items():
            var = spec.get_str("map_to_aux_variable", None)
            if var is None:
                continue
            if var not in self.variables:
                raise AuxError(
                    f"Buffer '{bname}' maps to unknown aux variable '{var}'"
                )
            self._map[var] = bname

        # flexible path: ProjectTensorAux kernels (blocks() honors `active =`)
        ak = root.children.get("AuxKernels")
        if ak is not None:
            for b in ak.blocks():
                p = Params(b, problem.global_params)
                t = p.get_str("type", required=True)
                if t not in ("ProjectTensorAux", "ProjectVectorTensorAux"):
                    # ProjectVectorTensorAux: component-wise projection of a
                    # vector buffer (reference ProjectVectorTensorAux.C —
                    # upstream marks it "under development and not tested")
                    raise AuxError(f"Unknown AuxKernel type '{t}'")
                var = p.get_str("variable", required=True)
                buf = p.get_str("buffer", required=True)
                if var not in self.variables:
                    raise AuxError(
                        f"AuxKernel '{b.name}': unknown variable '{var}'"
                    )
                if buf not in known_buffers:
                    raise AuxError(
                        f"AuxKernel '{b.name}': unknown buffer '{buf}' "
                        f"(not declared and not produced by any compute)"
                    )
                self._map.setdefault(var, buf)
                self.kernel_type[var] = t
                self.kernel_execute_on[var] = set(
                    x.upper() for x in p.get_str_vector(
                        "execute_on", default=["INITIAL", "TIMESTEP_END"]
                    )
                )

    def __bool__(self):
        return bool(self.variables)

    def source_buffer(self, var: str) -> Optional[str]:
        """Buffer feeding aux variable `var` (None if unmapped — MOOSE would
        report zeros for such a variable)."""
        return self._map.get(var)

    def is_nodal(self, var: str) -> bool:
        return self.variables[var].nodal

    @staticmethod
    def _initial_only(exec_on) -> bool:
        """True when the kernel executes ONLY at INITIAL — the one case
        where MOOSE would never re-sample the buffer.  Kernels with other
        flags (TIMESTEP_BEGIN, FINAL, ...) are sampled live at output time
        instead of being frozen at t=0."""
        return exec_on is not None and exec_on <= {"INITIAL", "NONE"}

    def fetch(self, state) -> Dict[str, np.ndarray]:
        """The buffers that ``values`` will read for every variable, on the
        host: one transfer a buffer (an INITIAL-only variable already
        sampled reads its cache, not the state).  On a mesh each is the
        whole grid's, gathered to rank 0 (``Domain.gather_to``; every rank
        calls this), and the other ranks get an empty dict."""
        names = {buf for var, buf in self._map.items()
                 if var in self.variables and not (
                     self._initial_only(self.kernel_execute_on.get(var))
                     and var in self._initial_cache)}
        dom = self.problem.domain
        out = {}
        for b in sorted(names):
            whole = dom.gather_to(state["buffers"][b])
            if whole is not None:
                out[b] = whole.numpy()
        return out

    @property
    def samples_here(self) -> bool:
        """True where ``values`` samples: without a mesh, or on rank 0."""
        mesh = self.problem.domain.mesh
        return mesh is None or mesh.rank == 0

    def seed_initial(self, state):
        """Populate the INITIAL-only kernel cache from the actual t=0 state.
        Without this, a variable first sampled at step N > 0 (output
        interval > 1, FINAL-only outputs) would cache step-N data as its
        'initial' value."""
        initial = [var for var, exec_on in self.kernel_execute_on.items()
                   if self._initial_only(exec_on)]
        if not initial:
            return
        host = {"buffers": self.fetch(state)}
        for var in initial:
            if self.samples_here:
                self.values(host, var)
            else:
                self._initial_cache[var] = None

    def values(self, state, var: str) -> np.ndarray:
        """Sample the mapped buffer onto the variable's support, on the
        host (``state`` may hold tensors or the arrays of ``fetch``).

        Nodal: (n0+1, ..., nd+1) with periodic wrap (mapBuffersToAux index
        arithmetic, reference TensorProblem.C:338-372).  Elemental: the raw
        (n0, ..., nd) cell field; the whole grid's on a mesh, from the
        arrays of ``fetch``."""
        dom = self.problem.domain
        buf = self._map.get(var)
        n = tuple(dom.n_global)
        if buf is None:
            shape = tuple(x + 1 for x in n) if self.is_nodal(var) else n
            return np.zeros(shape)
        # an AuxKernel restricted to INITIAL keeps its first sample
        # (MOOSE only re-executes kernels on their execute_on flags)
        exec_on = self.kernel_execute_on.get(var)
        if self._initial_only(exec_on):
            if var in self._initial_cache:
                return self._initial_cache[var]
        arr = _host(state["buffers"][buf])
        if arr.ndim == dom.dim + 1 and \
                self.kernel_type.get(var) == "ProjectVectorTensorAux":
            # ProjectVectorTensorAux: component-wise sampling of a vector
            # buffer (periodic wrap applies to the spatial axes only)
            if self.is_nodal(var):
                for d in range(dom.dim):
                    idx = [slice(None)] * arr.ndim
                    idx[d] = np.arange(n[d] + 1) % n[d]
                    arr = arr[tuple(idx)]
            if self._initial_only(exec_on):
                self._initial_cache[var] = arr
            return arr
        if arr.ndim != dom.dim:
            raise AuxError(
                f"Buffer '{buf}' is not a scalar field; cannot map to aux "
                f"variable '{var}' (reference TensorProblem.C:341-346; use "
                "ProjectVectorTensorAux for vector buffers)"
            )
        if self.is_nodal(var):
            for d in range(dom.dim):
                idx = [slice(None)] * dom.dim
                idx[d] = np.arange(n[d] + 1) % n[d]
                arr = arr[tuple(idx)]
        if self._initial_only(exec_on):
            self._initial_cache[var] = arr
        return arr


def sample_at(domain, array, points):
    """Sample a (possibly vector/tensor-valued) grid field at arbitrary
    physical points by periodic multilinear interpolation, on the host.

    The capability equivalent of the reference's grid->FE-mesh coupling
    surface (SURVEY §7 stage 8): MOOSE MultiApps sample tensor buffers at
    arbitrary FE node/quadrature locations via ProjectTensorAux on a
    conforming mesh (reference src/auxkernels/ProjectTensorAux.C:36-71);
    here any point set is accepted directly.

    Parameters
    ----------
    domain : Domain
    array : (n0[,n1[,n2]][,v...]) ndarray or tensor — cell-centered field
        values.
    points : (m, dim) array of physical coordinates (wrapped periodically).

    Returns an (m[,v...]) ndarray.
    """
    arr = _host(array)
    pts = np.atleast_2d(np.asarray(points, dtype=float))
    dim = domain.dim
    if pts.shape[1] != dim:
        raise AuxError(
            f"sample_at: points must be (m, {dim}) for a {dim}-D domain, "
            f"got {pts.shape}")
    if arr.shape[:dim] != domain.shape[:dim]:
        raise AuxError(
            f"sample_at: field shape {arr.shape} does not start with the "
            f"grid shape {domain.shape}")

    # fractional cell-centered index of each point: centers sit at
    # min + (i + 1/2) h, so u = (x - min)/h - 1/2 (periodic)
    idx0, frac = [], []
    for d in range(dim):
        h = domain.grid_spacing[d]
        u = (pts[:, d] - domain.mins[d]) / h - 0.5
        i0 = np.floor(u).astype(int)
        frac.append(u - i0)
        idx0.append(i0)

    out = None
    for corner in range(1 << dim):
        w = np.ones(pts.shape[0])
        ix = []
        for d in range(dim):
            hi = (corner >> d) & 1
            w = w * (frac[d] if hi else 1.0 - frac[d])
            ix.append((idx0[d] + hi) % domain.shape[d])
        vals = arr[tuple(ix)]  # (m[, v...])
        w = w.reshape((-1,) + (1,) * (vals.ndim - 1))
        out = w * vals if out is None else out + w * vals
    return out
