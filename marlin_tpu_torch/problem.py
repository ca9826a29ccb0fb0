"""TensorProblem: owns buffers, computes, solver, postprocessors.

The spectral and lattice Boltzmann halves of marlin_tpu/problem.py, run
eagerly on torch tensors (reference src/problems/TensorProblem.C and
LatticeBoltzmannProblem.C).  It turns a parsed deck into a state dict with
the JAX package's keys

    state = {"buffers": {...}, "old": {...}, "n_advances": int,
             "old_dt": (float, ...), "solver": {...}}

and advances it one MOOSE timestep at a time.  Deck features outside the
ported slice fail at build with a named error (UNSUPPORTED_BLOCKS and the
checks in ``__init__``), never by being skipped.

An LBM problem (``[Problem] type = LatticeBoltzmannProblem``) runs
``substeps`` lattice updates a step, from the second step on: stream,
boundary conditions, then the solve chain.  With ``lbm_backend = PALLAS``
all but the last substep of a step go through the fused kernel of
``lbm_fused.py`` (the JAX package's backend name, kept so decks run
unchanged); the default ``JNP`` runs every substep through the eager chain.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import computes as _computes_pkg  # noqa: F401  (registers compute types)
from . import lbm_fused
from . import postprocessors as _pp_pkg  # noqa: F401  (registers pp types)
from . import solvers as _solvers_pkg  # noqa: F401  (registers solver types)
from . import stencils as _stencils_pkg  # noqa: F401  (registers stencils)
from .computes.base import ComputeGroup, Spec, TensorCompute
from .domain import FFT_BACKENDS, PARALLEL_MODES, PRECISIONS, Domain
from .hit import HitNode
from .params import Params
from .postprocessors import Postprocessor
from .registry import computes as compute_registry
from .registry import postprocessors as pp_registry
from .registry import solvers as solver_registry
from .registry import stencils as stencil_registry
from .solvers.base import advance_state


class ProblemError(Exception):
    pass


#: deck blocks whose features are not ported to marlin_tpu_torch yet
UNSUPPORTED_BLOCKS = {
    "TensorOutputs": "XDMF/HDF5 field outputs",
    "AuxVariables": "the aux-variable (Exodus) coupling surface",
    "AuxKernels": "the aux-variable (Exodus) coupling surface",
    "Functions": "MOOSE functions",
    "VectorPostprocessors": "vector postprocessors",
    "TensorTimeIntegrators": "legacy [TensorTimeIntegrators] blocks",
}


def build_domain(node: Optional[HitNode], device=None) -> Domain:
    """The Domain of a deck's [Domain] block
    (marlin_tpu/problem.py:build_domain)."""
    if node is None:
        raise ProblemError("Missing [Domain] block")
    p = Params(node)
    return Domain(
        dim=p.get_int("dim", required=True),
        n=[p.get_int("nx", 1), p.get_int("ny", 1), p.get_int("nz", 1)],
        mins=[p.get_float("xmin", 0.0), p.get_float("ymin", 0.0),
              p.get_float("zmin", 0.0)],
        maxs=[p.get_float("xmax", 1.0), p.get_float("ymax", 1.0),
              p.get_float("zmax", 1.0)],
        parallel_mode=p.get_enum("parallel_mode", PARALLEL_MODES, "NONE"),
        floating_precision=p.get_enum("floating_precision", PRECISIONS,
                                      "DEVICE_DEFAULT"),
        fft_backend=p.get_enum("fft_backend", FFT_BACKENDS, "DEFAULT"),
        device=device,
    )


class TensorProblem:
    """``deck_dir`` resolves relative ``file =`` paths of LBM buffers;
    ``arrays`` maps a dataset name (the file's stem) to an array read in
    place of that HDF5 file, so a caller with the data in memory needs no
    file and no h5py."""

    def __init__(self, root: HitNode, device=None, deck_dir: Optional[str] = None,
                 arrays: Optional[Dict[str, np.ndarray]] = None):
        for block, what in UNSUPPORTED_BLOCKS.items():
            if block in root.children:
                raise ProblemError(
                    f"[{block}] ({what}) is not ported to marlin_tpu_torch yet")
        gp = root.children.get("GlobalParams")
        self.global_params = dict(gp.params) if gp is not None else {}

        self.domain = build_domain(root.children.get("Domain"), device=device)

        # -- problem-level constants (reference TensorProblem.C:38-39,57-60)
        self.constants: Dict[str, float] = {}
        prob = root.children.get("Problem")
        self.problem_params = Params(prob, self.global_params)
        ptype = self.problem_params.get_str("type", "TensorProblem")
        if ptype not in ("TensorProblem", "LatticeBoltzmannProblem"):
            raise ProblemError(
                f"[Problem] type = {ptype} is not ported to marlin_tpu_torch yet")
        self.deck_dir = deck_dir
        self.arrays = dict(arrays or {})
        self.is_lbm = ptype == "LatticeBoltzmannProblem"
        # LBM problem options (reference LatticeBoltzmannProblem.C:14-33)
        self.lbm_substeps = self.problem_params.get_int("substeps", 1)
        self.lbm_tolerance = self.problem_params.get_float("tolerance", 1.0e-15)
        self.lbm_binary_media = self.problem_params.get_str("binary_media", None)
        # the fused substep kernel (lbm_fused.py) under the JAX package's
        # backend name
        self.lbm_backend = self.problem_params.get_enum(
            "lbm_backend", ["JNP", "PALLAS"], "JNP"
        )
        self._lbm_fused_plan = None
        self._lbm_solid_mask = None
        self._lbm_media = None
        if self.problem_params.get_bool("batch_fft", False):
            raise ProblemError(
                "[Problem] batch_fft = true is not ported to marlin_tpu_torch yet")
        names = self.problem_params.get_str_vector("scalar_constant_names")
        values = self.problem_params.get_float_vector("scalar_constant_values")
        if len(names) != len(values):
            raise ProblemError("scalar_constant_names/values length mismatch")
        self.constants.update(dict(zip(names, values)))
        self._fetched_constants: List[str] = []

        # -- explicit buffers ----------------------------------------------
        self.buffer_specs: Dict[str, Params] = {}
        tb = root.children.get("TensorBuffers")
        if tb is not None:
            for b in tb.blocks():
                spec = Params(b, self.global_params)
                btype = spec.get_str("type", "PlainTensorBuffer")
                if btype not in ("PlainTensorBuffer", "LBMTensorBuffer"):
                    raise ProblemError(
                        f"[TensorBuffers/{b.name}] type = {btype} is not "
                        "ported to marlin_tpu_torch yet (PlainTensorBuffer "
                        "and LBMTensorBuffer only)")
                self.buffer_specs[b.name] = spec

        # -- stencils (LBM) -------------------------------------------------
        self.stencils = {}
        st = root.children.get("Stencil")
        if st is not None:
            for b in st.blocks():
                p = Params(b, self.global_params)
                self.stencils[b.name] = stencil_registry.create(
                    p.get_str("type", required=True), b.name, p, self
                )

        # -- computes -------------------------------------------------------
        tc = root.children.get("TensorComputes")
        ic_nodes = tc.children.get("Initialize") if tc else None
        solve_nodes = tc.children.get("Solve") if tc else None
        pp_nodes = tc.children.get("Postprocess") if tc else None
        bc_nodes = tc.children.get("Boundary") if tc else None
        self.ic_computes = self._build_group("_initialize", ic_nodes)
        self.solve_computes = (
            [self._build_compute(b) for b in solve_nodes.blocks()]
            if solve_nodes is not None
            else []
        )
        self.pp_computes = self._build_group("_postprocess", pp_nodes)
        self.bc_computes = (
            [self._build_compute(b) for b in bc_nodes.blocks()]
            if bc_nodes is not None
            else []
        )
        if self.is_lbm:
            # the substep's boundary and solve chains, dependency-sorted
            # once (marlin_tpu/problem.py:_lbm_step_impl sorts them per trace)
            gp = Params(None, self.global_params)
            self._lbm_bcs = ComputeGroup("_lbm_bc", gp, self, self.bc_computes).sort()
            self._lbm_solves = ComputeGroup("_lbm_solve", gp, self,
                                            self.solve_computes).sort()

        # -- solver ---------------------------------------------------------
        self.solver = None
        ts = root.children.get("TensorSolver")
        if ts is not None:
            params = Params(ts, self.global_params)
            cls = solver_registry.get(params.get_str("type", required=True))
            self.solver = cls(ts.name, params, self)
            if "Predictors" in ts.children:
                raise ProblemError(
                    "[TensorSolver/Predictors] is not ported to "
                    "marlin_tpu_torch yet")
            root_name = params.get_str("root_compute")
            if root_name is not None:
                named = {c.name: c for c in self.solve_computes}
                if root_name not in named:
                    raise ProblemError(f"root_compute '{root_name}' not found")
                root_compute = named[root_name]
            else:
                root_compute = ComputeGroup(
                    "_solve_root", Params(None, self.global_params), self,
                    self.solve_computes)
            if isinstance(root_compute, ComputeGroup):
                root_compute.sort()
            self.solver.bind(root_compute)
            if getattr(self.solver, "carry_reciprocal", False):
                self.solver.prune_reciprocal_ffts()

        # -- postprocessors --------------------------------------------------
        self.postprocessors: List[Postprocessor] = []
        pps = root.children.get("Postprocessors")
        if pps is not None:
            for b in pps.blocks():
                p = Params(b, self.global_params)
                self.postprocessors.append(
                    pp_registry.create(p.get_str("type", required=True), b.name, p, self)
                )

    # ------------------------------------------------------------------
    def _build_compute(self, node: HitNode) -> TensorCompute:
        params = Params(node, self.global_params)
        tname = params.get_str("type")
        if tname is None or tname == "ComputeGroup":
            members = [self._build_compute(b) for b in node.blocks()]
            return ComputeGroup(node.name, params, self, members)
        cls = compute_registry.get(tname)
        return cls(node.name, params, self)

    def _build_group(self, name: str, node: Optional[HitNode]) -> ComputeGroup:
        members = [self._build_compute(b) for b in node.blocks()] if node is not None else []
        return ComputeGroup(name, Params(None, self.global_params), self, members)

    # -- services used by computes ------------------------------------------
    def lbm_stencil(self):
        if len(self.stencils) != 1:
            raise ProblemError(
                "LatticeBoltzmannProblem requires exactly one [Stencil] block"
            )
        return next(iter(self.stencils.values()))

    def lbm_solid_mask(self) -> Optional[torch.Tensor]:
        """Static solid mask (binary_media == 0), a bool tensor on the
        device, or None (reference maskedFillSolids is a no-op without
        binary media)."""
        return self._lbm_solid_mask

    def lbm_media(self) -> Optional[torch.Tensor]:
        """The binary media as an int8 code on the device, (nx, ny, nz):
        0 solid (media == 0), 1 fluid (media >= 1), -1 neither (negative
        ids), or None.  Captured once; the fused kernel reads it as is."""
        return self._lbm_media

    def get_constant(self, name: str) -> float:
        """Fetch a named constant; fetch-before-declare is reported at init
        (reference TensorProblem.C:156-166)."""
        if name not in self.constants:
            try:
                return float(name)
            except ValueError:
                if name not in self._fetched_constants:
                    self._fetched_constants.append(name)
                return 0.0
        return self.constants[name]

    def declared_buffer_shape(self, name: str):
        """Full declared shape of an explicitly declared buffer, or None."""
        spec = self.buffer_specs.get(name)
        if spec is None:
            return None
        if self._is_lbm_buffer(spec):
            return self._lbm_buffer_shape(spec)
        vdims = spec.get_int_vector("value_dimensions", [])
        if spec.get_bool("reciprocal", False):
            return self.domain.reciprocal_value_shape(vdims)
        return self.domain.value_shape(vdims)

    @staticmethod
    def _is_lbm_buffer(spec: Params) -> bool:
        return (spec.get_str("type", "PlainTensorBuffer") == "LBMTensorBuffer"
                or spec.has("buffer_type"))

    def _lbm_buffer_shape(self, spec: Params):
        dom = self.domain
        btype = spec.get_str("buffer_type", required=True)
        shape = list(dom.shape)
        while len(shape) < 3:
            shape.append(1)
        if btype == "df":
            shape.append(self.lbm_stencil().q)
        elif btype == "mv":
            shape.append(dom.dim)
        elif btype != "ms":
            raise ProblemError(f"Buffer type {btype} is not recognized")
        return tuple(shape)

    def _init_lbm_buffer(self, spec: Params) -> torch.Tensor:
        """LBM buffer: df -> trailing q, mv -> trailing dim, ms -> scalar;
        always 3 spatial dims (reference LBMTensorBuffer::init :96-125)."""
        shape = self._lbm_buffer_shape(spec)
        dtype = torch.int64 if spec.get_bool("is_integer", False) else self.domain.dtype
        if spec.has("file"):
            data = np.asarray(self._read_lbm_h5(spec.get_str("file")))
            if data.ndim < 3:
                data = data.reshape(data.shape + (1,) * (3 - data.ndim))
            return torch.as_tensor(data).to(device=self.domain.device, dtype=dtype)
        return self._zeros(shape, dtype)

    def _read_lbm_h5(self, path: str):
        """Read the dataset named like the file stem (reference
        LBMTensorBuffer::readTensorFromHdf5 :159-233), or take it from
        ``arrays``; a ``.npy`` file is read with numpy (no h5py needed)."""
        dataset = os.path.splitext(os.path.basename(path))[0]
        if dataset in self.arrays:
            return self.arrays[dataset]
        if not os.path.isabs(path):
            path = os.path.join(self.deck_dir or ".", path)
        if path.endswith(".npy"):
            return np.load(path)
        try:
            import h5py
        except ImportError as e:
            raise ProblemError(
                f"reading the LBM buffer file '{path}' needs h5py, which is "
                "not installed (or pass the data as arrays=, or as .npy)") from e
        with h5py.File(path, "r") as f:
            return f[dataset][...]

    def _capture_lbm_media(self, buffers):
        """The solid mask and the media code of ``lbm_binary_media`` from
        the binary-media buffer (marlin_tpu/problem.py:_capture_lbm_media)."""
        if not self.is_lbm or self.lbm_binary_media is None:
            return
        media = buffers[self.lbm_binary_media]
        while media.ndim < 3:
            media = media[..., None]
        self._lbm_solid_mask = media == 0
        self._lbm_media = torch.where(
            media == 0, 0, torch.where(media >= 1, 1, -1)).to(torch.int8).contiguous()

    def check_constants(self):
        missing = [n for n in self._fetched_constants if n not in self.constants]
        if len(missing) == 1:
            raise ProblemError(
                f"Constant {missing[0]} was requested but never declared."
            )
        if missing:
            raise ProblemError(
                f"Constants {', '.join(missing)} were requested but never declared."
            )

    def history_requests(self) -> Dict[str, int]:
        """The solver's and every compute's requests, deepest wins
        (marlin_tpu/problem.py:history_requests)."""
        req: Dict[str, int] = {}

        def merge(d):
            for k, v in d.items():
                req[k] = max(req.get(k, 0), v)

        if self.solver is not None:
            merge(self.solver.history_requests())

        def walk(members):
            for m in members:
                if isinstance(m, ComputeGroup):
                    walk(m.members)
                elif hasattr(m, "history_requests"):
                    merge(m.history_requests())

        walk(self.solve_computes)
        walk(self.bc_computes)
        walk([self.pp_computes, self.ic_computes])
        return req

    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=dtype, device=self.domain.device)

    # ------------------------------------------------------------------
    def init_state(self) -> Dict:
        """Build the initial state: zero buffers, run ICs, give derived
        buffers their shapes, allocate history stacks
        (marlin_tpu/problem.py:init_state; reference TensorProblem.C:74-151)."""
        self.check_constants()
        dom = self.domain
        buffers: Dict[str, torch.Tensor] = {}
        for name, spec in self.buffer_specs.items():
            if self._is_lbm_buffer(spec):
                buffers[name] = self._init_lbm_buffer(spec)
                continue
            dtype = dom.cdtype if spec.get_bool("reciprocal", False) else dom.dtype
            buffers[name] = self._zeros(self.declared_buffer_shape(name), dtype)

        # LBM binary media is available before ICs (file-loaded buffers,
        # reference LatticeBoltzmannProblem::init :60-68) so IC computes
        # mask solids; re-captured after ICs in case an IC updates it
        self._capture_lbm_media(buffers)

        # initial conditions in dependency order
        self.ic_computes.sort()
        ic_outputs = self.ic_computes.apply(buffers, {"t": 0.0})
        buffers.update(ic_outputs)

        if self.is_lbm:
            # ICs written with 2-D computes land at the bare grid shape;
            # give each LBM buffer its declared (nx, ny, nz[, k]) shape
            for name, spec in self.buffer_specs.items():
                if not self._is_lbm_buffer(spec) or name not in buffers:
                    continue
                want = self._lbm_buffer_shape(spec)
                cur = buffers[name]
                if tuple(cur.shape) != want and cur.numel() == math.prod(want):
                    buffers[name] = cur.reshape(want)
            self._capture_lbm_media(buffers)

        # derived buffers start as zeros with the shapes one evaluation of
        # the solve and postprocess chains produces (the reference
        # zero-inits every buffer; marlin_tpu needs final shapes for jit)
        solve_all = ComputeGroup(
            "_all_solve", Params(None, self.global_params), self, self.solve_computes
        ).sort()
        groups = [solve_all, self.pp_computes.sort()]
        self._shape_complete(groups, buffers, set(ic_outputs))

        if self.solver is not None:
            for b in self.solver.extra_input_buffers() + self.solver.output_buffers():
                if b not in buffers:
                    buffers[b] = self._zeros(dom.shape, dom.dtype)

        old = {}
        old_max = 0
        for name, n_states in self.history_requests().items():
            if name not in buffers:
                raise ProblemError(f"History requested for unknown buffer '{name}'")
            cur = buffers[name]
            old[name] = self._zeros((n_states,) + tuple(cur.shape), cur.dtype)
            old_max = max(old_max, n_states)
        solver_state = {}
        if self.is_lbm:
            # convergence residual starts at 1 (reference
            # LatticeBoltzmannProblem _convergence_residual initial value)
            solver_state["residual"] = torch.ones((), dtype=dom.dtype,
                                                  device=dom.device)
        return {
            "buffers": buffers,
            "old": old,
            "n_advances": 0,
            "old_dt": (0.0,) * old_max,
            "solver": solver_state,
        }

    def _shape_complete(self, groups, buffers, ic_outputs):
        """Give each buffer the solve and postprocess chains derive zeros of
        the shape and dtype one evaluation would give it, computed by the
        computes' shape rules without running them (marlin_tpu uses
        jax.eval_shape here)."""
        dom = self.domain
        scope = {k: Spec(tuple(v.shape), v.dtype) for k, v in buffers.items()}
        derived: Dict[str, Spec] = {}
        for g in groups:
            for m in g.sorted_members:
                for b in m.inputs:
                    if b not in scope:
                        # implicit buffer creation: the reference
                        # auto-creates a zeros PlainTensorBuffer
                        scope[b] = derived[b] = Spec(dom.shape, dom.dtype)
                for name, spec in m.output_specs(scope).items():
                    scope[name] = spec
                    if name not in ic_outputs:
                        derived[name] = spec
                    elif tuple(buffers[name].shape) != spec.shape:
                        raise ProblemError(
                            f"Compute '{m.name}' produces shape {spec.shape} "
                            f"for buffer '{name}' but its IC produced "
                            f"{tuple(buffers[name].shape)}.")
        for name, spec in derived.items():
            cur = buffers.get(name)
            if cur is None or tuple(cur.shape) != spec.shape or cur.dtype != spec.dtype:
                buffers[name] = self._zeros(spec.shape, spec.dtype)

    # ------------------------------------------------------------------
    def step(self, state, t, dt, dt_old, first_step: bool):
        """One full timestep (marlin_tpu/problem.py:_step_impl)."""
        if self.is_lbm:
            return self._lbm_step(state, t, dt, first_step)
        if not first_step:
            state = advance_state(state, dt)
        if self.solver is not None:
            return self.solver.step(state, t, dt, dt_old, first_step)
        # no solver: run all solve computes once per step (reference
        # TensorProblem::execute else-branch, :185-188)
        buffers = dict(state["buffers"])
        ctx = {"t": t, "old": state["old"], "n_advances": state["n_advances"]}
        for c in self.solve_computes:
            buffers.update(c.apply(buffers, ctx))
        return {**state, "buffers": buffers}

    def _lbm_step(self, state, t, dt, first_step: bool):
        """One MOOSE timestep of the LBM problem: `lbm_substeps` substeps
        (marlin_tpu/problem.py:_lbm_step_impl; reference
        LatticeBoltzmannProblem::execute :103-131).  Substeps run from MOOSE
        step 2 on (reference `timeStep() > 1`)."""
        if first_step:
            return state
        state = advance_state(state, dt)  # MOOSE-level advance
        if self.lbm_backend == "PALLAS" and self.lbm_substeps > 1:
            state = self._lbm_fused_substeps(state)
            # the LAST substep runs the eager chain, so every deck buffer
            # (f, density, velocity, feq, speed) and the old-state ring are
            # exactly as the unfused path leaves them
            return self._lbm_substep(state, t, dt)
        for _ in range(self.lbm_substeps):
            state = self._lbm_substep(state, t, dt)
        return state

    def _lbm_substep(self, state, t, dt):
        """advance -> stream -> boundary conditions -> solve chain."""
        state = advance_state(state, dt)
        if self.solver is not None and hasattr(self.solver, "stream"):
            state = self.solver.stream(state)
        ctx = {"t": t, "old": state["old"], "n_advances": state["n_advances"]}
        buffers = dict(state["buffers"])
        for bc in self._lbm_bcs.sorted_members:
            buffers.update(bc.apply(buffers, ctx))
        buffers.update(self._lbm_solves.apply(buffers, ctx))
        solver_state = dict(state["solver"])
        if "__residual__" in buffers:
            solver_state["residual"] = buffers.pop("__residual__")
        return {**state, "buffers": buffers, "solver": solver_state}

    def _lbm_fused_substeps(self, state):
        """Substeps 0..n-2 through the fused kernel (lbm_fused.py), carrying
        only fpc (and on thermal decks gpc), q-major, and the carried scalar
        (marlin_tpu/problem.py:_lbm_fused_substeps)."""
        if self._lbm_fused_plan is None:
            self._lbm_fused_plan = lbm_fused.match_chain(self)
        plan = self._lbm_fused_plan
        cfg = plan.config
        n_fused = self.lbm_substeps - 1

        # the trailing eager substep refreshes slot 0 of every depth-1
        # ring, so skipping the fused substeps' pushes is invisible; deeper
        # rings would retain skipped history and are rejected
        if len(state["old_dt"]) > 1:
            raise lbm_fused.FusedChainError(
                "lbm_backend = PALLAS supports dt-history depth <= 1"
            )
        for name, stack in state["old"].items():
            if stack.shape[0] != 1:
                raise lbm_fused.FusedChainError(
                    f"lbm_backend = PALLAS supports history depth 1 (got "
                    f"{stack.shape[0]} for '{name}')"
                )
        # buffers other than the carried set go stale during the fused
        # substeps, so history on them would record whole-step differences
        allowed_old = {plan.fpc, plan.fpc2, plan.speed}
        extra_old = set(state["old"]) - allowed_old
        if extra_old:
            raise lbm_fused.FusedChainError(
                f"lbm_backend = PALLAS supports old-state history on "
                f"{sorted(n for n in allowed_old if n)} only "
                f"(got {sorted(extra_old)})"
            )

        # q-major inside the loop: each direction's plane is contiguous
        # (no copy when the eager chain left the distribution
        # direction-major)
        def q_major(name):
            return state["buffers"][name].permute(3, 0, 1, 2).contiguous()

        fpc_qm = q_major(plan.fpc)
        gpc_qm = q_major(plan.fpc2) if cfg.two_lattice else None
        media = self.lbm_media() if cfg.has_media else None
        # checks and packed arguments once; then one launch a substep
        step = lbm_fused.substepper(fpc_qm, media, cfg, gpc_qm)
        for _ in range(n_fused):
            out = step(fpc_qm, gpc_qm)
            if cfg.two_lattice:
                fpc_qm, gpc_qm, speed = out
            else:
                fpc_qm, speed = out
        buffers = dict(state["buffers"])
        # the (nx, ny, nz, q) views of the q-major results, as the eager
        # chain stores distributions
        buffers[plan.fpc] = fpc_qm.permute(1, 2, 3, 0)
        if cfg.two_lattice:
            buffers[plan.fpc2] = gpc_qm.permute(1, 2, 3, 0)
        if plan.speed is not None:
            # |u|, or on thermal decks T (the residual's field)
            buffers[plan.speed] = speed
        return {
            **state,
            "buffers": buffers,
            "n_advances": state["n_advances"] + n_fused,
        }

    def _pp_values(self, state, pps, t, dt, extra=None) -> Dict[str, float]:
        """The postprocessors' values, and the 0-d tensors of ``extra``,
        fetched to the host in one transfer."""
        ctx = {"t": t, "dt": dt}
        buffers = dict(state["buffers"])
        buffers.update(self.pp_computes.apply(buffers, ctx))
        st = {**state, "buffers": buffers}
        vals = {pp.name: pp.compute(st, ctx) for pp in pps}
        vals.update(extra or {})
        if not vals:
            return {}
        host = torch.stack([torch.as_tensor(v, device=self.domain.device)
                            .to(torch.float64).reshape(()) for v in vals.values()])
        return dict(zip(vals, host.tolist()))

    def step_with_pps(self, state, t, dt, dt_old, first_step: bool):
        """Timestep + TIMESTEP_END postprocessors; returns (state, host
        values) (marlin_tpu/problem.py:step_with_pps).  An LBM problem's
        convergence residual rides the same transfer as
        ``_lbm_residual``."""
        state = self.step(state, t, dt, dt_old, first_step)
        active = [pp for pp in self.postprocessors
                  if "TIMESTEP_END" in pp.execute_on]
        extra = None
        if self.is_lbm and "residual" in state["solver"]:
            extra = {"_lbm_residual": state["solver"]["residual"]}
        return state, self._pp_values(state, active, t + dt, dt, extra)

    def execute_postprocessors(self, state, flag: str, t, dt) -> Dict[str, float]:
        """Run PP computes + postprocessors for an execute flag."""
        active = [pp for pp in self.postprocessors if flag in pp.execute_on]
        if not active:
            return {}
        return self._pp_values(state, active, t, dt)
