"""TensorProblem: owns buffers, computes, solver, postprocessors.

The spectral and lattice Boltzmann halves of marlin_tpu/problem.py, run
eagerly on torch tensors (reference src/problems/TensorProblem.C and
LatticeBoltzmannProblem.C).  It turns a parsed deck into a state dict with
the JAX package's keys

    state = {"buffers": {...}, "old": {...}, "n_advances": int,
             "old_dt": (float, ...), "solver": {...}}

and advances it one MOOSE timestep at a time.  Deck features outside the
ported slice fail at build with a named error (the checks in
``__init__``), never by being skipped.  ``[Functions]`` are parsed
expressions of (x, y, z, t) evaluated on the host; the legacy
``[TensorTimeIntegrators]`` block maps onto an AdamsBashforthMoulton
solver; ``[Problem] batch_fft = true`` fuses runs of independent
transforms into batched ones (``ComputeGroup.fuse_ffts``).

An LBM problem (``[Problem] type = LatticeBoltzmannProblem``) runs
``substeps`` lattice updates a step, from the second step on: stream,
boundary conditions, then the solve chain.  With ``lbm_backend = PALLAS``
all but the last substep of a step go through the fused kernel of
``lbm_fused.py`` (the JAX package's backend name, kept so decks run
unchanged), and the last one too where the plan has a final form
(``FusedLBMPlan.final``); the default ``JNP`` runs every substep through
the eager chain.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import checkpoint
from . import computes as _computes_pkg  # noqa: F401  (registers compute types)
from . import lbm_fused, parallel, perf
from . import postprocessors as _pp_pkg  # noqa: F401  (registers pp types)
from . import solvers as _solvers_pkg  # noqa: F401  (registers solver types)
from . import stencils as _stencils_pkg  # noqa: F401  (registers stencils)
from .aux import AuxSystem
from .computes.base import ComputeGroup, Spec, TensorCompute
from .domain import FFT_BACKENDS, PARALLEL_MODES, PRECISIONS, Domain
from .expression import CompiledExpression
from .hit import HitNode
from .params import Params
from .postprocessors import Postprocessor, VectorPostprocessor
from .registry import computes as compute_registry
from .registry import postprocessors as pp_registry
from .registry import predictors as predictor_registry
from .registry import solvers as solver_registry
from .registry import stencils as stencil_registry
from .solvers.base import advance_state


class ProblemError(Exception):
    pass


#: NEML2 primitive-typed buffers and their default trailing value dims
#: (reference src/tensor_buffers/NEML2TensorBuffer.C; Mandel SR2 and SSR4,
#: modified Rodrigues parameters for Rot)
NEML2_VALUE_DIMS = {"VectorTensor": [3], "SR2Tensor": [6], "R2Tensor": [3, 3],
                    "SSR4Tensor": [6, 6], "RotTensor": [3]}


def build_domain(node: Optional[HitNode], device=None, mesh=None) -> Domain:
    """The Domain of a deck's [Domain] block on ``mesh``, or on one device
    without one (marlin_tpu/problem.py:build_domain)."""
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
        mesh=mesh,
        debug=p.get_bool("debug", False),
    )


class TensorProblem:
    """``deck_dir`` resolves relative ``file =`` paths of LBM buffers;
    ``arrays`` maps a dataset name (the file's stem) to an array read in
    place of that HDF5 file, so a caller with the data in memory needs no
    file and no h5py."""

    def __init__(self, root: HitNode, device=None, deck_dir: Optional[str] = None,
                 arrays: Optional[Dict[str, np.ndarray]] = None, mesh=None):
        self.root = root
        gp = root.children.get("GlobalParams")
        self.global_params = dict(gp.params) if gp is not None else {}
        # the performance graph (perf.py), which the Transient shares: on
        # from the deck's [Outputs] perf_graph, so that the build is in it
        self.perf = perf.PerfGraph(enabled=Params(
            root.children.get("Outputs"), self.global_params).get_bool("perf_graph", False))
        with self.perf.active(), self.perf.span("problem::build"):
            self._build(root, device, deck_dir, arrays, mesh)
        self.perf.cuda = self.domain.device.type == "cuda"

    def _build(self, root, device, deck_dir, arrays, mesh):
        prob = root.children.get("Problem")
        self.problem_params = Params(prob, self.global_params)
        ptype = self.problem_params.get_str("type", "TensorProblem")
        if ptype not in ("TensorProblem", "LatticeBoltzmannProblem"):
            raise ProblemError(
                f"[Problem] type = {ptype} is not ported to marlin_tpu_torch yet")
        self.is_lbm = ptype == "LatticeBoltzmannProblem"
        # batch independent same-shape transforms (ComputeGroup.fuse_ffts
        # and the solvers' inverse transforms)
        self.batch_fft = self.problem_params.get_bool("batch_fft", False)
        if self.batch_fft:
            self._check_batch_fft(root, self.is_lbm)

        self.domain = build_domain(root.children.get("Domain"), device=device, mesh=mesh)

        # -- problem-level constants (reference TensorProblem.C:38-39,57-60)
        self.constants: Dict[str, float] = {}
        self.deck_dir = deck_dir
        self.arrays = dict(arrays or {})
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
        self._buffer_layouts = None  # buffer_layouts(), built at first use
        self._lbm_solid_mask = None
        self._lbm_media = None
        self._lbm_media_raw = None
        self.spectral_solve_substeps = self.problem_params.get_int(
            "spectral_solve_substeps", 1)
        names = self.problem_params.get_str_vector("scalar_constant_names")
        values = self.problem_params.get_float_vector("scalar_constant_values")
        if len(names) != len(values):
            raise ProblemError("scalar_constant_names/values length mismatch")
        self.constants.update(dict(zip(names, values)))
        self._fetched_constants: List[str] = []

        self.functions: Dict[str, object] = {}
        fns = root.children.get("Functions")
        if fns is not None:
            self._build_functions(fns)

        # -- explicit buffers ----------------------------------------------
        self.buffer_specs: Dict[str, Params] = {}
        tb = root.children.get("TensorBuffers")
        if tb is not None:
            for b in tb.blocks():
                spec = Params(b, self.global_params)
                btype = spec.get_str("type", "PlainTensorBuffer")
                if btype not in ("PlainTensorBuffer", "LBMTensorBuffer", *NEML2_VALUE_DIMS):
                    raise ProblemError(
                        f"[TensorBuffers/{b.name}] type = {btype} is not "
                        "ported to marlin_tpu_torch yet (PlainTensorBuffer, "
                        "LBMTensorBuffer and the NEML2 primitive types only)")
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

        # -- aux-variable coupling surface (reference mapBuffersToAux /
        # ProjectTensorAux, src/problems/TensorProblem.C:250-379) ------------
        self.aux = AuxSystem(self, root)

        # -- solver ---------------------------------------------------------
        self.solver = None
        self._solverless_group = None  # the per-step computes of a deck without a solver
        self._build_solver(root)

        # -- postprocessors --------------------------------------------------
        self.postprocessors: List[Postprocessor] = []
        pps = root.children.get("Postprocessors")
        if pps is not None:
            for b in pps.blocks():
                p = Params(b, self.global_params)
                self.postprocessors.append(
                    pp_registry.create(p.get_str("type", required=True), b.name, p, self)
                )
        # cross-postprocessor checks once all are built (forward references)
        for pp in self.postprocessors:
            pp.check(self)
        # compute-group evaluations so far (ComputeGroupExecutionCount): the
        # static count, group_evals_per_step a step, and an iterative
        # solver's iteration evaluations as of the last step
        self.compute_count = 0
        self.device_group_evals = 0
        # the [Postprocess] group's outputs of the last postprocessor
        # evaluation: (state buffers, t, outputs), reused by
        # run_postprocess_computes for the same buffers at the same time
        self._pp_group_last = None

        # -- vector postprocessors --------------------------------------------
        self.vector_postprocessors: List[VectorPostprocessor] = []
        vpps = root.children.get("VectorPostprocessors")
        if vpps is not None:
            for b in vpps.blocks():
                p = Params(b, self.global_params)
                self.vector_postprocessors.append(
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

    def _build_functions(self, fns: HitNode):
        """``[Functions]`` (marlin_tpu/problem.py:184-252): ParsedFunction
        blocks are expressions of (x, y, z, t) with constants from
        ``symbol_names``/``symbol_values`` (or the legacy ``vars``/``vals``);
        a non-numeric value names another function, evaluated at the same
        point (composition).  ShiftedFunction wraps a function with a
        space and time offset (reference src/functions/ShiftedFunction.C)
        and is resolved once every ParsedFunction exists."""
        for b in fns.blocks():
            p = Params(b, self.global_params)
            if p.get_str("type", "ParsedFunction") == "ShiftedFunction":
                continue
            expr = p.get_str("expression", p.get_str("value", "0"))
            consts = {"pi": math.pi, "e": math.e}
            syms = p.get_str_vector("symbol_names", p.get_str_vector("vars"))
            vals = p.get_str_vector("symbol_values", p.get_str_vector("vals"))
            composed = []
            for sname, sval in zip(syms, vals):
                try:
                    consts[sname] = float(sval)
                except ValueError:
                    composed.append((sname, sval))
            ce = CompiledExpression(expr, ["x", "y", "z", "t"] + [n for n, _ in composed],
                                    constants=consts)
            self.functions[b.name] = self._composed(ce, composed) if composed else ce
        for b in fns.blocks():
            p = Params(b, self.global_params)
            if p.get_str("type") != "ShiftedFunction":
                continue
            inner = self.functions[p.get_str("function", required=True)]
            shift = p.get_float_vector("shift", [0.0, 0.0, 0.0])
            shift = list(shift) + [0.0] * (3 - len(shift))
            self.functions[b.name] = self._shifted(inner, shift,
                                                   p.get_float("delta_t", 0.0))

    def _composed(self, ce, composed):
        def call(env):
            scope = dict(env)
            for sname, fname in composed:
                scope[sname] = self.functions[fname](env)
            return ce(scope)

        return call

    @staticmethod
    def _shifted(inner, shift, tshift):
        def call(env):
            return inner({"x": env["x"] + shift[0], "y": env["y"] + shift[1],
                          "z": env["z"] + shift[2], "t": env["t"] + tshift})

        return call

    def get_function(self, name: str):
        if name not in self.functions:
            raise ProblemError(f"Function '{name}' not found")
        return self.functions[name]

    def _build_solver(self, root: HitNode):
        """The solver of ``[TensorSolver]``, or of the legacy
        ``[TensorTimeIntegrators]`` (marlin_tpu/problem.py:_build_solver),
        bound to its root compute; without either, the per-step computes'
        wrapper group, fused under batch_fft."""
        ts = root.children.get("TensorSolver")
        tti = root.children.get("TensorTimeIntegrators")
        if ts is not None:
            params = Params(ts, self.global_params)
            stype = params.get_str("type", required=True)
            cls = solver_registry.get(stype)
            self.solver = cls(ts.name, params, self)
            root_name = params.get_str("root_compute")
            # [TensorSolver/Predictors]: built for every solver, applied by
            # those that hold a `predictors` list (SecantSolver's alone
            # applies them)
            preds = ts.children.get("Predictors")
            if preds is not None:
                for b in preds.blocks():
                    p = Params(b, self.global_params)
                    pred = predictor_registry.create(
                        p.get_str("type", required=True), b.name, p, self)
                    getattr(self.solver, "predictors", []).append(pred)
        elif tti is not None:
            self.solver = self._legacy_integrators(tti)
            root_name = None
        else:
            # the top-level per-step computes run in declared order
            # (reference TensorProblem::execute else-branch), so the
            # wrapper group is never sorted; fuse_ffts sorts nested groups
            self._solverless_group = ComputeGroup(
                "_solve_root", Params(None, self.global_params), self,
                self.solve_computes)
            if self.batch_fft:
                self._solverless_group.fuse_ffts()
            return
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
        if self.batch_fft and isinstance(root_compute, ComputeGroup):
            root_compute.fuse_ffts()

    def _legacy_integrators(self, tti: HitNode):
        """Legacy ``[TensorTimeIntegrators]`` FFTSemiImplicit blocks (the
        reference's benchmarks/01_spinodal_decomposition/1a.i:114-121) as
        one AdamsBashforthMoulton of predictor order history_size + 1,
        with ``[Problem] spectral_solve_substeps`` substeps and
        ``carry_reciprocal``/``fused_spectral`` taken from ``[Problem]``
        (marlin_tpu/problem.py:349-395)."""
        buffers, rbufs, lins, nonlins = [], [], [], []
        history = 1
        for b in tti.blocks():
            p = Params(b, self.global_params)
            if p.get_str("type") != "FFTSemiImplicit":
                raise ProblemError(
                    f"Unsupported TensorTimeIntegrator type {p.get_str('type')}")
            buffers.append(p.get_str("buffer", required=True))
            rbufs.append(p.get_str("reciprocal_buffer", required=True))
            lins.append(p.get_str("linear_reciprocal", "0"))
            nonlins.append(p.get_str("nonlinear_reciprocal", required=True))
            history = max(history, p.get_int("history_size", 1))
        synth = HitNode("_fft_semi_implicit")
        for key, value in (("buffer", buffers), ("reciprocal_buffer", rbufs),
                           ("linear_reciprocal", lins),
                           ("nonlinear_reciprocal", nonlins)):
            synth.set_param(key, " ".join(value))
        synth.set_param("predictor_order", str(history + 1))
        synth.set_param("corrector_steps", "0")
        synth.set_param("substeps", str(self.spectral_solve_substeps))
        for extra in ("carry_reciprocal", "fused_spectral"):
            v = self.problem_params.get_str(extra, None)
            if v is not None:
                synth.set_param(extra, v)
        cls = solver_registry.get("AdamsBashforthMoulton")
        return cls(synth.name, Params(synth, self.global_params), self)

    @staticmethod
    def _check_batch_fft(root: HitNode, is_lbm: bool):
        """``[Problem] batch_fft = true`` applies to serial spectral decks
        only (marlin_tpu/problem.py:444-467, its words).  Checked before the
        Domain is built, so that its refusal of FFT_PENCIL does not speak
        first."""
        if is_lbm:
            raise ProblemError(
                "[Problem] batch_fft = true does not apply to "
                "LatticeBoltzmannProblem (LBM solve chains contain no "
                "spectral transforms); remove it")
        dom = root.children.get("Domain")
        if dom is not None and Params(dom).get_str("parallel_mode", "NONE") != "NONE":
            raise ProblemError(
                "[Problem] batch_fft = true is serial-only (the "
                "distributed transforms shard per field); remove it "
                "for parallel_mode != NONE decks")


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

    def lbm_media_ids(self) -> Optional[torch.Tensor]:
        """The binary-media buffer as the deck gives it, (nx, ny, nz) on the
        device, or None: the region ids of ``regional`` boundaries."""
        return self._lbm_media_raw

    def lbm_media(self) -> Optional[torch.Tensor]:
        """The binary media as an int8 code on the device, (nx, ny, nz):
        0 solid (media == 0), 1 fluid (media >= 1), -1 neither (negative
        ids), or None.  Captured once; the fused kernel reads it as is."""
        return self._lbm_media

    def get_compute(self, name: str) -> TensorCompute:
        """A compute by name anywhere in the solve, IC, postprocess and
        boundary chains (marlin_tpu/problem.py:get_compute; reference
        TensorProblem::getComputes)."""

        def search(members):
            for m in members:
                if m.name == name:
                    return m
                if isinstance(m, ComputeGroup):
                    found = search(m.members)
                    if found is not None:
                        return found
            return None

        for pool in (self.solve_computes, [self.ic_computes, self.pp_computes],
                     self.bc_computes):
            found = search(pool)
            if found is not None:
                return found
        raise ProblemError(f"Compute '{name}' not found.")

    def newton_diag_keys(self) -> List[str]:
        """The pseudo-buffer keys of Newton convergence flags (FFTMechanics)
        in the solve, IC and postprocess chains
        (marlin_tpu/problem.py:newton_diag_keys)."""
        if getattr(self, "_newton_diag_keys", None) is not None:
            return self._newton_diag_keys
        keys = []

        def walk(members):
            for m in members:
                if isinstance(m, ComputeGroup):
                    walk(m.members)
                elif getattr(m, "converged_key", None):
                    keys.append(m.converged_key)

        walk(self.solve_computes)
        walk([self.pp_computes, self.ic_computes])
        self._newton_diag_keys = keys
        return keys

    @staticmethod
    def check_newton_diags(values):
        """Raise if a Newton solve exhausted nl_max_its (the reference's
        FFTMechanics.C error); ``values`` maps pseudo-key -> host float,
        0.0 where the solve did not converge."""
        from .computes.mechanics import newton_exhausted_message

        for key, ok in values.items():
            if not ok:
                raise RuntimeError(newton_exhausted_message(key[len("__converged_"):-2]))

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
        vdims = (spec.get_int_vector("value_dimensions", [])
                 or NEML2_VALUE_DIMS.get(spec.get_str("type", "PlainTensorBuffer"), []))
        if spec.get_bool("reciprocal", False):
            return self.domain.reciprocal_value_shape(vdims)
        return self.domain.value_shape(vdims)

    def _declared_dtype(self, spec: Params) -> torch.dtype:
        dom = self.domain
        if self._is_lbm_buffer(spec):
            return torch.int64 if spec.get_bool("is_integer", False) else dom.dtype
        return dom.cdtype if spec.get_bool("reciprocal", False) else dom.dtype

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
        dtype = self._declared_dtype(spec)
        if spec.has("file"):
            data = np.asarray(self._read_lbm_h5(spec.get_str("file")))
            if data.ndim < 3:
                data = data.reshape(data.shape + (1,) * (3 - data.ndim))
            # the whole grid's data: this rank keeps its block
            data = np.ascontiguousarray(self.domain.local(data))
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
        self._lbm_media_raw = media
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
        """The solver's, its predictors', every postprocessor's and every
        compute's requests, deepest wins
        (marlin_tpu/problem.py:history_requests)."""
        req: Dict[str, int] = {}

        def merge(d):
            for k, v in d.items():
                req[k] = max(req.get(k, 0), v)

        if self.solver is not None:
            merge(self.solver.history_requests())
            for p in getattr(self.solver, "predictors", []):
                merge(p.history_requests())
        for pp in self.postprocessors:
            merge(pp.history_requests())

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
        if dom.debug and (dom.mesh is None or dom.mesh.rank == 0):
            # reference Domain/debug=true introspection
            # (marlin_tpu/problem.py:870-882): the domain and its layout
            print(f"[marlin_tpu_torch] domain: {dom!r}")
            print(f"[marlin_tpu_torch] fft_backend: {dom.fft_backend}; "
                  f"{self.spectral_solve_substeps} substeps a step")
            if dom.mesh is not None:
                from . import parallel as _par

                print(f"[marlin_tpu_torch] mesh: {dom.mesh}; real spec "
                      f"{_par.real_spec(dom, dom.dim)}; reciprocal spec "
                      f"{_par.reciprocal_spec(dom, dom.dim)}")
        buffers: Dict[str, torch.Tensor] = {}
        for name, spec in self.buffer_specs.items():
            if self._is_lbm_buffer(spec):
                buffers[name] = self._init_lbm_buffer(spec)
                continue
            buffers[name] = self._zeros(self.declared_buffer_shape(name),
                                        self._declared_dtype(spec))

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
        for g in groups:
            g.check()
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
        # Newton convergence flags (FFTMechanics) start True; each solve ANDs
        # its own in, and the step's one transfer reads them
        for key in self.newton_diag_keys():
            buffers[key] = torch.ones((), dtype=torch.bool, device=dom.device)

        solver_state = {} if self.solver is None else self.solver.init_solver_state()
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
        layouts = self.buffer_layouts()
        scope = {k: Spec(tuple(v.shape), v.dtype, layouts.get(k, parallel.REAL))
                 for k, v in buffers.items()}
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
        """One full timestep (marlin_tpu/problem.py:_step_impl).  On an
        FFT_SLAB or FFT_PENCIL mesh the step leaves every tensor of the
        state contiguous: the distributed transforms return strided
        blocks, the bits of a later transform depend on its input's
        strides, and a block restored from a checkpoint is contiguous, so
        a run resumed at a step is the uninterrupted one bit for bit only
        where the running state is contiguous there too (one copy a step,
        of the strided leaves).  REAL_SPACE runs no transform, and its
        LBM distributions are large: it copies nothing."""
        with perf.span("problem::step"):
            state = self._step(state, t, dt, dt_old, first_step)
            if self.domain.mesh is not None and self.domain.parallel_mode != "REAL_SPACE":
                state = {**state, **{part: {k: v.contiguous() if isinstance(v, torch.Tensor)
                                            else v for k, v in state[part].items()}
                                     for part in ("buffers", "old", "solver")}}
        # the earlier steps' spans are read while the card runs this one
        self.perf.resolve()
        return state

    def _step(self, state, t, dt, dt_old, first_step: bool):
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
        buffers.update(self._solverless_group.apply(buffers, ctx))
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
            with perf.span("solver::fused_substeps"):
                state = self._lbm_fused_substeps(state, t, dt)
            if self._lbm_fused_plan.final is not None:
                # the last substep was the kernel's final form
                perf.count("substeps_fused", self.lbm_substeps)
                perf.count("lbm_final_fused")
                return state
            perf.count("substeps_fused", self.lbm_substeps - 1)
            perf.count("lbm_final_eager")
            # the LAST substep runs the eager chain, so every deck buffer
            # (f, density, velocity, feq, speed) and the old-state ring are
            # exactly as the unfused path leaves them
            return self._lbm_substep(state, t, dt)
        for _ in range(self.lbm_substeps):
            state = self._lbm_substep(state, t, dt)
        return state

    def _lbm_substep(self, state, t, dt):
        """advance -> stream -> boundary conditions -> solve chain."""
        with perf.span("solver::substep"):
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

    def _lbm_fused_substeps(self, state, t, dt):
        """Substeps 0..n-2 through the fused kernel (lbm_fused.py), carrying
        only fpc (and on thermal decks gpc), q-major, and the carried scalar
        (marlin_tpu/problem.py:_lbm_fused_substeps); on a plan with a final
        form (``FusedLBMPlan.final``) substep n-1 too (``_lbm_final_substep``)."""
        if self._lbm_fused_plan is None:
            self._lbm_fused_plan = lbm_fused.match_chain(self)
        plan = self._lbm_fused_plan
        cfg = plan.config
        n_fused = self.lbm_substeps - 1

        # the last substep (eager, or the final form) refreshes slot 0 of
        # every depth-1 ring, so skipping the fused substeps' pushes is
        # invisible; deeper rings would retain skipped history and are
        # rejected
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
        step = lbm_fused.substepper(fpc_qm, media, cfg, gpc_qm, plan.offsets)
        if cfg.sharded:
            # a block of a mesh: the media's halo ring once (it does not
            # change), the distributions' before every substep
            # (marlin_tpu/problem.py:1100-1150)
            mesh = self.domain.mesh
            mring = None if media is None else parallel.halo_ring(
                mesh, media, 0, cfg.shard_y)
        for _ in range(n_fused):
            rings = None
            if cfg.sharded:
                rings = (parallel.halo_ring(mesh, fpc_qm, 1, cfg.shard_y),
                         None if gpc_qm is None else parallel.halo_ring(
                             mesh, gpc_qm, 1, cfg.shard_y),
                         mring)
            # only fpc_qm (gpc_qm) holds a launch's input, so the last one's
            # is freed before the final form allocates its outputs
            out = step(fpc_qm, gpc_qm, rings=rings)
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
        state = {
            **state,
            "buffers": buffers,
            "n_advances": state["n_advances"] + n_fused,
        }
        if plan.final is None:
            return state
        return self._lbm_final_substep(state, t, dt, step, fpc_qm)

    def _lbm_final_substep(self, state, t, dt, step, fpc_qm):
        """The last substep of a step through the kernel's final form: the
        ring pushed as ``_lbm_substep`` pushes it, one launch whose outputs
        are the deck's buffers (the q-major distributions as (nx, ny, nz,
        q) views, as the fused loop leaves fpc), then the deck's residual
        compute on the new speed and the ring."""
        from .computes.lbm import LBMComputeResidual

        plan = self._lbm_fused_plan
        stores = plan.final
        state = advance_state(state, dt)
        fpc_qm, speed, f_qm, feq_qm, density, velocity = step(fpc_qm, final=True)
        buffers = dict(state["buffers"])
        buffers.update({plan.fpc: fpc_qm.permute(1, 2, 3, 0),
                        stores.f: f_qm.permute(1, 2, 3, 0),
                        stores.feq: feq_qm.permute(1, 2, 3, 0),
                        stores.density: density, stores.velocity: velocity})
        if plan.speed is not None:
            buffers[plan.speed] = speed
        solver_state = state["solver"]
        ctx = {"t": t, "old": state["old"], "n_advances": state["n_advances"]}
        for c in self._lbm_solves.sorted_members:
            if isinstance(c, LBMComputeResidual):
                solver_state = {**solver_state,
                                "residual": c.apply(buffers, ctx)["__residual__"]}
        return {**state, "buffers": buffers, "solver": solver_state}

    def _pp_values(self, state, pps, t, dt, extra=None) -> Dict[str, float]:
        """The postprocessors' values at time ``t``: the tensor ones, and
        the 0-d tensors of ``extra``, fetched to the host in one transfer,
        then the ``depends_on_pps`` ones on the host from those values, in
        declaration order (marlin_tpu/problem.py:execute_postprocessors)."""
        tensor_pps = [pp for pp in pps if not getattr(pp, "depends_on_pps", False)]
        vals = dict(extra or {})
        result: Dict[str, float] = {}
        with perf.span("problem::postprocessors"):
            if tensor_pps:
                ctx = {"t": t, "dt": dt}
                buffers = dict(state["buffers"])
                group = self.pp_computes.apply(buffers, ctx)
                self._pp_group_last = (state["buffers"], t, group)
                buffers.update(group)
                st = {**state, "buffers": buffers}
                vals = {**{pp.name: pp.compute(st, ctx) for pp in tensor_pps}, **vals}
                # the flags of an FFTMechanics in the postprocess chain, which
                # exist only in its outputs, ride the same transfer
                vals.update({k: group[k] for k in self.newton_diag_keys() if k in group})
            if vals:
                host = torch.stack([torch.as_tensor(v, device=self.domain.device)
                                    .to(torch.float64).reshape(()) for v in vals.values()])
        if vals:
            with perf.span("problem::fetch"):
                result = dict(zip(vals, host.tolist()))
            perf.count("fetches")
        self.check_newton_diags({k: result.pop(k) for k in self.newton_diag_keys()
                                 if k in result})
        for pp in pps:
            if getattr(pp, "depends_on_pps", False):
                result[pp.name] = float(pp.compute_host(result, float(t)))
        return result

    def step_with_pps(self, state, t, dt, dt_old, first_step: bool):
        """Timestep + TIMESTEP_END postprocessors; returns (state, host
        values) (marlin_tpu/problem.py:step_with_pps).  An LBM problem's
        convergence residual rides the same transfer as
        ``_lbm_residual``."""
        state = self.step(state, t, dt, dt_old, first_step)
        if self.solver is not None:
            self.compute_count += self.solver.group_evals_per_step()
        # an iterative solver's iteration evaluations, a host count in its
        # state (marlin_tpu/problem.py:_fetch_group_evals fetches it)
        self.device_group_evals = int(state["solver"].get("group_evals", 0))
        active = [pp for pp in self.postprocessors
                  if "TIMESTEP_END" in pp.execute_on]
        extra = {}
        if self.is_lbm and "residual" in state["solver"]:
            extra["_lbm_residual"] = state["solver"]["residual"]
        # the solve chain's Newton flags (marlin_tpu/problem.py:1192)
        extra.update({k: state["buffers"][k] for k in self.newton_diag_keys()
                      if k in state["buffers"]})
        return state, self._pp_values(state, active, t + dt, dt, extra)

    def execute_postprocessors(self, state, flag: str, t, dt) -> Dict[str, float]:
        """Run PP computes + postprocessors for an execute flag."""
        active = [pp for pp in self.postprocessors if flag in pp.execute_on]
        if not active:
            return {}
        return self._pp_values(state, active, t, dt)

    def run_postprocess_computes(self, state, t):
        """The state with the [Postprocess] group's buffers materialised at
        time ``t``, for field outputs (marlin_tpu/problem.py:
        run_postprocess_computes).  Where the postprocessors of this very
        state at ``t`` already ran the group, its outputs are reused: the
        group runs once an output point."""
        last = self._pp_group_last
        if last is not None and last[0] is state["buffers"] and last[1] == t:
            group = last[2]
        else:
            group = self.pp_computes.apply(dict(state["buffers"]), {"t": t})
        return {**state, "buffers": {**state["buffers"], **group}}

    def load_checkpoint(self, path: str):
        """(state, meta) of a checkpoint of either package, the state's
        tensors on this problem's device; an LBM problem's media are taken
        from it as ``init_state`` takes them.  The file holds global
        arrays: on a mesh every rank takes its block of each leaf
        (``parallel.block_of``, by the leaf's recorded layout), so a
        checkpoint written at one mesh size, or serially, resumes at
        another."""
        tables = self._layout_tables()

        def block(key, arr):
            part, _, name = key.partition("/")
            if part not in tables or name == "__empty__":
                return arr
            table = tables[part]
            if name not in table:
                raise ProblemError(f"checkpoint '{path}' does not fit this deck: "
                                   f"{key} is not a leaf of its state")
            return self._block_of(table[name], arr, 1 if part == "old" else 0)

        state, meta = checkpoint.load(path, self.domain.device, select=block)
        self._check_restored(state["buffers"], path)
        self._capture_lbm_media(state["buffers"])
        return state, meta

    # -- layouts of the state on a mesh (the sharded checkpoint) -----------
    def buffer_layouts(self) -> Dict[str, Optional[str]]:
        """The layout on a mesh of every buffer the state holds
        (``parallel.REAL``, ``RECIPROCAL``, ``FULL`` or None), recorded
        where each buffer is made: a declared buffer by its declaration
        (LBM buffers and real ones REAL, ``reciprocal = true`` RECIPROCAL),
        a compute's output by its ``output_specs`` (the initial conditions,
        then the solve and postprocess chains, in their order), the
        solver's extra buffers REAL, the Newton flags None.  Built once
        from the declarations alone, so that ``recover`` needs no
        ``init_state``; a history stack's slots take their buffer's."""
        if self._buffer_layouts is not None:
            return self._buffer_layouts
        dom = self.domain
        scope: Dict[str, Spec] = {}
        for name, spec in self.buffer_specs.items():
            reciprocal = not self._is_lbm_buffer(spec) and spec.get_bool("reciprocal", False)
            scope[name] = Spec(tuple(self.declared_buffer_shape(name)),
                               self._declared_dtype(spec),
                               parallel.RECIPROCAL if reciprocal else parallel.REAL)
        solve_all = ComputeGroup(
            "_all_solve", Params(None, self.global_params), self, self.solve_computes
        ).sort()
        for g in (self.ic_computes.sort(), solve_all, self.pp_computes.sort()):
            for m in g.sorted_members:
                for b in m.inputs:
                    scope.setdefault(b, Spec(dom.shape, dom.dtype))
                scope.update(m.output_specs(scope))
        layouts = {k: v.layout for k, v in scope.items()}
        if self.solver is not None:
            for b in self.solver.extra_input_buffers() + self.solver.output_buffers():
                layouts.setdefault(b, parallel.REAL)
        for key in self.newton_diag_keys():
            layouts[key] = None
        self._buffer_layouts = layouts
        return layouts

    def _layout_tables(self) -> Dict[str, Dict[str, Optional[str]]]:
        buffers = self.buffer_layouts()
        solver = dict(self.solver.STATE_LAYOUTS) if self.solver is not None else {}
        if self.is_lbm:
            solver["residual"] = None  # the convergence residual, a reduction
        return {"buffers": buffers, "old": buffers, "solver": solver}

    def state_layout(self, state) -> Dict:
        """The layout of each leaf of ``state``, in its tree: {"buffers",
        "old", "solver"} -> {name: layout}; ``n_advances`` and ``old_dt``
        are the same on every rank.  A leaf whose layout was never
        recorded is a named error, not a guess."""
        tables = self._layout_tables()
        out = {}
        for part, table in tables.items():
            missing = sorted(set(state[part]) - set(table))
            if missing:
                raise ProblemError(f"state['{part}'] entries {missing} have no "
                                   "recorded layout (parallel.REAL, RECIPROCAL, "
                                   "FULL or None)")
            out[part] = {k: table[k] for k in state[part]}
        return out

    def _block_of(self, layout, arr: np.ndarray, lead: int) -> np.ndarray:
        """This rank's block of a global leaf of ``layout``: an axis of
        extent 1 where the layout's is larger is a broadcast (whole on
        every rank), and a pencil's half axis fits its pad rows to this
        mesh's (they hold zeros); on no mesh, the array itself.  An array
        that fits none of these is another deck's: it is kept whole, for
        ``_check_restored`` to name."""
        dom = self.domain
        if layout is None:
            return arr
        extents = parallel.layout_extents(dom, layout)
        spec = list(parallel.layout_spec(dom, layout, arr.ndim, lead))
        for d in range(min(dom.dim, arr.ndim - lead)):
            have, want = arr.shape[lead + d], extents[d]
            if have == want:
                continue
            if have == 1:
                spec[lead + d] = None
                continue
            if layout == parallel.RECIPROCAL and d == dom.half_axis \
                    and dom.parallel_mode == "FFT_PENCIL" \
                    and min(have, want) >= dom.n_global[d] // 2 + 1:
                arr = _fit_rows(arr, lead + d, want)
                continue
            return arr  # another deck's array: _check_restored names it
        if dom.mesh is None:
            return arr
        return parallel.block_of(dom.mesh, arr, tuple(spec))

    def gathered_state(self, state, root: int = 0):
        """``state`` with every leaf whole, its tensors on the host, on
        rank ``root`` (None on the other ranks): each laid-out leaf
        gathered there by ``parallel.gather_to`` (one leaf at a time, so
        no rank holds more than one whole leaf besides what it keeps),
        each other one taken from ``root``.  Every rank calls it.  The
        ranks' block shapes travel first, in one collective, so that
        every rank reads the same global shapes: an axis of a leaf whose
        blocks are all of extent 1 where the layout's blocks are larger
        is a broadcast and is kept whole."""
        mesh = self.domain.mesh
        if mesh is None:
            return state
        layouts = self.state_layout(state)
        leaves = [(part, k) for part in ("buffers", "old", "solver")
                  for k in sorted(state[part])]
        laid = [(part, k) for part, k in leaves if layouts[part][k] is not None]
        shapes = parallel.all_shapes(mesh, [tuple(state[p][k].shape) for p, k in laid],
                                     self.domain.device)
        out = {"buffers": {}, "old": {}, "solver": {},
               "n_advances": state["n_advances"], "old_dt": state["old_dt"]}
        for i, (part, k) in enumerate(laid):
            layout = layouts[part][k]
            lead = 1 if part == "old" else 0
            t = state[part][k]
            spec, shape = parallel.settle_layout(
                mesh, parallel.layout_spec(self.domain, layout, t.ndim, lead),
                parallel.layout_extents(self.domain, layout), lead, [s[i] for s in shapes])
            out[part][k] = parallel.gather_to(mesh, t, spec, shape, root, device="cpu")
        for part, k in leaves:
            if layouts[part][k] is None:
                v = state[part][k]
                out[part][k] = v.cpu() if isinstance(v, torch.Tensor) else v
        return out if mesh.rank == root else None

    def _check_restored(self, buffers, path):
        """Every declared buffer is in the checkpoint with the shape and
        dtype ``init_state`` gives it (a checkpoint of another deck or
        precision is a named error)."""
        for name, spec in self.buffer_specs.items():
            spec.has("file")  # an LBM buffer's data is the checkpoint's
            dtype = self._declared_dtype(spec)
            shape = tuple(self.declared_buffer_shape(name))
            got = buffers.get(name)
            if got is None or tuple(got.shape) != shape or got.dtype != dtype:
                have = "missing" if got is None else f"{tuple(got.shape)} {got.dtype}"
                raise ProblemError(
                    f"checkpoint '{path}' does not fit this deck: buffer '{name}' "
                    f"is {have}, the deck declares {shape} {dtype}")


def _fit_rows(arr: np.ndarray, axis: int, rows: int) -> np.ndarray:
    """``arr`` cut or zero-padded to ``rows`` along ``axis`` (a pencil's
    half spectrum whose pad rows, zeros past n/2 + 1, another mesh laid
    out otherwise)."""
    have = arr.shape[axis]
    if have >= rows:
        return arr[(slice(None),) * axis + (slice(0, rows),)]
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rows - have)
    return np.pad(arr, pad)
