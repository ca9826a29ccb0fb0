"""TensorProblem: owns buffers, computes, solver, postprocessors.

The spectral half of marlin_tpu/problem.py, run eagerly on torch tensors
(reference src/problems/TensorProblem.C).  It turns a parsed deck into a
state dict with the JAX package's keys

    state = {"buffers": {...}, "old": {...}, "n_advances": int,
             "old_dt": (float, ...), "solver": {...}}

and advances it one MOOSE timestep at a time.  Deck features outside the
ported slice fail at build with a named error (UNSUPPORTED_BLOCKS and the
checks in ``__init__``), never by being skipped.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import computes as _computes_pkg  # noqa: F401  (registers compute types)
from . import postprocessors as _pp_pkg  # noqa: F401  (registers pp types)
from . import solvers as _solvers_pkg  # noqa: F401  (registers solver types)
from .computes.base import ComputeGroup, Spec, TensorCompute
from .domain import FFT_BACKENDS, PARALLEL_MODES, PRECISIONS, Domain
from .hit import HitNode
from .params import Params
from .postprocessors import Postprocessor
from .registry import computes as compute_registry
from .registry import postprocessors as pp_registry
from .registry import solvers as solver_registry
from .solvers.base import advance_state


class ProblemError(Exception):
    pass


#: deck blocks whose features are not ported to marlin_tpu_torch yet
UNSUPPORTED_BLOCKS = {
    "TensorOutputs": "XDMF/HDF5 field outputs",
    "AuxVariables": "the aux-variable (Exodus) coupling surface",
    "AuxKernels": "the aux-variable (Exodus) coupling surface",
    "Functions": "MOOSE functions",
    "Stencil": "lattice Boltzmann",
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
    def __init__(self, root: HitNode, device=None):
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
        if ptype != "TensorProblem":
            raise ProblemError(
                f"[Problem] type = {ptype} is not ported to marlin_tpu_torch yet")
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
                if btype != "PlainTensorBuffer" or spec.has("buffer_type"):
                    raise ProblemError(
                        f"[TensorBuffers/{b.name}] type = {btype} is not "
                        "ported to marlin_tpu_torch yet (PlainTensorBuffer only)")
                self.buffer_specs[b.name] = spec

        # -- computes -------------------------------------------------------
        tc = root.children.get("TensorComputes")
        ic_nodes = tc.children.get("Initialize") if tc else None
        solve_nodes = tc.children.get("Solve") if tc else None
        pp_nodes = tc.children.get("Postprocess") if tc else None
        if tc is not None and "Boundary" in tc.children:
            raise ProblemError(
                "[TensorComputes/Boundary] (lattice Boltzmann boundary "
                "computes) is not ported to marlin_tpu_torch yet")
        self.ic_computes = self._build_group("_initialize", ic_nodes)
        self.solve_computes = (
            [self._build_compute(b) for b in solve_nodes.blocks()]
            if solve_nodes is not None
            else []
        )
        self.pp_computes = self._build_group("_postprocess", pp_nodes)

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
        vdims = spec.get_int_vector("value_dimensions", [])
        if spec.get_bool("reciprocal", False):
            return self.domain.reciprocal_value_shape(vdims)
        return self.domain.value_shape(vdims)

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
        return self.solver.history_requests() if self.solver is not None else {}

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
            dtype = dom.cdtype if spec.get_bool("reciprocal", False) else dom.dtype
            buffers[name] = self._zeros(self.declared_buffer_shape(name), dtype)

        # initial conditions in dependency order
        self.ic_computes.sort()
        ic_outputs = self.ic_computes.apply(buffers, {"t": 0.0})
        buffers.update(ic_outputs)

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
        return {
            "buffers": buffers,
            "old": old,
            "n_advances": 0,
            "old_dt": (0.0,) * old_max,
            "solver": {},
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

    def _pp_values(self, state, pps, t, dt) -> Dict[str, float]:
        ctx = {"t": t, "dt": dt}
        buffers = dict(state["buffers"])
        buffers.update(self.pp_computes.apply(buffers, ctx))
        st = {**state, "buffers": buffers}
        return {pp.name: float(pp.compute(st, ctx)) for pp in pps}

    def step_with_pps(self, state, t, dt, dt_old, first_step: bool):
        """Timestep + TIMESTEP_END postprocessors; returns (state, host
        values) (marlin_tpu/problem.py:step_with_pps)."""
        state = self.step(state, t, dt, dt_old, first_step)
        active = [pp for pp in self.postprocessors
                  if "TIMESTEP_END" in pp.execute_on]
        return state, self._pp_values(state, active, t + dt, dt)

    def execute_postprocessors(self, state, flag: str, t, dt) -> Dict[str, float]:
        """Run PP computes + postprocessors for an execute flag."""
        active = [pp for pp in self.postprocessors if flag in pp.execute_on]
        if not active:
            return {}
        return self._pp_values(state, active, t, dt)
