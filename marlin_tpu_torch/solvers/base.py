"""Solver base classes and state-history machinery.

The PyTorch counterpart of marlin_tpu/solvers/base.py (reference:
src/tensor_solver/TensorSolver.C:93-115, SplitOperatorBase.C:16-66).

State layout (the JAX package's keys, managed here and by TensorProblem):

    state = {
      "buffers":    {name: Tensor},          # current values
      "old":        {name: Tensor[S, ...]},  # stacked old states
      "n_advances": int,                     # effective advanceState calls
      "old_dt":     tuple of floats,         # old MOOSE-dt ring
      "solver":     {...},                   # solver internals
    }

``n_advances`` and ``old_dt`` are host values: the eager loop branches on
them, and keeping them off the device costs no synchronisation.  So are an
iterative solver's ``iterations``, ``converged`` and ``group_evals``
(``IterativeCounts``): its host loop fetches what it decides on once an
iteration, and knows them.
``advance_state`` mirrors reference TensorBuffer::advanceState
(include/tensor_buffers/TensorBuffer.h:63-80).  Tensors in the state are
never written in place, so a depth-1 ring holds the current tensor itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from .. import perf
from ..params import Params


def advance_state(state: Dict, dt) -> Dict:
    """Push current buffer values into the old-state stacks."""
    new_old = {}
    for name, stack in state["old"].items():
        cur = state["buffers"][name].to(stack.dtype).unsqueeze(0)
        new_old[name] = cur if stack.shape[0] == 1 else torch.cat(
            [cur, stack[:-1]], dim=0)
    old_dt = tuple(state["old_dt"])
    if old_dt:
        old_dt = (float(dt),) + old_dt[:-1]
    return {
        **state,
        "old": new_old,
        "n_advances": state["n_advances"] + 1,
        "old_dt": old_dt,
    }


@dataclass
class SplitVariable:
    """One integrated variable binding for split-operator solvers
    (reference: SplitOperatorBase::Variable)."""

    buffer: str
    reciprocal_buffer: str
    linear_reciprocal: Optional[str]  # None == the deck's `'0'` placeholder
    nonlinear_reciprocal: str


@dataclass
class ExplicitVariable:
    """Variable binding for explicit solvers (reference: ExplicitSolverBase)."""

    buffer: str
    reciprocal_buffer: str
    time_derivative_reciprocal: str


@dataclass
class IterativeCounts:
    """What an iterative solver's host loop saw since the solver was built:
    substeps, iterations, device-to-host fetches (one an iteration, and
    Broyden's one before its first), substeps that did not converge.  Read
    by chip_smoke.py; the state keeps the JAX package's per-substep
    entries."""

    substeps: int = 0
    iterations: int = 0
    syncs: int = 0
    failed: int = 0


class TensorSolver:
    """Base solver: substep loop + buffer forwarding (reference
    TensorSolver.C:104-107: the state advances between substeps)."""

    def __init__(self, name: str, params: Params, problem):
        self.name = name
        self.params = params
        self.problem = problem
        self.domain = problem.domain
        self.substeps = params.get_int("substeps", 1)
        if self.substeps < 1:
            params.error("substeps",
                         "must be >= 1 (0 would silently freeze every step)")
        fb = params.get_str_vector("forward_buffer")
        fbn = params.get_str_vector("forward_buffer_new")
        if len(fb) != len(fbn):
            params.error(
                "forward_buffer", "needs as many entries as forward_buffer_new"
            )
        self.forwarded_buffers: List[Tuple[str, str]] = list(zip(fb, fbn))
        self.compute = None  # root ComputeGroup, bound by the problem

    # -- wiring -----------------------------------------------------------
    def bind(self, compute):
        self.compute = compute

    def history_requests(self) -> Dict[str, int]:
        """buffer name -> number of old states requested."""
        return {}

    def init_solver_state(self) -> Dict:
        """The solver's entries of ``state["solver"]``, built once by
        ``TensorProblem.init_state`` (marlin_tpu/problem.py:845-846)."""
        return {}

    #: the layout on a mesh of each entry the solver keeps in
    #: ``state["solver"]`` (``parallel.REAL``, ``RECIPROCAL``, ``FULL``, or
    #: None for a value every rank holds whole), for the sharded checkpoint
    STATE_LAYOUTS: Dict[str, Optional[str]] = {}

    def extra_input_buffers(self) -> List[str]:
        """Buffers the solver reads that must exist in the state."""
        return [b for _, b in self.forwarded_buffers]

    def output_buffers(self) -> List[str]:
        """Buffers the solver writes (integrated variables, forwards)."""
        return [b for b, _ in self.forwarded_buffers]

    def group_evals_per_step(self) -> int:
        """Compute-group evaluations per MOOSE timestep (feeds the
        ComputeGroupExecutionCount postprocessor)."""
        return self.substeps

    # -- execution helpers -------------------------------------------------
    def _run_group(self, state: Dict, t) -> Dict:
        """Evaluate the root compute and apply buffer forwarding
        (reference TensorSolver::forwardBuffers :86-91)."""
        buffers = dict(state["buffers"])
        updates = self.compute.apply(
            buffers, {"t": t, "old": state["old"],
                      "n_advances": state["n_advances"]})
        buffers.update(updates)
        for fwd, fwd_new in self.forwarded_buffers:
            buffers[fwd] = buffers[fwd_new]
        return {**state, "buffers": buffers}

    # -- main entry --------------------------------------------------------
    def step(self, state: Dict, t, dt, dt_old, first_step: bool) -> Dict:
        """One full timestep = `substeps` substeps.  Substep s sees
        sub_time = t + s*sub_dt; the state advances between substeps except
        during the first MOOSE timestep (the reference's timeStep()<=1
        guard in TensorProblem::advanceState)."""
        sub_dt = dt / self.substeps
        if getattr(self, "carry_reciprocal", False):
            # seed ū = fft(u) once per timestep (the per-substep transform
            # is pruned; see SplitOperatorBase.prune_reciprocal_ffts)
            buffers = dict(state["buffers"])
            for v in self.variables:
                buffers[v.reciprocal_buffer] = self.domain.fft(buffers[v.buffer])
            state = {**state, "buffers": buffers}
        for s in range(self.substeps):
            with perf.span("solver::substep"):
                if s > 0 and not first_step:
                    state = advance_state(state, dt)
                state = self.substep(state, t + s * sub_dt, sub_dt, dt, dt_old, s,
                                     first_step)
        return state

    def substep(self, state, sub_time, sub_dt, dt, dt_old, substep_index, first_step):
        raise NotImplementedError

    def _ifft_all(self, pairs):
        """{key: ifft(ū)} for a list of (key, ū) pairs.  Under ``[Problem]
        batch_fft = true`` spectra of the same shape and complexness
        transform as one batched inverse, by the rule core.BatchedFFT uses
        (marlin_tpu/solvers/base.py:171-184)."""
        from ..domain import batched_transform

        dom = self.domain
        if not getattr(self.problem, "batch_fft", False) or len(pairs) < 2:
            return {k: dom.ifft(u) for k, u in pairs}
        return batched_transform(dom.ifft, pairs)

    def _ifft_stacked(self, names, stacked):
        """{name: ifft(stacked[..., i])} for a value-stacked spectrum
        (variable order on the trailing axis).  Under batch_fft the stack
        transforms whole, one launch of each inverse kernel an axis under
        PALLAS (marlin_tpu/solvers/base.py:186-195)."""
        dom = self.domain
        if getattr(self.problem, "batch_fft", False) and len(names) >= 2:
            res = dom.ifft(stacked)
            return {k: res[..., i] for i, k in enumerate(names)}
        return {k: dom.ifft(stacked[..., i]) for i, k in enumerate(names)}

    # -- history helpers ---------------------------------------------------
    def n_old(self, state: Dict, buffer: str) -> int:
        """Valid old-state count for a buffer."""
        if buffer not in state["old"]:
            return 0
        return min(state["n_advances"], state["old"][buffer].shape[0])

    def old_stack(self, state: Dict, buffer: str) -> torch.Tensor:
        """Old-state stack for a buffer; empty leading axis if no history."""
        if buffer in state["old"]:
            return state["old"][buffer]
        cur = state["buffers"][buffer]
        return cur.new_zeros((0,) + tuple(cur.shape))


class SplitOperatorBase(TensorSolver):
    """Binds N variables {u, ū, L̄, N̄} (reference SplitOperatorBase.C:36-66)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        buffers = params.get_str_vector("buffer", required=True)
        rbufs = params.get_str_vector("reciprocal_buffer", required=True)
        lins = params.get_str_vector("linear_reciprocal")
        nonlins = params.get_str_vector("nonlinear_reciprocal", required=True)
        n = len(buffers)
        if not lins:
            lins = ["0"] * n
        if len(rbufs) != n or len(lins) != n or len(nonlins) != n:
            params.error(
                "buffer",
                "Must have the same number of entries as 'reciprocal_buffer', "
                "'linear_reciprocal' and 'nonlinear_reciprocal'.",
            )
        self.variables = [
            SplitVariable(
                buffers[i],
                rbufs[i],
                None if lins[i] == "0" else lins[i],
                nonlins[i],
            )
            for i in range(n)
        ]
        self.history_size = 0  # set by subclasses via request_history

        # When the deck's only producer of ū is `ForwardFFT(input = u)`, that
        # transform is redundant: the previous substep's update already has
        # ū, and u = ifft(ū).  `carry_reciprocal = true` prunes the
        # ForwardFFT from the solve group and carries ū across substeps,
        # one of the three transforms of a semi-implicit Cahn-Hilliard
        # substep.  Off by default: gold parity needs the recompute.
        self.carry_reciprocal = params.get_bool("carry_reciprocal", False)
        if self.carry_reciprocal and not getattr(
            self, "supports_carry_reciprocal", False
        ):
            params.error(
                "carry_reciprocal",
                f"not supported by {type(self).__name__}: the solver must "
                "write the updated ū back each substep (currently only "
                "AdamsBashforthMoulton does)",
            )

    def prune_reciprocal_ffts(self):
        """Remove the ForwardFFT members producing each variable's ū
        (carry_reciprocal mode).  Errors if ū has a different producer."""
        from ..computes.base import ComputeGroup
        from ..computes.core import ForwardFFT

        targets = {v.reciprocal_buffer: v.buffer for v in self.variables}
        found = set()

        if not isinstance(self.compute, ComputeGroup):
            raise ValueError(
                "carry_reciprocal = true requires the solver's root compute "
                "to be a ComputeGroup containing the ForwardFFT producers "
                f"(got a single '{type(self.compute).__name__}' via "
                "root_compute)"
            )

        def prune(group):
            kept = []
            for m in group.members:
                if isinstance(m, ComputeGroup):
                    prune(m)
                    kept.append(m)
                elif (
                    isinstance(m, ForwardFFT)
                    and m.out in targets
                    and m.input == targets[m.out]
                ):
                    found.add(m.out)
                else:
                    kept.append(m)
            group.members = kept
            group._update_io()

        prune(self.compute)
        missing = set(targets) - found
        if missing:
            raise ValueError(
                f"carry_reciprocal = true requires each reciprocal_buffer to "
                f"be produced by a ForwardFFT of its buffer; not found for "
                f"{sorted(missing)}"
            )
        self.compute.sort()

    def request_history(self, history_size: int):
        self.history_size = history_size

    def history_requests(self):
        if self.history_size == 0:
            return {}
        return {v.nonlinear_reciprocal: self.history_size for v in self.variables}

    def extra_input_buffers(self):
        out = super().extra_input_buffers()
        for v in self.variables:
            out += [v.reciprocal_buffer, v.nonlinear_reciprocal]
            if v.linear_reciprocal:
                out.append(v.linear_reciprocal)
        return out

    def output_buffers(self):
        return super().output_buffers() + [v.buffer for v in self.variables]


class ExplicitSolverBase(TensorSolver):
    """Binds variables {u, ū, dū/dt} (reference ExplicitSolverBase.C:14-30)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        buffers = params.get_str_vector("buffer")
        rbufs = params.get_str_vector("reciprocal_buffer")
        tds = params.get_str_vector("time_derivative_reciprocal")
        n = len(buffers)
        if len(rbufs) != n or len(tds) != n:
            params.error(
                "buffer",
                "Must have the same number of entries as 'reciprocal_buffer' "
                "and 'time_derivative_reciprocal'.",
            )
        self.variables = [
            ExplicitVariable(buffers[i], rbufs[i], tds[i]) for i in range(n)
        ]

    def extra_input_buffers(self):
        out = super().extra_input_buffers()
        for v in self.variables:
            out += [v.reciprocal_buffer, v.time_derivative_reciprocal]
        return out

    def output_buffers(self):
        return super().output_buffers() + [v.buffer for v in self.variables]


class IterativeSolver(SplitOperatorBase):
    """Shared state of the iterative solvers: the JAX package's per-substep
    ``iterations``, ``converged`` and ``group_evals`` entries, kept on the
    host, and the loop's counts (``IterativeCounts``)."""

    iterative = True
    STATE_LAYOUTS = {"iterations": None, "converged": None, "group_evals": None}

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.counts = IterativeCounts()

    def init_solver_state(self):
        # group_evals: the iteration loops' group evaluations, summed (the
        # one initial evaluation a substep is counted by
        # group_evals_per_step); ComputeGroupExecutionCount adds it
        return {"iterations": 0, "converged": True, "group_evals": 0}

    def _record(self, state, it, converged, syncs, extra=None):
        """The substep's solver entries (and ``extra``'s), counted."""
        self.counts.substeps += 1
        self.counts.iterations += it
        self.counts.syncs += syncs
        self.counts.failed += not converged
        solver_state = {**state.get("solver", {}), **(extra or {})}
        solver_state["iterations"] = it
        solver_state["converged"] = converged
        solver_state["group_evals"] = int(solver_state.get("group_evals", 0)) + it
        return solver_state
