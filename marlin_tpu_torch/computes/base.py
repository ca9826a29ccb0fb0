"""Compute base classes and the dependency-sorted ComputeGroup.

The PyTorch counterpart of marlin_tpu/computes/base.py (reference:
include/tensor_computes/TensorOperatorBase.h:27-168,
src/tensor_computes/ComputeGroup.C:39-169).

A compute is an object configured from a deck block that exposes
``apply(state, ctx) -> {buffer: tensor}``, evaluated eagerly, and
``output_specs(specs) -> {buffer: Spec}``, the shape and dtype of each
output computed from those of the inputs (the port's counterpart of
``jax.eval_shape``, which TensorProblem.init_state uses to give derived
buffers their zeros without running anything), and the layout the output
takes on a mesh (``Spec.layout``, which the sharded checkpoint reads).  Groups
dependency-sort members by requested/supplied buffer names and run them in
that order.  Under ``[Problem] batch_fft = true`` a sorted group rewrites
each run of independent same-direction transforms into one batched
transform (``fuse_ffts``, ``core.BatchedFFT``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..params import Params
from ..parallel import REAL


@dataclass(frozen=True)
class Spec:
    """Shape and dtype of a buffer, and its layout on a mesh: ``REAL``,
    ``RECIPROCAL``, ``FULL`` or None (one value on every rank; see
    ``parallel.layout_spec``).  Two specs are equal by shape and dtype; a
    spec unpacks to (shape, dtype)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    layout: Optional[str] = field(default=REAL, compare=False)

    def __iter__(self):
        return iter((self.shape, self.dtype))


class ComputeError(Exception):
    pass


class TensorCompute:
    """Base class for all computes.

    Subclasses set ``self.outputs`` (supplied buffer names) and
    ``self.inputs`` (requested buffer names) during __init__, and implement
    ``apply``.
    """

    def __init__(self, name: str, params: Params, problem):
        self.name = name
        self.params = params
        self.problem = problem
        self.domain = problem.domain
        # default output buffer: the `buffer` param (may be a vector)
        self.outputs: List[str] = params.get_str_vector("buffer", default=[])
        self.inputs: List[str] = []

    # convenience ---------------------------------------------------------
    @property
    def out(self) -> str:
        if len(self.outputs) != 1:
            raise ComputeError(f"Compute '{self.name}' has outputs {self.outputs}")
        return self.outputs[0]

    def input_buffer(self, key: str = "input", required: bool = True) -> Optional[str]:
        name = self.params.get_str(key, required=required)
        if name is not None and name not in self.inputs:
            self.inputs.append(name)
        return name

    def input_buffers(self, key: str = "inputs") -> List[str]:
        names = self.params.get_str_vector(key)
        for n in names:
            if n not in self.inputs:
                self.inputs.append(n)
        return names

    def constant(self, key: str, default=None, required: bool = False) -> float:
        """Fetch a scalar param that may name a problem-level constant
        (reference MarlinConstantInterface / TensorProblem::getConstant,
        include/problems/TensorProblem.h:358-437)."""
        raw = self.params.get_str(key, required=required)
        if raw is None:
            return default
        try:
            return float(raw)
        except ValueError:
            return self.problem.get_constant(raw)

    # interface -----------------------------------------------------------
    def check(self):
        """Validation hook run once the whole problem is built."""

    def apply(self, state: Dict, ctx: Dict) -> Dict:
        raise NotImplementedError

    def output_specs(self, specs: Dict[str, Spec]) -> Dict[str, Spec]:
        """Spec of each output given the specs of the buffers in scope."""
        raise NotImplementedError(f"{type(self).__name__} has no shape rule")

    def __repr__(self):
        return f"{type(self).__name__}({self.name}: {self.inputs} -> {self.outputs})"


class ComputeGroup(TensorCompute):
    """Nested DAG of computes, dependency-sorted at build time
    (reference: src/tensor_computes/ComputeGroup.C:102-158)."""

    def __init__(self, name: str, params: Params, problem, members: Sequence[TensorCompute]):
        super().__init__(name, params, problem)
        self.members = list(members)
        self.sorted_members: List[TensorCompute] = []
        self._fused = False
        self._fused_members: List[int] = []
        self._update_io()

    def _update_io(self):
        supplied = set()
        requested = set()
        for m in self.members:
            supplied.update(m.outputs)
            requested.update(m.inputs)
        self.outputs = sorted(supplied)
        # group inputs = requested but not supplied internally (reference
        # TracedComputeSequence.C:34-64 external-inputs rule)
        self.inputs = sorted(requested - supplied)

    def sort(self):
        """Topological sort by buffer dataflow; error on cycles."""
        # a group whose execution list fuse_ffts() rewrote is sorted
        # already: rebuilding it from self.members would drop the
        # BatchedFFT nodes (init_state wraps the same members in a fresh
        # group whose sort() recurses into this one)
        if self._fused:
            if [id(m) for m in self.members] != self._fused_members:
                raise ComputeError(
                    f"Compute group '{self.name}' was mutated after "
                    "fuse_ffts(); re-run sort() + fuse_ffts() after any "
                    "member change (prune passes must run before fusion)"
                )
            return self
        # first supplier wins as the producer; later suppliers of the same
        # buffer (legal in MOOSE's resolver, used by e.g. LBM residual decks)
        # keep their declaration order
        producers: Dict[str, TensorCompute] = {}
        for m in self.members:
            for out in m.outputs:
                producers.setdefault(out, m)

        # edges: producer -> consumer
        indeg = {id(m): 0 for m in self.members}
        edges: Dict[int, List[TensorCompute]] = {id(m): [] for m in self.members}
        for m in self.members:
            for inp in m.inputs:
                p = producers.get(inp)
                if p is not None and p is not m:
                    edges[id(p)].append(m)
                    indeg[id(m)] += 1

        # Kahn, stable by original order
        ready = [m for m in self.members if indeg[id(m)] == 0]
        order: List[TensorCompute] = []
        while ready:
            m = ready.pop(0)
            order.append(m)
            for succ in edges[id(m)]:
                indeg[id(succ)] -= 1
                if indeg[id(succ)] == 0:
                    ready.append(succ)
        if len(order) != len(self.members):
            stuck = [m.name for m in self.members if m not in order]
            raise ComputeError(
                f"Cyclic dependency in compute group '{self.name}' among: {stuck}. "
                "Use the solver's forward_buffer parameter to break cycles."
            )
        self.sorted_members = order
        for m in order:
            if isinstance(m, ComputeGroup):
                m.sort()
        return self

    def check(self):
        for m in self.members:
            m.check()

    def fuse_ffts(self):
        """Rewrite the sorted execution list so that each run of
        independent ForwardFFT (or InverseFFT) members evaluates as one
        batched transform (``[Problem] batch_fft = true``; core.BatchedFFT).
        Only consecutive runs in the topological order fuse, and a run splits
        where a member consumes another member's output (an fft of an fft
        keeps its order).  Recurses into nested groups, sorting each first:
        nested groups run dependency-sorted even where the top level keeps
        its declared order (a deck without a solver).  Runs after sort()
        and after any carry_reciprocal pruning."""
        from .core import BatchedFFT, ForwardFFT, InverseFFT

        fused: List[TensorCompute] = []
        run: List[TensorCompute] = []
        run_cls = None

        def flush():
            nonlocal run, run_cls
            if len(run) >= 2:
                fused.append(BatchedFFT(run, self.problem, run_cls is InverseFFT))
            else:
                fused.extend(run)
            run, run_cls = [], None

        for m in self.sorted_members or self.members:
            if isinstance(m, ComputeGroup):
                flush()
                m.sort().fuse_ffts()
                fused.append(m)
                continue
            cls = type(m)
            if cls in (ForwardFFT, InverseFFT):
                if run and (cls is not run_cls or any(m.input == r.out for r in run)):
                    flush()
                run.append(m)
                run_cls = cls
            else:
                flush()
                fused.append(m)
        flush()
        self.sorted_members = fused
        self._fused = True
        self._fused_members = [id(m) for m in self.members]
        return self

    def execution_order(self) -> List[str]:
        out = []
        for m in self.sorted_members or self.members:
            if isinstance(m, ComputeGroup):
                out.extend(m.execution_order())
            else:
                out.append(m.name)
        return out

    def output_specs(self, specs: Dict[str, Spec]) -> Dict[str, Spec]:
        scope = dict(specs)
        out: Dict[str, Spec] = {}
        for m in self.sorted_members or self.members:
            upd = m.output_specs(scope)
            scope.update(upd)
            out.update(upd)
        return out

    def apply(self, state: Dict, ctx: Dict) -> Dict:
        members = self.sorted_members or self.members
        buffers = dict(state)
        updates: Dict[str, object] = {}
        for m in members:
            out = m.apply(buffers, ctx)
            buffers.update(out)
            updates.update(out)
        return updates

    def __repr__(self):
        return f"ComputeGroup({self.name}: {[m.name for m in self.members]})"
