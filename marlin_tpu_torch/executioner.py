"""Transient executioner, time steppers, Terminator, outputs, checkpoints.

A port of marlin_tpu/executioner.py: the host-side time loop around the
eager step.  Only scalar postprocessor values cross to the host each step;
field outputs ([TensorOutputs] XDMF, ``[Outputs] exodus``), vector
postprocessors and checkpoints fetch buffers on their own cadence.
``[Outputs] perf_graph = true`` (or ``--timing``) prints the problem's
performance graph (``perf.PerfGraph``, ``Transient.perf``) at the end of
each ``run``: the JAX executioner's sections ("outputs" holds the CSV, the
field outputs and the vector postprocessors, "checkpoint" the checkpoint
writes, ``solver::step`` a step to its fetch) and the spans inside them,
with device time on the card; ``transient.perf.enabled = True`` records
without printing.
``checkpoint_interval = N`` writes ``<file_base>_checkpoint.npz`` every N
steps (``checkpoint.py``, the JAX package's layout); ``Transient.recover``
resumes from one, bit for bit.  On a mesh every rank runs the loop and
takes part in every gather of an output, a vector postprocessor or a
checkpoint, in the same order; rank 0 writes the CSV, the Exodus file,
the vector postprocessors' files and the checkpoint, and each rank its
own XDMF frames.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from . import checkpoint, parallel, perf
from .exodus import ExodusOutput
from .expression import fparse
from .hit import HitNode
from .outputs import build_tensor_outputs
from .params import Params, check_unused
from .problem import TensorProblem


class TimeStepper:
    def __init__(self, params: Params):
        self.dt0 = params.get_float("dt", 1.0)

    def dt(self, step: int, dt_old: float, solver_info: Optional[dict]) -> float:
        return self.dt0


class IterationAdaptiveDT(TimeStepper):
    """MOOSE IterationAdaptiveDT / the reference's
    TensorSolveIterationAdaptiveDT (src/timesteppers/
    TensorSolveIterationAdaptiveDT.C:12-160; marlin_tpu/executioner.py:31-98):

    - with iteration bounds (``optimal_iterations`` ± ``iteration_window``,
      or ``min_iterations``/``max_iterations``) and an iterative solver:
      cut dt by cutback_factor when the last substep took more than
      max_iterations, grow it by growth_factor only below min_iterations,
      hold it otherwise; without either, grow from step 2 on;
    - a FAILED (non-converged) solve re-attempts the same step at dt ×
      cutback_factor_at_failure (computeFailedDT :111-129), and dt does not
      grow on the first step after a cutback (computeDT :76-94);
    - dt is capped by the smallest `timestep_limiting_postprocessor` value
      from step 2 on (limitDTToPostprocessorValue :131-159)."""

    def __init__(self, params: Params):
        super().__init__(params)
        self.growth_factor = params.get_float("growth_factor", 2.0)
        self.cutback_factor = params.get_float("cutback_factor", 0.5)
        self.cutback_factor_at_failure = params.get_float(
            "cutback_factor_at_failure", 0.5
        )
        self.optimal_iterations = params.get_int("optimal_iterations", None)
        self.iteration_window = params.get_int(
            "iteration_window",
            int(self.optimal_iterations / 5) if self.optimal_iterations else 0,
        )
        self.min_iterations = params.get_int("min_iterations", None)
        self.max_iterations = params.get_int("max_iterations", None)
        if self.optimal_iterations is not None:
            if self.min_iterations is None:
                self.min_iterations = self.optimal_iterations - self.iteration_window
            if self.max_iterations is None:
                self.max_iterations = self.optimal_iterations + self.iteration_window
        self.limiting_pps = params.get_str_vector(
            "timestep_limiting_postprocessor", []
        )
        self.cutback_occurred = False

    def dt(self, step, dt_old, solver_info):
        if step <= 1:
            return self.dt0
        allow_growth = not self.cutback_occurred
        self.cutback_occurred = False
        dt = dt_old
        iteration_based = (
            self.min_iterations is not None or self.max_iterations is not None
        )
        if solver_info is not None and iteration_based:
            its = solver_info.get("iterations", 0)
            if self.max_iterations is not None and its > self.max_iterations:
                dt = dt_old * self.cutback_factor
            elif (
                allow_growth
                and self.min_iterations is not None
                and its < self.min_iterations
            ):
                dt = dt_old * self.growth_factor
        elif allow_growth:
            dt = dt_old * self.growth_factor
        return dt

    def failed_dt(self, dt):
        self.cutback_occurred = True
        return dt * self.cutback_factor_at_failure

    def limit_to_pps(self, dt, step, pp_values):
        if not self.limiting_pps or step <= 1:
            return dt
        limit = min(pp_values.get(n, float("inf")) for n in self.limiting_pps)
        return min(dt, limit) if limit < dt else dt


def build_stepper(exec_node: Optional[HitNode], global_params) -> TimeStepper:
    if exec_node is not None:
        ts = exec_node.children.get("TimeStepper") or exec_node.children.get(
            "TimeSteppers"
        )
        if ts is not None:
            p = Params(ts, global_params)
            t = p.get_str("type", "ConstantDT")
            if t in ("IterationAdaptiveDT", "TensorSolveIterationAdaptiveDT"):
                return IterationAdaptiveDT(p)
            return TimeStepper(p)
    return TimeStepper(Params(exec_node, global_params))


class Terminator:
    """[UserObjects] Terminator: act when an expression over postprocessor
    values becomes true (reference
    benchmarks/01_spinodal_decomposition/1a.i:107-111).  fail_mode = HARD
    (default) ends the run, as an error for error_level = ERROR;
    fail_mode = SOFT fails the current timestep so the stepper retries it."""

    def __init__(self, params: Params):
        self.expression = params.get_str("expression", required=True)
        self.fail_mode = params.get_enum("fail_mode", ["HARD", "SOFT"], "HARD")
        self.error_level = params.get_enum(
            "error_level", ["NONE", "INFO", "WARNING", "ERROR"], "INFO")
        self.message = params.get_str("message", None)

    def check(self, pp_values: Dict[str, float]) -> bool:
        try:
            return fparse(self.expression, pp_values) != 0.0
        except Exception as e:
            raise RuntimeError(
                f"Terminator expression '{self.expression}' failed to "
                f"evaluate: {e}"
            ) from e


class CSVWriter:
    """MOOSE-compatible CSV output: `time` column + ASCII-sorted
    postprocessor columns, 14 significant digits; rows are appended every
    step so an aborted run keeps what it wrote."""

    def __init__(self, path: str):
        self.path = path
        self.rows: List[Dict[str, float]] = []
        self.columns: List[str] = []
        self._written = 0
        self._written_cols = None

    def add_row(self, time: float, values: Dict[str, float]):
        row = {"time": time}
        row.update(values)
        for k in values:
            if k not in self.columns:
                self.columns.append(k)
        self.rows.append(row)

    @staticmethod
    def _fmt(x: float) -> str:
        if x == 0:
            return "0"
        return f"{x:.14g}"

    def write(self):
        cols = ["time"] + sorted(self.columns)
        rewrite = cols != self._written_cols
        with open(self.path, "w" if rewrite else "a") as f:
            if rewrite:
                f.write(",".join(cols) + "\n")
                self._written = 0
            for row in self.rows[self._written:]:
                f.write(",".join(self._fmt(row.get(c, 0.0)) for c in cols) + "\n")
        self._written_cols = cols
        self._written = len(self.rows)


class Transient:
    """The time loop: dt scheduling, solver stepping, postprocessor and CSV
    output, terminator checks."""

    def __init__(
        self,
        problem: TensorProblem,
        exec_node: Optional[HitNode] = None,
        outputs_node: Optional[HitNode] = None,
        user_objects_node: Optional[HitNode] = None,
        file_base: Optional[str] = None,
        output_dir: str = ".",
    ):
        self.problem = problem
        gp = problem.global_params
        p = Params(exec_node, gp)
        self.num_steps = p.get_int("num_steps", 10**9)
        self.start_time = p.get_float("start_time", 0.0)
        self.end_time = p.get_float("end_time", 1e30)
        self.dtmin = p.get_float("dtmin", 1e-12)
        self.dtmax = p.get_float("dtmax", 1e30)
        self.stepper = build_stepper(exec_node, gp)
        if "dt" in (exec_node.params if exec_node is not None else {}):
            self.stepper.dt0 = p.get_float("dt")

        self.terminators: List[Terminator] = []
        if user_objects_node is not None:
            for b in user_objects_node.blocks():
                bp = Params(b, gp)
                btype = bp.get_str("type")
                if btype != "Terminator":
                    raise ValueError(
                        f"[UserObjects/{b.name}] type = {btype} is not ported "
                        "to marlin_tpu_torch yet (Terminator only)")
                self.terminators.append(Terminator(bp))

        self.output_dir = output_dir or "."
        self.csv = None
        # on a mesh every rank runs the loop; rank 0 alone writes the CSV
        # and prints (the postprocessor values are the group's already)
        mesh = problem.domain.mesh
        self.rank0 = mesh is None or mesh.rank == 0
        op = Params(outputs_node, gp)
        deck_file_base = op.get_str("file_base", None)
        self.file_base = file_base or deck_file_base or "out"
        csv_enabled = op.get_bool("csv", False)
        # [Outputs] exodus = true (or a type = Exodus sub-block): the aux
        # variables and postprocessors to <file_base>.e (exodus.py)
        exodus_enabled = op.get_bool("exodus", False)
        if outputs_node is not None:
            for b in outputs_node.blocks():
                btype = Params(b, gp).get_str("type")
                if btype == "CSV":
                    csv_enabled = True
                elif btype == "Exodus":
                    exodus_enabled = True
                elif btype is not None:
                    raise ValueError(
                        f"Unknown [Outputs] sub-block type '{btype}' "
                        f"(block '{b.name}')"
                    )
        os.makedirs(self.output_dir, exist_ok=True)
        if csv_enabled and self.rank0:
            self.csv = CSVWriter(os.path.join(self.output_dir, self.file_base + ".csv"))
        # field outputs: Exodus here, [TensorOutputs] added by run_deck
        self.tensor_outputs = []
        if exodus_enabled:
            self.tensor_outputs.append(ExodusOutput(
                os.path.join(self.output_dir, self.file_base + ".e"), problem))
        # perf graph (reference `perf_graph = true`, MOOSE TIME_SECTION):
        # the problem's, so that its build is in it too
        self.perf = problem.perf
        self.print_perf = op.get_bool("perf_graph", False)
        if self.print_perf:
            self.perf.enabled = True

        self.state = None
        self.time = self.start_time
        self.step_count = 0
        # attempts re-run at a cut dt: non-converged solves, SOFT terminators
        self.rejected_steps = 0
        self.pp_values: Dict[str, float] = {}
        # an LBM problem's convergence residual, fetched with each step's
        # postprocessor values (None: not fetched yet)
        self._lbm_residual: Optional[float] = None
        # the last step's dt (nonzero once a step ran or a checkpoint was
        # recovered) and the vector postprocessors' file counter
        self._last_dt = 0.0
        self._vpp_counter = 0
        # checkpoint/resume (the reference checkpoints no tensor buffers,
        # SURVEY §5.4; this is the full-state superset)
        self.checkpoint_interval = p.get_int("checkpoint_interval", 0)
        self.checkpoint_path = os.path.join(
            self.output_dir, self.file_base + "_checkpoint.npz")

    def init(self):
        with self.perf.active():
            self._init()

    def _init(self):
        with self.perf.span("problem::init_state (build + ICs)"):
            self.state = self.problem.init_state()
        self.time = self.start_time
        # EXEC_INITIAL: CSV row 0 reports 0 for TIMESTEP_END-only
        # postprocessors (MOOSE semantics)
        initial = self.problem.execute_postprocessors(
            self.state, "INITIAL", self.time, 0.0
        )
        self.pp_values = {pp.name: 0.0 for pp in self.problem.postprocessors}
        self.pp_values.update(initial)
        # INITIAL-only aux kernels keep their t=0 projection even if the
        # first output sampling happens at a later step
        self.problem.aux.seed_initial(self.state)
        self._vpp_counter = 0
        with self.perf.span("outputs"):
            if self.csv is not None:
                self.csv.add_row(self.time, dict(self.pp_values))
            self._run_outputs(initial=True)
            self._write_vpps("INITIAL")

    def _run_outputs(self, initial=False):
        for out in self.tensor_outputs:
            if getattr(out, "wants_pp_values", False):
                out.output(self.problem, self.state, self.time,
                           initial=initial, pp_values=self.pp_values)
            else:
                out.output(self.problem, self.state, self.time, initial=initial)

    def _write_vpps(self, flag):
        """Vector postprocessor CSV series: <file_base>_<name>_NNNN.csv
        (MOOSE naming convention).  On a mesh every rank computes (a
        histogram's counts are summed over the ranks) and rank 0 writes."""
        active = [v for v in self.problem.vector_postprocessors
                  if flag in v.execute_on]
        if flag == "TIMESTEP_END":
            self._vpp_counter += 1
        for v in active:
            cols = v.compute(self.state, {"t": self.time})
            if not self.rank0:
                continue
            path = os.path.join(
                self.output_dir,
                f"{self.file_base}_{v.name}_{self._vpp_counter:04d}.csv")
            names = list(cols)
            rows = zip(*[cols[c] for c in names])
            with open(path, "w") as f:
                f.write(",".join(names) + "\n")
                for row in rows:
                    f.write(",".join(CSVWriter._fmt(x) for x in row) + "\n")

    def save_checkpoint(self):
        """Write the checkpoint.  On a mesh every rank sends its blocks to
        rank 0 (``TensorProblem.gathered_state``), rank 0 writes the
        global arrays in the serial layout, and every rank waits at a
        barrier, so that no rank reads the file before it is whole."""
        with self.perf.active(), self.perf.span("checkpoint"):
            state = self.problem.gathered_state(self.state)
            if self.rank0:
                checkpoint.save(
                    self.checkpoint_path, state, self.time, self.step_count,
                    self._last_dt, self.pp_values,
                    aux_cache=self.problem.aux._initial_cache)
            parallel.barrier(self.problem.domain.mesh)

    def recover(self, path=None):
        """Resume from a checkpoint of either package (default: this
        run's own): restores the state, time, step count, last dt,
        postprocessor values and INITIAL-only aux samples.  Works without
        ``init()``; ``run()`` then goes on from the restored step.  On a
        mesh every rank reads the file and keeps its blocks, whatever mesh
        (or none) wrote it; several hosts need the file on a file system
        they share."""
        with self.perf.active(), self.perf.span("checkpoint::read"):
            state, meta = self.problem.load_checkpoint(path or self.checkpoint_path)
        self.state = state
        self.time = meta["time"]
        self.step_count = meta["step"]
        self._vpp_counter = meta["step"]
        self._last_dt = meta["dt"]
        self._lbm_residual = None  # re-fetch from the restored state
        self.pp_values = dict(meta.get("pp_values", {}))
        # the saved samples are the only valid source: the t=0 state is gone
        self.problem.aux._initial_cache.update(meta.get("aux_cache", {}))

    def run(self) -> Dict[str, float]:
        with self.perf.active():
            values = self._run()
        if self.print_perf and self.rank0:
            print(self.perf.report())
        return values

    def _run(self) -> Dict[str, float]:
        if self.state is None:
            self._init()
        dt_old = self._last_dt  # nonzero when resuming from a checkpoint
        dt = self._last_dt or self.stepper.dt0
        solver_info = None
        while self.step_count < self.num_steps and self.time < self.end_time - 1e-13:
            # LBM convergence early-out (reference LatticeBoltzmannProblem::
            # execute :74 — once the residual drops below tolerance, all
            # further execution is skipped)
            if self.problem.is_lbm:
                res = self._lbm_residual
                if res is None:
                    res = float(self.state["solver"]["residual"])
                    perf.count("fetches")
                if res < self.problem.lbm_tolerance:
                    break
            self.step_count += 1
            dt = self.stepper.dt(self.step_count, dt, solver_info)
            if hasattr(self.stepper, "limit_to_pps"):
                dt = self.stepper.limit_to_pps(dt, self.step_count, self.pp_values)
            dt = min(dt, self.dtmax, self.end_time - self.time)
            dt = max(dt, self.dtmin)

            # attempt the step; a solve that did not converge, or a SOFT
            # terminator, fails the CURRENT step and it is re-attempted at
            # cut dt (MOOSE Transient semantics; the reference's
            # computeFailedDT, TensorSolveIterationAdaptiveDT.C:111-129).
            # The pre-step state is never written in place, so rejection
            # costs no copy.
            prev_state = self.state
            while True:
                self.perf.step = self.step_count
                # ends at the postprocessors' fetch, the step's one sync
                with self.perf.span(perf.FIRST_STEP if self.step_count == 1
                                    else perf.STEP):
                    self.state, values = self.problem.step_with_pps(
                        prev_state, self.time, dt, dt_old,
                        first_step=(self.step_count == 1),
                    )
                solver_info = self._solver_info()
                soft_fired = any(
                    t.check({**self.pp_values, **values})
                    for t in self.terminators if t.fail_mode == "SOFT"
                )
                solve_ok = solver_info is None or solver_info["converged"]
                if solve_ok and not soft_fired:
                    break
                if not hasattr(self.stepper, "failed_dt"):
                    if soft_fired:
                        raise RuntimeError(
                            "Terminator fired with fail_mode = SOFT but the "
                            "TimeStepper cannot cut back the timestep (no "
                            "IterationAdaptiveDT); cannot continue!"
                        )
                    # a solve that did not converge under a constant dt:
                    # the solver rolled back to the old solution, and the
                    # run continues (SecantSolver.C:185-193)
                    break
                if dt <= self.dtmin:
                    raise RuntimeError(
                        "Solve failed and timestep already at dtmin, "
                        "cannot continue!"
                    )
                self.rejected_steps += 1
                dt = max(self.stepper.failed_dt(dt), self.dtmin)
            self._last_dt = dt
            self.time += dt
            dt_old = dt
            # internal early-out scalar: consume it before it reaches the
            # CSV and the console tables
            self._lbm_residual = values.pop("_lbm_residual", None)
            self.pp_values.update(values)
            with self.perf.span("outputs"):
                if self.csv is not None:
                    self.csv.add_row(self.time, dict(self.pp_values))
                    self.csv.write()
                self._run_outputs()
                self._write_vpps("TIMESTEP_END")
            if (self.checkpoint_interval
                    and self.step_count % self.checkpoint_interval == 0):
                self.save_checkpoint()

            hard_fired = [t for t in self.terminators
                          if t.fail_mode == "HARD" and t.check(self.pp_values)]
            if hard_fired:
                t = hard_fired[0]
                msg = t.message or (
                    f"Terminator expression '{t.expression}' is true")
                if t.error_level == "ERROR":
                    raise RuntimeError(msg)
                if t.error_level != "NONE" and self.rank0:
                    print(msg)
                break

        with self.perf.span("outputs"):
            if self.csv is not None:
                self.csv.write()
            for out in self.tensor_outputs:
                out.finalize()
        return self.pp_values

    def _solver_info(self):
        """The last substep's iterations and convergence of an iterative
        solver, or None (marlin_tpu/executioner.py:500-507); host values."""
        sstate = self.state["solver"]
        if "iterations" not in sstate:
            return None
        return {"iterations": int(sstate["iterations"]),
                "converged": bool(sstate["converged"])}


def run_deck(
    root: HitNode,
    file_base: Optional[str] = None,
    output_dir: str = ".",
    device=None,
    deck_dir: Optional[str] = None,
    arrays=None,
    deck_stem: Optional[str] = None,
    recover: Optional[str] = None,
    mesh=None,
) -> Transient:
    """Build and run a full deck on ``device`` (default "cuda"); returns the
    finished Transient (marlin_tpu/executioner.py:run_deck).  ``deck_dir``
    and ``arrays`` go to TensorProblem (LBM buffer files); ``deck_stem`` is
    the [TensorOutputs]' default file base; ``recover`` is a checkpoint to
    resume from in place of the initial state; ``mesh`` (a
    ``parallel.Mesh``, this process one of its ranks) runs a
    ``parallel_mode`` deck distributed, each rank on its block."""
    problem = TensorProblem(root, device=device, deck_dir=deck_dir, arrays=arrays,
                            mesh=mesh)
    transient = Transient(
        problem,
        exec_node=root.children.get("Executioner"),
        outputs_node=root.children.get("Outputs"),
        user_objects_node=root.children.get("UserObjects"),
        file_base=file_base,
        output_dir=output_dir,
    )
    # [TensorOutputs]: XDMF field outputs
    tout = root.children.get("TensorOutputs")
    if tout is not None:
        transient.tensor_outputs.extend(build_tensor_outputs(
            tout, problem, output_dir=transient.output_dir,
            default_file_base=deck_stem))
    if recover is not None:
        transient.recover(recover)
    else:
        transient.init()
    # unknown-parameter audit after every object has read its keys
    check_unused(
        root, strict=problem.problem_params.get_bool("strict_params", False)
    )
    transient.run()
    return transient
