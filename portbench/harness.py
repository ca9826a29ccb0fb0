"""One run of one cell of the benchmark.

Everything about a cell is found by name: its entry in ``BENCHMARK.json``,
its configuration (``configs/<config>/config.json`` and the deck beside
it), its traffic (``traffic/<traffic>.json``), its limits
(``limits/<workload>.json``), the comparison of its configuration's kind
(``kinds/<kind>.py``) and a reader for each metric
(``metrics/<metric>.py``).

The timed entry is ``marlin_tpu_torch.executioner.Transient.run``, on a
``Transient`` built from the deck as ``run_deck`` builds one.  After the
warm-up steps the harness raises ``num_steps`` by a chunk and calls
``run()`` again until the window's seconds have passed; the chunk is
worked out from the warm-up steps.  A wrapper around the problem's
``step_with_pps`` records when each step returns: each return follows the
step's one fetch of its postprocessor values.  The window ends in a
device synchronisation.

With ``trace`` the wrappers also synchronise at the end of
``TensorProblem.step`` (the postprocessors' time is what follows it), and
``torch.profiler`` traces ``trace_steps`` steps in the middle of the
window.  Once the window has closed and the device's peak memory has been
read, the program is freed and the cell's kind compares what the timed
path produced with the plain reference.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch

from . import trace as tracing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROFILE_ATTEMPTS = 3
CHUNK_S = 0.25  # the host time a run() call of the window aims at


class RunError(RuntimeError):
    """The run cannot give a result."""


# -- finding the pieces by name ---------------------------------------------
def _json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> Dict:
    return _json(ROOT, "BENCHMARK.json")


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise RunError(f"no workload '{name}' in BENCHMARK.json")


def config(name: str) -> Dict:
    cfg = _json(HERE, "configs", name, "config.json")
    with open(os.path.join(HERE, "configs", name, cfg["deck"])) as f:
        cfg["deck_text"] = f.read()
    return cfg


def traffic(name: str) -> Dict:
    return _json(HERE, "traffic", name + ".json")


def limits(name: str) -> Dict[str, float]:
    return _json(HERE, "limits", name + ".json")["limits"]


def module(folder: str, name: str):
    """``portbench/<folder>/<name>.py``, loaded by its path (a metric's
    name may hold dots)."""
    path = os.path.join(HERE, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(cfg: Dict):
    return importlib.import_module(f"portbench.kinds.{cfg['kind']}")


def metrics_of(bench: Dict, name: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


# -- the device --------------------------------------------------------------
def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """Wrappers on the problem's ``step_with_pps`` (and, when ``sync_step``,
    on ``step``): the host time at each step's return, the state each step
    began from and the values it fetched; with ``sync_step`` the seconds
    from the end of the step (synchronised) to that return."""

    def __init__(self, problem, device, sync_step: bool):
        self.returns: List[float] = []
        self.postprocess: List[Optional[float]] = []
        self.last_in = None
        self.last_values: Dict[str, float] = {}
        self._step_end = None
        #: the synchronisation after each step; off in the profiled steps,
        #: whose idle share it would raise
        self.syncing = sync_step
        step, step_with_pps = problem.step, problem.step_with_pps
        # spans for the trace, in the traced run only
        span = torch.profiler.record_function if sync_step else (
            lambda name: contextlib.nullcontext())

        def timed_step(*args, **kwargs):
            with span("portbench::TensorProblem.step"):
                out = step(*args, **kwargs)
            if self.syncing:
                sync(device)
            self._step_end = time.perf_counter()
            return out

        def timed_step_with_pps(state, *args, **kwargs):
            self.last_in = state
            with span("portbench::step_with_pps"):
                out = step_with_pps(state, *args, **kwargs)
            now = time.perf_counter()
            self.returns.append(now)
            self.postprocess.append(now - self._step_end if sync_step else None)
            self.last_values = dict(out[1])
            return out

        if sync_step:
            problem.step = timed_step
        problem.step_with_pps = timed_step_with_pps


def advance(transient, steps: int):
    """``steps`` more steps through ``Transient.run``; a run that stops
    short (an LBM residual early-out, a Terminator) fails."""
    transient.num_steps += steps
    transient.run()
    if transient.step_count != transient.num_steps:
        raise RunError(f"Transient.run stopped at step {transient.step_count} "
                       f"of {transient.num_steps}")


def profile(transient, timer: StepTimer, steps: int, substeps: int, device,
            out_dir: str) -> Dict:
    """Trace ``steps`` steps with torch.profiler (host and device), with
    the timer's synchronisation after each step off; a trace without
    device operations is taken again."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    path = os.path.join(out_dir, "trace.json")
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        sync(device)
        timer.syncing = False
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(tracing.SPAN):
                advance(transient, steps)
                sync(device)
        timer.syncing = True
        prof.export_chrome_trace(path)
        reduced = tracing.reduce(tracing.load(path), steps * substeps)
        os.remove(path)
        if reduced is not None:
            reduced["steps"] = steps * attempt
            return reduced
    raise RunError(f"{PROFILE_ATTEMPTS} traces in a row held no device operation")


# -- one run -----------------------------------------------------------------
def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             started: Optional[float] = None, sizes: Optional[Dict] = None,
             control: bool = False) -> Dict:
    """One run of workload ``name``: returns the result line's object and,
    under ``"record"``, what the metric readers read.  ``sizes`` replaces
    the configuration's sizes (the tests' small grids); ``control`` adds,
    under ``"control"``, the readings of the reference stored in the
    precision below the configuration's, put in the program's place."""
    started = time.perf_counter() if started is None else started
    device = torch.device(device)
    bench = benchmark()
    wl = workload(bench, name)
    cfg = config(wl["config"])
    if sizes:
        cfg["sizes"] = {**cfg["sizes"], **sizes}
    tr_cfg = traffic(wl["traffic"])
    cfg["chips"] = wl["chips"]
    cell = kind(cfg).Cell(cfg, seed, device)

    from marlin_tpu_torch import hit

    record: Dict = {"import_s": time.perf_counter() - started}
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    record["cuda_init_s"] = time.perf_counter() - started - record["import_s"]
    root = hit.parse(cfg["deck_text"].format(**cell.deck_fields()))
    hit.apply_cli_args(root, list(tr_cfg.get("overrides", [])))
    out_dir = tempfile.mkdtemp(prefix="portbench_")
    try:
        return _run(name, seconds, trace, device, started, bench, cfg, tr_cfg,
                    cell, root, out_dir, record, control)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _run(name, seconds, trace, device, started, bench, cfg, tr_cfg, cell,
         root, out_dir, record, control) -> Dict:
    from marlin_tpu_torch.executioner import Transient
    from marlin_tpu_torch.params import check_unused
    from marlin_tpu_torch.problem import TensorProblem

    sync(device)
    t0 = time.perf_counter()
    problem = TensorProblem(root, device=device, arrays=cell.arrays())
    transient = Transient(problem, exec_node=root.children.get("Executioner"),
                          outputs_node=root.children.get("Outputs"),
                          user_objects_node=root.children.get("UserObjects"),
                          output_dir=out_dir)
    transient.init()
    check_unused(root, strict=problem.problem_params.get_bool("strict_params", False))
    transient.num_steps = 0
    sync(device)
    record["init_s"] = time.perf_counter() - t0
    record["allocated_after_init"] = (torch.cuda.memory_allocated(device)
                                      if device.type == "cuda" else None)

    timer = StepTimer(problem, device, sync_step=trace)
    substeps = int(cfg["sizes"]["substeps"])
    warm = int(tr_cfg["warm_steps"])
    t1 = time.perf_counter()
    advance(transient, 1)
    record["first_step_s"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    advance(transient, warm - 1)
    rest = (time.perf_counter() - t2) / max(1, warm - 1)
    record["warm_steps_s"] = time.perf_counter() - t2
    cell.capture_start(transient.state, warm)
    chunk = record["chunk"] = max(1, int(CHUNK_S / max(rest, 1e-6)))
    if trace and device.type == "cuda":
        # the profiler's first start loads CUPTI: once here, in set-up
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            sync(device)
    sync(device)

    # -- the window ----------------------------------------------------------
    first = len(timer.returns)
    w0 = time.perf_counter()
    record["setup_s"] = w0 - started
    traced, traced_steps = None, int(tr_cfg["trace_steps"])
    while True:
        if trace and traced is None and time.perf_counter() - w0 >= seconds / 2:
            traced_at = len(timer.returns)
            traced = profile(transient, timer, traced_steps, substeps, device, out_dir)
        advance(transient, chunk)
        if time.perf_counter() - w0 >= seconds:
            break
    if trace and traced is None:
        traced_at = len(timer.returns)
        traced = profile(transient, timer, traced_steps, substeps, device, out_dir)
    sync(device)
    w1 = time.perf_counter()
    returns = timer.returns[first:]
    record.update(window_s=w1 - w0, steps=len(returns), substeps=len(returns) * substeps,
                  step_s=[b - a for a, b in zip([w0] + returns[:-1], returns)])
    record["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                            if device.type == "cuda" else None)
    if trace:
        skip = set(range(traced_at, traced_at + traced["steps"]))
        record["postprocess_s"] = [p for i, p in enumerate(timer.postprocess)
                                   if i >= first and i not in skip]
        record["trace"] = traced
    bytes_, flops = cell.work_per_substep()
    record["work"] = {"bytes": bytes_, "flops": flops}
    record["peaks"] = _json(HERE, "peaks.json")

    # -- the comparison, with the program freed --------------------------------
    cell.capture_last(timer.last_in, transient.state, timer.last_values)
    del timer, transient, problem, root
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    lim = limits(name)
    readings = cell.readings()
    control_readings = cell.control() if control else None
    cell.release()
    checks = {k: {"value": v, "limit": lim[k]} for k, v in readings.items()}
    wrong = [k for k, c in checks.items()
             if not (math.isfinite(c["value"]) and c["value"] <= c["limit"])]

    result = {"correct": not wrong, "attempted": record["steps"], "failed": len(wrong)}
    result["metrics"] = {}
    for m in metrics_of(bench, name, trace):
        value = module("metrics", m["name"]).read(record)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                        "kind": (torch.cuda.get_device_name(device)
                                 if device.type == "cuda" else "cpu"),
                        "count": int(cfg["chips"]),
                        "memory_peak_bytes": record["peak_bytes"]}
    if trace:
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = checks
    if control:
        result["control"] = control_readings
    result["record"] = record
    return result


def check_lines(checks: Dict[str, Dict]) -> Sequence[str]:
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
