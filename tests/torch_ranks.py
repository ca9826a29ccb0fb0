"""Ranks for the port's distributed tests, on the CPU.

``spawn(world, cases, tmp_path)`` starts ``world`` processes with
torch.multiprocessing (spawn), each joining a gloo group through a file
store under ``tmp_path`` (no port, so parallel test workers cannot
collide), with one thread each.  Every rank runs the listed cases, each a
function of this module by name with its keyword arguments, and sends its
results back.  The parent collects them against a deadline: a rank that
raises, dies or hangs fails the caller's test, and every rank left is
killed, so no rank can hang the suite.  This module imports the port and
not the JAX package, so a rank never loads JAX.
"""

from __future__ import annotations

import datetime
import os
import queue
import time
import traceback

import numpy as np
import torch

DEADLINE = 150.0  # seconds for a spawn's whole list of cases


def _child(rank, world, store, cases, q):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        for i, (name, kw) in enumerate(cases):
            try:
                q.put((rank, i, "ok", globals()[name](**kw)))
            except Exception:
                q.put((rank, i, "error", traceback.format_exc()))
                return
    finally:
        dist.destroy_process_group()


def spawn(world: int, cases, tmp_path, deadline: float = DEADLINE):
    """Run ``cases`` ([(name, kwargs), ...]) on ``world`` ranks; returns, a
    case, the list of the ranks' results in rank order."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store_{world}_{time.monotonic_ns()}")
    procs = [ctx.Process(target=_child, args=(r, world, store, cases, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    end = time.monotonic() + deadline
    try:
        while len(results) < world * len(cases):
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks did not finish {cases} in "
                                   f"{deadline} s")
            try:
                rank, i, kind, value = q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and p.exitcode != 0]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if kind == "error":
                raise RuntimeError(f"rank {rank}, case {cases[i][0]}:\n{value}")
            results[(rank, i)] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(results) == world * len(cases) else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [[results[(r, i)] for r in range(world)] for i in range(len(cases))]


def assemble(blocks, shape):
    """The global array from every rank's (slices, block)."""
    first = blocks[0][1]
    out = np.zeros(tuple(shape) + first.shape[len(shape):], first.dtype)
    for sl, b in blocks:
        out[sl] = b
    return out


# ---------------------------------------------------------------------------
# cases (run on every rank)
# ---------------------------------------------------------------------------


def _mesh(mode, shape=None):
    from marlin_tpu_torch import parallel

    return parallel.make_mesh(mode, shape=shape)


def slab_fft(dim, n, complex_input, seed=0):
    """The forward and inverse slab transforms of a seeded field: this
    rank's (reciprocal slice, spectrum block) and (real slice, inverse)."""
    from marlin_tpu_torch.domain import Domain

    dom = Domain(dim, n, parallel_mode="FFT_SLAB", floating_precision="DOUBLE",
                 device="cpu", mesh=_mesh("FFT_SLAB"))
    rng = np.random.RandomState(seed)
    g = rng.randn(*n)
    if complex_input:
        g = g + 1j * rng.randn(*n)
    x = torch.from_numpy(np.ascontiguousarray(g[dom.real_slice]))
    z = dom.fft(x)
    sl = dom.full_slice if complex_input else dom.reciprocal_slice
    return {"spectrum": (sl, z.numpy()), "back": (dom.real_slice, dom.ifft(z).numpy()),
            "uneven": dom.uneven}


def pencil_fft(n, shape, complex_input=False, seed=0, kspace=False):
    """The forward and inverse pencil transforms of a seeded field on a
    (p1, p2) mesh: this rank's (reciprocal slice, spectrum block), (real
    slice, inverse), the pad and the exchanges made; with ``kspace`` also
    the inverse of the spectrum divided by 1 + 0.01·k² (a pointwise k²
    operator between the transforms)."""
    from marlin_tpu_torch import parallel
    from marlin_tpu_torch.domain import Domain

    dom = Domain(3, n, maxs=[1.0, 2.0, 3.0], parallel_mode="FFT_PENCIL",
                 floating_precision="DOUBLE", device="cpu",
                 mesh=_mesh("FFT_PENCIL", shape))
    rng = np.random.RandomState(seed)
    g = rng.rand(*n)
    if complex_input:
        g = g + 1j * rng.rand(*n)
    x = torch.from_numpy(np.ascontiguousarray(g[dom.real_slice]))
    parallel.reset_calls()
    z = dom.fft(x)
    back = dom.ifft(z)
    out = {"spectrum": (dom.full_slice if complex_input else dom.reciprocal_slice,
                        z.numpy()),
           "back": (dom.real_slice, back.numpy()), "pad": dom.reciprocal_pad,
           "reciprocal_shape": dom.global_reciprocal_shape,
           "calls": parallel.calls()}
    if kspace:
        out["kspace"] = (dom.real_slice,
                         dom.ifft(z / (1.0 + 0.01 * dom.k_square)).numpy())
    return out


def counts_of(problem, names):
    """The host loops' counts of the computes ``names`` (FFTMechanics:
    its counts and CG log; NEML2TensorCompute: each Newton model's log)
    and of the solver, where it keeps any."""
    import dataclasses

    out = {}
    for name in names:
        c = problem.get_compute(name)
        if hasattr(c, "model"):
            from marlin_tpu_torch.computes.neml2 import walk_models

            out[name] = [list(m.counts.log) for m in walk_models(c.model)
                         if hasattr(m, "counts")]
        else:
            out[name] = dict(dataclasses.asdict(c.counts), cg_log=list(c.cg_log))
    counts = getattr(problem.solver, "counts", None)
    if counts is not None:
        out["solver"] = dataclasses.asdict(counts)
    return out


def deck_run(text, steps, mode, mesh_shape=None, arrays=None, buffers=(), old=(),
             how="steps", dt=1.0, output_dir=None, initial=(), counts=(), deck_dir=None,
             path=None, overrides=()):
    """A deck on the mesh of every rank.  ``how`` "steps": the
    problem's steps at ``dt`` from t = 0, as the JAX package's tests drive
    them (the first one the first step); "run_deck": the whole run, its
    CSV in ``output_dir``/rank<r>.  ``overrides`` are command-line
    arguments to the deck; with ``path`` the deck is that file (``text``
    unused).  Returns this rank's slices and blocks
    of ``buffers`` (None: every one) and of the history stacks ``old``,
    the initial state's blocks of ``initial`` (under "steps"), the
    residual, the advances, the loops' counts (``counts_of``), the
    collectives of the run (``parallel.calls()``) and, under run_deck, the
    postprocessor values."""
    import torch.distributed as dist

    from marlin_tpu_torch import hit, parallel
    from marlin_tpu_torch.executioner import run_deck
    from marlin_tpu_torch.problem import TensorProblem

    mesh = _mesh(mode, mesh_shape)
    parallel.reset_calls()
    res = {}
    def load():
        if path:
            return hit.load(path, list(overrides))
        root = hit.parse(text)
        hit.apply_cli_args(root, list(overrides))
        return root

    if how == "steps":
        p = TensorProblem(load(), device="cpu", arrays=arrays, mesh=mesh,
                          deck_dir=deck_dir)
        st = p.init_state()
        res["initial"] = {k: st["buffers"][k].numpy().copy() for k in initial}
        for i in range(steps):
            st = p.step(st, i * dt, dt, dt, i == 0)
    else:
        root = load()
        root.child("Executioner", create=True).set_param("num_steps", str(steps))
        out = os.path.join(output_dir, f"rank{dist.get_rank()}")
        tr = run_deck(root, device="cpu", mesh=mesh, arrays=arrays, output_dir=out,
                      deck_dir=deck_dir)
        p, st = tr.problem, tr.state
        res["pps"] = dict(tr.pp_values)
    dom = p.domain
    names = st["buffers"] if buffers is None else buffers
    res.update({
        "slice": dom.real_slice, "reciprocal_slice": dom.reciprocal_slice,
        "n_advances": st["n_advances"],
        "buffers": {k: st["buffers"][k].numpy() for k in names},
        "old": {k: st["old"][k].numpy() for k in (st["old"] if old is None else old)}})
    if "residual" in st["solver"]:
        res["residual"] = float(st["solver"]["residual"])
    res["counts"] = counts_of(p, counts)
    res["calls"] = parallel.calls()
    return res


def named_error(text, mode, output_dir, mesh_shape=None, steps=2, arrays=None):
    """The message of what a whole run of a deck on the mesh raises, or
    None."""
    try:
        deck_run(text, steps, mode, mesh_shape, arrays=arrays, buffers=(),
                 how="run_deck", output_dir=output_dir)
    except Exception as e:  # the test reads the words
        return f"{type(e).__name__}: {e}"
    return None


def outputs_run(text, mode, output_dir, steps=2, mesh_shape=None, arrays=None):
    """A whole run of a deck on the mesh of every rank, all ranks writing
    into the one directory ``output_dir`` (file base "out", deck stem
    "det"), as one process of the JAX package writes its per-rank files.
    Returns the postprocessor values and this rank's real-space slice."""
    from marlin_tpu_torch import hit
    from marlin_tpu_torch.executioner import run_deck

    mesh = _mesh(mode, mesh_shape)
    root = hit.parse(text)
    root.child("Executioner", create=True).set_param("num_steps", str(steps))
    tr = run_deck(root, device="cpu", mesh=mesh, arrays=arrays, output_dir=output_dir,
                  file_base="out", deck_stem="det")
    return {"pps": dict(tr.pp_values), "slice": tr.problem.domain.real_slice}


def _leaves(problem, state):
    """Every leaf of ``state`` as numpy with its recorded layout, and the
    rank's slices of each layout."""
    dom = problem.domain
    layout = problem.state_layout(state)
    out = {part: {k: (np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v),
                      layout[part][k]) for k, v in state[part].items()}
           for part in ("buffers", "old", "solver")}
    out["n_advances"] = int(state["n_advances"])
    out["old_dt"] = tuple(state["old_dt"])
    out["slices"] = {"real": dom.real_slice, "reciprocal": dom.reciprocal_slice,
                     "full": dom.full_slice}
    return out


def resume_run(text, mode, output_dir, steps, mesh_shape=None, arrays=None,
               checkpoint_at=0, recover=None):
    """One run of a deck on the mesh of every rank, its outputs in
    ``output_dir``/rank<r> and its checkpoint in ``output_dir`` (rank 0
    writes it): ``steps`` steps from the start, checkpointing every
    ``checkpoint_at`` (0: never), or from the checkpoint ``recover`` on.
    Returns this rank's leaves (``_leaves``), the postprocessor values,
    the checkpoint's path and the CSV rows."""
    import torch.distributed as dist

    from marlin_tpu_torch import hit
    from marlin_tpu_torch.executioner import run_deck

    mesh = _mesh(mode, mesh_shape)
    root = hit.parse(text)
    ex = root.child("Executioner", create=True)
    ex.set_param("num_steps", str(steps))
    if checkpoint_at:
        ex.set_param("checkpoint_interval", str(checkpoint_at))
    out = os.path.join(output_dir, f"rank{dist.get_rank()}")
    tr = run_deck(root, device="cpu", mesh=mesh, arrays=arrays, output_dir=out,
                  file_base="ck", recover=recover)
    res = _leaves(tr.problem, tr.state)
    res["pps"] = dict(tr.pp_values)
    res["checkpoint"] = tr.checkpoint_path
    csv = os.path.join(out, "ck.csv")
    res["csv"] = open(csv).read().splitlines() if os.path.exists(csv) else None
    res["step"], res["time"] = tr.step_count, tr.time
    return res
