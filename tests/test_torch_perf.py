"""marlin_tpu_torch/perf.py: the performance graph's spans and counters.
On the CPU: spans nest and carry their parent and step; a graph that is off
records nothing and reads no clock; the spans and counters a step of the
benchmark's three decks (``portbench/configs``, at 16³) and of a few
other routes records; the kernel builds' counter; the spans in a
``torch.profiler`` trace; the checkpoint's spans; host-loop fetches; and,
on the card only, device time by CUDA events."""

import threading

import pytest
import torch

from marlin_tpu_torch import decks, hit, perf
from marlin_tpu_torch import unordered_fft as uf
from marlin_tpu_torch.executioner import Transient, run_deck
from marlin_tpu_torch.problem import TensorProblem
from portbench import harness

SEED = 2 ** 31 + 977
N = 16


def _transient(root, out, arrays=None, device="cpu"):
    problem = TensorProblem(root, device=device, arrays=arrays)
    return Transient(problem, exec_node=root.children.get("Executioner"),
                     outputs_node=root.children.get("Outputs"), output_dir=str(out))


def _cell(name, out, device="cpu"):
    """A Transient of a benchmark cell's deck at N³, as the harness builds it."""
    wl = harness.workload(harness.benchmark(), name)
    cfg = harness.config(wl["config"])
    cfg["sizes"] = {**cfg["sizes"], "n": N}
    cfg["chips"] = wl["chips"]
    cell = harness.kind(cfg).Cell(cfg, SEED, torch.device(device))
    root = hit.parse(cfg["deck_text"].format(**cell.deck_fields()))
    hit.apply_cli_args(root, list(harness.traffic(wl["traffic"]).get("overrides", [])))
    return _transient(root, out, cell.arrays(), device), int(cfg["sizes"]["substeps"])


def _deck(text, out, overrides=()):
    root = hit.parse(text)
    hit.apply_cli_args(root, list(overrides))
    return _transient(root, out)


def _traced_steps(tr, warm, steps):
    """Run ``warm`` steps with the graph off, then ``steps`` with it on;
    the graph's totals of those."""
    tr.init()
    tr.num_steps = warm
    tr.run()
    tr.perf.enabled = True
    tr.perf.clear()
    tr.num_steps = warm + steps
    tr.run()
    return tr.perf.totals()


def test_spans_nest_with_parent_step_and_self_time():
    g = perf.PerfGraph(enabled=True)
    with g.active():
        g.step = 7
        with perf.span("outer") as outer:
            with perf.span("inner"):
                with perf.span("leaf"):
                    pass
            with perf.span("inner"):
                perf.count("things", 2)
        g.step = 8
        with perf.span("next"):
            pass
    assert perf.span("after") is perf._OFF  # the graph is no longer active
    # the latest step's spans, as they closed
    assert [(s.name, s.parent and s.parent.name, s.step) for s in g.last] == [
        ("next", None, 8)]
    totals = g.totals()
    assert totals["counters"] == {"things": 2}
    spans = totals["spans"]
    assert {n: s["calls"] for n, s in spans.items()} == {
        "leaf": 1, "inner": 2, "outer": 1, "next": 1}
    assert spans["outer"]["self_s"] == pytest.approx(
        spans["outer"]["host_s"] - spans["inner"]["host_s"], abs=1e-12)
    assert spans["inner"]["self_s"] == pytest.approx(
        spans["inner"]["host_s"] - spans["leaf"]["host_s"], abs=1e-12)
    assert all(s["device_s"] is None for s in spans.values())  # no card
    assert outer.step == 7 and outer.parent is None


def test_spans_of_another_thread_and_of_an_inactive_graph_are_not_recorded():
    g = perf.PerfGraph(enabled=True)
    seen = []
    with g.active():
        with perf.span("main"):
            t = threading.Thread(target=lambda: seen.append(perf.span("other")))
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    assert seen == [perf._OFF]
    assert list(g.sections) == ["main"]
    other = perf.PerfGraph(enabled=True)
    with perf.span("x"), other.span("y"):
        pass
    assert list(other.sections) == ["y"]


def test_tracing_off_records_nothing_and_reads_no_clock(tmp_path, monkeypatch):
    """The default: every span is the shared no-op (no allocation), with
    no clock read and no CUDA event."""
    class NoClock:
        def perf_counter(self):
            raise AssertionError("a span read the clock")

        time = perf_counter

    def no_event(*args, **kwargs):
        raise AssertionError("a span made a CUDA event")

    tr, _ = _cell("ch3d512_fused", tmp_path)
    monkeypatch.setattr(perf, "time", NoClock())
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    tr.init()
    tr.num_steps = 2
    tr.run()
    assert not tr.perf.enabled
    assert tr.perf.sections == {} and tr.perf.counters == {} and tr.perf.last == []
    assert perf.span("anything") is perf.span("else") is perf._OFF


@pytest.mark.parametrize("name, fused", [
    ("ch3d512_fused", True),
    ("ch3d512_default", False),
    ("lbm_porous256_fused", True),
])
def test_benchmark_decks_record_their_spans_and_one_fetch_a_step(tmp_path, name, fused):
    """The LBM deck's plan has a final form: every substep of a step runs
    in the fused loop's span, the last one the final form, and no eager
    substep follows; the fused CH route runs its last substep eagerly."""
    tr, substeps = _cell(name, tmp_path)
    steps = 3
    totals = _traced_steps(tr, 3, steps)
    calls = {n: s["calls"] for n, s in totals["spans"].items()}
    final = name.startswith("lbm")
    assert totals["steps"] == steps
    assert totals["counters"]["fetches"] == steps
    assert calls["problem::step"] == calls["problem::postprocessors"] == steps
    assert calls["problem::fetch"] == steps
    if final:
        assert calls["solver::fused_substeps"] == steps
        assert totals["counters"]["substeps_fused"] == steps * substeps
        assert totals["counters"]["lbm_final_fused"] == steps
        assert "lbm_final_eager" not in totals["counters"]
        assert "solver::substep" not in calls
    elif fused:
        assert calls["solver::fused_substeps"] == steps
        assert totals["counters"]["substeps_fused"] == steps * (substeps - 1)
        assert calls["solver::substep"] == steps
    else:
        assert "solver::fused_substeps" not in calls
        assert "substeps_fused" not in totals["counters"]
        assert calls["solver::substep"] == steps * substeps
    # the step's spans nest under it, and carry its number
    last = {s.name: s for s in tr.perf.last}
    assert {s.step for s in tr.perf.last} == {tr.step_count}
    substep = "solver::fused_substeps" if final else "solver::substep"
    assert last[substep].parent.name == "problem::step"
    assert last["problem::step"].parent.name == perf.STEP
    assert last["problem::fetch"].parent.name == perf.STEP
    assert last[perf.STEP].parent is None


@pytest.mark.parametrize("overrides, fused", [
    (["Domain/fft_backend=PALLAS", "TensorSolver/carry_reciprocal=true",
      "TensorSolver/fused_spectral=true"], True),
    (["Domain/fft_backend=DEFAULT"], False),
], ids=["fused", "default"])
def test_two_field_routes_record_their_substeps(tmp_path, overrides, fused):
    """decks.MULTI_3D_DECK (kernel 6's chain), 4 substeps a step; it has
    no postprocessor, so its steps fetch nothing."""
    tr = _deck(decks.MULTI_3D_DECK.format(n=8, domain_extra="", solver_extra=""), tmp_path,
               overrides + ["TensorSolver/substeps=4"])
    totals = _traced_steps(tr, 2, 2)
    calls = {n: s["calls"] for n, s in totals["spans"].items()}
    assert "fetches" not in totals["counters"] and "problem::fetch" not in calls
    assert calls["solver::substep"] == (2 if fused else 8)
    assert calls.get("solver::fused_substeps", 0) == (2 if fused else 0)
    assert totals["counters"].get("substeps_fused", 0) == (6 if fused else 0)


def test_report_has_device_and_self_columns_and_the_counters(tmp_path):
    tr, _ = _cell("ch3d512_default", tmp_path)
    _traced_steps(tr, 1, 1)
    text = tr.perf.report()
    header = next(line for line in text.splitlines() if line.startswith("Section"))
    for column in ("Calls", "Total(s)", "Avg(ms)", "Self(ms)", "Device(ms)", "%Total"):
        assert column in header
    assert "Counters: fetches 1" in text


def test_kernel_builds_count_nvcc_runs_only(tmp_path, monkeypatch):
    """A build runs nvcc once and counts it; a built library is loaded
    without a build (a warm window reads 0)."""
    runs = []

    def fake_nvcc(cmd, **kwargs):
        runs.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()

        class Done:
            returncode, stdout, stderr = 0, "", ""
        return Done()

    monkeypatch.setattr(uf, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(uf, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(uf.subprocess, "run", fake_nvcc)
    lib = uf.CudaLibrary("probe", {}, text="// nothing\n")
    g = perf.PerfGraph(enabled=True)
    with g.active():
        lib.build()
        lib.build()
    assert len(runs) == 1
    assert g.counters == {"kernel_builds": 1}
    assert g.sections["kernels::build"][1] == 1


def test_spans_are_named_ranges_in_a_profiler_trace(tmp_path):
    """The LBM cell's step: its last substep is the kernel's final form,
    inside ``solver::fused_substeps``, so no ``solver::substep`` range."""
    tr, _ = _cell("lbm_porous256_fused", tmp_path)
    tr.init()
    tr.num_steps = 2
    tr.run()
    tr.perf.enabled = True
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.num_steps = 3
        tr.run()
    names = {e.name for e in prof.events()}
    for span in (perf.STEP, "problem::step", "solver::fused_substeps",
                 "problem::postprocessors", "problem::fetch", "outputs"):
        assert span in names, span
    assert "solver::substep" not in names


def test_host_loop_reads_count_as_fetches(tmp_path):
    """An iterative solver's host-loop reads add to ``fetches`` beside the
    postprocessors' one transfer a step; its own ``counts`` stay."""
    text = decks.OSTWALD_2A_SECANT_DECK.format(
        n=16, substeps=2, dt=0.01, num_steps=3, domain_extra="", problem_extra="",
        solver_extra="", relative_tolerance="1e-9")
    tr = _deck(text, tmp_path)
    tr.perf.enabled = True
    tr.run()
    syncs = tr.problem.solver.counts.syncs
    assert syncs > 0
    assert tr.perf.counters["fetches"] == syncs + tr.perf.sections["problem::fetch"][1]


def test_checkpoint_write_and_read_are_spans(tmp_path):
    """Benchmark 1a's deck (its `perf_graph = true`) with a checkpoint at
    step 2: the write is a `checkpoint` span of the run, the read a
    `checkpoint::read` span of the Transient that recovers from it."""
    text = decks.BENCH_1A_DECK.format(n=16, substeps=2, domain_extra="", solver_extra="")
    args = ["Executioner/num_steps=2", "Executioner/checkpoint_interval=2"]
    root = hit.parse(text)
    hit.apply_cli_args(root, args)
    tr = run_deck(root, output_dir=str(tmp_path), device="cpu")
    assert tr.perf.sections["checkpoint"][1] == 1
    again = hit.parse(text)
    hit.apply_cli_args(again, args)
    resumed = _transient(again, tmp_path / "resumed")
    resumed.recover(tr.checkpoint_path)
    assert resumed.perf.sections["checkpoint::read"][1] == 1
    assert resumed.step_count == 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_time_by_events_on_the_card(cuda, tmp_path):
    """On the card a span's device time comes from its CUDA events, with no
    synchronisation of its own: a span that queues 20 large products
    returns long before the card has run them, so its device time exceeds
    its host time.  A benchmark deck on the card (the DEFAULT route, no
    hand kernel) gives every step span device time, a child no more than
    its parent, and fetches once a step."""
    x = torch.randn(4096, 4096, device=cuda)
    torch.cuda.synchronize(cuda)
    g = perf.PerfGraph(enabled=True, cuda=True)
    with g.active():
        with perf.span("work"):
            for _ in range(20):
                x = x @ x / 64.0
    work = g.totals()["spans"]["work"]
    assert work["device_s"] > work["host_s"] > 0
    tr, substeps = _cell("ch3d512_default", tmp_path, "cuda")
    assert tr.perf.cuda
    totals = _traced_steps(tr, 2, 3)
    spans = totals["spans"]
    assert totals["counters"]["fetches"] == 3
    assert spans["solver::substep"]["calls"] == 3 * substeps
    assert all(s["device_s"] is not None and s["device_s"] >= 0 for s in spans.values())
    assert spans["solver::substep"]["device_s"] > 0
    assert spans["solver::substep"]["device_s"] <= spans["problem::step"]["device_s"]
    assert spans["problem::step"]["device_s"] <= spans[perf.STEP]["device_s"]
