"""The metric arithmetic on the CPU: the work counts behind
substep_roofline, the trace's busy and idle time and its top gaps from a
synthetic trace, the percentile over every step, and the harness finding
a new configuration, traffic mix, limit file or metric by its name."""

import json
import math
import os
import shutil

import pytest

from portbench import harness, trace
from portbench.kinds import ch_spectral, lbm_d3q19


def metric(name):
    return harness.module("metrics", name)


def test_ch_work_per_substep():
    n = 512
    cells, half = n ** 3, n * n * 257
    b, f = ch_spectral.work_per_substep(n)
    # c in and out (float32), N old in and new out (complex64) and the two
    # factors (float32) over the half spectrum
    assert b == 8 * cells + 16 * half + 8 * half == 2_690_646_016
    assert f == 2 * 2.5 * cells * 27 + 7 * cells + 14 * half
    peaks = harness._json(harness.HERE, "peaks.json")
    bound = metric("substep_roofline").bound_s({"bytes": b, "flops": f}, peaks)
    assert math.isclose(bound, b / 3.35e12)  # bytes bind: 0.803 ms
    assert metric("substep_roofline").binds({"bytes": b, "flops": f}, peaks) == "bytes"


def test_lbm_work_per_substep():
    n = 256
    b, f = lbm_d3q19.work_per_substep(n, 20)
    cells = n ** 3
    assert b == cells * (2 * 19 * 4 + 1) + cells * 20 / 20
    assert f == 262 * cells
    assert math.isclose(b / 3.35e12 * 1e3, 0.7713, rel_tol=1e-3)


def test_roofline_and_idle_from_a_record():
    rec = {"trace": {"busy_s": 0.080, "window_s": 0.100, "kernels": 200, "substeps": 20},
           "work": {"bytes": 3.35e9, "flops": 1.0}, "peaks": {"bytes_per_s": 3.35e12,
                                                              "flops_per_s": 6.7e13}}
    # a substep's bound is 1 ms; the device is busy 4 ms a substep
    assert math.isclose(metric("substep_roofline").read(rec), 25.0)
    assert math.isclose(metric("device_idle_pct").read(rec), 20.0)
    assert metric("launches_per_substep").read(rec) == 10.0
    assert metric("substep_roofline").read({}) is None
    assert metric("device_idle_pct").read({"trace": None}) is None


def test_percentile_over_every_step():
    # 100 steps of 1 ms and 10 of 50 ms, in chunks: p95 reads the tail of
    # every step, not of the chunks' means
    steps = [0.001] * 100 + [0.050] * 10
    rec = {"step_s": steps}
    p95 = metric("step_ms_p95").read(rec)
    assert p95 == pytest.approx(50.0)
    xs = list(range(1, 101))
    assert metric("step_ms_p95").percentile(xs, 95) == pytest.approx(95.05)
    assert metric("step_ms_p95").read({"step_s": []}) is None


def test_window_metrics_from_a_record():
    rec = {"window_s": 35.0, "substeps": 5000, "peak_bytes": 3 * 2 ** 30,
           "allocated_after_init": 2 ** 30, "setup_s": 9.5, "init_s": 1.25,
           "postprocess_s": [0.001, 0.003]}
    assert metric("substep_ms").read(rec) == pytest.approx(7.0)
    assert metric("peak_mem_gib").read(rec) == 3.0
    assert metric("workspace_gib").read(rec) == 2.0
    assert metric("setup_s").read(rec) == 9.5
    assert metric("init_s").read(rec) == 1.25
    assert metric("postprocess_ms").read(rec) == pytest.approx(2.0)
    assert metric("peak_mem_gib").read({"peak_bytes": None}) is None


def chrome(events):
    return {"traceEvents": [{"ph": "X", "name": n, "ts": s, "dur": d, "cat": c}
                            for n, s, d, c in events]}


def test_trace_reduction():
    doc = chrome([
        (trace.SPAN, 0.0, 100.0, "user_annotation"),
        ("aten::add", 5.0, 10.0, "cpu_op"),
        ("cudaLaunchKernel", 8.0, 2.0, "cuda_runtime"),
        ("k_a", 10.0, 20.0, "kernel"),
        ("k_b", 25.0, 10.0, "kernel"),   # overlaps k_a: the union counts once
        ("Memcpy DtoH", 40.0, 5.0, "gpu_memcpy"),
        ("aten::item", 46.0, 30.0, "cpu_op"),
        ("k_a", 80.0, 10.0, "kernel"),
        ("ncclKernel_AllToAll", 90.0, 5.0, "kernel"),
        ("outside", 150.0, 10.0, "kernel"),  # past the span: left out
    ])
    r = trace.reduce(trace.events(doc), substeps=4)
    # busy: [10, 35] + [40, 45] + [80, 95] = 25 + 5 + 15 = 45 µs of 100
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(45e-6)
    assert r["kernels"] == 4
    assert r["nccl_s"] == pytest.approx(5e-6)
    ops = dict(r["device_ops"])
    assert ops["k_a"] == pytest.approx(30e-6) and ops["k_b"] == pytest.approx(10e-6)
    gaps = dict(r["idle_gaps"])
    # idle: [0, 10] (midpoint 5: aten::add starts there), [35, 40] (none),
    # [45, 80] (midpoint 62.5: aten::item), [95, 100] (none)
    assert gaps["aten::item"] == pytest.approx(35e-6)
    assert gaps[trace.PYTHON] == pytest.approx(10e-6)
    assert gaps["aten::add"] == pytest.approx(10e-6)
    assert r["idle_gaps"][0][0] == "aten::item"


def test_an_empty_device_trace_reads_nothing():
    doc = chrome([(trace.SPAN, 0.0, 100.0, "user_annotation"),
                  ("aten::add", 5.0, 10.0, "cpu_op")])
    assert trace.reduce(trace.events(doc), substeps=2) is None
    assert trace.reduce([], substeps=2) is None


def test_merged_and_gaps():
    assert trace.merged([(3, 4), (0, 2), (1, 3)]) == [(0, 4)]
    assert trace.gaps([(2, 3), (5, 6)], 0, 10) == [(0, 2), (3, 5), (6, 10)]


@pytest.fixture
def copy_of_portbench(tmp_path, monkeypatch):
    """A copy of the benchmark's files, with the harness reading them."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    monkeypatch.setattr(harness, "HERE", str(root / "portbench"))
    monkeypatch.setattr(harness, "ROOT", str(root))
    return root


def test_new_pieces_are_found_by_name(copy_of_portbench):
    """A later change adds files and entries and edits no file that is
    there: a configuration, a traffic mix, a cell's limits and a metric."""
    pb = copy_of_portbench / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    new_cfg = pb / "configs" / "ch3d_128"
    new_cfg.mkdir()
    cfg = json.loads((pb / "configs" / "ch3d_512" / "config.json").read_text())
    cfg.update(name="ch3d_128", sizes={**cfg["sizes"], "n": 128})
    (new_cfg / "config.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "configs" / "ch3d_512" / "deck.i", new_cfg / "deck.i")
    (pb / "traffic" / "carry.json").write_text(json.dumps(
        {"overrides": ["Domain/fft_backend=PALLAS", "TensorSolver/carry_reciprocal=true"],
         "warm_steps": 3, "trace_steps": 2}))
    (pb / "limits" / "ch3d128_carry.json").write_text(json.dumps(
        {"limits": {"last_c": 1.0}}))
    (pb / "metrics" / "steps.per-window.py").write_text(
        "def read(record):\n    return record.get('steps')\n")
    bench = json.loads((copy_of_portbench / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ch3d128_carry", "config": "ch3d_128",
                               "traffic": "carry", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps.per-window", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "kernels", "moves": "substep_ms",
                               "workloads": ["ch3d128_carry"]})
    (copy_of_portbench / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data  # nothing that was there changed

    b = harness.benchmark()
    wl = harness.workload(b, "ch3d128_carry")
    assert harness.config(wl["config"])["sizes"]["n"] == 128
    assert "deck_text" in harness.config(wl["config"])
    assert harness.traffic(wl["traffic"])["warm_steps"] == 3
    assert harness.limits("ch3d128_carry") == {"last_c": 1.0}
    names = [m["name"] for m in harness.metrics_of(b, "ch3d128_carry", trace=True)]
    assert names == ["steps.per-window"]
    assert harness.module("metrics", "steps.per-window").read({"steps": 7}) == 7
    assert "steps.per-window" not in [
        m["name"] for m in harness.metrics_of(b, "ch3d512_fused", trace=True)]
