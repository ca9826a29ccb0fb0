"""The trace reduction names an idle gap by the program's innermost span
around it (marlin_tpu_torch.perf's spans are ``record_function`` ranges,
category ``user_annotation``, while a profile is active), before the
benchmark's own wrapper span and before "Python between operations"."""

import pytest

from portbench import trace


def chrome(events):
    return {"traceEvents": [{"ph": "X", "name": n, "ts": s, "dur": d, "cat": c}
                            for n, s, d, c in events]}


def test_an_idle_gap_reads_the_innermost_program_span():
    doc = chrome([
        (trace.SPAN, 0.0, 200.0, "user_annotation"),
        ("portbench::TensorProblem.step", 0.0, 120.0, "user_annotation"),
        ("problem::step", 1.0, 118.0, "user_annotation"),
        ("solver::fused_substeps", 2.0, 60.0, "user_annotation"),
        ("k_fused", 40.0, 30.0, "kernel"),          # [40, 70]
        ("solver::substep", 65.0, 50.0, "user_annotation"),
        ("k_eager", 90.0, 40.0, "kernel"),          # [90, 130]
        ("problem::fetch", 130.0, 20.0, "user_annotation"),
        ("Memcpy DtoH", 131.0, 2.0, "gpu_memcpy"),  # [131, 133]
        ("outputs", 160.0, 30.0, "user_annotation"),
        ("k_next", 195.0, 5.0, "kernel"),           # [195, 200]
    ])
    r = trace.reduce(trace.events(doc), substeps=2)
    gaps = dict(r["idle_gaps"])
    # [0, 40] (midpoint 20): inside the fused substeps' span, the innermost
    assert gaps["solver::fused_substeps"] == pytest.approx(40e-6)
    # [70, 90] (midpoint 80): the eager substep's span
    assert gaps["solver::substep"] == pytest.approx(20e-6)
    # [133, 195] (midpoint 164): the outputs span
    assert gaps["outputs"] == pytest.approx(62e-6)
    assert "portbench::TensorProblem.step" not in gaps and trace.PYTHON not in gaps
