"""Wall-time performance graph (the reference's MOOSE perf-graph analog,
`perf_graph = true` in decks — reference TIME_SECTION usage,
src/problems/TensorProblem.C:253,320 and
benchmarks/01_spinodal_decomposition/1a.i:178).

A copy of marlin_tpu/perf.py.  The split that matters is build / first
step / step / output: the first step builds and loads the CUDA kernels it
reaches, later ones don't.  `PerfGraph.section(name)` accumulates host wall
time and call counts and adds no device synchronisation of its own;
`report()` renders the summary table printed at the end of a run (CLI
`--timing` or deck `[Outputs] perf_graph = true`)."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List


class PerfGraph:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.sections: Dict[str, List[float]] = {}  # name -> [total_s, calls]
        self._t0 = time.time()

    @contextmanager
    def section(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.time()
        try:
            yield
        finally:
            acc = self.sections.setdefault(name, [0.0, 0])
            acc[0] += time.time() - t0
            acc[1] += 1

    def add(self, name: str, seconds: float, calls: int = 1):
        acc = self.sections.setdefault(name, [0.0, 0])
        acc[0] += seconds
        acc[1] += calls

    def report(self) -> str:
        total = time.time() - self._t0
        lines = [
            "",
            "Performance Graph:",
            f"{'Section':<38}{'Calls':>8}{'Self(s)':>12}{'Avg(ms)':>12}{'%Total':>9}",
            "-" * 79,
        ]
        accounted = 0.0
        for name, (secs, calls) in sorted(
            self.sections.items(), key=lambda kv: -kv[1][0]
        ):
            accounted += secs
            avg = secs / calls * 1e3 if calls else 0.0
            pct = 100.0 * secs / total if total > 0 else 0.0
            lines.append(
                f"{name:<38}{calls:>8}{secs:>12.3f}{avg:>12.2f}{pct:>8.1f}%"
            )
        lines.append("-" * 79)
        lines.append(
            f"{'(total wall)':<38}{'':>8}{total:>12.3f}{'':>12}{100.0:>8.1f}%"
        )
        other = total - accounted
        lines.append(
            f"{'(untimed)':<38}{'':>8}{other:>12.3f}{'':>12}"
            f"{100.0 * other / total if total > 0 else 0.0:>8.1f}%"
        )
        return "\n".join(lines)
