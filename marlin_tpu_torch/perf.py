"""The port's performance graph: spans and counters at its layer
boundaries (the reference's MOOSE perf graph, `perf_graph = true` in
decks — reference TIME_SECTION usage, src/problems/TensorProblem.C:253,320
and benchmarks/01_spinodal_decomposition/1a.i:178).

A span (``span(name)``, a ``with`` block) records its host time and, on
the card, the device time between two CUDA events recorded on the current
stream at its start and end; its parent (the span open when it began, in
the same thread) and the step it belongs to (``PerfGraph.step``, which
the Transient sets before each step).  A span adds no synchronisation:
its events are read once they have completed, in ``resolve`` (which
``TensorProblem.step`` calls once it has queued a step's work, after the
fetch of the step before) or at ``report``/``totals``.  While a ``torch.profiler``
profile is active a span is also a ``record_function`` range of the same
name, so the trace names the host's time by the program's spans.  The
graph keeps totals by name (calls, host, device and self seconds; self is
a span less its children), counters (``count``), and the spans of the
latest step (``last``); it writes them out only when asked
(``report()``, ``totals()``).

One switch, ``PerfGraph.enabled``, off by default: ``[Outputs] perf_graph
= true`` and the CLI's ``--timing`` set it and print ``report()`` at the
end of each ``Transient.run``; ``transient.perf.enabled = True`` from
Python records without printing.  Code anywhere in the port records into
the *active* graph (``PerfGraph.active``: a problem's build, a
Transient's init, run, checkpoint and recover).  With none active, or
with the active one off, a span costs one attribute check: no event, no
clock read, no allocation.

Span names are ``layer::what``: ``solver::step`` (ends at the step's
fetch), ``problem::step``, ``solver::fused_substeps``, ``solver::substep``
(each substep of the eager chain), ``problem::postprocessors`` (up to the
transfer), ``problem::fetch``, ``outputs``, ``checkpoint``,
``checkpoint::read``, ``problem::build``, ``problem::init_state (build +
ICs)``, ``kernels::build``, ``kernels::load`` and
``parallel::<collective>``.  Counters: ``substeps_fused``,
``kernel_builds`` (nvcc or g++ runs) and ``fetches`` (device-to-host
reads on the step path).  The kernels' own launch counters
(``unordered_fft.launches()``, ``spectral.launches()``,
``lbm_fused.launches()``, ``parallel.calls()``) stay where they are; the
report prints them.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

#: the step's span, and its name on the first step
STEP = "solver::step"
FIRST_STEP = "solver::step (first; incl. compile)"


class _Off:
    """What ``span`` returns while its graph is off: a shared no-op."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One span of an enabled graph (a context manager)."""

    __slots__ = ("graph", "name", "parent", "step", "host_s", "child_s",
                 "_t0", "_start", "_end", "_range")

    def __init__(self, graph: "PerfGraph", name: str):
        self.graph = graph
        self.name = name
        self.parent: Optional[Span] = None
        self.step = graph.step
        self.host_s = 0.0
        self.child_s = 0.0
        self._start = self._end = self._range = None

    def __enter__(self):
        g = self.graph
        self.parent, g._open = g._open, self
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        if g.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.host_s = time.perf_counter() - self._t0
        if self._start is not None:
            self._end = torch.cuda.Event(enable_timing=True)
            self._end.record()
        if self._range is not None:
            self._range.__exit__(*exc)
        self.graph._close(self)
        return False


class PerfGraph:
    """Spans and counters of one problem and its Transient (module
    docstring).  ``cuda``: spans also record device time (the problem's
    device is the card)."""

    def __init__(self, enabled: bool = False, cuda: bool = False):
        self.enabled = enabled
        self.cuda = cuda
        self.step = 0
        self.sections: Dict[str, List[float]] = {}  # name -> [host s, calls]
        self.device_s: Dict[str, float] = {}
        self.self_s: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}
        self.last: List[Span] = []  # the latest step's spans, as they closed
        self._outer_s = 0.0  # host seconds of the spans without a parent
        self._open: Optional[Span] = None
        self._pending: List[Span] = []
        self._thread = threading.get_ident()
        self._t0 = time.time()

    # -- recording -----------------------------------------------------------
    def span(self, name: str):
        if not self.enabled:
            return _OFF
        # a build in another thread (chip_smoke.py's) would tangle the
        # parents: only the thread that activated the graph records spans
        if threading.get_ident() != self._thread:
            return _OFF
        return Span(self, name)

    def count(self, name: str, n: int = 1):
        if self.enabled:
            self.counters[name] = self.counters.get(name, 0) + n

    def _close(self, s: Span):
        self._open = s.parent
        if s.parent is not None:
            s.parent.child_s += s.host_s
        else:
            self._outer_s += s.host_s
        acc = self.sections.setdefault(s.name, [0.0, 0])
        acc[0] += s.host_s
        acc[1] += 1
        self.self_s[s.name] = self.self_s.get(s.name, 0.0) + s.host_s - s.child_s
        if s._end is not None:
            self._pending.append(s)
        if self.last and self.last[-1].step != s.step:
            self.last = []
        self.last.append(s)

    def resolve(self, wait: bool = False):
        """Add the device time of every span whose events have completed
        (with ``wait``, of every span: a synchronisation, for the end of a
        run)."""
        if not self._pending:
            return
        keep = []
        for s in self._pending:
            if wait:
                s._end.synchronize()
            elif not s._end.query():
                keep.append(s)
                continue
            self.device_s[s.name] = (self.device_s.get(s.name, 0.0)
                                     + s._start.elapsed_time(s._end) / 1e3)
        self._pending = keep

    @contextmanager
    def active(self):
        """Spans and counters anywhere in the port record into this graph
        within the block (the one active before it is restored after)."""
        global _current
        prev, _current = _current, self
        thread, self._thread = self._thread, threading.get_ident()
        try:
            yield self
        finally:
            _current, self._thread = prev, thread

    def clear(self):
        """Forget every total, counter and span recorded so far."""
        self.sections.clear()
        self.device_s.clear()
        self.self_s.clear()
        self.counters.clear()
        self.last = []
        self._outer_s = 0.0
        self._pending = []
        self._t0 = time.time()

    # -- writing out -----------------------------------------------------------
    def totals(self) -> Dict:
        """The totals as plain data: ``steps`` (the step spans, attempts
        included), ``spans`` by name (calls, host_s, device_s or None,
        self_s) and ``counters``."""
        self.resolve(wait=True)
        return {
            "steps": sum(self.sections.get(n, (0.0, 0))[1] for n in (STEP, FIRST_STEP)),
            "spans": {n: {"calls": calls, "host_s": secs,
                          "device_s": self.device_s.get(n),
                          "self_s": self.self_s[n]}
                      for n, (secs, calls) in self.sections.items()},
            "counters": dict(self.counters),
        }

    def report(self) -> str:
        self.resolve(wait=True)
        total = time.time() - self._t0
        lines = [
            "",
            "Performance Graph:",
            f"{'Section':<38}{'Calls':>8}{'Total(s)':>12}{'Avg(ms)':>12}"
            f"{'Self(ms)':>12}{'Device(ms)':>12}{'%Total':>9}",
            "-" * 103,
        ]
        for name, (secs, calls) in sorted(self.sections.items(), key=lambda kv: -kv[1][0]):
            avg = secs / calls * 1e3 if calls else 0.0
            pct = 100.0 * secs / total if total > 0 else 0.0
            dev = self.device_s.get(name)
            dev_col = f"{dev * 1e3:>12.2f}" if dev is not None else f"{'-':>12}"
            lines.append(f"{name:<38}{calls:>8}{secs:>12.3f}{avg:>12.2f}"
                         f"{self.self_s[name] * 1e3:>12.2f}{dev_col}{pct:>8.1f}%")
        lines.append("-" * 103)
        lines.append(f"{'(total wall)':<38}{'':>8}{total:>12.3f}{'':>36}{100.0:>8.1f}%")
        other = total - self._outer_s  # the outermost spans add up to the wall
        lines.append(f"{'(untimed)':<38}{'':>8}{other:>12.3f}{'':>36}"
                     f"{100.0 * other / total if total > 0 else 0.0:>8.1f}%")
        if self.counters:
            lines.append("Counters: " + ", ".join(
                f"{k} {v}" for k, v in sorted(self.counters.items())))
        launched = _launch_counters()
        if launched:
            lines.append("Kernel launches and collectives (this process): " + ", ".join(
                f"{k} {v}" for k, v in launched.items()))
        return "\n".join(lines)


def _launch_counters() -> Dict[str, int]:
    """The kernels' and collectives' own counters, where nonzero."""
    from . import lbm_fused, parallel, spectral, unordered_fft

    out: Dict[str, int] = {}
    for counts in (unordered_fft.launches(), spectral.launches(),
                   lbm_fused.launches(), parallel.calls()):
        out.update({k: v for k, v in counts.items() if v})
    return out


#: the graph that ``span`` and ``count`` record into (``PerfGraph.active``)
_current = PerfGraph()


def span(name: str):
    """A span of the active graph (a no-op while it is off)."""
    return _current.span(name)


def count(name: str, n: int = 1):
    """Add ``n`` to a counter of the active graph (nothing while it is off)."""
    _current.count(name, n)
