"""The reduction of a profiler trace to the per-layer numbers.

The input is a Chrome trace as ``torch.profiler`` exports it: complete
events (``"ph": "X"``) with a category, a start ``ts`` and a duration
``dur`` in microseconds.  Device operations are the categories in
``DEVICE``; what the host was doing, those in ``HOST``.  Every function
takes and returns plain data, so the tests can feed it a synthetic trace.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: the name of the annotation the harness puts around the traced steps
SPAN = "portbench::traced_steps"
#: where no host operation covers an idle gap, the host was in Python
PYTHON = "host: Python between operations"
TOP = 10

Event = Tuple[str, float, float, str]  # name, start µs, end µs, category


def events(doc: Dict) -> List[Event]:
    out = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start = float(e["ts"])
        out.append((str(e.get("name", "")), start, start + float(e["dur"]),
                    str(e.get("cat", ""))))
    return out


def load(path: str) -> List[Event]:
    with open(path) as f:
        return events(json.load(f))


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def span_of(evts: Sequence[Event]) -> Optional[Tuple[float, float]]:
    """The traced steps' span: the harness's annotation, else every event."""
    spans = [(s, e) for n, s, e, c in evts if n == SPAN]
    if spans:
        return min(s for s, _ in spans), max(e for _, e in spans)
    if not evts:
        return None
    return min(s for _, s, _, _ in evts), max(e for _, _, e, _ in evts)


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float):
    """The idle intervals of [lo, hi] between the merged busy intervals."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def host_at(host: Sequence[Event], points: np.ndarray) -> List[str]:
    """For each time in ``points``, the innermost (shortest) host operation
    running then, or ``PYTHON`` where none is."""
    if not host:
        return [PYTHON] * len(points)
    starts = np.array([h[1] for h in host])
    ends = np.array([h[2] for h in host])
    length = ends - starts
    names = []
    for p in points:
        covering = np.nonzero((starts <= p) & (ends >= p))[0]
        names.append(host[covering[np.argmin(length[covering])]][0]
                     if covering.size else PYTHON)
    return names


def reduce(evts: Sequence[Event], substeps: int) -> Optional[Dict]:
    """Busy and idle time, launches and the top operations and idle gaps
    of the traced span; None where the trace holds no device operation."""
    span = span_of(evts)
    if span is None:
        return None
    lo, hi = span
    device = [(n, max(s, lo), min(e, hi), c) for n, s, e, c in evts
              if c in DEVICE and e > lo and s < hi]
    if not device:
        return None
    busy_iv = merged((s, e) for _, s, e, _ in device)
    busy = sum(e - s for s, e in busy_iv)
    by_name: Dict[str, float] = defaultdict(float)
    for n, s, e, _ in device:
        by_name[n] += e - s
    idle = gaps(busy_iv, lo, hi)
    host = [h for h in evts if h[3] in HOST and h[0] != SPAN]
    labels = host_at(host, np.array([(s + e) / 2 for s, e in idle]))
    by_host: Dict[str, float] = defaultdict(float)
    for (s, e), label in zip(idle, labels):
        by_host[label] += e - s
    nccl = sum(e - s for s, e in merged((s, e) for n, s, e, _ in device
                                         if "nccl" in n.lower()))
    top = lambda d: [[k, v / 1e6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "kernels": sum(1 for _, _, _, c in device if c == "kernel"),
            "substeps": substeps, "nccl_s": nccl / 1e6,
            "device_ops": top(by_name), "idle_gaps": top(by_host)}
