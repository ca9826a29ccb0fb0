"""step_ms_p95: the 95th percentile of the wall time of every step in the
window: its substeps, postprocessors, fetch and CSV row, from one step's
return to the next (host clock)."""

import math


def percentile(values, q):
    """The q-th percentile by linear interpolation between the closest
    ranks, over all the values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def read(record):
    p = percentile(record.get("step_s", []), 95)
    return None if p is None else 1e3 * p
