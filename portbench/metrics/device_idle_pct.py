"""device_idle_pct: the share of the profiled steps' span in which no
device operation ran (union of the trace's device intervals)."""


def read(record):
    t = record.get("trace")
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
