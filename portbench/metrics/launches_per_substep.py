"""launches_per_substep: device kernels in the profiled steps' trace over
the substeps traced."""


def read(record):
    t = record.get("trace")
    if not t or not t["substeps"]:
        return None
    return t["kernels"] / t["substeps"]
