"""substep_roofline: the least time the card could take for a substep of
the configuration's work (its bytes over the peak bandwidth or its flops
over the peak float32 rate, whichever is larger: the kind's
work_per_substep) over the device-busy time a substep in the trace, in
percent.  The work is counted per configuration, whatever kernels do it."""


def bound_s(work, peaks):
    return max(work["bytes"] / peaks["bytes_per_s"], work["flops"] / peaks["flops_per_s"])


def binds(work, peaks):
    memory = work["bytes"] / peaks["bytes_per_s"]
    return "bytes" if memory >= work["flops"] / peaks["flops_per_s"] else "flops"


def read(record):
    t, work = record.get("trace"), record.get("work")
    if not t or not work or not t["busy_s"] or not t["substeps"]:
        return None
    return 100.0 * bound_s(work, record["peaks"]) / (t["busy_s"] / t["substeps"])
