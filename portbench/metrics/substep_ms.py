"""substep_ms: the window's wall time over the substeps completed in it
(host clock; the window ends in a device synchronisation)."""


def read(record):
    if not record.get("substeps"):
        return None
    return 1e3 * record["window_s"] / record["substeps"]
