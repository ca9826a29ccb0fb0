"""workspace_gib: the peak allocated device memory less what was allocated
right after Transient.init(), in GiB."""


def read(record):
    peak, base = record.get("peak_bytes"), record.get("allocated_after_init")
    if peak is None or base is None:
        return None
    return (peak - base) / 2 ** 30
