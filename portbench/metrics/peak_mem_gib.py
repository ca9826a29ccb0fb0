"""peak_mem_gib: torch.cuda.max_memory_allocated() over set-up and window,
read when the window closes, in GiB."""


def read(record):
    peak = record.get("peak_bytes")
    return None if peak is None else peak / 2 ** 30
