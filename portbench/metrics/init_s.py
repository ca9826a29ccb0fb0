"""init_s: TensorProblem(...) and Transient.init(), between two device
synchronisations (host clock)."""


def read(record):
    return record.get("init_s")
