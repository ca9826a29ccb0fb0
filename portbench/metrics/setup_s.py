"""setup_s: from the start of the benchmark's process to the window's start:
imports, the problem's build and init, the libraries' build or load, the
warm-up steps (host clock)."""


def read(record):
    return record.get("setup_s")
