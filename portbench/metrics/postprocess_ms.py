"""postprocess_ms: the mean over the traced run's window steps (the
profiled ones left out) of the time from the end of TensorProblem.step,
synchronised, to the return of step_with_pps: the postprocessors, their
fetch and the problem's bookkeeping (host clock)."""


def read(record):
    values = [v for v in record.get("postprocess_s") or [] if v is not None]
    if not values:
        return None
    return 1e3 * sum(values) / len(values)
