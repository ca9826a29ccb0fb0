"""One module a kind of configuration, found by the ``kind`` of its
``config.json``.  Each defines ``Cell(config, seed, device)``
with ``deck_fields()``, ``arrays()``, ``capture_start(state, steps)``,
``capture_last(state_in, state_out, values)``, ``readings()``,
``control()``, ``release()`` and ``work_per_substep()``."""

import torch


def widest_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| as a share of want's largest magnitude."""
    want = want.double()
    return float((got.double() - want).abs().max()) / float(want.abs().max())
