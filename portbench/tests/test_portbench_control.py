"""The control (the reference stored in bfloat16, the precision below the
configuration's float32, in the program's place) fails each cell's
limits, at a size a test run holds.  On the card, the same at 64³."""

import pytest
import torch

from portbench import harness

from small import SMALL, run


def failed(readings, limits):
    return [k for k, v in readings.items() if v > limits[k]]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(name):
    r = run(name, control=True)
    assert r["correct"]
    assert failed(r["control"], harness.limits(name))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = harness.run_cell(name, 2 ** 31 + 5, 1.0, False, device="cuda",
                         sizes={"n": 64}, control=True)
    assert r["correct"], r["checks"]
    assert failed(r["control"], harness.limits(name))
