"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
16³ with the program patched to (1) return its state unchanged from a
step, (2) leave half of the grid out of a step, (3) alter the answer a
step fetches.  (The fourth fault, an exchange between cards left out,
belongs to cells on several cards; these cells run on one.)"""

import pytest
import torch

from marlin_tpu_torch.problem import TensorProblem

from small import SMALL, run

FIELDS = {"ch3d512_fused": "c", "ch3d512_default": "c", "lbm_porous256_fused": "fpc"}
ANSWERS = {"ch3d512_fused": "mean", "ch3d512_default": "mean",
           "lbm_porous256_fused": "speed_mean"}


def unchanged(original, name):
    def step(self, state, *args, **kwargs):
        return state
    return step


def half_left_out(original, name):
    field = FIELDS[name]

    def step(self, state, *args, **kwargs):
        out = original(self, state, *args, **kwargs)
        new, old = out["buffers"][field], state["buffers"][field]
        half = new.shape[0] // 2
        mixed = torch.cat([old[:half], new[half:]], 0)
        return {**out, "buffers": {**out["buffers"], field: mixed}}
    return step


def answer_altered(original, name):
    key = ANSWERS[name]

    def step_with_pps(self, *args, **kwargs):
        state, values = original(self, *args, **kwargs)
        values = dict(values)
        values[key] = values[key] * (1 + 1e-3)
        return state, values
    return step_with_pps


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("fault,method", [(unchanged, "step"), (half_left_out, "step"),
                                          (answer_altered, "step_with_pps")])
def test_a_broken_step_is_not_correct(monkeypatch, name, fault, method):
    original = getattr(TensorProblem, method)
    monkeypatch.setattr(TensorProblem, method, fault(original, name))
    r = run(name)
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1
