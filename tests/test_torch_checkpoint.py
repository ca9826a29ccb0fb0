"""Checkpoint and resume of the port (marlin_tpu_torch/checkpoint.py,
Transient.save_checkpoint / recover, run_deck(recover=...)), on the CPU.

Within the port a resumed run equals the uninterrupted one bit for bit:
every buffer, history slot, solver entry, n_advances, old_dt, the
postprocessor values and the CSV rows after the checkpoint, on DEFAULT
float64, PALLAS float32 (the kernels' twins), the fused float32 path
(carry_reciprocal + fused_spectral, a complex64 ū in the kernels' order)
and the LBM decks on PALLAS and JNP.  Across the packages (the JAX
package's layout is the port's), a checkpoint of either resumed by the
other equals the writer's uninterrupted run within 1e-10 (float64).

The JAX package is imported inside the cases that run it, so the ``cuda``
case runs on the card with ``--noconftest``.
"""

import json

import numpy as np
import pytest
import torch

from __graft_entry__ import _CH_DECK
from marlin_tpu_torch import checkpoint, decks, hit
from marlin_tpu_torch.executioner import Transient, run_deck
from marlin_tpu_torch.problem import ProblemError, TensorProblem

TOL = 1e-10
FUSED = "carry_reciprocal = true\n  fused_spectral = true"
PALLAS = "fft_backend = PALLAS\n  floating_precision = SINGLE"


def _1a(domain_extra, solver_extra, n=32, substeps=4):
    """Benchmark 1a's deck small: its adaptive dt (never a float32 value),
    its postprocess group and postprocessors, CSV."""
    text = decks.BENCH_1A_DECK.format(n=n, substeps=substeps, domain_extra=domain_extra,
                                      solver_extra=solver_extra)
    return text.replace("  perf_graph = true\n", "")


def _lbm(name, backend):
    if name == "karman":
        text = decks.KARMAN_DECK.format(nx=40, ny=12, substeps=4, backend=backend)
        return text.replace("[Domain]", "[Domain]\n  floating_precision = SINGLE"), {
            "binary_media": decks.karman_media(40, 12)}
    return decks.MIXED_DECK.format(n=8, substeps=3, backend=backend), None


CASES = {
    "default_f64": (_1a("floating_precision = DOUBLE", ""), None),
    "pallas_f32": (_1a(PALLAS, ""), None),
    "fused_f32": (_1a(PALLAS, FUSED), None),
    "karman_pallas": _lbm("karman", "PALLAS"),
    "karman_jnp": _lbm("karman", "JNP"),
    "mixed_pallas": _lbm("mixed", "PALLAS"),
    "mixed_jnp": _lbm("mixed", "JNP"),
}


def _steps(text, steps, interval=0):
    """``text`` stopped after ``steps`` steps, checkpointing every
    ``interval``."""
    root = hit.parse(text)
    ex = root.child("Executioner")
    ex.set_param("num_steps", str(steps))
    if interval:
        ex.set_param("checkpoint_interval", str(interval))
    return root


def _assert_states_equal(a, b):
    assert set(a["buffers"]) == set(b["buffers"])
    assert set(a["old"]) == set(b["old"])
    assert set(a["solver"]) == set(b["solver"])
    for part in ("buffers", "old", "solver"):
        for k, v in a[part].items():
            w = b[part][k]
            assert v.dtype == w.dtype and v.shape == w.shape, (part, k)
            assert torch.equal(v, w), (part, k)
    assert a["n_advances"] == b["n_advances"]
    assert a["old_dt"] == b["old_dt"]


def _csv(path):
    return path.read_text().splitlines()


@pytest.mark.parametrize("case", list(CASES))
def test_resume_is_bit_exact(case, tmp_path):
    """Steps 1-3, a checkpoint, steps 4-6 resumed by run_deck: equal to
    6 uninterrupted steps."""
    text, arrays = CASES[case]
    full = run_deck(_steps(text, 6), output_dir=str(tmp_path / "full"), device="cpu",
                    arrays=arrays)
    part = run_deck(_steps(text, 3, interval=3), output_dir=str(tmp_path / "part"),
                    device="cpu", arrays=arrays)
    res = run_deck(_steps(text, 6), output_dir=str(tmp_path / "res"), device="cpu",
                   arrays=arrays, recover=part.checkpoint_path)
    assert res.step_count == full.step_count == 6
    assert res.time == full.time
    _assert_states_equal(res.state, full.state)
    assert res.pp_values == full.pp_values
    if full.csv is not None:
        assert _csv(tmp_path / "res" / "out.csv")[1:] == _csv(tmp_path / "full" / "out.csv")[5:]
    if case == "fused_f32":
        assert res.state["buffers"]["cbar"].dtype == torch.complex64


def _transient(text, out_dir):
    root = hit.parse(text)
    problem = TensorProblem(root, device="cpu")
    return Transient(problem, exec_node=root.children.get("Executioner"),
                     outputs_node=root.children.get("Outputs"),
                     user_objects_node=root.children.get("UserObjects"),
                     file_base="ck", output_dir=str(out_dir))


@pytest.mark.parametrize("init", [False, True], ids=["recover_only", "init_then_recover"])
def test_recover_with_and_without_init(init, tmp_path):
    """recover() then run() works without init() (the JAX package's
    regression test_recover_without_init_runs), and after it."""
    text = CASES["default_f64"][0]
    part = _transient(text.replace("end_time = 10500", "end_time = 10500\n  num_steps = 3"),
                      tmp_path / "part")
    part.run()
    part.save_checkpoint()
    six = text.replace("end_time = 10500", "end_time = 10500\n  num_steps = 6")
    res = _transient(six, tmp_path / "res")
    if init:
        res.init()
    res.recover(part.checkpoint_path)
    res.run()
    full = _transient(six, tmp_path / "full")
    full.run()
    assert res.step_count == 6
    _assert_states_equal(res.state, full.state)


_NO_HISTORY = """
[Domain]
  dim = 2
  nx = 8
  ny = 8
  floating_precision = DOUBLE
[]
[TensorComputes]
  [Initialize]
    [c]
      type = ParsedCompute
      buffer = c
      extra_symbols = true
      expression = 'sin(2*pi*x)*cos(2*pi*y)'
    []
  []
  [Solve]
    [decay]
      type = ParsedCompute
      buffer = c
      expression = 'c*0.99'
      inputs = c
    []
  []
[]
[Problem]
  type = TensorProblem
[]
[Executioner]
  type = Transient
  num_steps = 4
  dt = 0.1
[]
"""


def test_history_free_deck_resumes(tmp_path):
    """An empty state['old'] and an empty solver dict survive the round
    trip (their __empty__ markers), and the run resumes."""
    part = run_deck(_steps(_NO_HISTORY, 2, interval=2), output_dir=str(tmp_path / "p"),
                    device="cpu")
    assert part.state["old"] == {} and part.state["solver"] == {}
    with np.load(part.checkpoint_path) as f:
        assert "old/__empty__" in f.files and "solver/__empty__" in f.files
    state, meta = checkpoint.load(part.checkpoint_path, "cpu")
    assert state["old"] == {} and state["solver"] == {} and meta["step"] == 2
    res = run_deck(_steps(_NO_HISTORY, 4), output_dir=str(tmp_path / "r"), device="cpu",
                   recover=part.checkpoint_path)
    full = run_deck(_steps(_NO_HISTORY, 4), output_dir=str(tmp_path / "f"), device="cpu")
    _assert_states_equal(res.state, full.state)


_F32_DT = """
[Executioner]
  type = Transient
  num_steps = 4
  [TimeStepper]
    type = ConstantDT
    dt = 0.1
  []
[]
[Postprocessors]
  [change]
    type = TensorIntegralChangePostprocessor
    buffer = c
  []
[]
"""


def test_float32_deck_keeps_old_dt_exact(tmp_path):
    """dt = 0.1 is not a float32 value: the checkpoint of a float32 deck
    writes old_dt in float64, reads it back as the same Python float, and
    the resumed run is bit-exact; a float32 old_dt (the JAX package's
    layout for such a deck) reads too."""
    assert float(np.float32(0.1)) != 0.1
    text = _CH_DECK.format(nx=16, ny=16, substeps=2).replace(
        "[Domain]", "[Domain]\n  floating_precision = SINGLE") + _F32_DT
    part = run_deck(_steps(text, 2, interval=2), output_dir=str(tmp_path / "p"), device="cpu")
    assert part.state["buffers"]["c"].dtype == torch.float32
    assert part.state["old_dt"] == (0.1,)
    with np.load(part.checkpoint_path) as f:
        assert f["old_dt"].dtype == np.float64 and f["old_dt"].tolist() == [0.1]
        assert f["n_advances"].dtype == np.int32
        meta = json.loads(bytes(f["__meta__"]).decode())
        assert meta["dt"] == 0.1 and meta["step"] == 2
        payload = {k: f[k] for k in f.files}
    state, _meta = checkpoint.load(part.checkpoint_path, "cpu")
    assert state["old_dt"] == (0.1,)
    res = run_deck(_steps(text, 4), output_dir=str(tmp_path / "r"), device="cpu",
                   recover=part.checkpoint_path)
    full = run_deck(_steps(text, 4), output_dir=str(tmp_path / "f"), device="cpu")
    _assert_states_equal(res.state, full.state)
    assert res.pp_values == full.pp_values
    payload["old_dt"] = payload["old_dt"].astype(np.float32)
    np.savez(tmp_path / "f32.npz", **payload)
    state, _meta = checkpoint.load(str(tmp_path / "f32.npz"), "cpu")
    assert state["old_dt"] == (float(np.float32(0.1)),)


def test_checkpoint_layout_round_trip(tmp_path):
    """The keys of the JAX package's layout, the aux samples under
    __aux__/, and a complex buffer and bool buffer kept as they are."""
    state = {
        "buffers": {"c": torch.arange(6.0).reshape(2, 3),
                    "cbar": torch.randn(2, 3, dtype=torch.complex64),
                    "ok": torch.tensor(True)},
        "old": {"c": torch.zeros(1, 2, 3)},
        "n_advances": 7,
        "old_dt": (0.3,),
        "solver": {"residual": torch.tensor(0.5)},
    }
    checkpoint.save(str(tmp_path / "ck.npz"), state, 1.25, 4, 0.3, {"m": 2.5},
                    aux_cache={"c0": np.ones((3, 4))})
    with np.load(tmp_path / "ck.npz") as f:
        assert sorted(f.files) == ["__aux__/c0", "__meta__", "buffers/c", "buffers/cbar",
                                   "buffers/ok", "n_advances", "old/c", "old_dt",
                                   "solver/residual"]
    back, meta = checkpoint.load(str(tmp_path / "ck"), "cpu")
    _assert_states_equal(back, state)
    assert meta["time"] == 1.25 and meta["step"] == 4 and meta["dt"] == 0.3
    assert meta["pp_values"] == {"m": 2.5}
    np.testing.assert_array_equal(meta["aux_cache"]["c0"], np.ones((3, 4)))


@pytest.mark.parametrize("writer", [np.savez, np.savez_compressed])
def test_checkpoint_members_read_as_numpy_reads_them(writer, tmp_path):
    """load reads np.savez's stored members straight from the file and any
    other member through zipfile: every array as np.load gives it (dtype,
    shape, Fortran order, 0-d and empty ones), and a flipped byte of a
    stored member fails its CRC-32 as zipfile's read does."""
    import zipfile

    arrays = {"buffers/c": np.random.default_rng(0).random((3, 4, 5)).astype(np.float32),
              "buffers/f": np.asfortranarray(np.arange(42.0).reshape(6, 7)),
              "buffers/z": (np.arange(4) + 1j * np.arange(4)).astype(np.complex64),
              "old/__empty__": np.zeros(0, dtype=np.uint8),
              "n_advances": np.asarray(3, dtype=np.int32), "flag": np.asarray(True)}
    path = str(tmp_path / "m.npz")
    writer(path, **arrays)
    got = dict(checkpoint._members(path))
    with np.load(path) as f:
        assert sorted(got) == sorted(f.files)
        for k in f.files:
            assert got[k].dtype == f[k].dtype and got[k].shape == f[k].shape, k
            np.testing.assert_array_equal(got[k], f[k], err_msg=k)
    if writer is np.savez:
        raw = bytearray(open(path, "rb").read())
        raw[raw.find(arrays["buffers/c"].tobytes()) + 5] ^= 1
        open(path, "wb").write(bytes(raw))
        with pytest.raises(zipfile.BadZipFile, match="CRC"):
            dict(checkpoint._members(path))


def test_initial_only_aux_sample_rides_the_checkpoint(tmp_path):
    """An INITIAL-only projection keeps its t = 0 sample across a resume
    without init (the t = 0 state is gone)."""
    text = _CH_DECK.format(nx=8, ny=8, substeps=1).replace(
        "[Domain]", "[Domain]\n  floating_precision = DOUBLE") + """
[AuxVariables]
  [c0]
  []
[]
[AuxKernels]
  [c0]
    type = ProjectTensorAux
    buffer = c
    variable = c0
    execute_on = INITIAL
  []
[]
[Outputs]
  exodus = true
[]
[Executioner]
  type = Transient
  num_steps = 4
[]
"""
    from marlin_tpu_torch.exodus import read_exodus

    part = run_deck(_steps(text, 2, interval=2), output_dir=str(tmp_path / "p"), device="cpu")
    res = run_deck(_steps(text, 4), output_dir=str(tmp_path / "r"), device="cpu",
                   recover=part.checkpoint_path)
    first = read_exodus(str(tmp_path / "p" / "out.e"))["nodal"]["c0"][0]
    resumed = read_exodus(str(tmp_path / "r" / "out.e"))
    assert len(resumed["time"]) == 2  # steps 3 and 4
    for frame in resumed["nodal"]["c0"]:
        np.testing.assert_array_equal(frame, first)
    assert res.step_count == 4


@pytest.mark.parametrize("other", ["precision", "extent"])
def test_checkpoint_of_another_deck_is_a_named_error(other, tmp_path):
    text = _CH_DECK.format(nx=16, ny=16, substeps=1).replace(
        "[Domain]", "[Domain]\n  floating_precision = DOUBLE") + _F32_DT
    text = text.replace("[TensorComputes]", "[TensorBuffers]\n  [c]\n  []\n[]\n"
                        "[TensorComputes]", 1)
    part = run_deck(_steps(text, 2, interval=2), output_dir=str(tmp_path / "p"), device="cpu")
    if other == "precision":
        text = text.replace("floating_precision = DOUBLE", "floating_precision = SINGLE")
    else:
        text = text.replace("nx = 16", "nx = 8")
    with pytest.raises(ProblemError, match="does not fit this deck: buffer 'c'"):
        run_deck(_steps(text, 4), output_dir=str(tmp_path / "r"), device="cpu",
                 recover=part.checkpoint_path)


def _jax_transient(text, out_dir, steps):
    from marlin_tpu import hit as jhit
    from marlin_tpu.executioner import Transient as JaxTransient
    from marlin_tpu.problem import TensorProblem as JaxProblem

    root = jhit.parse(text)
    root.child("Executioner").set_param("num_steps", str(steps))
    return JaxTransient(JaxProblem(root), exec_node=root.children.get("Executioner"),
                        outputs_node=root.children.get("Outputs"),
                        user_objects_node=root.children.get("UserObjects"),
                        file_base="ck", output_dir=str(out_dir))


def _assert_close_to_jax(port, jax_tr):
    assert port.step_count == jax_tr.step_count
    assert port.time == pytest.approx(jax_tr.time, abs=1e-12)
    for k, v in jax_tr.state["buffers"].items():
        np.testing.assert_allclose(port.state["buffers"][k].numpy(), np.asarray(v),
                                   rtol=0, atol=TOL, err_msg=k)
    assert set(port.pp_values) == set(jax_tr.pp_values)
    for k, v in jax_tr.pp_values.items():
        assert port.pp_values[k] == pytest.approx(v, rel=0, abs=TOL), k


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX checkpoint at step 5, resumed by the port to step 10, equals
    the JAX package's 10 uninterrupted steps within 1e-10."""
    text = _1a("floating_precision = DOUBLE", "", n=16, substeps=3)
    part = _jax_transient(text, tmp_path / "jax_part", 5)
    part.run()
    part.save_checkpoint()
    full = _jax_transient(text, tmp_path / "jax_full", 10)
    full.run()
    res = run_deck(_steps(text, 10), output_dir=str(tmp_path / "port"), device="cpu",
                   recover=part.checkpoint_path)
    _assert_close_to_jax(res, full)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """The reverse: the port's checkpoint at step 5, resumed by the JAX
    package to step 10, equals the port's 10 uninterrupted steps within
    1e-10."""
    text = _1a("floating_precision = DOUBLE", "", n=16, substeps=3)
    part = run_deck(_steps(text, 5, interval=5), output_dir=str(tmp_path / "port_part"),
                    device="cpu")
    full = run_deck(_steps(text, 10), output_dir=str(tmp_path / "port_full"), device="cpu")
    res = _jax_transient(text, tmp_path / "jax", 10)
    res.recover(part.checkpoint_path)
    res.run()
    _assert_close_to_jax(full, res)


def _mech(n=16):
    """MECH_DECK at n³ in float64, the analytic tangent, 2 substeps a step."""
    text = decks.MECH_DECK.format(n=n, domain_extra="floating_precision = DOUBLE")
    strain = "        applied_macroscopic_strain = applied_strain\n"
    return text.replace(strain, strain + "        analytic_tangent = true\n").replace(
        "  substeps = 10\n", "  substeps = 2\n")


def test_mech_deck_resumes_bit_exact(tmp_path):
    """MECH_DECK at 16³ with a checkpoint at step 1 resumes to step 3 equal
    to 3 uninterrupted steps bit for bit: F, the (3, 3) applied strain and
    the 0-d bool Newton flag among the buffers."""
    text = _mech()
    full = run_deck(_steps(text, 3), output_dir=str(tmp_path / "full"), device="cpu")
    part = run_deck(_steps(text, 1, interval=1), output_dir=str(tmp_path / "part"),
                    device="cpu")
    res = run_deck(_steps(text, 3), output_dir=str(tmp_path / "res"), device="cpu",
                   recover=part.checkpoint_path)
    _assert_states_equal(res.state, full.state)
    flag = res.state["buffers"]["__converged_mech__"]
    assert flag.dtype == torch.bool and flag.shape == () and bool(flag)
    assert res.state["buffers"]["applied_strain"].shape == (3, 3)


def test_jax_mech_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX checkpoint of MECH_DECK at step 1, resumed by the port to step
    3, equals the JAX package's 3 uninterrupted steps within 1e-10, the
    Newton flag included."""
    import jax

    jax.config.update("jax_enable_x64", True)
    text = _mech()
    part = _jax_transient(text, tmp_path / "jax_part", 1)
    part.run()
    part.save_checkpoint()
    full = _jax_transient(text, tmp_path / "jax_full", 3)
    full.run()
    res = run_deck(_steps(text, 3), output_dir=str(tmp_path / "port"), device="cpu",
                   recover=part.checkpoint_path)
    _assert_close_to_jax(res, full)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip(cuda, tmp_path):
    """A state on the card written and read back: its tensors return to
    the card, bit for bit, and a resumed run equals the uninterrupted one."""
    text = _1a(PALLAS, FUSED, n=64, substeps=10)
    part = run_deck(_steps(text, 2, interval=2), output_dir=str(tmp_path / "p"), device=cuda)
    state, meta = checkpoint.load(part.checkpoint_path, cuda)
    assert all(t.is_cuda for t in state["buffers"].values())
    _assert_states_equal(state, part.state)
    res = run_deck(_steps(text, 4), output_dir=str(tmp_path / "r"), device=cuda,
                   recover=part.checkpoint_path)
    full = run_deck(_steps(text, 4), output_dir=str(tmp_path / "f"), device=cuda)
    _assert_states_equal(res.state, full.state)
