"""The port's field outputs (marlin_tpu_torch/xdmf.py, exodus.py, aux.py,
outputs.py, vtk.py, xdmfdiff.py and the vector postprocessors) against the
JAX package's, on the CPU.

Both packages run the same deck text in float64 (the port on
``device="cpu"``) and write their series into two directories:

- XDMF: the ``.xmf`` text is identical and ``xdmfdiff.compare`` of the two
  series passes within 1e-10 (absolute, no relative slack);
- Exodus: both ``.e`` files read back with ``read_exodus``; times, mesh and
  global variables equal within 1e-10, field variables too;
- the aux-variable postprocessors' CSV columns within 1e-10;
- TensorHistogram: identical files, one a step;
- the copies (VTK, xdmfdiff, ``sample_at``): the serial cases of
  tests/test_vtk.py, tests/test_xdmfdiff.py and tests/test_sample_at.py,
  parametrised over both packages' modules.
"""

import importlib
import io
import os
import shutil
import sys
import xml.etree.ElementTree as ET

import h5py
import numpy as np
import pytest
import torch

from __graft_entry__ import _CH_DECK
from marlin_tpu import hit as jhit
from marlin_tpu.executioner import run_deck as jax_run_deck
from marlin_tpu.problem import TensorProblem as JaxProblem
from marlin_tpu_torch import hit
from marlin_tpu_torch import main as port_main
from marlin_tpu_torch import xdmfdiff
from marlin_tpu_torch.aux import AuxError
from marlin_tpu_torch.executioner import run_deck
from marlin_tpu_torch.exodus import read_exodus
from marlin_tpu_torch.outputs import OutputError
from marlin_tpu_torch.params import ParamError
from marlin_tpu_torch.problem import TensorProblem

from .test_xdmfdiff import DET_DECK

TOL = 1e-10
PACKAGES = ["marlin_tpu", "marlin_tpu_torch"]


def _module(package, name):
    return importlib.import_module(f"{package}.{name}")


def _run_both(text, tmp_path, stem="det"):
    """Run ``text`` in both packages; (JAX transient, port transient, JAX
    directory, port directory)."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jroot = jhit.parse(text)
    jhit.expand_braces(jroot)
    jt = jax_run_deck(jroot, file_base="out", output_dir=str(jdir), deck_stem=stem)
    pt = run_deck(hit.parse(text), file_base="out", output_dir=str(pdir),
                  device="cpu", deck_stem=stem)
    return jt, pt, jdir, pdir


def _xdmf_deck(mode="CELL", hdf5=True):
    return (DET_DECK.replace("output_mode = Cell", f"output_mode = {mode}")
            .replace("enable_hdf5 = true", f"enable_hdf5 = {str(hdf5).lower()}")
            .replace("  ymax = 1\n", "  ymax = 1\n  floating_precision = DOUBLE\n"))


# -- XDMF ----------------------------------------------------------------------


@pytest.mark.parametrize("hdf5", [True, False], ids=["hdf5", "binary"])
@pytest.mark.parametrize("mode", ["CELL", "NODE", "OVERSIZED_NODAL"])
def test_xdmf_series_matches_jax(mode, hdf5, tmp_path):
    _jt, pt, jdir, pdir = _run_both(_xdmf_deck(mode, hdf5), tmp_path)
    assert (pdir / "det.xmf").read_text() == (jdir / "det.xmf").read_text()
    out = io.StringIO()
    assert xdmfdiff.compare(str(jdir / "det.xmf"), str(pdir / "det.xmf"),
                            rtol=0.0, atol=TOL, out=out) == 0, out.getvalue()
    series = xdmfdiff.read_series(str(pdir / "det.xmf"))
    assert len(series) == 3  # t = 0 and two steps
    want = (17, 17) if mode == "NODE" else (16, 16)
    assert series[-1][1]["c"].shape == want
    # the last frame is the final state (transposed for Paraview's order)
    c = pt.state["buffers"]["c"].numpy()
    if mode == "NODE":
        c = np.concatenate([c, c[:1]], 0)
        c = np.concatenate([c, c[:, :1]], 1)
    np.testing.assert_array_equal(series[-1][1]["c"], c.T)
    if hdf5:
        with h5py.File(pdir / "det.h5") as f:
            assert sorted(f) == ["c.0", "c.1", "c.2"]
    else:
        assert sorted(p for p in os.listdir(pdir) if p.endswith(".bin")) == [
            "det.c.0.bin", "det.c.1.bin", "det.c.2.bin"]


def test_xdmf_untransposed_two_buffers_match_jax(tmp_path):
    """``transpose = false`` and two buffers, one of them produced by the
    postprocess group (1a's free-energy density, through
    run_postprocess_computes)."""
    from marlin_tpu_torch.decks import BENCH_1A_DECK

    text = BENCH_1A_DECK.format(n=16, substeps=2, domain_extra="floating_precision = DOUBLE",
                                solver_extra="")
    text = text.replace("end_time = 10500", "end_time = 10500\n  num_steps = 3")
    text = text.replace("  perf_graph = true\n", "") + """
[TensorOutputs]
  [fields]
    type = XDMFTensorOutput
    buffer = 'f c'
    transpose = false
    file_base = fields
  []
[]
"""
    _jt, pt, jdir, pdir = _run_both(text, tmp_path)
    assert (pdir / "fields.xmf").read_text() == (jdir / "fields.xmf").read_text()
    out = io.StringIO()
    assert xdmfdiff.compare(str(jdir / "fields.xmf"), str(pdir / "fields.xmf"),
                            rtol=0.0, atol=TOL, out=out) == 0, out.getvalue()
    series = xdmfdiff.read_series(str(pdir / "fields.xmf"))
    assert len(series) == 4
    assert float(np.abs(series[-1][1]["f"]).max()) > 0  # not the zero-initialised f


def test_xdmf_mistyped_buffer_raises(tmp_path):
    text = DET_DECK.replace("buffer = c\n    output_mode", "buffer = concnetration\n"
                            "    output_mode")
    with pytest.raises(KeyError, match="concnetration"):
        run_deck(hit.parse(text), output_dir=str(tmp_path), device="cpu", deck_stem="det")


def test_xdmf_writer_thread_error_propagates(tmp_path, monkeypatch):
    """An exception in the writer thread (disk full, ...) re-raises at the
    next join point: the run must not end well with missing output."""
    from marlin_tpu_torch import xdmf as xdmf_mod

    monkeypatch.setattr(
        xdmf_mod.XDMFTensorOutput, "_write_h5",
        lambda self, frame_data: (_ for _ in ()).throw(OSError("disk full")))
    with pytest.raises(RuntimeError, match="writer thread.*disk full"):
        run_deck(hit.parse(DET_DECK), output_dir=str(tmp_path), device="cpu",
                 deck_stem="det")


def test_xdmf_writer_thread_sees_no_tensor(tmp_path, monkeypatch):
    """The main thread fetches the frame; the writer gets numpy arrays."""
    from marlin_tpu_torch import xdmf as xdmf_mod

    seen = []
    real = xdmf_mod.XDMFTensorOutput._write_h5

    def spy(self, frame_data):
        seen.extend(type(a) for a in frame_data.values())
        return real(self, frame_data)

    monkeypatch.setattr(xdmf_mod.XDMFTensorOutput, "_write_h5", spy)
    run_deck(hit.parse(_xdmf_deck(hdf5=False)), output_dir=str(tmp_path),
             device="cpu", deck_stem="det")
    assert seen and set(seen) == {np.ndarray}


def test_hdf5_without_h5py_is_a_named_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)  # `import h5py` raises
    with pytest.raises(OutputError, match="enable_hdf5 = true needs h5py"):
        run_deck(hit.parse(DET_DECK), output_dir=str(tmp_path), device="cpu",
                 deck_stem="det")
    # the binary layout needs no h5py
    run_deck(hit.parse(_xdmf_deck(hdf5=False)), output_dir=str(tmp_path),
             device="cpu", deck_stem="det")
    assert (tmp_path / "det.c.2.bin").exists()


@pytest.mark.parametrize("text,match", [
    (DET_DECK.replace("type = XDMFTensorOutput", "type = VTKTensorOutput"),
     "Unknown \\[TensorOutputs\\] type 'VTKTensorOutput'"),
    (DET_DECK + "[Outputs]\n  [x]\n    type = Nemesis\n  []\n[]\n",
     "Unknown \\[Outputs\\] sub-block type 'Nemesis'"),
], ids=["tensor_output", "outputs_sub_block"])
def test_unknown_output_types_match_jax(text, match, tmp_path):
    with pytest.raises(Exception, match=match):
        jax_run_deck(jhit.parse(text), output_dir=str(tmp_path / "j"), deck_stem="det")
    with pytest.raises(Exception, match=match):
        run_deck(hit.parse(text), output_dir=str(tmp_path / "p"), device="cpu",
                 deck_stem="det")


def test_cli_writes_xdmf_under_the_deck_stem(tmp_path, capsys):
    deck = tmp_path / "decay.i"
    deck.write_text(_xdmf_deck(hdf5=False))
    assert port_main.main([str(deck), "--compute-device", "cpu",
                           "--output-dir", str(tmp_path / "out")]) == 0
    assert (tmp_path / "out" / "decay.xmf").exists()
    assert len(xdmfdiff.read_series(str(tmp_path / "out" / "decay.xmf"))) == 3


# -- Exodus and aux variables -------------------------------------------------------

_AUX = """
[AuxVariables]
  [c_nodal]
  []
  [c_elem]
    family = MONOMIAL
    order = CONSTANT
  []
  [c0]
    family = MONOMIAL
  []
  [v_nodal]
  []
[]
[AuxKernels]
  [c_elem]
    type = ProjectTensorAux
    buffer = c
    variable = c_elem
  []
  [c0]
    type = ProjectTensorAux
    buffer = c
    variable = c0
    execute_on = INITIAL
  []
  [v_nodal]
    type = ProjectVectorTensorAux
    buffer = v
    variable = v_nodal
  []
[]
[Postprocessors]
  [c_max]
    type = NodalExtremeValue
    variable = c_nodal
  []
  [c_min]
    type = ElementExtremeValue
    variable = c_elem
    value_type = MIN
  []
  [c_avg]
    type = ElementAverageValue
    variable = c_nodal
  []
  [c_int]
    type = ElementIntegralVariablePostprocessor
    variable = c_elem
  []
  [evals]
    type = ComputeGroupExecutionCount
  []
[]
[Outputs]
  exodus = true
  csv = true
[]
[Executioner]
  type = Transient
  num_steps = 3
  [TimeStepper]
    type = ConstantDT
    dt = 0.5
  []
[]
"""


def _aux_deck():
    """_CH_DECK at 16², float64, with c mapped to a nodal aux variable,
    an elemental and an INITIAL-only projection, a constant vector buffer
    projected component-wise, the aux postprocessors and Exodus + CSV."""
    text = _CH_DECK.format(nx=16, ny=16, substeps=2).replace(
        "[Domain]", "[Domain]\n  floating_precision = DOUBLE")
    text = text.replace("[TensorComputes]", """[TensorBuffers]
  [c]
    map_to_aux_variable = c_nodal
  []
  [v]
    value_dimensions = '2'
  []
[]
[TensorComputes]""", 1)
    text = text.replace("  [Initialize]\n", """  [Initialize]
    [v]
      type = ConstantTensor
      buffer = v
      real = 1.5
    []
""", 1)
    return text + _AUX


def test_exodus_and_aux_postprocessors_match_jax(tmp_path):
    jt, pt, jdir, pdir = _run_both(_aux_deck(), tmp_path)
    je, pe = read_exodus(str(jdir / "out.e")), read_exodus(str(pdir / "out.e"))
    assert len(pe["time"]) == 4
    np.testing.assert_array_equal(pe["time"], je["time"])
    for ax in je["coords"]:
        np.testing.assert_array_equal(pe["coords"][ax], je["coords"][ax])
    np.testing.assert_array_equal(pe["connect"], je["connect"])
    assert set(pe["nodal"]) == set(je["nodal"]) == {"c_nodal", "v_nodal_x", "v_nodal_y"}
    assert set(pe["elem"]) == set(je["elem"]) == {"c_elem", "c0"}
    assert set(pe["glo"]) == set(je["glo"])
    for kind in ("nodal", "elem", "glo"):
        for name, vals in je[kind].items():
            np.testing.assert_allclose(pe[kind][name], vals, rtol=0, atol=TOL,
                                       err_msg=f"{kind} {name}")
    # the INITIAL-only projection keeps its t = 0 sample
    np.testing.assert_array_equal(pe["elem"]["c0"][-1], pe["elem"]["c0"][0])
    assert not np.array_equal(pe["elem"]["c_elem"][-1], pe["elem"]["c_elem"][0])
    np.testing.assert_array_equal(pe["nodal"]["v_nodal_x"], 1.5)
    # the aux postprocessors' CSV columns, and the static evaluation count
    jrows = (jdir / "out.csv").read_text().splitlines()
    prows = (pdir / "out.csv").read_text().splitlines()
    assert prows[0] == jrows[0]
    for jr, pr in zip(jrows[1:], prows[1:]):
        np.testing.assert_allclose([float(x) for x in pr.split(",")],
                                   [float(x) for x in jr.split(",")], rtol=0, atol=TOL)
    assert pt.pp_values["evals"] == jt.pp_values["evals"] == 6.0  # 3 steps x 2 substeps
    c = pt.state["buffers"]["c"].numpy()
    assert pt.pp_values["c_max"] == pytest.approx(c.max(), abs=TOL)
    assert pt.pp_values["c_int"] == pytest.approx(c.mean() * 16 * 16, abs=TOL)


@pytest.mark.parametrize("nodal", [True, False], ids=["nodal", "elemental"])
@pytest.mark.parametrize("kernel", ["map_to_aux_variable", "ProjectTensorAux",
                                    "ProjectTensorAux_initial", "ProjectVectorTensorAux"])
def test_aux_values_match_jax(kernel, nodal, tmp_path):
    """AuxSystem.values of one random state in both packages, and the
    INITIAL-only cache (seeded from the first state, then frozen)."""
    buf = "v" if kernel == "ProjectVectorTensorAux" else "c"
    family = "" if nodal else "    family = MONOMIAL\n"
    text = _CH_DECK.format(nx=8, ny=6, substeps=1).replace(
        "[Domain]", "[Domain]\n  floating_precision = DOUBLE")
    text = text.replace("[TensorComputes]", "[TensorBuffers]\n  [c]\n"
                        + ("    map_to_aux_variable = a\n" if kernel == "map_to_aux_variable"
                           else "") + "  []\n  [v]\n    value_dimensions = '3'\n  []\n[]\n"
                        "[TensorComputes]", 1)
    text += f"[AuxVariables]\n  [a]\n{family}  []\n[]\n"
    if kernel != "map_to_aux_variable":
        ktype = kernel.split("_")[0]
        exec_on = "    execute_on = INITIAL\n" if kernel.endswith("initial") else ""
        text += (f"[AuxKernels]\n  [a]\n    type = {ktype}\n    buffer = {buf}\n"
                 f"    variable = a\n{exec_on}  []\n[]\n")
    jp, pp = JaxProblem(jhit.parse(text)), TensorProblem(hit.parse(text), device="cpu")
    rng = np.random.default_rng(3)
    states = [{"c": rng.standard_normal((8, 6)), "v": rng.standard_normal((8, 6, 3))}
              for _ in range(2)]
    for st in states:
        jv = jp.aux.values({"buffers": st}, "a")
        pv = pp.aux.values({"buffers": {k: torch.from_numpy(v) for k, v in st.items()}}, "a")
        np.testing.assert_array_equal(pv, jv)
    want = states[0 if kernel.endswith("initial") else 1][buf]
    if nodal:
        want = np.concatenate([want, want[:1]], 0)
        want = np.concatenate([want, want[:, :1]], 1)
    np.testing.assert_array_equal(pv, want)


_AUX_ERRORS = {
    "unknown_buffer": ("[AuxVariables]\n  [c]\n  []\n[]\n[AuxKernels]\n  [c]\n"
                       "    type = ProjectTensorAux\n    buffer = cc\n    variable = c\n  []\n[]\n",
                       "unknown buffer 'cc'"),
    "unknown_variable": ("[AuxVariables]\n  [c]\n  []\n[]\n[AuxKernels]\n  [k]\n"
                         "    type = ProjectTensorAux\n    buffer = c\n    variable = d\n  []\n[]\n",
                         "unknown variable 'd'"),
    "unknown_kernel": ("[AuxVariables]\n  [c]\n  []\n[]\n[AuxKernels]\n  [k]\n"
                       "    type = FunctionAux\n    variable = c\n  []\n[]\n",
                       "Unknown AuxKernel type 'FunctionAux'"),
    "family": ("[AuxVariables]\n  [c]\n    family = HERMITE\n  []\n[]\n",
               "unsupported family 'HERMITE'"),
    "order": ("[AuxVariables]\n  [c]\n    family = MONOMIAL\n    order = FIRST\n  []\n[]\n",
              "only CONSTANT MONOMIAL"),
    "map_to_unknown": ("[TensorBuffers]\n  [c]\n    map_to_aux_variable = nope\n  []\n[]\n",
                       "maps to unknown aux variable 'nope'"),
    "pp_variable": ("[AuxVariables]\n  [c]\n  []\n[]\n[Postprocessors]\n  [m]\n"
                    "    type = ElementAverageValue\n    variable = d\n  []\n[]\n",
                    "unknown aux variable 'd'"),
}

_ERR_DECK = """
[Domain]
  dim = 1
  nx = 8
[]
[TensorComputes]
  [Initialize]
    [c]
      type = ConstantTensor
      buffer = c
      real = 1
    []
  []
[]
[Problem]
  type = TensorProblem
[]
"""


@pytest.mark.parametrize("case", list(_AUX_ERRORS))
def test_aux_errors_match_jax(case):
    """The aux error paths of tests/test_errors.py give the same messages."""
    from marlin_tpu.aux import AuxError as JaxAuxError
    from marlin_tpu.params import ParamError as JaxParamError

    block, match = _AUX_ERRORS[case]
    text = _ERR_DECK + block
    with pytest.raises((JaxAuxError, JaxParamError), match=match) as je:
        JaxProblem(jhit.parse(text))
    with pytest.raises((AuxError, ParamError), match=match) as pe:
        TensorProblem(hit.parse(text), device="cpu")
    assert str(pe.value) == str(je.value)


def test_non_scalar_buffer_on_scalar_aux_is_an_error():
    text = _ERR_DECK.replace("[TensorComputes]", "[TensorBuffers]\n  [v]\n"
                             "    value_dimensions = '2'\n    map_to_aux_variable = a\n"
                             "  []\n[]\n[TensorComputes]") + "[AuxVariables]\n  [a]\n  []\n[]\n"
    p = TensorProblem(hit.parse(text), device="cpu")
    with pytest.raises(AuxError, match="is not a scalar field"):
        p.aux.values({"buffers": {"v": torch.zeros(8, 2)}}, "a")


# -- vector postprocessors ---------------------------------------------------------


def test_histogram_series_matches_jax(tmp_path):
    text = _CH_DECK.format(nx=16, ny=16, substeps=2).replace(
        "[Domain]", "[Domain]\n  floating_precision = DOUBLE") + """
[VectorPostprocessors]
  [hist]
    type = TensorHistogram
    buffer = c
    min = 0.45
    max = 0.55
    bins = 7
    execute_on = 'INITIAL TIMESTEP_END'
  []
[]
[Executioner]
  type = Transient
  num_steps = 4
[]
"""
    _run_both(text, tmp_path)
    names = sorted(p for p in os.listdir(tmp_path / "jax") if "_hist_" in p)
    assert names == [f"out_hist_{i:04d}.csv" for i in range(5)]
    assert sorted(p for p in os.listdir(tmp_path / "port") if "_hist_" in p) == names
    for name in names:
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text(), name
    rows = (tmp_path / "port" / names[-1]).read_text().splitlines()
    assert rows[0] == "bin,count" and len(rows) == 8
    assert sum(float(r.split(",")[1]) for r in rows[1:]) > 0


def test_histogram_bins_are_numpys():
    """Edges and counts of np.histogram, not torch.histc's."""
    from marlin_tpu_torch.postprocessors import TensorHistogram

    text = _ERR_DECK + """
[VectorPostprocessors]
  [h]
    type = TensorHistogram
    buffer = c
    min = 0
    max = 1
    bins = 3
  []
[]
"""
    p = TensorProblem(hit.parse(text), device="cpu")
    (h,) = p.vector_postprocessors
    assert isinstance(h, TensorHistogram)
    u = torch.tensor([0.0, 1 / 3, 0.5, 2 / 3, 1.0, 1.5, -0.1, 0.999999])
    cols = h.compute({"buffers": {"c": u}}, {})
    counts, _ = np.histogram(u.numpy(), bins=3, range=(0, 1))
    np.testing.assert_array_equal(cols["count"], counts)
    np.testing.assert_allclose(cols["bin"], [1 / 6, 0.5, 5 / 6])


# -- the copies: vtk, xdmfdiff, sample_at, over both packages --------------------------


def _parse_vtk(path):
    from .test_vtk import _parse_vtk as parse

    return parse(path)


@pytest.mark.parametrize("package", PACKAGES)
def test_vtk_scalar_vector_and_tensor_fields(package, tmp_path):
    """test_vtk.py's scalar round trip, vectors in 3-D, 2-D vectors padded
    to 3, many components and tensors flattened, shape and complex errors."""
    vtk = _module(package, "vtk")
    rng = np.random.RandomState(0)
    c = rng.rand(4, 6)
    vtk.write_structured_vtk(str(tmp_path / "a.vtk"), {"c": c}, spacing=(0.5, 0.25))
    head, fields = _parse_vtk(tmp_path / "a.vtk")
    assert head["DIMENSIONS"] == [4, 6, 1] and head["SPACING"] == [0.5, 0.25, 1.0]
    np.testing.assert_allclose(fields["c"].reshape(6, 4).T, c, rtol=1e-10)
    u, s = rng.rand(3, 4, 5, 3), rng.rand(3, 4, 5)
    vtk.write_structured_vtk(str(tmp_path / "b.vtk"), {"disp": u, "c": s})
    _head, fields = _parse_vtk(tmp_path / "b.vtk")
    np.testing.assert_allclose(fields["disp"].reshape(5, 4, 3, 3).transpose(2, 1, 0, 3),
                               u, rtol=1e-10)
    v = rng.rand(4, 4, 2)
    vtk.write_structured_vtk(str(tmp_path / "v.vtk"), {"v": v}, grid_shape=(4, 4))
    _head, fields = _parse_vtk(tmp_path / "v.vtk")
    assert fields["v"].shape == (16, 3) and np.all(fields["v"][:, 2] == 0.0)
    F = rng.rand(4, 4, 9)
    vtk.write_structured_vtk(str(tmp_path / "F.vtk"), {"F": F}, grid_shape=(4, 4))
    _head, fields = _parse_vtk(tmp_path / "F.vtk")
    for k in range(9):
        np.testing.assert_allclose(fields[f"F_{k}"].reshape(4, 4).T, F[..., k], rtol=1e-10)
    stress = np.arange(64, dtype=float).reshape(4, 4, 2, 2)
    vtk.write_structured_vtk(str(tmp_path / "t.vtk"), {"stress": stress}, grid_shape=(4, 4))
    assert "SCALARS stress_3 double 1" in (tmp_path / "t.vtk").read_text()
    with pytest.raises(ValueError, match="does not match"):
        vtk.write_structured_vtk(str(tmp_path / "x.vtk"),
                                 {"a": np.zeros((4, 4)), "b": np.zeros((5, 5))})
    with pytest.raises(ValueError, match="complex"):
        vtk.write_structured_vtk(str(tmp_path / "x.vtk"),
                                 {"cbar": np.zeros((4, 4), complex)}, grid_shape=(4, 4))


_VTK_DECK = """
[Domain]
  dim = 2
  nx = 8
  ny = 8
  xmax = 2
  ymax = 2
  floating_precision = DOUBLE
[]
[TensorBuffers]
  [disp]
    value_dimensions = '2'
  []
[]
[TensorComputes]
  [Initialize]
    [c]
      type = ParsedCompute
      buffer = c
      extra_symbols = true
      expression = 'x + 10*y'
    []
  []
[]
[Problem]
  type = TensorProblem
[]
"""


def test_state_vtk_matches_jax(tmp_path):
    """write_state_vtk of a port state (tensors fetched to the host) writes
    the JAX package's file, scalar and lone vector buffer alike."""
    from marlin_tpu.vtk import write_state_vtk as jax_write
    from marlin_tpu_torch.vtk import write_state_vtk

    jp, pp = JaxProblem(jhit.parse(_VTK_DECK)), TensorProblem(hit.parse(_VTK_DECK), device="cpu")
    js, ps = jp.init_state(), pp.init_state()
    for names in (["c"], ["disp"]):
        jax_write(str(tmp_path / "j.vtk"), jp, js, names)
        write_state_vtk(str(tmp_path / "p.vtk"), pp, ps, names)
        assert (tmp_path / "p.vtk").read_text() == (tmp_path / "j.vtk").read_text()
    head, fields = _parse_vtk(tmp_path / "p.vtk")
    assert head["DIMENSIONS"] == [8, 8, 1] and fields["disp"].shape == (64, 3)
    write_state_vtk(str(tmp_path / "c.vtk"), pp, ps, ["c"])
    head, fields = _parse_vtk(tmp_path / "c.vtk")
    assert head["SPACING"][0] == pytest.approx(0.25)
    assert head["ORIGIN"][0] == pytest.approx(0.125)
    np.testing.assert_allclose(fields["c"].reshape(8, 8).T, ps["buffers"]["c"].numpy(),
                               atol=1e-10)
    with pytest.raises(KeyError, match="not in state"):
        write_state_vtk(str(tmp_path / "x.vtk"), pp, ps, ["nope"])


@pytest.fixture
def series(tmp_path):
    """The deterministic XDMF deck's series, written by the port, in HDF5
    and in the binary layout."""
    out = {}
    for hdf5 in (True, False):
        d = tmp_path / ("h5" if hdf5 else "bin")
        run_deck(hit.parse(_xdmf_deck(hdf5=hdf5)), output_dir=str(d), device="cpu",
                 deck_stem="det")
        out[hdf5] = d
    return out


@pytest.mark.parametrize("package", PACKAGES)
def test_xdmfdiff_identical_and_perturbed_series(package, series, tmp_path):
    """test_xdmfdiff.py's identical series, perturbed HDF5 copy and CLI exit
    codes, on the port's own output."""
    diff = _module(package, "xdmfdiff")
    xmf, h5 = str(series[True] / "det.xmf"), str(series[True] / "det.h5")
    out = io.StringIO()
    assert diff.compare(xmf, xmf, out=out) == 0 and "[OK]" in out.getvalue()
    xmf_b, h5_b = str(tmp_path / "b.xmf"), str(tmp_path / "b.h5")
    shutil.copy(h5, h5_b)
    with open(xmf) as f:
        text = f.read()
    with open(xmf_b, "w") as f:
        f.write(text.replace("det.h5", "b.h5"))
    with h5py.File(h5_b, "r+") as f:
        data = np.asarray(f["c.1"])
        data.flat[0] += 1.0
        del f["c.1"]
        f["c.1"] = data
    out = io.StringIO()
    assert diff.compare(xmf, xmf_b, out=out) == 1 and "[FAIL]" in out.getvalue()
    assert diff.main([xmf, xmf]) == 0
    assert diff.main([xmf, xmf_b]) == 1
    assert diff.main([xmf, xmf_b, "--atol", "10"]) == 0


@pytest.mark.parametrize("package", PACKAGES)
def test_xdmfdiff_snapshot_count_and_time_pairing(package, series, tmp_path):
    """test_xdmfdiff.py's truncated series and its pairing by time with a
    dropped leading frame."""
    diff = _module(package, "xdmfdiff")
    xmf = str(series[True] / "det.xmf")
    assert len(diff.read_series(xmf)) == 3
    for drop, name in ((-1, "trunc.xmf"), (0, "late.xmf")):
        tree = ET.parse(xmf)
        for dom in tree.getroot():
            for grid in dom:
                if grid.get("CollectionType") == "Temporal":
                    grid.remove(list(grid)[drop])
        tree.write(str(series[True] / name))
        out = io.StringIO()
        failures = diff.compare(xmf, str(series[True] / name), out=out)
        text = out.getvalue()
        assert "snapshot count differs" in text and "[FAIL]" not in text
        assert "no matching snapshot" in text and failures == 2


@pytest.mark.parametrize("package", PACKAGES)
def test_xdmfdiff_binary_layout_and_nan(package, series, tmp_path):
    diff = _module(package, "xdmfdiff")
    xmf = str(series[False] / "det.xmf")
    assert diff.read_series(xmf)[0][1]["c"].shape == (16, 16)
    assert diff.compare(xmf, xmf, out=io.StringIO()) == 0
    shutil.copytree(series[False], tmp_path / "nan")
    target = tmp_path / "nan" / "det.c.0.bin"
    data = np.fromfile(target, dtype=np.float64)
    data[0] = np.nan
    data.tofile(target)
    out = io.StringIO()
    assert diff.compare(xmf, str(tmp_path / "nan" / "det.xmf"), out=out) >= 1
    assert "[FAIL]" in out.getvalue()


@pytest.mark.parametrize("package", PACKAGES)
def test_xdmfdiff_pair_by_time_local_gap(package):
    diff = _module(package, "xdmfdiff")
    fa = {"c": np.zeros((2, 2))}
    sa = [(0.0, fa), (1e-5, fa), (50.0, fa), (100.0, fa)]
    sb = [(0.0, fa), (1e-5, fa), (50.0, fa), (100.0 + 1e-4, fa)]
    pairs, (ua, ub) = diff._pair_by_time(sa, sb)
    assert not ua and not ub and len(pairs) == 4


def _domain(package, dim, n):
    if package == "marlin_tpu":
        from marlin_tpu.domain import Domain, Precision

        return Domain(dim, (n,) * dim, maxs=(1.0,) * dim,
                      floating_precision=Precision.DOUBLE)
    from marlin_tpu_torch.domain import Domain

    return Domain(dim=dim, n=[n] * dim, maxs=[1.0] * dim,
                  floating_precision="DOUBLE", device="cpu")


def _axis(dom, d):
    a = dom.axis(d)
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("package", PACKAGES)
def test_sample_at_exact_linear_and_periodic(package):
    """test_sample_at.py's cell centres, linear field, periodic wrap with
    vector values and shape errors."""
    aux = _module(package, "aux")
    dom = _domain(package, 2, 16)
    x, y = _axis(dom, 0), _axis(dom, 1)
    f = np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y)
    xs, ys = np.meshgrid(x.ravel(), y.ravel(), indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel()], -1)
    np.testing.assert_allclose(aux.sample_at(dom, f, pts), f.ravel(), atol=1e-14)
    dom = _domain(package, 2, 32)
    f = np.broadcast_to(2.0 * _axis(dom, 0) + 3.0 * _axis(dom, 1), (32, 32))
    pts = 0.1 + 0.8 * np.random.RandomState(3).rand(200, 2)
    np.testing.assert_allclose(aux.sample_at(dom, f, pts),
                               2.0 * pts[:, 0] + 3.0 * pts[:, 1], atol=1e-12)
    dom = _domain(package, 1, 8)
    f = np.stack([np.arange(8.0), np.arange(8.0) * 10], -1)
    np.testing.assert_allclose(aux.sample_at(dom, f, [[0.0]])[0], [3.5, 35.0])
    np.testing.assert_allclose(aux.sample_at(dom, f, [[1.0]])[0], [3.5, 35.0])
    dom = _domain(package, 2, 8)
    with pytest.raises(aux.AuxError, match="points must be"):
        aux.sample_at(dom, np.zeros((8, 8)), np.zeros((3, 3)))
    with pytest.raises(aux.AuxError, match="grid shape"):
        aux.sample_at(dom, np.zeros((4, 4)), np.zeros((3, 2)))


@pytest.mark.parametrize("package", PACKAGES)
def test_sample_at_converges_in_3d(package):
    aux = _module(package, "aux")
    errs = []
    for n in (8, 16, 32):
        dom = _domain(package, 3, n)
        ax = [_axis(dom, d) for d in range(3)]
        f = (np.sin(2 * np.pi * ax[0]) * np.sin(2 * np.pi * ax[1])
             * np.sin(2 * np.pi * ax[2]))
        pts = np.random.RandomState(5).rand(500, 3)
        exact = (np.sin(2 * np.pi * pts[:, 0]) * np.sin(2 * np.pi * pts[:, 1])
                 * np.sin(2 * np.pi * pts[:, 2]))
        errs.append(np.abs(aux.sample_at(dom, f, pts) - exact).max())
    assert errs[1] < errs[0] / 2.5 and errs[2] < errs[1] / 2.5


def test_sample_at_takes_a_tensor():
    from marlin_tpu_torch.aux import sample_at

    dom = _domain("marlin_tpu_torch", 2, 8)
    f = np.random.RandomState(1).rand(8, 8)
    pts = np.random.RandomState(2).rand(20, 2)
    np.testing.assert_array_equal(sample_at(dom, torch.from_numpy(f), pts),
                                  sample_at(dom, f, pts))
