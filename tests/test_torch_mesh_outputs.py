"""The port's outputs on a mesh (per-rank XDMF, Exodus and the aux
variables through the gather to rank 0, TensorHistogram's summed counts)
against the JAX package's, on the CPU.

Ranks are spawned with torch.multiprocessing over gloo
(tests/torch_ranks.py), one spawn a world size, every rank writing into
one directory as the JAX package's one process writes its per-rank files;
the JAX package runs the same deck text in this process on the
conftest's virtual CPU devices.  Decks, in float64: decks.CH_DECK cut to
16² (2-D stand-in) and decks.CH3D_DECK at 16³ on FFT_SLAB at P = 2 and 4,
CH3D on a 2 × 2 FFT_PENCIL, decks.laplacian_rs's 2-D deck on a REAL_SPACE
cut (x at P = 2, x × y at P = 4), and an uneven slab (ny = 6 over P = 4).
Each run writes an XDMF series of its field (raw .bin or h5), Exodus with
a nodal, an elemental and an INITIAL-only aux variable, the aux
postprocessors, a histogram and CSV.

- the XMF text is identical to the JAX package's;
- each rank's frames are within 1e-10 of the JAX package's (.bin and h5);
- the uneven slab's empty rank writes no file and has no subgrid;
- NODE output at P > 1 is refused in the JAX package's words;
- Exodus times, coordinates, connectivity, fields and globals within 1e-10;
- the histogram CSVs are the JAX package's files (tests/test_torch_outputs.py's
  rule: identical text), and their counts sum to the cell count;
- the aux postprocessors' CSV columns within 1e-10.
"""

import math
import os

import h5py
import numpy as np
import pytest

from marlin_tpu_torch import decks
from marlin_tpu_torch.exodus import read_exodus

from tests import torch_ranks

TOL = 1e-10
STEPS = 2
DOUBLE = "floating_precision = DOUBLE"


def _ch2d(nx=16, ny=16):
    return (decks.CH_DECK.format(domain_extra=f"parallel_mode = FFT_SLAB\n  {DOUBLE}",
                                 solver_extra="")
            .replace("nx = 128", f"nx = {nx}").replace("ny = 128", f"ny = {ny}")
            .replace("substeps = 5", "substeps = 2"))


def _ch3d(mode):
    return decks.CH3D_DECK.format(n=16, substeps=2).replace(
        "[Domain]", f"[Domain]\n  parallel_mode = {mode}\n  {DOUBLE}")


def _laplacian():
    return decks.laplacian_rs(2, 16, domain_extra=DOUBLE)


def _aux_pps(b):
    return f"""  [{b}_aux_avg]
    type = ElementAverageValue
    variable = {b}_nodal
  []
  [{b}_aux_max]
    type = NodalExtremeValue
    variable = {b}_nodal
  []
  [{b}_aux_min]
    type = ElementExtremeValue
    variable = {b}_elem
    value_type = MIN
  []
  [{b}_aux_int]
    type = ElementIntegralVariablePostprocessor
    variable = {b}_elem
  []
"""


def with_outputs(text, b, hdf5, lo, hi, mode="CELL"):
    """``text`` with an XDMF series of ``b``, its aux variables (nodal,
    elemental, INITIAL-only elemental) and their postprocessors, a
    histogram of ``b`` on [lo, hi], Exodus and CSV."""
    text = text.replace("[Outputs]\n  csv = true\n[]\n", "")
    if "[Postprocessors]\n" in text:
        text = text.replace("[Postprocessors]\n", "[Postprocessors]\n" + _aux_pps(b), 1)
    else:
        text += "[Postprocessors]\n" + _aux_pps(b) + "[]\n"
    return text + f"""
[TensorOutputs]
  [xdmf]
    type = XDMFTensorOutput
    buffer = {b}
    enable_hdf5 = {str(hdf5).lower()}
    output_mode = {mode}
  []
[]
[AuxVariables]
  [{b}_nodal]
  []
  [{b}_elem]
    family = MONOMIAL
    order = CONSTANT
  []
  [{b}0]
    family = MONOMIAL
  []
[]
[AuxKernels]
  [{b}_nodal]
    type = ProjectTensorAux
    buffer = {b}
    variable = {b}_nodal
  []
  [{b}_elem]
    type = ProjectTensorAux
    buffer = {b}
    variable = {b}_elem
  []
  [{b}0]
    type = ProjectTensorAux
    buffer = {b}
    variable = {b}0
    execute_on = INITIAL
  []
[]
[VectorPostprocessors]
  [hist]
    type = TensorHistogram
    buffer = {b}
    min = {lo}
    max = {hi}
    bins = 7
    execute_on = 'INITIAL TIMESTEP_END'
  []
[]
[Outputs]
  exodus = true
  csv = true
[]
"""


#: name -> (deck text, mode, world, mesh shape, field)
RUNS = {
    "ch2d_slab_2": (with_outputs(_ch2d(), "c", False, 0.45, 0.55), "FFT_SLAB", 2, None, "c"),
    "ch2d_slab_4": (with_outputs(_ch2d(), "c", True, 0.45, 0.55), "FFT_SLAB", 4, None, "c"),
    "ch3d_slab_2": (with_outputs(_ch3d("FFT_SLAB"), "c", True, 0.45, 0.55), "FFT_SLAB", 2,
                    None, "c"),
    "ch3d_slab_4": (with_outputs(_ch3d("FFT_SLAB"), "c", False, 0.45, 0.55), "FFT_SLAB", 4,
                    None, "c"),
    "ch3d_pencil_4": (with_outputs(_ch3d("FFT_PENCIL"), "c", False, 0.45, 0.55),
                      "FFT_PENCIL", 4, (2, 2), "c"),
    "laplacian_rs_2": (with_outputs(_laplacian(), "u", True, -1.5, 1.5), "REAL_SPACE", 2,
                       (2,), "u"),
    "laplacian_rs_4": (with_outputs(_laplacian(), "u", False, -1.5, 1.5), "REAL_SPACE", 4,
                       (2, 2), "u"),
    # ny = 6 over P = 4: blocks of 2, 2, 2 and 0 rows
    "uneven_4": (with_outputs(_ch2d(8, 6), "c", False, 0.45, 0.55), "FFT_SLAB", 4, None, "c"),
}
NODE = with_outputs(_ch2d(), "c", False, 0.45, 0.55, mode="NODE")
NODE_WORDS = "XDMFTensorOutput currently supports only CELL output mode in parallel."


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run on its world size, one spawn a world size; the NODE deck
    at P = 2."""
    tmp = tmp_path_factory.mktemp("out_ranks")
    out = {"tmp": tmp}
    for world in (2, 4):
        names = [n for n, r in RUNS.items() if r[2] == world]
        cases = [("outputs_run", dict(text=RUNS[n][0], mode=RUNS[n][1], mesh_shape=RUNS[n][3],
                                      steps=STEPS, output_dir=str(tmp / n))) for n in names]
        if world == 2:
            cases.append(("named_error", dict(text=NODE, mode="FFT_SLAB",
                                              output_dir=str(tmp / "node"))))
        res = torch_ranks.spawn(world, cases, tmp)
        out.update(zip(names, res))
        if world == 2:
            out["node"] = res[-1]
    return out


def _jax_mesh(mode, world, shape):
    import jax

    from marlin_tpu import parallel as jpar
    from marlin_tpu.domain import ParallelMode

    kw = {} if shape is None else {"shape": shape}
    return jpar.make_mesh(getattr(ParallelMode, mode), jax.devices()[:world], **kw)


def _jax_run(text, mode, world, shape, out):
    from marlin_tpu import hit as jhit
    from marlin_tpu.executioner import run_deck as jax_run_deck

    root = jhit.parse(text)
    root.child("Executioner", create=True).set_param("num_steps", str(STEPS))
    return jax_run_deck(root, file_base="out", output_dir=str(out), deck_stem="det",
                        mesh=_jax_mesh(mode, world, shape))


@pytest.fixture(scope="module")
def jax_runs(runs):
    """The JAX package's run of every deck on the same mesh."""
    out = {}
    for name, (text, mode, world, shape, _b) in RUNS.items():
        out[name] = _jax_run(text, mode, world, shape, runs["tmp"] / f"jax_{name}")
    return out


def _dirs(runs, name):
    return runs["tmp"] / f"jax_{name}", runs["tmp"] / name


@pytest.mark.parametrize("name", list(RUNS))
def test_xmf_and_frames_match_jax(runs, jax_runs, name):
    jdir, pdir = _dirs(runs, name)
    assert (pdir / "det.xmf").read_text() == (jdir / "det.xmf").read_text()
    world = RUNS[name][2]
    files = sorted(p for p in os.listdir(jdir) if ".rank" in p)
    assert files and sorted(p for p in os.listdir(pdir) if ".rank" in p) == files
    for f in files:
        if f.endswith(".bin"):
            a, b = np.fromfile(jdir / f), np.fromfile(pdir / f)
            assert a.shape == b.shape, f
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL, err_msg=f)
        else:
            with h5py.File(jdir / f) as a, h5py.File(pdir / f) as b:
                assert sorted(a) == sorted(b) and len(a) == STEPS + 1, f
                for k in a:
                    np.testing.assert_allclose(b[k][...], a[k][...], rtol=0, atol=TOL,
                                               err_msg=f"{f}:{k}")
    ranks = {int(f.split(".rank")[1][:4]) for f in files}
    assert ranks == set(range(world)) - ({3} if name == "uneven_4" else set())


def test_empty_rank_writes_no_file_and_no_subgrid(runs, jax_runs):
    _jdir, pdir = _dirs(runs, "uneven_4")
    assert not [p for p in os.listdir(pdir) if ".rank0003" in p]
    xmf = (pdir / "det.xmf").read_text()
    assert "Rank2" in xmf and "Rank3" not in xmf
    assert xmf.count("<Grid Name=\"Rank") == 3 * (STEPS + 1)


def test_node_mode_at_p_above_1_is_refused_in_the_jax_words(runs):
    assert all(r is not None and NODE_WORDS in r for r in runs["node"]), runs["node"]
    from marlin_tpu.params import ParamError as JaxParamError

    with pytest.raises(JaxParamError, match=NODE_WORDS.replace(".", r"\.")):
        _jax_run(NODE, "FFT_SLAB", 2, None, runs["tmp"] / "jax_node")


@pytest.mark.parametrize("name", list(RUNS))
def test_exodus_matches_jax(runs, jax_runs, name):
    jdir, pdir = _dirs(runs, name)
    je, pe = read_exodus(str(jdir / "out.e")), read_exodus(str(pdir / "out.e"))
    assert len(pe["time"]) == STEPS + 1
    np.testing.assert_array_equal(pe["time"], je["time"])
    for ax in je["coords"]:
        np.testing.assert_array_equal(pe["coords"][ax], je["coords"][ax])
    np.testing.assert_array_equal(pe["connect"], je["connect"])
    for kind in ("nodal", "elem", "glo"):
        assert set(pe[kind]) == set(je[kind]), kind
        for key, vals in je[kind].items():
            np.testing.assert_allclose(pe[kind][key], vals, rtol=0, atol=TOL,
                                       err_msg=f"{kind} {key}")
    b = RUNS[name][4]
    # the INITIAL-only variable keeps its t = 0 sample
    np.testing.assert_array_equal(pe["elem"][f"{b}0"][-1], pe["elem"][f"{b}0"][0])
    # only rank 0 writes the whole grid's file
    assert sorted(p for p in os.listdir(pdir) if p.endswith(".e")) == ["out.e"]


@pytest.mark.parametrize("name", list(RUNS))
def test_histograms_and_aux_postprocessors_match_jax(runs, jax_runs, name):
    jdir, pdir = _dirs(runs, name)
    hists = sorted(p for p in os.listdir(jdir) if "_hist_" in p)
    assert hists == [f"out_hist_{i:04d}.csv" for i in range(STEPS + 1)]
    assert sorted(p for p in os.listdir(pdir) if "_hist_" in p) == hists
    for h in hists:
        assert (pdir / h).read_text() == (jdir / h).read_text(), h
        rows = (pdir / h).read_text().splitlines()[1:]
        counts = sum(float(r.split(",")[1]) for r in rows)
        assert 0 < counts <= math.prod(jax_runs[name].problem.domain.n_global)
    jrows = (jdir / "out.csv").read_text().splitlines()
    prows = (pdir / "out.csv").read_text().splitlines()
    assert prows[0] == jrows[0] and len(prows) == len(jrows) == STEPS + 2
    for jr, pr in zip(jrows[1:], prows[1:]):
        np.testing.assert_allclose([float(x) for x in pr.split(",")],
                                   [float(x) for x in jr.split(",")], rtol=0, atol=TOL)
    for r in runs[name]:
        assert r["pps"] == runs[name][0]["pps"]


def test_histogram_counts_sum_to_the_cells(runs, jax_runs):
    """A range that holds every value: the summed counts are the cell
    count, each cell counted once whatever the mesh."""
    for name in ("ch2d_slab_4", "ch3d_pencil_4", "uneven_4"):
        _jdir, pdir = _dirs(runs, name)
        rows = (pdir / "out_hist_0000.csv").read_text().splitlines()[1:]
        n = math.prod(jax_runs[name].problem.domain.n_global)
        assert sum(float(r.split(",")[1]) for r in rows) == n, name
