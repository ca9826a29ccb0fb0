"""The port's lattice Boltzmann chain (marlin_tpu_torch: stencils.py,
computes/lbm.py, computes/lbm_bc.py, solvers/lbm_stream.py and the LBM half
of problem.py) against the JAX package's, on the CPU, in float64.

Tolerances:
- each compute and boundary condition on the same numpy input: 1e-12 (the
  port sums directions in index order and multiplies by reciprocals where
  the JAX package divides; a few ulps);
- whole decks, every buffer, every old slot and the residual: 1e-12, and
  1e-10 for the decks with a Zou-He inlet, as
  tests/test_pallas_lbm.py::test_fused_inlet_outlet_parity holds them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from marlin_tpu import hit as jhit
from marlin_tpu import stencils as jstencils
from marlin_tpu.executioner import run_deck as jax_run_deck
from marlin_tpu.problem import TensorProblem as JaxProblem
from marlin_tpu_torch import decks, hit, stencils
from marlin_tpu_torch.executioner import run_deck
from marlin_tpu_torch.problem import ProblemError, TensorProblem

from tests import test_pallas_lbm as tpl
from tests.test_torch_lbm_fused import (DECKS, TOL, ZOUHE_TOL, assert_state_parity,
                                        box_media as _box_media,
                                        deck as deck_text,
                                        media_file as _media_file,
                                        run_port as _run_port)


def _run_jax(text, steps=3):
    p = JaxProblem(jhit.parse(text))
    s = p.init_state()
    dt = jnp.asarray(1.0, p.domain.dtype)
    for i in range(steps):
        s = p.step(s, float(i), dt, dt, i == 0)
    return s


# -- the stencils -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["LBMD2Q9", "LBMD3Q19", "LBMD3Q27"])
def test_stencil_tables_are_the_jax_tables(name):
    ours = getattr(stencils, name)("s")
    ref = getattr(jstencils, name)("s")
    assert set(vars(ours)) == set(vars(ref))
    for attr, value in vars(ref).items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(getattr(ours, attr), value, err_msg=attr)
        else:
            assert getattr(ours, attr) == value, attr


# -- each compute and boundary condition ---------------------------------------------

_BCS_3D = """  [Boundary]
{blocks}  []
[]
[TensorSolver]"""


def _bc(name, btype, boundary, extra=""):
    return (f"    [{name}]\n      type = {btype}\n      buffer = f\n"
            f"      boundary = {boundary}\n{extra}    []\n")


def _harness_bcs(faces, zouhe_faces):
    old = "      f_old = fpc\n"
    blocks = "".join(_bc(f"bb_{b}", "LBMBounceBack", b, old) for b in faces)
    blocks += "".join(_bc(f"zg_{b}", "LBMMicroscopicZeroGradientBC", b)
                      for b in faces)
    for b in zouhe_faces:
        blocks += _bc(f"zh1_{b}", "LBMFixedFirstOrderBC", b,
                      "      f = f\n      value = 0.02\n")
        blocks += _bc(f"zh0_{b}", "LBMFixedZerothOrderBC", b,
                      "      f = f\n      value = 1.01\n")
    return blocks


def _with_bcs(deck, blocks):
    head, rest = deck.split("  [Boundary]", 1)
    return head + _BCS_3D.format(blocks=blocks) + rest.split("[TensorSolver]", 1)[1]


FACES_3D = ["left", "right", "bottom", "top", "front", "back"]

_EXTRA_BUFFERS = "".join(
    f"  [{name}]\n    type = LBMTensorBuffer\n    buffer_type = {kind}\n  []\n"
    for name, kind in (("fpc_mrt", "df"), ("fpc_mrtp", "df"), ("fpc_bgkp", "df"),
                       ("F_g", "mv"), ("F_b", "mv"), ("F_gb", "mv"), ("T", "ms")))


def _block(name, btype, lines):
    body = "".join(f"      {line}\n" for line in lines)
    return f"    [{name}]\n      type = {btype}\n{body}    []\n"


def _collision(name, btype, out, projection):
    lines = [f"buffer = {out}", "f = f", "feq = feq", "tau0 = 0.7"]
    return _block(name, btype, lines + (["projection = true"] if projection else []))


def _forces(name, out, gravity, buoyancy, direction):
    lines = [f"buffer = {out}", "rho = density", "temperature = T", "rho0 = 0.9",
             "T0 = 1.02", "gravity = 0.002", f"gravity_direction = {direction}"]
    lines += ["enable_gravity = true"] * gravity + ["enable_buoyancy = true"] * buoyancy
    return _block(name, "LBMComputeForces", lines)


_EXTRA_SOLVES = (
    _collision("x_mrt", "LBMMRTCollision", "fpc_mrt", False)
    + _collision("x_mrt_projected", "LBMMRTCollision", "fpc_mrtp", True)
    + _collision("x_bgk_projected", "LBMBGKCollision", "fpc_bgkp", True)
    + _forces("x_gravity", "F_g", True, False, 1)
    + _forces("x_buoyancy", "F_b", False, True, 0)
    + _forces("x_gravity_buoyancy", "F_gb", True, True, 1)
    + _block("x_apply", "LBMApplyForces", ["buffer = fpc_mrt", "rho = density",
                                          "forces = F_gb", "tau0 = 0.7"]))


def _with_extras(deck):
    """A harness deck with the MRT and projected collisions and the force
    computes beside its own chain (each writes a buffer of its own; the
    harness applies every compute to the same random state)."""
    deck = deck.replace("[TensorBuffers]\n", "[TensorBuffers]\n" + _EXTRA_BUFFERS, 1)
    return deck.replace("  [Solve]\n", "  [Solve]\n" + _EXTRA_SOLVES, 1)


def _harness_3d(tmp_path, stencil):
    deck = decks.MEDIA_DECK.format(backend="JNP", media_h5=_media_file(
        tmp_path, _box_media())).replace("type = LBMD3Q19", f"type = {stencil}")
    blocks = _harness_bcs(FACES_3D, ["left", "right"])
    blocks += _bc("bb_wall", "LBMBounceBack", "wall", "      f_old = fpc\n")
    return _with_extras(_with_bcs(deck, blocks))


def _harness_allface(tmp_path, stencil):
    return _with_extras(decks.ALLFACE_DECK.format(n=6, stencil=stencil, backend="JNP"))


def _harness_2d(tmp_path, stencil):
    """A D2Q9 channel (the eager chain's 2-D and D2Q9 branches, which the
    fused kernel does not take yet), with the sine inlet profile."""
    deck = decks.INLET_OUTLET_DECK.format(backend="JNP")
    deck = deck.replace("dim = 3", "dim = 2").replace("  nz = 10\n", "")
    deck = deck.replace("type = LBMD3Q19", "type = LBMD2Q9")
    deck = deck.replace("constants = '0.01 0.0 0.0'", "constants = '0.01 0.0'")
    blocks = _harness_bcs(["left", "right", "bottom", "top"],
                          ["left", "right", "bottom", "top"])
    blocks += _bc("zh1_perturbed", "LBMFixedFirstOrderBC", "left",
                  "      f = f\n      value = 0.02\n      perturb = true\n")
    return _with_extras(_with_bcs(deck, blocks))


HARNESSES = {
    "d3q19_media": (_harness_3d, "LBMD3Q19"),
    "d3q27_media": (_harness_3d, "LBMD3Q27"),
    "d3q19_allface": (_harness_allface, "LBMD3Q19"),
    "d2q9_channel": (_harness_2d, "LBMD2Q9"),
}


def _random_state(buffers, q, rng):
    """Distributions around their weights, small velocities, densities
    around 1; integer buffers (the media) as they are."""
    out = {}
    for name, ref in buffers.items():
        ref = np.asarray(ref)
        if ref.dtype.kind != "f":
            out[name] = ref
        elif ref.ndim == 4 and ref.shape[-1] == q:
            out[name] = (1.0 + 0.1 * rng.standard_normal(ref.shape)) / q
        elif ref.ndim == 4:
            out[name] = 0.02 * rng.standard_normal(ref.shape)
        else:
            out[name] = 1.0 + 0.1 * rng.standard_normal(ref.shape)
    return out


def _members(problem):
    return (list(problem.ic_computes.members) + list(problem.solve_computes)
            + list(problem.bc_computes))


@pytest.mark.parametrize("harness", list(HARNESSES))
def test_each_compute_matches_jax(harness, tmp_path):
    build, stencil = HARNESSES[harness]
    text = build(tmp_path, stencil)
    jp = JaxProblem(jhit.parse(text))
    js = jp.init_state()
    pp = TensorProblem(hit.parse(text), device="cpu")
    pp.init_state()
    q = jp.lbm_stencil().q
    rng = np.random.RandomState(7)
    inputs = _random_state(js["buffers"], q, rng)
    old = {"fpc": inputs["fpc"][None] * 1.01, "speed": inputs["speed"][None] * 0.9}
    jctx = {"t": 0.0, "old": {k: jnp.asarray(v) for k, v in old.items()},
            "n_advances": 2}
    pctx = {"t": 0.0, "old": {k: torch.from_numpy(v) for k, v in old.items()},
            "n_advances": 2}
    pmembers = {m.name: m for m in _members(pp)}
    checked = 0
    for jm in _members(jp):
        pm = pmembers[jm.name]
        assert type(pm).__name__ == type(jm).__name__
        ref = jm.apply({k: jnp.asarray(v) for k, v in inputs.items()}, jctx)
        got = pm.apply({k: torch.from_numpy(np.array(v)) for k, v in inputs.items()},
                       pctx)
        assert set(got) == set(ref), jm.name
        for k, v in ref.items():
            g = got[k].numpy()
            assert g.shape == np.shape(v), (jm.name, k)
            np.testing.assert_allclose(g, np.asarray(v), rtol=0, atol=TOL,
                                       err_msg=f"{jm.name}: {k}")
        checked += 1
    assert checked == len(pmembers)


def test_residual_is_one_before_history():
    """LBMComputeResidual reports 1 with no old state and on the first
    advance (n_advances 0), as the JAX package does."""
    text = decks.INLET_OUTLET_DECK.format(backend="JNP")
    pp = TensorProblem(hit.parse(text), device="cpu")
    s = pp.init_state()
    res = [m for m in pp.solve_computes if m.name == "residual"][0]
    assert float(res.apply(s["buffers"], {})["__residual__"]) == 1.0
    ctx = {"old": s["old"], "n_advances": 0}
    assert float(res.apply(s["buffers"], ctx)["__residual__"]) == 1.0


# -- whole decks ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["allface_d3q19", "allface_d3q27", "media",
                                  "inlet_outlet", "porous_16", "mixed_12",
                                  "thermal", "pebbles", "porous_proj",
                                  "collisionless"])
def test_deck_state_matches_jax(case, tmp_path):
    text = deck_text(case, "JNP", tmp_path)[0]
    assert_state_parity(_run_jax(text), _run_port(text), DECKS[case][2])


def test_media_obstacle_deflects_the_flow(tmp_path):
    """The wall bounce-back is active: the box turns the x flow into y."""
    text, arrays = deck_text("media", "JNP")
    s = _run_port(text, arrays=arrays)
    v = s["buffers"]["velocity"]
    assert bool(torch.isfinite(v).all()) and v[..., 1].abs().max().item() > 0


def test_lbm_early_out_matches_jax(tmp_path):
    """[Problem] tolerance stops the run once the residual falls under it
    (reference LatticeBoltzmannProblem::execute :74); the residual rides
    each step's postprocessor fetch.  Both packages stop at step 5 of 12."""
    text = decks.INLET_OUTLET_DECK.format(backend="JNP").replace(
        "num_steps = 3", "num_steps = 12").replace(
        "substeps = 6", "substeps = 3").replace(
        "lbm_backend = JNP", "lbm_backend = JNP\n  tolerance = 0.02")
    jt = jax_run_deck(jhit.parse(text), output_dir=str(tmp_path / "jax"))
    pt = run_deck(hit.parse(text), output_dir=str(tmp_path / "port"), device="cpu")
    assert jt.step_count == pt.step_count == 5
    assert pt.time == jt.time
    assert "_lbm_residual" not in pt.pp_values
    assert abs(float(pt.state["solver"]["residual"])
               - float(jt.state["solver"]["residual"])) < ZOUHE_TOL
    assert float(pt.state["solver"]["residual"]) < 0.02


# -- media files, decks ---------------------------------------------------------------


def test_media_file_route_and_arrays_route(tmp_path):
    """`file =` reads the dataset named like the file stem, relative to the
    deck's directory; `arrays=` stands in for the file; without h5py the
    file route is a named error."""
    media = _box_media()
    _media_file(tmp_path, media)
    text = decks.MEDIA_DECK.format(backend="JNP", media_h5="media.h5")
    by_file = TensorProblem(hit.parse(text), device="cpu", deck_dir=str(tmp_path))
    s1 = by_file.init_state()
    by_array = TensorProblem(hit.parse(text), device="cpu", arrays={"media": media})
    s2 = by_array.init_state()
    for s in (s1, s2):
        assert s["buffers"]["media"].dtype == torch.int64
        np.testing.assert_array_equal(s["buffers"]["media"].numpy(), media)
    assert torch.equal(by_file.lbm_solid_mask(), torch.from_numpy(media == 0))
    assert by_file.lbm_media().dtype == torch.int8


def test_media_npy_file_needs_no_h5py(tmp_path, monkeypatch):
    """A `.npy` media file is read with numpy, relative to the deck."""
    media = _box_media()
    np.save(tmp_path / "media.npy", media)
    text = decks.MEDIA_DECK.format(backend="JNP", media_h5="media.npy")
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    p = TensorProblem(hit.parse(text), device="cpu", deck_dir=str(tmp_path))
    s = p.init_state()
    np.testing.assert_array_equal(s["buffers"]["media"].numpy(), media)


def test_media_file_without_h5py_is_a_named_error(monkeypatch):
    text = decks.MEDIA_DECK.format(backend="JNP", media_h5="missing.h5")
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(ProblemError, match="needs h5py"):
        TensorProblem(hit.parse(text), device="cpu").init_state()


def test_media_code_keeps_negative_ids_apart(tmp_path):
    """Solid is media == 0 and fluid media >= 1; negative ids are neither
    (they are not masked and do not bounce)."""
    media = _box_media()
    media[0, 0, :] = -1
    text = decks.MEDIA_DECK.format(backend="JNP", media_h5="media.h5")
    p = TensorProblem(hit.parse(text), device="cpu", arrays={"media": media})
    p.init_state()
    code = p.lbm_media().numpy()
    np.testing.assert_array_equal(code, np.where(media == 0, 0, np.where(media >= 1, 1, -1)))


def test_lbm_deck_copies_are_the_originals():
    assert decks.POROUS_DECK == bench._POROUS_DECK
    assert decks.MIXED_DECK == bench._MIXED_DECK
    assert decks.ALLFACE_DECK == tpl._ALLFACE_DECK
    assert decks.MEDIA_DECK == tpl._MEDIA_DECK
    assert decks.INLET_OUTLET_DECK == tpl._INLET_OUTLET_DECK
    assert decks.THERMAL3D_DECK == bench._THERMAL3D_DECK
    keep = dict(backend="{backend}", media_h5="{media_h5}")
    assert decks.PEBBLES_DECK.format(nx=12, ny=8, nz=8, substeps=6, **keep) == \
        tpl._THERMAL_3D_DECK.format(**keep)


def _bench_porous_media(n):
    """bench.py:bench_lbm_porous's sphere-pack loop (bench.py:1128-1138)."""
    rng = np.random.RandomState(42)
    media = np.ones((n, n, n), dtype=np.int64)
    idx = np.indices((n, n, n))
    r = max(2, n // 16)
    for _ in range(max(8, (n // r) ** 3 // 24)):
        c = rng.randint(0, n, 3)
        d2 = sum(np.minimum(np.abs(idx[k] - c[k]), n - np.abs(idx[k] - c[k])) ** 2
                 for k in range(3))
        media[d2 <= r * r] = 0
    return media


@pytest.mark.parametrize("n", [4, 32])
def test_porous_media_is_the_benchmark_pack(n):
    ours = decks.porous_media(n)
    assert ours.dtype == np.int64
    np.testing.assert_array_equal(ours, _bench_porous_media(n))
