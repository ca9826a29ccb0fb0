"""The port's fused LBM substep (marlin_tpu_torch/lbm_fused.py, kernel 7 of
the JAX package) against marlin_tpu/pallas_lbm.py, on the CPU.

On the CPU ``lbm_fused.fused_substep`` computes its plain twin; the Pallas
kernel runs in interpret mode, as tests/test_pallas_lbm.py runs it.

Tolerances:
- the twin against the interpret-mode kernel, one substep in float64:
  1e-12;
- whole decks on ``lbm_backend = PALLAS``: 1e-12, and 1e-10 with a Zou-He
  face and on the thermal, projected and collisionless decks
  (tests/test_pallas_lbm.py's own), against JAX on PALLAS and on JNP;
- the port's PALLAS path against its own JNP path: equal, bit for bit, in
  float32 and float64 (the kernel and its twin do the eager chain's
  operations in its order);
- the 2-D twin against the interpret-mode kernel, one substep: 1e-12 in
  float64, and in float32 2e-6 of the largest magnitude (the two round in
  different orders: the JAX kernel multiplies by 1/ρ, divides by c_s² and
  evaluates the inlet's sine in float32; a few float32 ulps);
- the tree mean density against ``torch.sum``: 1e-12 relative in float64;
- rejections: the JAX package's message, word for word (one deck a
  reachable ``_reject``, the thermal ones edits of decks.THERMAL3D_DECK,
  the 2-D ones edits of decks.CHANNEL2D_DECK and of a 2-D thermal deck).
The `cuda` cases hold the CUDA kernel to its twin on the card; the JAX
package is imported inside a fixture, so they run where there is no jax
(nor h5py: the port takes the media as arrays).
"""

import ctypes
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from marlin_tpu_torch import decks, hit, perf
from marlin_tpu_torch import lbm_fused as lf
from marlin_tpu_torch import state as port_state
from marlin_tpu_torch.problem import TensorProblem

TOL = 1e-12
ZOUHE_TOL = 1e-10


@pytest.fixture
def jx():
    """The JAX package's LBM modules, Pallas in interpret mode."""
    PL = pytest.importorskip("marlin_tpu.pallas_lbm")
    import jax.numpy as jnp

    from marlin_tpu import hit as jhit
    from marlin_tpu.problem import TensorProblem as JaxProblem

    old = PL._INTERPRET
    PL._INTERPRET = True
    yield SimpleNamespace(PL=PL, jnp=jnp, hit=jhit, Problem=JaxProblem)
    PL._INTERPRET = old


def media_file(tmp_path, media, name="media"):
    import h5py

    path = tmp_path / f"{name}.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset(name, data=media)
    return str(path)


def box_media():
    """tests/test_pallas_lbm.py's box obstacle."""
    media = np.ones((8, 12, 10), dtype=np.int64)
    media[3:6, 4:8, 2:6] = 0
    return media


def run_jax(jx, text, steps=3):
    p = jx.Problem(jx.hit.parse(text))
    s = p.init_state()
    dt = jx.jnp.asarray(1.0, p.domain.dtype)
    for i in range(steps):
        s = p.step(s, float(i), dt, dt, i == 0)
    return s


def run_port(text, steps=3, device="cpu", **kw):
    p = TensorProblem(hit.parse(text), device=device, **kw)
    s = p.init_state()
    for i in range(steps):
        s = p.step(s, float(i), 1.0, 1.0, i == 0)
    return s


def assert_state_parity(js, ps, tol):
    """tests/test_pallas_lbm.py:_assert_state_parity across the packages:
    every buffer, every old slot, the residual and n_advances."""
    ps = port_state.to_numpy(ps)
    assert set(ps["buffers"]) == set(js["buffers"])
    assert set(ps["old"]) == set(js["old"])
    for group in ("buffers", "old"):
        for name, ref in js[group].items():
            got = ps[group][name]
            assert got.shape == np.shape(ref), (group, name)
            d = np.max(np.abs(got - np.asarray(ref)))
            assert d < tol, f"{group}[{name}]: maxdiff {d}"
    r1, r2 = float(js["solver"]["residual"]), float(ps["solver"]["residual"])
    assert abs(r1 - r2) < tol, f"residual {r1} vs {r2}"
    assert int(ps["n_advances"]) == int(js["n_advances"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _zeroth_order(backend):
    """decks.INLET_OUTLET_DECK as a pressure-driven channel: Zou-He density
    faces (zeroth order) on both x faces (chip_smoke.py's plan)."""
    deck = decks.INLET_OUTLET_DECK.format(backend=backend)
    deck = deck.replace("type = LBMFixedFirstOrderBC", "type = LBMFixedZerothOrderBC")
    deck = deck.replace("value = 0.01", "value = 1.001")
    return deck.replace("""      type = LBMMicroscopicZeroGradientBC
      buffer = f
      boundary = right""", """      type = LBMFixedZerothOrderBC
      buffer = f
      f = f
      value = 1.0
      boundary = right""")


def _reversed(backend):
    """The inlet on the right face, the zero-gradient outlet on the left."""
    deck = decks.INLET_OUTLET_DECK.format(backend=backend)
    deck = deck.replace("value = 0.01\n      boundary = left",
                        "value = -0.01\n      boundary = right")
    return deck.replace("LBMMicroscopicZeroGradientBC\n      buffer = f\n"
                        "      boundary = right",
                        "LBMMicroscopicZeroGradientBC\n      buffer = f\n"
                        "      boundary = left")


def _media_channel(backend, media_h5):
    """The inlet-outlet channel through binary media: solids on the faces
    Zou-He and zero-gradient write, obstacle bounce-back beside them."""
    deck = decks.INLET_OUTLET_DECK.format(backend=backend)
    deck = deck.replace("""    [inlet]""", """    [wall]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = wall
    []
    [inlet]""")
    deck = deck.replace("""  [speed]
    type = LBMTensorBuffer
    buffer_type = ms
  []
""", f"""  [speed]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [media]
    type = LBMTensorBuffer
    buffer_type = ms
    is_integer = true
    file = {media_h5}
  []
""", 1)
    return deck.replace("  substeps = 6\n", "  substeps = 6\n  binary_media = media\n")


def _channel_media():
    """Two boxes, one on the inlet face and one on the outlet face."""
    media = np.ones((12, 10, 10), dtype=np.int64)
    media[0:3, 3:6, 3:6] = 0
    media[-2:, 5:8, 2:5] = 0
    return media


def _thermal_zero_gradient(backend):
    """decks.THERMAL3D_DECK with a zero-gradient face on the thermal
    lattice in place of its cold Zou-He face."""
    return decks.THERMAL3D_DECK.format(n=6, substeps=4, backend=backend).replace(
        """    [cold_right]
      type = LBMFixedZerothOrderBC
      buffer = g
      f = g
      value = T_C
      boundary = right""", """    [cold_right]
      type = LBMMicroscopicZeroGradientBC
      buffer = g
      boundary = right""")


def karman_media_64():
    """tests/test_pallas_lbm.py:1277-1279's cylinder at 64×32."""
    x, y = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
    media = np.ones((64, 32), dtype=np.int64)
    media[(x - 16) ** 2 + (y - 16) ** 2 <= 5 ** 2] = 0
    return media


def _perturb_right_2d(backend):
    """decks.CHANNEL2D_DECK with its inlet on the right face and perturb =
    true, the outlet on the left: the sine profile exists only on the D2Q9
    left face, so both packages ignore perturb here."""
    deck = decks.CHANNEL2D_DECK.format(nx=12, ny=10, substeps=6, backend=backend)
    for old, new in (("value = 0.01\n      boundary = left",
                      "value = -0.01\n      perturb = true\n      boundary = right"),
                     ("LBMMicroscopicZeroGradientBC\n      buffer = f\n      boundary = right",
                      "LBMMicroscopicZeroGradientBC\n      buffer = f\n      boundary = left")):
        assert old in deck, old
        deck = deck.replace(old, new)
    return deck


def pebbles_media():
    """tests/test_pallas_lbm.py's Pebbles obstacle."""
    media = np.ones((12, 8, 8), dtype=np.int64)
    media[5:8, 3:6, 2:5] = 0
    return media


DECKS = {
    # name: (deck(backend, media_h5), media or None, tolerance of a whole
    # deck) — every feature group of the slice
    "porous_8": (lambda b, m: decks.POROUS_DECK.format(
        n=8, substeps=4, backend=b, media_h5=m), lambda: decks.porous_media(8), TOL),
    "mixed_8": (lambda b, m: decks.MIXED_DECK.format(n=8, substeps=4, backend=b),
                None, ZOUHE_TOL),
    "reversed": (lambda b, m: _reversed(b), None, ZOUHE_TOL),
    "allface_d3q19": (lambda b, m: decks.ALLFACE_DECK.format(
        n=9, stencil="LBMD3Q19", backend=b), None, TOL),
    "allface_d3q27": (lambda b, m: decks.ALLFACE_DECK.format(
        n=8, stencil="LBMD3Q27", backend=b), None, TOL),
    "zeroth_order": (lambda b, m: _zeroth_order(b), None, ZOUHE_TOL),
    "media": (lambda b, m: decks.MEDIA_DECK.format(backend=b, media_h5=m),
              box_media, TOL),
    "media_channel": (_media_channel, _channel_media, ZOUHE_TOL),
    "inlet_outlet": (lambda b, m: decks.INLET_OUTLET_DECK.format(backend=b),
                     None, ZOUHE_TOL),
    "porous_16": (lambda b, m: decks.POROUS_DECK.format(
        n=16, substeps=5, backend=b, media_h5=m), lambda: decks.porous_media(16), TOL),
    "mixed_12": (lambda b, m: decks.MIXED_DECK.format(n=12, substeps=5, backend=b),
                 None, ZOUHE_TOL),
    # the thermal double-distribution decks (BGK; MRT with media), the
    # projected and collisionless chains: 1e-10, the JAX package's bound for
    # its own thermal decks (tests/test_pallas_lbm.py)
    "thermal": (lambda b, m: decks.THERMAL3D_DECK.format(n=6, substeps=4, backend=b),
                None, ZOUHE_TOL),
    "thermal_zg": (lambda b, m: _thermal_zero_gradient(b), None, ZOUHE_TOL),
    "pebbles": (lambda b, m: decks.PEBBLES_DECK.format(
        nx=12, ny=8, nz=8, substeps=6, backend=b, media_h5=m), pebbles_media, ZOUHE_TOL),
    "porous_proj": (lambda b, m: decks.PROJECTED_DECK.format(
        n=8, substeps=4, backend=b, media_h5=m), lambda: decks.porous_media(8), ZOUHE_TOL),
    "collisionless": (lambda b, m: decks.COLLISIONLESS_DECK.format(backend=b), None,
                      ZOUHE_TOL),
    "allface_d3q27_mrt": (lambda b, m: decks.ALLFACE_DECK.format(
        n=8, stencil="LBMD3Q27", backend=b).replace("LBMBGKCollision", "LBMMRTCollision"),
        None, ZOUHE_TOL),
    # the 2-D (D2Q9) decks: the channel with BGK and with MRT, the Kármán
    # pattern (Smagorinsky with the projection, a perturbed inlet, the
    # cylinder) and the 2-D thermal pair
    "channel2d": (lambda b, m: decks.CHANNEL2D_DECK.format(
        nx=12, ny=10, substeps=6, backend=b), None, ZOUHE_TOL),
    "channel2d_mrt": (lambda b, m: decks.CHANNEL2D_MRT_DECK.format(
        nx=12, ny=10, substeps=6, backend=b), None, ZOUHE_TOL),
    "karman": (lambda b, m: decks.KARMAN_DECK.format(
        nx=64, ny=32, substeps=6, backend=b).replace("binary_media.h5", m),
        karman_media_64, ZOUHE_TOL),
    "thermal2d": (lambda b, m: decks.THERMAL2D_DECK.format(n=8, substeps=4, backend=b),
                  None, ZOUHE_TOL),
    # perturb = true where the reference ignores it: a D2Q9 right face, and
    # the D3Q19 left face
    "perturb_right_2d": (lambda b, m: _perturb_right_2d(b), None, ZOUHE_TOL),
    "perturb_3d": (lambda b, m: decks.INLET_OUTLET_DECK.format(backend=b).replace(
        "value = 0.01\n", "value = 0.01\n      perturb = true\n"), None, ZOUHE_TOL),
}
PLAN_CASES = ["porous_8", "mixed_8", "reversed", "allface_d3q19",
              "allface_d3q27", "zeroth_order", "media_channel", "thermal",
              "thermal_zg", "pebbles", "porous_proj", "collisionless",
              "allface_d3q27_mrt", "perturb_3d"]
PLAN_CASES_2D = ["channel2d", "channel2d_mrt", "karman", "thermal2d", "perturb_right_2d"]


def deck(case, backend, tmp_path=None):
    """(deck text, arrays): the media as an h5 file under ``tmp_path`` (for
    the JAX package), or, without it, as the port's ``arrays``."""
    make, media, _tol = DECKS[case]
    if media is None:
        return make(backend, None), None
    if tmp_path is None:
        return make(backend, "media.h5"), {"media": media()}
    return make(backend, media_file(tmp_path, media())), None


def port_plan(case, device="cpu"):
    text, arrays = deck(case, "PALLAS")
    p = TensorProblem(hit.parse(text), device=device, arrays=arrays)
    p.init_state()
    return lf.match_chain(p)


def jax_plan(jx, case, tmp_path):
    p = jx.Problem(jx.hit.parse(deck(case, "PALLAS", tmp_path)[0]))
    p.init_state()
    return jx.PL.match_chain(p)


def _same_field(name, ours, ref):
    if name in ("post_bcs", "post_bcs2"):
        keys = [f.name for f in dataclasses.fields(lf.PostBC)]
        return [[getattr(bc, k) for k in keys] for bc in ours] == \
            [[getattr(bc, k) for k in keys] for bc in ref]
    if name == "force" and ours is not None and ref is not None:
        return dataclasses.asdict(ours) == {k: getattr(ref, k) for k in
                                            dataclasses.asdict(ours)}
    return ours == ref


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_and_twin_match_pallas(jx, case, tmp_path):
    """The port's plan is the JAX package's, field for field, and one
    twin substep equals one interpret-mode kernel substep (4×5×6, float64,
    random distributions and media), incl. the corners where zero-gradient
    faces meet bounce-back, and both lattices of the thermal plans."""
    jplan, plan = jax_plan(jx, case, tmp_path), port_plan(case)
    assert (plan.fpc, plan.speed, plan.fpc2) == (jplan.fpc, jplan.speed, jplan.fpc2)
    for field in dataclasses.fields(plan.config):
        ours, ref = getattr(plan.config, field.name), getattr(jplan.config, field.name)
        assert _same_field(field.name, ours, ref), field.name
    shape = (4, 5, 6)
    cfg = dataclasses.replace(plan.config, nx=4, ny=5, nz=6)
    jcfg = dataclasses.replace(jplan.config, nx=4, ny=5, nz=6, block=4,
                               nx_global=4, ny_global=5)
    rng = np.random.RandomState(11)
    w = np.asarray(cfg.w)[:, None, None, None]
    fpc = w * (1.0 + 0.1 * rng.standard_normal((cfg.q,) + shape))
    gpc = w * (1.0 + 0.1 * rng.standard_normal((cfg.q,) + shape)) \
        if cfg.two_lattice else None
    media = jmedia = None
    if cfg.has_media:
        code = rng.choice([0, 1, 1, 1, -1], size=shape).astype(np.int8)
        media = torch.from_numpy(code)
        jmedia = jx.jnp.asarray(code.astype(np.float64))
        fpc = np.where(code == 0, 0.0, fpc)
        if gpc is not None:
            gpc = np.where(code == 0, 0.0, gpc)
    ref = jx.PL.fused_substep(jx.jnp.asarray(fpc), jmedia, jcfg,
                              gpc_qm=None if gpc is None else jx.jnp.asarray(gpc))
    got = lf.fused_substep(torch.from_numpy(fpc), media, cfg,
                           None if gpc is None else torch.from_numpy(gpc))
    assert len(got) == len(ref) == (3 if cfg.two_lattice else 2)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=TOL)
    assert lf.launches() == {"lbm_substep": 0, "lbm_density_mean": 0}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", PLAN_CASES_2D)
def test_plan_and_twin_match_pallas_2d(jx, case, dtype, tmp_path):
    """The 2-D plans: the port's plan is the JAX package's, field for field,
    and one twin substep (7×9×1: odd extents, random distributions and
    media) equals one interpret-mode single-block kernel substep on the
    squeezed (q, nx, ny) arrays, incl. the perturbed inlet, the transverse
    Zou-He rows and the Smagorinsky τ with its mean density."""
    jplan, plan = jax_plan(jx, case, tmp_path), port_plan(case)
    assert (plan.fpc, plan.speed, plan.fpc2) == (jplan.fpc, jplan.speed, jplan.fpc2)
    for field in dataclasses.fields(plan.config):
        ours, ref = getattr(plan.config, field.name), getattr(jplan.config, field.name)
        assert _same_field(field.name, ours, ref), field.name
    assert plan.config.two_d and (plan.config.smag is not None) == (case == "karman")
    nx, ny = 7, 9
    cfg = dataclasses.replace(plan.config, nx=nx, ny=ny)
    jcfg = dataclasses.replace(jplan.config, nx=nx, ny=ny, block=nx, nx_global=nx,
                               ny_global=ny)
    rng = np.random.RandomState(13)
    w = np.asarray(cfg.w)[:, None, None]
    fpc = (w * (1.0 + 0.1 * rng.standard_normal((cfg.q, nx, ny)))).astype(dtype)
    gpc = (w * (1.0 + 0.1 * rng.standard_normal((cfg.q, nx, ny)))).astype(dtype) \
        if cfg.two_lattice else None
    media = jmedia = None
    if cfg.has_media:
        code = rng.choice([0, 1, 1, 1, -1], size=(nx, ny)).astype(np.int8)
        media = torch.from_numpy(code[..., None])
        jmedia = jx.jnp.asarray(code.astype(dtype))
        fpc = np.where(code == 0, 0.0, fpc).astype(dtype)
    ref = jx.PL.fused_substep(jx.jnp.asarray(fpc), jmedia, jcfg,
                              gpc_qm=None if gpc is None else jx.jnp.asarray(gpc))
    got = lf.fused_substep(torch.from_numpy(fpc[..., None]), media, cfg,
                           None if gpc is None else torch.from_numpy(gpc[..., None]))
    assert len(got) == len(ref) == (3 if cfg.two_lattice else 2)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype and g.shape[-1] == 1
        # (NaN where both give it: random media can leave a fluid face cell
        # that copies a solid inner neighbour with no mass)
        tol = TOL if dtype == np.float64 else 2e-6 * np.nanmax(np.abs(r))
        np.testing.assert_allclose(g[..., 0].numpy(), r, rtol=0, atol=tol)
    assert lf.launches() == {"lbm_substep": 0, "lbm_density_mean": 0}


@pytest.mark.parametrize("nx,ny,nz", [(1, 1, 1), (7, 9, 1), (33, 17, 1), (5, 3, 7),
                                      (300, 301, 1)])
def test_tree_mean_is_the_mean(nx, ny, nz):
    """computes/lbm.py tree_mean (the pairwise tree the kernel's reduction
    passes reproduce) against torch.sum / n, 1e-12 relative in float64, on
    odd extents (zero padding to the next power of two)."""
    from marlin_tpu_torch.computes.lbm import tree_mean

    a = torch.from_numpy(np.random.RandomState(nx + ny).uniform(0.5, 1.5, (nx, ny, nz)))
    ref = torch.sum(a) / a.numel()
    got = tree_mean(a)
    assert got.shape == () and got.dtype == torch.float64
    assert abs(got.item() - ref.item()) <= 1e-12 * abs(ref.item())


# -- whole decks --------------------------------------------------------------------

WHOLE_CASES = ["allface_d3q19", "allface_d3q27", "media", "inlet_outlet",
               "media_channel", "porous_16", "mixed_12", "reversed", "zeroth_order",
               "thermal", "thermal_zg", "pebbles", "porous_proj", "collisionless",
               "allface_d3q27_mrt", "perturb_3d"] + PLAN_CASES_2D


@pytest.mark.parametrize("case", WHOLE_CASES)
def test_pallas_deck_matches_jax_jnp(jx, case, tmp_path):
    assert_state_parity(run_jax(jx, deck(case, "JNP", tmp_path)[0]),
                        run_port(deck(case, "PALLAS", tmp_path)[0]), DECKS[case][2])


@pytest.mark.parametrize("case", ["allface_d3q19", "mixed_8", "thermal", "pebbles",
                                  "karman", "thermal2d"])
def test_pallas_deck_matches_jax_pallas(jx, case, tmp_path):
    text = deck(case, "PALLAS", tmp_path)[0]
    assert_state_parity(run_jax(jx, text), run_port(text), DECKS[case][2])


def _bit_for_bit(case, precision, device="cpu"):
    runs = []
    for backend in ("JNP", "PALLAS"):
        text, arrays = deck(case, backend)
        text = text.replace("[Domain]",
                            f"[Domain]\n  floating_precision = {precision}")
        runs.append(run_port(text, device=device, arrays=arrays))
    a, b = runs
    assert a["n_advances"] == b["n_advances"] > 0
    for group in ("buffers", "old"):
        for name, t in a[group].items():
            assert torch.equal(t, b[group][name]), (group, name)
    assert torch.equal(a["solver"]["residual"], b["solver"]["residual"])


BIT_CASES = ["porous_16", "mixed_12", "media_channel", "thermal", "pebbles",
             "porous_proj", "collisionless"] + PLAN_CASES_2D


@pytest.mark.parametrize("precision", ["SINGLE", "DOUBLE"])
@pytest.mark.parametrize("case", BIT_CASES)
def test_pallas_is_jnp_bit_for_bit(case, precision):
    """The fused substeps compute the eager chain's operations in its
    order: every buffer equal, bit for bit, after 3 steps."""
    _bit_for_bit(case, precision)


@pytest.mark.parametrize("deck_text, final", [
    (decks.MIXED_DECK.format(n=6, substeps=5, backend="PALLAS"), True),
    (decks.THERMAL3D_DECK.format(n=6, substeps=5, backend="PALLAS"), False),
], ids=["final_form", "eager_last"])
def test_fused_loop_runs_all_but_the_last_substep(tmp_path, monkeypatch, deck_text, final):
    """None in the first MOOSE step; then on a plan with a final form
    (one lattice, its chain writing only what the kernel stores) every
    substep of a step is a fused call, the last one the final form, and on
    one without (the thermal pair) all but the last, which is the eager
    chain's.  The loop takes its substep wrapper once a step; the graph
    counts the fused substeps and which way each step's last one ran."""
    calls, finals, steppers = [], [], []
    orig = lf.substepper

    def counted(*a):
        steppers.append(1)
        step = orig(*a)

        def wrapped(*b, final=False, **kw):
            calls.append(1)
            finals.append(final)
            return step(*b, final=final, **kw)
        return wrapped

    monkeypatch.setattr(lf, "substepper", counted)
    graph = perf.PerfGraph(enabled=True)
    with graph.active():
        s = run_port(deck_text, steps=4)
    fused = 5 if final else 4
    assert len(calls) == 3 * fused
    assert sum(finals) == (3 if final else 0)
    assert len(steppers) == 3
    assert s["n_advances"] == 3 * 5 + 3
    assert s["buffers"]["fpc"].shape == (6, 6, 6, 19)
    last = "lbm_final_fused" if final else "lbm_final_eager"
    assert graph.counters == {"substeps_fused": 3 * fused, last: 3}


#: the cases whose plan has a final form: every one-lattice 3-D plan with a
#: collision (their chains write nothing the kernel does not store)
FINAL_CASES = [c for c in DECKS if c not in ("thermal", "thermal_zg", "pebbles",
                                             "collisionless") + tuple(PLAN_CASES_2D)]
MASS = ("    [mass]\n      type = LBMComputeDensity\n      buffer = mass\n      f = f\n"
        "    []\n")


def _mixed_with_mass():
    """decks.MIXED_DECK whose solve chain also writes a second density
    buffer, one the final form does not store."""
    text = decks.MIXED_DECK.format(n=6, substeps=3, backend="PALLAS")
    text = text.replace("[TensorBuffers]\n", "[TensorBuffers]\n  [mass]\n    type = "
                        "LBMTensorBuffer\n    buffer_type = ms\n  []\n", 1)
    return text.replace("    [residual]\n", MASS + "    [residual]\n", 1)


@pytest.mark.parametrize("case", list(DECKS) + ["mixed_mass"])
def test_final_form_engages_where_it_stores_every_written_buffer(case):
    """``match_chain`` decides once whether a step's last substep runs the
    kernel's final form: on an unsharded one-lattice 3-D plan with a
    collision whose boundary and solve chains write no buffer but f, feq,
    fpc, the density, the velocity and the speed (the residual writes
    none).  The thermal pairs, the collisionless chain and every 2-D plan
    keep the eager substep, and so does a deck whose chain writes one more
    buffer (a second density)."""
    if case == "mixed_mass":
        p = TensorProblem(hit.parse(_mixed_with_mass()), device="cpu")
        p.init_state()
        plan = lf.match_chain(p)
        assert lf.final_form(plan.config) and plan.final is None
        return
    plan = port_plan(case)
    assert (plan.final is not None) == (case in FINAL_CASES)
    assert lf.final_form(plan.config) == (case in FINAL_CASES)
    if plan.final is not None:
        assert plan.final == lf.FinalStores("f", "feq", "density", "velocity")


def test_a_chain_writing_more_keeps_the_eager_last_substep():
    """The second-density deck runs its last substep eagerly and still
    equals its JNP run bit for bit, the extra buffer included."""
    runs = [run_port(_mixed_with_mass().replace("PALLAS", backend), steps=3)
            for backend in ("JNP", "PALLAS")]
    for group in ("buffers", "old"):
        for name, t in runs[0][group].items():
            assert torch.equal(t, runs[1][group][name]), (group, name)
    assert torch.equal(runs[0]["solver"]["residual"], runs[1]["solver"]["residual"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", [c for c in PLAN_CASES if c in FINAL_CASES])
def test_twin_final_form_adds_the_deck_buffers(case, dtype):
    """The twin's final form (4×5×6, random distributions and media) gives
    the hot form's fpc and speed, and besides them f and feq q-major, the
    density Σf and the (nx, ny, nz, 3) velocity, zero at solids; a plan
    without a final form refuses it."""
    cfg = dataclasses.replace(port_plan(case).config, nx=4, ny=5, nz=6)
    fpc, _gpc, media = _card_inputs(cfg, dtype, "cpu", 3)
    hot = lf.fused_substep_twin(fpc, media, cfg)
    got = lf.substepper(fpc, media, cfg)(fpc, final=True)
    assert len(got) == 6
    same = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for g, r in zip(got[:2], hot):
        same(g, r)
    f, feq, rho, vel = got[2:]
    assert f.shape == feq.shape == fpc.shape and vel.shape == (4, 5, 6, 3)
    from marlin_tpu_torch.computes.lbm import _direction_sum

    same(rho, _direction_sum(f))
    if media is not None:
        solid = media == 0
        for t in (f, feq, vel.movedim(-1, 0)):
            assert not t[:, solid].any()
    thermal = dataclasses.replace(port_plan("thermal").config, nx=4, ny=5, nz=6)
    with pytest.raises(ValueError, match="final form"):
        lf.fused_substep_twin(fpc, None, thermal, fpc, final=True)


# -- rejections ----------------------------------------------------------------------

BASE = decks.INLET_OUTLET_DECK.format(backend="PALLAS").replace(
    "nx = 12", "nx = 6").replace("ny = 10", "ny = 5").replace("nz = 10", "nz = 5")
SOLVER = "[TensorSolver]\n  type = LBMStream\n  buffer = f\n  f_old = fpc\n[]\n"
INLET = ("    [inlet]\n      type = LBMFixedFirstOrderBC\n      buffer = f\n"
         "      f = f\n      value = 0.01\n      boundary = left\n    []\n")
TOP = ("    [top]\n      type = LBMBounceBack\n      buffer = f\n"
       "      f_old = fpc\n      boundary = top\n    []\n")
VELOCITY = ("    [velocity]\n      type = LBMComputeVelocity\n      buffer = velocity\n"
            "      f = f\n      rho = density\n    []\n")
DENSITY = "    [density]\n      type = LBMComputeDensity\n      buffer = density\n      f = f\n    []\n"
FEQ = ("    [feq]\n      type = LBMEquilibrium\n      buffer = feq\n      bulk = density\n"
       "      velocity = velocity\n    []\n")
COLLISION = ("    [collision]\n      type = LBMBGKCollision\n      buffer = fpc\n"
             "      f = f\n      feq = feq\n      tau0 = 0.6\n    []\n")
SPEED = ("    [speed]\n      type = LBMComputeVelocityMagnitude\n      buffer = speed\n"
         "      velocity = velocity\n    []\n")
RESIDUAL = ("    [residual]\n      type = LBMComputeResidual\n      buffer = speed\n"
            "      speed = speed\n    []\n")
BUFFERS = "[TensorBuffers]\n"
DF = "  [{0}]\n    type = LBMTensorBuffer\n    buffer_type = {1}\n  []\n"


def _edit(*pairs, base=BASE):
    """BASE with each (old, new) pair replaced once."""
    for old, new in pairs:
        assert old in base, old
        base = base.replace(old, new, 1)
    return base


def _bb_after(text):
    """BASE's top bounce-back moved after the outlet."""
    text = text.replace(TOP, "")
    return text.replace("      boundary = right\n    []\n",
                        "      boundary = right\n    []\n" + TOP)


REJECTIONS = {
    "no_stream_solver": _edit((SOLVER, "")),
    "three_buffers": _edit((SOLVER, SOLVER.replace("buffer = f\n  f_old = fpc",
                                                   "buffer = 'f feq speed'\n"
                                                   "  f_old = 'fpc fpc fpc'"))),
    "same_buffer_twice": _edit((SOLVER, SOLVER.replace("buffer = f\n  f_old = fpc",
                                                       "buffer = 'f f'\n"
                                                       "  f_old = 'fpc fpc'"))),
    "bc_not_streamed": _edit((TOP, TOP.replace("buffer = f", "buffer = feq"))),
    "zouhe_other_buffer": _edit((INLET, INLET.replace("f = f", "f = fpc"))),
    "zouhe_front": _edit((INLET, INLET.replace("boundary = left", "boundary = front"))),
    "zouhe_top": _edit((INLET, INLET.replace("boundary = left", "boundary = top"))),
    "zero_gradient_wall": _edit(("buffer = f\n      boundary = right",
                                 "buffer = f\n      boundary = wall")),
    "unfusable_bc": _edit((TOP, "    [odd]\n      type = ParsedCompute\n"
                                "      buffer = f\n      expression = 'f'\n"
                                "      inputs = f\n    []\n" + TOP)),
    "bounce_back_after_zouhe": _bb_after(BASE),
    "bounce_back_other_pair": _edit((TOP, TOP.replace("f_old = fpc", "f_old = feq"))),
    "wall_without_media": _edit((TOP, TOP.replace("boundary = top", "boundary = wall"))),
    "bounce_back_regional": _edit((TOP, TOP.replace("boundary = top",
                                                    "boundary = regional"))),
    "exclude_corners": _edit((TOP, TOP.replace("boundary = top",
                                               "boundary = top\n"
                                               "      exclude_corners_x = true"))),
    "unfusable_solve": _edit((RESIDUAL, RESIDUAL + "    [odd]\n      type = ParsedCompute\n"
                                        "      buffer = odd\n      expression = '1'\n"
                                        "    []\n")),
    "two_velocities": _edit((VELOCITY, VELOCITY + VELOCITY.replace(
        "[velocity]\n      type = LBMComputeVelocity\n      buffer = velocity",
        "[velocity2]\n      type = LBMComputeVelocity\n      buffer = vel2")),
        (BUFFERS, BUFFERS + DF.format("vel2", "mv"))),
    "no_density": _edit((DENSITY, "")),
    "no_velocity": _edit((VELOCITY, "")),
    "velocity_of_other": _edit((VELOCITY, VELOCITY.replace("f = f", "f = fpc2")),
                               (BUFFERS, BUFFERS + DF.format("fpc2", "df"))),
    "enable_forces": _edit((VELOCITY, VELOCITY.replace("rho = density",
                                                       "rho = density\n"
                                                       "      enable_forces = true")),
                           (BUFFERS, BUFFERS + DF.format("forces", "mv"))),
    "equilibrium_without_collision": _edit((COLLISION, "")),
    "collisionless_other_old": _edit((COLLISION, ""), (FEQ, "")),
    "no_equilibrium": _edit((FEQ, "")),
    "equilibrium_other_velocity": _edit(
        (FEQ, FEQ.replace("velocity = velocity", "velocity = vel2")),
        (BUFFERS, BUFFERS + DF.format("vel2", "mv"))),
    "collision_other_feq": _edit((COLLISION, COLLISION.replace("feq = feq",
                                                               "feq = fpc"))),
    "collision_writes_other": _edit(
        (COLLISION, COLLISION.replace("buffer = fpc", "buffer = fpc2")),
        (BUFFERS, BUFFERS + DF.format("fpc2", "df"))),
    "speed_other_velocity": _edit(
        (SPEED, SPEED.replace("velocity = velocity", "velocity = vel2")),
        (BUFFERS, BUFFERS + DF.format("vel2", "mv"))),
    "residual_of_density": _edit((RESIDUAL, RESIDUAL.replace("speed = speed",
                                                             "speed = density"))),
    "two_lattice_no_density": _edit(
        (SOLVER, SOLVER.replace("buffer = f\n  f_old = fpc",
                                "buffer = 'f g'\n  f_old = 'fpc gpc'")),
        (BUFFERS, BUFFERS + DF.format("g", "df") + DF.format("gpc", "df"))),
    "forces_without_enable_forces": _edit(
        (RESIDUAL, RESIDUAL + "    [forces]\n      type = LBMComputeForces\n"
                              "      buffer = forces\n    []\n"),
        (BUFFERS, BUFFERS + DF.format("forces", "mv"))),
}

# the thermal deck (two lattices, buoyancy, the Guo source) and its edits
THERMAL = decks.THERMAL3D_DECK.format(n=6, substeps=3, backend="PALLAS")
T_VELOCITY = """      forces = F
      enable_forces = true
"""
T_FORCES = """    [Compute_forces]
      type = LBMComputeForces
      buffer = F
      rho0 = 'rho0'
      temperature = T
      T0 = T_0
      enable_buoyancy = true
      gravity = g
      gravity_direction = 0
    []
"""
T_APPLY = """    [Apply_forces]
      type = LBMApplyForces
      buffer = fpc
      velocity = velocity
      rho = density
      forces = F
      tau0 = tau_f
    []
"""
T_GEQ = """    [Eq_temperature]
      type = LBMEquilibrium
      buffer = geq
      bulk = T
      velocity = velocity
    []
"""
T_GCOLL = """    [Collision_temperature]
      type = LBMBGKCollision
      buffer = gpc
      f = g
      feq = geq
      tau0 = tau_T
    []
"""
T_FCOLL = """    [Collision_fluid]
      type = LBMBGKCollision
      buffer = fpc
      f = f
      feq = feq
      tau0 = tau_f
    []
"""
T_FEQ = """    [Eq_fluid]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
"""
T_BUFFERS = "[TensorBuffers]\n"
T_HOT = """    [hot_left]
      type = LBMFixedZerothOrderBC
      buffer = g
      f = g
      value = T_H
      boundary = left
    []
"""
T_PLATE = """    [plate_left]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = left
    []
"""


def _thermal(*pairs):
    return _edit(*pairs, base=THERMAL)


THERMAL_REJECTIONS = {
    "velocity_other_forces": _thermal((T_VELOCITY, T_VELOCITY.replace("forces = F",
                                                                      "forces = F2")),
                                      (T_BUFFERS, T_BUFFERS + DF.format("F2", "mv"))),
    "velocity_forces_without_compute": _thermal((T_FORCES, ""), (T_APPLY, "")),
    "buoyancy_one_lattice": _edit(
        (RESIDUAL, RESIDUAL + T_FORCES.replace("F\n", "forces\n").replace(
            "temperature = T", "temperature = density").replace("rho0 = 'rho0'",
                                                              "rho0 = 1.0").replace(
            "T0 = T_0", "T0 = 1.0").replace("gravity = g", "gravity = 0.001")),
        (VELOCITY, VELOCITY.replace("rho = density", "rho = density\n"
                                    "      enable_forces = true")),
        (BUFFERS, BUFFERS + DF.format("forces", "mv"))),
    "buoyancy_other_temperature": _thermal(
        (T_FORCES, T_FORCES.replace("temperature = T", "temperature = density"))),
    "gravity_other_density": _thermal(
        (T_FORCES, T_FORCES.replace("enable_buoyancy = true",
                                    "enable_buoyancy = true\n      enable_gravity = true\n"
                                    "      rho = T"))),
    "gravity_direction_3": _thermal(
        (T_FORCES, T_FORCES.replace("gravity_direction = 0", "gravity_direction = 3"))),
    "apply_other_buffer": _thermal((T_APPLY, T_APPLY.replace("buffer = fpc",
                                                             "buffer = gpc"))),
    "apply_other_density": _thermal((T_APPLY, T_APPLY.replace("rho = density",
                                                              "rho = T"))),
    "apply_without_forces": _edit(
        (RESIDUAL, RESIDUAL + T_APPLY.replace("forces = F", "forces = forces").replace(
            "tau0 = tau_f", "tau0 = 0.6")),
        (BUFFERS, BUFFERS + DF.format("forces", "mv"))),
    "two_forces": _thermal((T_FORCES, T_FORCES + T_FORCES.replace(
        "[Compute_forces]", "[Compute_forces2]").replace("buffer = F", "buffer = F2")),
        (T_BUFFERS, T_BUFFERS + DF.format("F2", "mv"))),
    "two_lattices_no_collision": _thermal((T_FCOLL, ""), (T_FEQ, ""), (T_GCOLL, ""),
                                          (T_GEQ, ""), (T_APPLY, "")),
    "second_lattice_no_collision": _thermal((T_GCOLL, "")),
    "thermal_equilibrium_other_velocity": _thermal(
        (T_GEQ, T_GEQ.replace("velocity = velocity", "velocity = v2")),
        (T_BUFFERS, T_BUFFERS + DF.format("v2", "mv"))),
    "thermal_collision_other_feq": _thermal((T_GCOLL, T_GCOLL.replace("feq = geq",
                                                                      "feq = gpc"))),
    "thermal_collision_writes_other": _thermal(
        (T_GCOLL, T_GCOLL.replace("buffer = gpc", "buffer = g2")),
        (T_BUFFERS, T_BUFFERS + DF.format("g2", "df"))),
    "bounce_back_after_zouhe_on_g": _thermal(
        (T_HOT, T_HOT + T_PLATE.replace("[plate_left]", "[g_plate]").replace(
            "buffer = f\n      f_old = fpc", "buffer = g\n      f_old = gpc"))),
    "bounce_back_g_other_pair": _thermal(
        (T_HOT, T_PLATE.replace("[plate_left]", "[g_plate]").replace(
            "buffer = f\n      f_old = fpc", "buffer = g\n      f_old = fpc") + T_HOT)),
    "residual_of_velocity_on_thermal": _thermal(
        (T_APPLY, T_APPLY + "    [residual]\n      type = LBMComputeResidual\n"
                            "      buffer = density\n      speed = density\n    []\n")),
}
REJECTIONS.update(THERMAL_REJECTIONS)

# the 2-D chains and the Smagorinsky collision: what the JAX package refuses
CHANNEL2D = decks.CHANNEL2D_DECK.format(nx=6, ny=5, substeps=3, backend="PALLAS")
C2_OUTLET = ("    [outlet]\n      type = LBMMicroscopicZeroGradientBC\n      buffer = f\n"
             "      boundary = right\n    []\n")
C2_BOTTOM = ("    [bottom]\n      type = LBMBounceBack\n      buffer = f\n"
             "      f_old = fpc\n      boundary = bottom\n    []\n")
THERMAL2D = decks.THERMAL2D_DECK.format(n=6, substeps=3, backend="PALLAS")
REJECTIONS.update({
    "smagorinsky_3d": _edit((COLLISION, COLLISION.replace("LBMBGKCollision",
                                                          "LBMSmagorinskyCollision"))),
    "smagorinsky_mrt": _edit((COLLISION, COLLISION.replace(
        "LBMBGKCollision", "LBMSmagorinskyMRTCollision"))),
    "smagorinsky_mrt_2d": _edit((COLLISION,
                                 COLLISION.replace("LBMBGKCollision",
                                                   "LBMSmagorinskyMRTCollision")),
                                base=CHANNEL2D),
    "zero_gradient_front_2d": _edit((C2_OUTLET, C2_OUTLET.replace("boundary = right",
                                                                  "boundary = front")),
                                    base=CHANNEL2D),
    "bounce_back_back_2d": _edit((C2_BOTTOM, C2_BOTTOM.replace("boundary = bottom",
                                                               "boundary = back")),
                                 base=CHANNEL2D),
    "gravity_direction_2_in_2d": _edit(
        (T_FORCES, T_FORCES.replace("gravity_direction = 0", "gravity_direction = 2")),
        base=THERMAL2D),
    "smagorinsky_second_lattice_2d": _edit(
        (T_GCOLL, T_GCOLL.replace("LBMBGKCollision", "LBMSmagorinskyCollision")),
        base=THERMAL2D),
})


def _jax_message(jx, text):
    p = jx.Problem(jx.hit.parse(text))
    s = p.init_state()
    dt = jx.jnp.asarray(1.0, p.domain.dtype)
    with pytest.raises(jx.PL.FusedChainError) as e:
        # the JAX package traces the fused branch on its first step
        for i in range(2):
            s = p.step(s, float(i), dt, dt, i == 0)
    return str(e.value)


def _port_message(text):
    p = TensorProblem(hit.parse(text), device="cpu")
    s = p.init_state()
    s = p.step(s, 0.0, 1.0, 1.0, True)  # the first MOOSE step runs no substeps
    with pytest.raises(lf.FusedChainError) as e:
        p.step(s, 1.0, 1.0, 1.0, False)
    return str(e.value)


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_rejection_is_the_jax_message(jx, case):
    text = REJECTIONS[case]
    assert _port_message(text) == _jax_message(jx, text)


NOT_PORTED = {
    # feature: a deck that an earlier slice of the port refused by name; each
    # now has the JAX package's own outcome
    "2-D": _edit(("dim = 3", "dim = 2"), ("  nz = 5\n", ""),
                 ("type = LBMD3Q19", "type = LBMD2Q9"),
                 ("constants = '0.01 0.0 0.0'", "constants = '0.01 0.0'"),
                 ("    [front]", "    [x_front]"), ("boundary = front", "boundary = top"),
                 ("    [back]", "    [x_back]"), ("boundary = back", "boundary = bottom")),
    "D2Q9 stencil": _edit(("type = LBMD3Q19", "type = LBMD2Q9")),
}


def _outcome(run):
    """("ran", state) or (error type name, message) of three steps."""
    try:
        return "ran", run()
    except Exception as e:  # the outcome itself is what is compared
        return type(e).__name__, str(e)


@pytest.mark.parametrize("feature", list(NOT_PORTED))
def test_unported_feature_is_a_named_error(jx, feature):
    """The chains an earlier slice refused by name now have the JAX
    package's outcome on lbm_backend = PALLAS: the 2-D D2Q9 channel fuses
    and its whole state equals JAX's (1e-10); the D2Q9 stencil on a 3-D
    deck with front and back faces fails in both packages with the same
    error and message (D2Q9 has no front set).  Neither falls back."""
    text = NOT_PORTED[feature]
    ours = _outcome(lambda: run_port(text))
    ref = _outcome(lambda: run_jax(jx, text))
    assert ours[0] == ref[0], (ours[0], ref[0])
    if ours[0] == "ran":
        assert_state_parity(ref[1], ours[1], ZOUHE_TOL)
        assert int(ours[1]["n_advances"]) > 0
    else:
        assert ours[1] == ref[1]


@pytest.mark.parametrize("edit,error,match", [
    ((COLLISION, COLLISION.replace("LBMBGKCollision", "LBMSmagorinskyMRTCollision")),
     lf.FusedChainError, "solve compute 'collision' (LBMSmagorinskyMRTCollision) is not "
                         "fusable"),
    ((COLLISION, COLLISION.replace("LBMBGKCollision", "LBMSmagorinskyCollision")),
     lf.FusedChainError, "Smagorinsky collisions fuse on 2-D decks only"),
    ((RESIDUAL, RESIDUAL + "    [surface]\n      type = LBMComputeSurfaceForces\n"
                           "      buffer = forces\n      chemical_potential = density\n"
                           "      grad_phi = velocity\n    []\n"),
     lf.FusedChainError, "lbm_backend = PALLAS: solve compute 'surface' "
                         "(LBMComputeSurfaceForces) is not fusable (use the default "
                         "JNP backend)"),
    ((RESIDUAL, RESIDUAL + "    [convert]\n      type = LBMTensorUnitConverter\n"
                           "      buffer = converted\n      tensor_buffer = velocity\n"
                           "      constant = 2\n    []\n"),
     lf.FusedChainError, "lbm_backend = PALLAS: solve compute 'convert' "
                         "(LBMTensorUnitConverter) is not fusable (use the default "
                         "JNP backend)"),
    # REAL_SPACE runs on a mesh (tests/test_torch_lbm_sharded.py); without
    # one the PALLAS step refuses it in the JAX package's words
    (("[Domain]", "[Domain]\n  parallel_mode = REAL_SPACE"), lf.FusedChainError,
     "lbm_backend = PALLAS: REAL_SPACE requires a 1-D (x) or 2-D (x×y) mesh"),
    ((TOP, TOP.replace("LBMBounceBack", "LBMDirichletBC").replace(
        "f_old = fpc\n", "f_old = fpc\n      feq = feq\n      rho = density\n"
                         "      velocity = velocity\n      value = 1.0\n")),
     lf.FusedChainError, "lbm_backend = PALLAS: boundary compute 'top' (LBMDirichletBC) "
                         "is not fusable (use the default JNP backend)"),
], ids=["smagorinsky_mrt", "smagorinsky", "surface_forces", "unit_converter",
        "sharded", "dirichlet"])
def test_unported_compute_fails_at_build(edit, error, match):
    """A REAL_SPACE deck without a mesh builds, and its PALLAS step refuses
    it by name, as the JAX package does.  The Smagorinsky collisions, the surface forces, the
    unit converter and the Dirichlet condition are ported: they build, and
    this 3-D deck's PALLAS step refuses them with the JAX package's words
    (``test_rejection_is_the_jax_message`` holds the Smagorinsky messages
    against the JAX package's, tests/test_torch_lbm_phase_bc.py the
    others)."""
    text = _edit(edit)
    if error is lf.FusedChainError:
        assert match in _port_message(text)
        return
    with pytest.raises(error, match=match):
        TensorProblem(hit.parse(text), device="cpu")


# -- the kernel's wrapper --------------------------------------------------------------


def test_wrapper_checks_its_inputs():
    cfg = dataclasses.replace(port_plan("porous_8").config, nx=4, ny=5, nz=6)
    fpc = torch.zeros((19, 4, 5, 6), dtype=torch.float64)
    media = torch.ones((4, 5, 6), dtype=torch.int8)
    with pytest.raises(ValueError, match="shape"):
        lf.fused_substep(fpc[:, :3], media, cfg)
    with pytest.raises(TypeError, match="dtype"):
        lf.fused_substep(fpc.to(torch.int32), media, cfg)
    with pytest.raises(ValueError, match="media"):
        lf.fused_substep(fpc, None, cfg)
    with pytest.raises(TypeError, match="int8"):
        lf.fused_substep(fpc, media.to(torch.int64), cfg)
    thermal = dataclasses.replace(port_plan("thermal").config, nx=4, ny=5, nz=6)
    with pytest.raises(ValueError, match="gpc"):
        lf.fused_substep(fpc, None, thermal)
    with pytest.raises(TypeError, match="gpc"):
        lf.fused_substep(fpc, None, thermal, fpc.to(torch.float32))


@pytest.mark.parametrize("case", ["mixed_8", "zeroth_order", "media_channel",
                                  "thermal_zg", "pebbles", "porous_proj",
                                  "collisionless"])
def test_plan_packs_for_the_kernel(case):
    """The kernel's plan struct: each lattice's faces in deck order (-1 for
    the obstacle slot), each Zou-He face's sums and rows as direction masks,
    the branch flags, and the coefficient tables in double and rounded to
    float."""
    cfg = port_plan(case).config
    p = lf.pack(cfg)
    q = cfg.q
    # no brick walk: the flat kernel
    assert (p.brick.by, p.brick.stages, p.brick.threads, p.brick.smem) == (0, 0, 0, 0)
    big = dataclasses.replace(cfg, nx=64, ny=64, nz=64)
    walk = lf.brick_plan(big, torch.float32)
    b = lf.pack(big, walk).brick
    assert (b.by, b.stages, b.threads, b.smem) == (walk.by, walk.stages, walk.threads,
                                                   walk.smem)
    assert (p.nx, p.ny, p.nz) == (cfg.nx, cfg.ny, cfg.nz)
    assert (p.two_lattice, p.collide) == (cfg.two_lattice, cfg.collide)
    assert p.speed == {"none": 0, "umag": 1, "t": 2}[cfg.speed_kind]
    assert list(p.mrt) == [cfg.msm is not None, cfg.msm2 is not None]
    assert list(p.proj) == [cfg.proj, cfg.proj2]
    assert list(p.d.inv_tau) == [1.0 / cfg.tau, 1.0 / cfg.tau2]
    for lat, faces, post_bcs in ((p.lat[0], cfg.faces, cfg.post_bcs),
                                 (p.lat[1], cfg.faces2, cfg.post_bcs2)):
        assert (lat.n_faces, lat.n_post) == (len(faces), len(post_bcs))
        for i, (axis, side, dirs) in enumerate(faces):
            assert (lat.face_axis[i], lat.face_side[i]) == (axis, side)
            assert lat.face_dirs[i] == sum(1 << d for d in dirs)
        for i, bc in enumerate(post_bcs):
            post = lat.post[i]
            assert post.kind == (bc.kind == "zg")
            assert post.sum1 == sum(1 << d for d in bc.sum1)
            assert post.rows == sum(1 << r[0] for r in bc.rows)
            for d, _src, cm, *_ in bc.rows:
                assert post.cm[d] == cm
    for lat, msm in enumerate((cfg.msm, cfg.msm2)):
        if msm is not None:
            flat = np.asarray(msm).reshape(-1)
            base = lat * lf.MAX_Q * lf.MAX_Q
            np.testing.assert_array_equal(p.d.msm[base:base + q * q], flat)
            np.testing.assert_array_equal(p.f.msm[base:base + q * q],
                                          flat.astype(np.float32))
    fc = cfg.force
    assert (p.force, p.guo) == (fc is not None, fc is not None and bool(fc.apply_tau))
    if p.guo:
        from marlin_tpu_torch.computes.lbm import guo_prefactors

        assert list(p.d.guo[:q]) == guo_prefactors(cfg.w, fc.apply_tau)
        assert (p.d.g_rho0, p.d.t0) == (fc.g * fc.rho0, fc.T0)


# -- the brick walk of 3-D plans ---------------------------------------------------------

_CONFIGS = {}


def plan_config(case):
    if case not in _CONFIGS:
        _CONFIGS[case] = port_plan(case).config
    return _CONFIGS[case]


BRICK_EXTENTS = [(9, 9, 9), (33, 17, 20), (64, 64, 64), (256, 256, 256)]
DTYPES = [torch.float32, torch.float64]


def _wrap(i, d, n):
    """csrc/lbm_substep.cuh ``wrap``: (i + d) mod n for d in -1..1."""
    v = i + d
    return np.where(v < 0, v + n, np.where(v >= n, v - n, v))


def _bricks(cfg, walk):
    """csrc/lbm_substep.cuh ``brick_at`` of every brick: (x, y0, rows)."""
    nyb = -(-cfg.ny // walk.by)
    b = np.arange(cfg.nx * nyb)
    y0 = (b % nyb) * walk.by
    return b // nyb, y0, np.minimum(walk.by, cfg.ny - y0)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("extent", BRICK_EXTENTS, ids=lambda e: "x".join(map(str, e)))
@pytest.mark.parametrize("case", PLAN_CASES)
def test_brick_walk_covers_every_cell_once(case, extent, dtype):
    """A mirror of the brick kernel's walk: the persistent blocks (at any
    grid) take every brick once, and the bricks' cells (row j = i / nz,
    z = i mod nz of each brick's rows × nz) are every cell once."""
    cfg = dataclasses.replace(plan_config(case), nx=extent[0], ny=extent[1], nz=extent[2])
    walk = lf.brick_plan(cfg, dtype)
    if walk is None:
        # the flat kernel runs: the rule is held by test_brick_plan_fits_or_is_none
        assert extent == (9, 9, 9) or (cfg.has_media and cfg.nz % 16)
        return
    x, y0, rows = _bricks(cfg, walk)
    bricks = len(x)
    for grid in (1, 7, 264, bricks):
        grid = min(grid, bricks)
        taken = np.concatenate([np.arange(blk, bricks, grid) for blk in range(grid)])
        assert np.array_equal(np.sort(taken), np.arange(bricks))
    seen = np.zeros((cfg.nx, cfg.ny), np.int64)
    for j in range(walk.by):
        live = j < rows
        np.add.at(seen, (x[live], y0[live] + j), 1)
    assert (seen == 1).all()
    for r in set(rows.tolist()):
        i = np.arange(r * cfg.nz)
        jz = np.stack([i // cfg.nz, i - i // cfg.nz * cfg.nz], 1)
        assert len({tuple(v) for v in jz.tolist()}) == r * cfg.nz
        assert jz[:, 0].max() == r - 1 and jz[:, 1].max() == cfg.nz - 1


@pytest.mark.parametrize("extent", [(33, 17, 20), (40, 24, 36), (64, 64, 64)],
                         ids=lambda e: "x".join(map(str, e)))
@pytest.mark.parametrize("case", ["mixed_8", "porous_8", "thermal", "pebbles",
                                  "allface_d3q27"])
def test_brick_pull_sources_wrap(case, extent):
    """A mirror of the brick's index maps: the stage row of direction q at
    brick row j comes from plane (x - e_x) mod nx, row (y0 + j - e_y) mod
    ny (brick_fetch), the cell at z reads it at Around(z).v[1 - e_z]
    (brick_stream), so each direction's pull source is ((x - e_x) mod nx,
    (y - e_y) mod ny, (z - e_z) mod nz), wrapped rows and planes included;
    the media byte read for the obstacle test (Stage::m) comes from the
    same cell, and the cell's own media byte from (x, y, z)."""
    cfg = dataclasses.replace(plan_config(case), nx=extent[0], ny=extent[1], nz=extent[2])
    walk = lf.brick_plan(cfg, torch.float32)
    if walk is None:
        assert cfg.has_media and cfg.nz % 16
        return
    nx, ny, nz, by = cfg.nx, cfg.ny, cfg.nz, walk.by
    x, y0, rows = _bricks(cfg, walk)
    z = np.arange(nz)
    zs = np.stack([_wrap(z, -1, nz), z, _wrap(z, 1, nz)])  # Around(z).v
    # media rows of the stage: [dx][jj] from plane x + dx - 1, row y0 + jj - 1
    media_x = [_wrap(x, dx - 1, nx) for dx in range(3)]
    media_y = [(y0 + jj - 1 + ny) % ny for jj in range(by + 2)]
    wrapped = 0
    for j in range(by):
        live = j < rows
        xl, yl = x[live], y0[live] + j
        for q, (ex, ey, ez) in enumerate(cfg.e):
            sx = _wrap(xl, -ex, nx)            # the stage row's plane
            sy = _wrap(yl, -ey, ny)            # and row
            sz = zs[1 - ez]                    # the cell's read in the row
            assert np.array_equal(sx, (xl - ex) % nx)
            assert np.array_equal(sy, (yl - ey) % ny)
            assert np.array_equal(sz, (z - ez) % nz)
            wrapped += int(((xl - ex) % nx != xl - ex).sum() + ((yl - ey) % ny != yl - ey).sum())
            # Stage::m(-e_x, j, -e_y, z): media row [1 - e_x][j + 1 - e_y]
            assert np.array_equal(media_x[1 - ex][live], (xl - ex) % nx)
            assert np.array_equal(media_y[j + 1 - ey][live], (yl - ey) % ny)
        assert np.array_equal(media_x[1][live], xl)
        assert np.array_equal(media_y[j + 1][live], yl)
    assert wrapped > 0  # the bricks at x = 0 and y = 0 pull from the far side


FIT_CASES = ([(case, e) for case in PLAN_CASES
              for e in BRICK_EXTENTS + [(40, 24, 36), (4, 4, 1024)]]
             + [(case, (33, 17, 1)) for case in PLAN_CASES_2D])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case,extent", FIT_CASES,
                         ids=[f"{c}-{'x'.join(map(str, e))}" for c, e in FIT_CASES])
def test_brick_plan_fits_or_is_none(case, extent, dtype):
    """``brick_plan`` gives None exactly where the flat kernel must run (a
    2-D plan, rows of the distribution or of the media that are not a
    multiple of 16 bytes, or one stage of one row that does not fit 227
    KB), and otherwise a walk whose stages fit 227 KB, with csrc's
    layout, at least one and at most ny rows, the plan class's stages
    where they fit, and whole warps of threads, no more than the brick has
    cells."""
    cfg = dataclasses.replace(plan_config(case), nx=extent[0], ny=extent[1], nz=extent[2])
    item = torch.empty((), dtype=dtype).element_size()
    walk = lf.brick_plan(cfg, dtype)
    flat = (cfg.nz == 1 or (cfg.nz * item) % 16 != 0 or (cfg.has_media and cfg.nz % 16 != 0)
            or lf.brick_layout(cfg, item, 1, 1) > lf.SMEM_BLOCK)
    assert (walk is None) == flat
    if walk is None:
        return
    lattices = 2 if cfg.two_lattice else 1
    stage = -(-(lattices * cfg.q * walk.by * cfg.nz * item + (
        3 * (walk.by + 2) * cfg.nz if cfg.has_media else 0)) // 16) * 16
    mrt = cfg.msm is not None or (cfg.two_lattice and cfg.msm2 is not None)
    msm = lattices * cfg.q * (-(-cfg.q * item // 16) * 16) if mrt else 0
    assert walk.smem == walk.stages * stage + 16 * walk.stages + msm
    assert walk.smem == lf.brick_layout(cfg, item, walk.by, walk.stages) <= lf.SMEM_BLOCK
    assert 1 <= walk.by <= cfg.ny
    # the plan class's stages, fewer only where they do not fit a block
    want = (1 + mrt) if cfg.two_lattice else (2 if cfg.q == 27 else 3)
    assert walk.stages <= want
    if walk.stages < want:
        assert (walk.stages + 1) * (stage + 16) + msm > lf.SMEM_BLOCK
    # a producer warp and whole consumer warps, no more than the brick's cells
    assert walk.threads % 32 == 0 and 64 <= walk.threads <= lf.brick_threads(cfg)
    assert walk.threads - 32 <= -(-walk.by * cfg.nz // 32) * 32
    # the most rows within the stage budget
    if walk.by < cfg.ny:
        assert (walk.by + 1) * lattices * cfg.q * cfg.nz * item > lf.STAGE_BYTES


# -- the walks of a block of a REAL_SPACE mesh -------------------------------------------

SPLITS = [(1, 1), (2, 1), (4, 1), (2, 2)]


@pytest.mark.parametrize("split", SPLITS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", PLAN_CASES + PLAN_CASES_2D)
def test_block_walk_and_pack(case, split):
    """A block of a mesh (``shard_plan`` of 64³, or of 64×64 on 2-D plans)
    takes the brick walk of the block on one-lattice 3-D plans (the halo
    brick), and the flat kernel (None) on two-lattice and 2-D blocks.  The
    packed plan carries the walk and the halo fields together; ``pack``
    refuses a plane walk on any block and a brick walk on a two-lattice
    block."""
    base = plan_config(case)
    extent = (64, 64, 1) if base.two_d else (64, 64, 64)
    cfg = dataclasses.replace(base, nx=extent[0], ny=extent[1], nz=extent[2])
    block, offs = lf.shard_plan(cfg, split, (split[0] - 1, split[1] - 1))
    for dtype in DTYPES:
        walk = lf.walk_plan(block, dtype, H100_SMS)
        if block.two_lattice or block.two_d:
            assert walk is None
        else:
            assert isinstance(walk, lf.BrickPlan) and walk == lf.brick_plan(block, dtype)
            p = lf.pack(block, walk, offs)
            assert (p.brick.by, p.brick.stages, p.brick.threads, p.brick.smem) == (
                walk.by, walk.stages, walk.threads, walk.smem)
            assert (p.halo.on, p.halo.shard_y, p.halo.xoff, p.halo.yoff) == (
                1, int(split[1] > 1), offs[0], offs[1])
            assert (p.halo.gnx, p.halo.gny, p.halo.stride) == (64, 64, block.ring)
            assert block.ring % block.nz == 0
    p = lf.pack(block, None, offs)
    assert p.halo.on == 1 and p.brick.by == 0
    with pytest.raises(lf.FusedChainError, match="no plane walk"):
        lf.pack(block, lf.PlanePlan(threads=lf.PLANE_THREADS, grid=1), offs)
    if block.two_lattice and not block.two_d:
        with pytest.raises(lf.FusedChainError, match="with one lattice, the brick walk"):
            lf.pack(block, lf.brick_plan(block, torch.float32), offs)


def test_block_brick_needs_ring_rows_at_multiples_of_nz():
    """``brick_plan`` admits a block only where each ring row starts at a
    multiple of nz (the ring's stride is one), as the bulk copies from the
    ring need; a ring that is not is refused, not copied from."""
    cfg = dataclasses.replace(plan_config("mixed_8"), nx=64, ny=64, nz=64)
    block, _offs = lf.shard_plan(cfg, (2, 2), (0, 0))
    assert lf.brick_plan(block, torch.float32) is not None

    class Odd(type(block)):
        @property
        def ring(self):
            return super().ring + 1

    odd = Odd(**{f.name: getattr(block, f.name) for f in dataclasses.fields(block)})
    assert lf.brick_plan(odd, torch.float32) is None


# -- the plane kernel of 2-D Smagorinsky plans -------------------------------------------

PLANE_EXTENTS = [(33, 17), (1000, 333), (800, 200), (4096, 2048)]
H100_SMS = 132  # the card the chooser's shapes are checked for


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("extent", PLANE_EXTENTS, ids=lambda e: "x".join(map(str, e)))
@pytest.mark.parametrize("case", PLAN_CASES_2D)
def test_plane_walk_covers_every_cell_once(case, extent, dtype):
    """A mirror of the 2-D walk: the plane kernel's thread t (t = block ·
    threads + lane, of grid · threads) takes cells t, t + grid·threads,
    ..., each (x, y) = (i / ny, i mod ny) at flattened index x·ny + y, so
    every cell once; its first cell, held in registers across the mean, is
    min(cells, grid · threads) cells in all, and at 800×200 in float32
    every cell on an H100 (its resident threads outnumber them).  A plan
    without the Smagorinsky mean takes the flat kernel, one thread a
    cell."""
    cfg = dataclasses.replace(plan_config(case), nx=extent[0], ny=extent[1])
    walk = lf.plane_plan(cfg, dtype, H100_SMS)
    cells = cfg.nx * cfg.ny
    i = np.arange(cells)
    if cfg.smag is None:
        assert walk is None and lf.walk_plan(cfg, dtype, H100_SMS) is None
        held = cells  # the flat kernel: a thread a cell
    else:
        step = walk.grid * walk.threads
        # thread i mod step takes cell i as its (i / step)-th: the threads'
        # first cells are 0 .. min(cells, step) - 1, each once
        firsts = i[i // step == 0]
        assert np.array_equal(firsts % step, np.arange(min(cells, step)))
        held = len(firsts)
        assert held == min(cells, step)
    x, y = i // cfg.ny, i % cfg.ny
    seen = np.zeros((cfg.nx, cfg.ny), np.int64)
    np.add.at(seen, (x, y), 1)
    assert (seen == 1).all() and np.array_equal(x * cfg.ny + y, i)
    if extent == (800, 200) and dtype == torch.float32:
        assert held == cells


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("extent", PLANE_EXTENTS, ids=lambda e: "x".join(map(str, e)))
@pytest.mark.parametrize("case", PLAN_CASES_2D)
def test_plane_pull_sources_wrap(case, extent, dtype):
    """A mirror of the flat map's pull (csrc/lbm_substep.cuh stream_cell on
    a 2-D plan, in both kernels that run it): direction q of cell (x, y)
    reads flattened index Around(x).v[1 - e_x]·ny + Around(y).v[1 - e_y],
    which is ((x - e_x) mod nx, (y - e_y) mod ny), wrapped in x and in y;
    the obstacle test reads the media byte at the same index, and the
    element offset q·nx·ny + index stays within 32-bit indices."""
    cfg = dataclasses.replace(plan_config(case), nx=extent[0], ny=extent[1])
    nx, ny = cfg.nx, cfg.ny
    item = torch.empty((), dtype=dtype).element_size()
    assert (cfg.q * nx * ny - 1) < 2 ** 31 and cfg.q * nx * ny * item > 0
    # every y of the rows at both x ends (where x wraps) and one between
    rows = np.unique([0, 1, nx // 2, nx - 2, nx - 1])
    x, y = np.meshgrid(rows, np.arange(ny), indexing="ij")
    xs = np.stack([_wrap(x, -1, nx), x, _wrap(x, 1, nx)])  # Around(x).v
    ys = np.stack([_wrap(y, -1, ny), y, _wrap(y, 1, ny)])
    wrapped = 0
    for ex, ey, _ez in cfg.e:
        src = xs[1 - ex] * ny + ys[1 - ey]
        assert np.array_equal(src, ((x - ex) % nx) * ny + (y - ey) % ny)
        wrapped += int(((x - ex) % nx != x - ex).sum() + ((y - ey) % ny != y - ey).sum())
    assert wrapped > 0


PLANE_FIT = PLANE_EXTENTS + [(1, 1), (7, 9), (500, 500)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("extent", PLANE_FIT, ids=lambda e: "x".join(map(str, e)))
@pytest.mark.parametrize("case", PLAN_CASES_2D + ["mixed_8"])
def test_plane_plan_fits_or_is_none(case, extent, dtype):
    """``plane_plan`` gives the plane kernel's launch to 2-D Smagorinsky
    plans only (None elsewhere: the flat kernel, or on 3-D plans
    ``brick_plan``'s walk): a block of PLANE_THREADS for each as many
    cells, at most ``plane_blocks`` an SM of the card's (an H100's 132
    here), so that every block of the cooperative launch is resident.
    Kármán at its shipped 800×200 (media rows of 200 bytes) in float32
    takes 625 blocks, a thread a cell."""
    base = plan_config(case)
    nz = 1 if base.two_d else 8
    cfg = dataclasses.replace(base, nx=extent[0], ny=extent[1], nz=nz)
    item = torch.empty((), dtype=dtype).element_size()
    walk = lf.plane_plan(cfg, dtype, H100_SMS)
    if not cfg.two_d or cfg.smag is None:
        assert walk is None
        if cfg.two_d:
            assert lf.walk_plan(cfg, dtype, H100_SMS) is None
        return
    blocks = lf.plane_blocks(cfg, item)
    assert blocks == (5 if item == 4 and not cfg.two_lattice else 2)
    cells = cfg.nx * cfg.ny
    assert walk.threads == lf.PLANE_THREADS == 256
    assert walk.grid == min(-(-cells // 256), H100_SMS * blocks) >= 1
    assert lf.walk_plan(cfg, dtype, H100_SMS) == walk
    assert lf.plane_plan(cfg, dtype, sms=2).grid == min(-(-cells // 256), 2 * blocks)
    if extent == (800, 200) and item == 4:
        assert walk.grid == 625 and walk.grid * walk.threads == cells


@pytest.mark.parametrize("case", PLAN_CASES_2D)
def test_plane_plan_packs(case):
    """The packed plan of each walk (``LbmBrick``): the plane kernel's
    threads and grid (no brick rows), zeros for the flat kernel, and a 3-D
    brick walk with no grid; the ctypes mirror's layout."""
    cfg = dataclasses.replace(plan_config(case), nx=800, ny=200)
    walk = lf.walk_plan(cfg, torch.float32, H100_SMS)
    b = lf.pack(cfg, walk).brick
    if cfg.smag is not None:
        assert (b.by, b.stages, b.threads, b.smem, b.grid) == (0, 0, 256, 0, walk.grid)
    else:
        assert walk is None and (b.by, b.stages, b.threads, b.smem, b.grid) == (0, 0, 0, 0, 0)
    assert lf._Brick.grid.offset == 16 and ctypes.sizeof(lf._Brick) == 20
    big = dataclasses.replace(plan_config("mixed_8"), nx=64, ny=64, nz=64)
    b3 = lf.pack(big, lf.walk_plan(big, torch.float32, H100_SMS)).brick
    assert b3.by > 0 and b3.grid == 0


def _pairs(v):
    """Rows of v summed in adjacent pairs, level by level (a perfect tree
    a row)."""
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def _tree_of(v):
    """csrc/lbm_substep.cu ``tree_of``: m values zero-padded to 256 runs of
    a power of two, each run as a binary counter carries (a perfect tree),
    then the 256 run sums in adjacent pairs."""
    m = v.numel()
    m2 = 1 << (m - 1).bit_length()
    run = m2 // 256 if m2 > 256 else 1
    return _pairs(_pairs(torch.cat([v, v.new_zeros(256 * run - m)]).reshape(256, run)))


def _chunk_mean(rho):
    """A mirror of the plane kernel's mean in torch ops: each aligned chunk
    of 256 cells summed in adjacent pairs (the block's warps, then its
    eight warp sums); above MEAN_FINAL chunk sums, their aligned runs of
    256 summed the same way; then ``_tree_of`` the sums, times 1/n."""
    n = rho.numel()
    c = lf.MEAN_CHUNK

    def chunks(v):
        m = -(-v.numel() // c)
        return _pairs(torch.cat([v, v.new_zeros(m * c - v.numel())]).reshape(m, c))

    sums = chunks(rho)
    if sums.numel() > lf.MEAN_FINAL:
        sums = chunks(sums)
    return _tree_of(sums) * (1.0 / n)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("nx,ny", PLANE_EXTENTS + [(1, 1), (7, 9), (257, 1), (300, 301),
                                                   (129, 512), (1025, 512)])
def test_chunk_mean_is_tree_mean(nx, ny, dtype):
    """The plane kernel's order of the Smagorinsky mean equals ``tree_mean``
    (the eager chain's and the twin's) bit for bit: every chunk and every
    run is an aligned power-of-two subtree, and zeros added are exact
    (odd extents, one chunk, 257 chunks, runs of two to eight, a second
    level of 9 and of 128 sums)."""
    from marlin_tpu_torch.computes.lbm import tree_mean

    rho = torch.from_numpy(np.random.RandomState(nx * 7 + ny).uniform(
        0.5, 1.5, (nx, ny, 1))).to(dtype)
    assert torch.equal(_chunk_mean(rho.reshape(-1)), tree_mean(rho))


# -- on the card -------------------------------------------------------------------------


CARD_EXTENTS = [(33, 17, 20), (40, 24, 36), (64, 64, 64)]
CARD_EXTENTS_2D = [(33, 17, 1), (800, 200, 1), (1000, 333, 1)]


def _card_inputs(cfg, dtype, device, seed):
    """A random distribution (and media code) at the plan's extent, as the
    card tests draw them."""
    shape = (cfg.nx, cfg.ny, cfg.nz)
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.tensor(cfg.w, dtype=dtype, device=device)[:, None, None, None]

    def distribution():
        return w * (1.0 + 0.1 * torch.randn((cfg.q,) + shape, generator=gen,
                                            device=device, dtype=dtype))

    fpc = distribution()
    gpc = distribution() if cfg.two_lattice else None
    media = None
    if cfg.has_media:
        media = (torch.rand(shape, generator=gen, device=device) > 0.2).to(torch.int8)
        fpc = torch.where(media == 0, 0.0, fpc).contiguous()
        if gpc is not None:
            gpc = torch.where(media == 0, 0.0, gpc).contiguous()
    return fpc, gpc, media


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", PLAN_CASES + PLAN_CASES_2D)
def test_kernel_matches_twin_on_card(cuda, case, dtype):
    """The CUDA kernel against its twin on the card, at 33×17×20, 40×24×36
    and 64³ (extents whose rows, bricks and wrapped source rows straddle
    the brick kernel's edges; the brick kernel runs where ``brick_plan``
    gives a walk, the flat one elsewhere) and for 2-D plans at 33×17,
    800×200 and 1000×333 (the flat kernel, and the plane kernel on
    Smagorinsky plans): the same operations in the same order, so equal
    bit for bit (NaN where
    both give it: random media can leave a fluid face cell that copies a
    solid inner neighbour with no mass).  One launch a substep; a
    Smagorinsky plan computes its mean density inside it, and the mean it
    writes equals the twin's.  A plan with a final form runs it too, on
    the walk the plan takes (the brick at 64³) and on the flat kernel, one
    launch each: its six outputs (fpc, speed, f, feq, density, velocity)
    equal the twin's final form bit for bit."""
    base = port_plan(case).config
    for shape in CARD_EXTENTS_2D if base.two_d else CARD_EXTENTS:
        cfg = dataclasses.replace(base, nx=shape[0], ny=shape[1], nz=shape[2])
        fpc, gpc, media = _card_inputs(cfg, dtype, cuda, 5)
        before = lf.launches()
        got = lf.fused_substep(fpc, media, cfg, gpc)
        torch.cuda.synchronize()
        smag = int(cfg.smag is not None)
        assert lf.launches() == {"lbm_substep": before["lbm_substep"] + 1,
                                 "lbm_density_mean": before["lbm_density_mean"] + smag}
        ref = lf.fused_substep_twin(fpc, media, cfg, gpc)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)
        if lf.final_form(cfg):
            if shape == (64, 64, 64):
                assert lf.brick_plan(cfg, dtype) is not None
            ref = lf.fused_substep_twin(fpc, media, cfg, final=True)
            _plan, avec = lf._kernel_args(fpc, media, cfg, None, "test")
            for step in (lf.substepper(fpc, media, cfg),
                         lf.plan_stepper(fpc, media, cfg, None, lf.pack(cfg), avec)):
                before = lf.launches()["lbm_substep"]
                got = step(fpc, final=True)
                torch.cuda.synchronize()
                assert lf.launches()["lbm_substep"] == before + 1
                assert len(got) == len(ref) == 6
                for g, r in zip(got, ref):
                    torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)
        if smag:
            mean = torch.full((), float("nan"), dtype=dtype, device=cuda)
            again = lf.substepper(fpc, media, cfg, gpc)(fpc, gpc, mean)
            torch.cuda.synchronize()
            torch.testing.assert_close(mean, lf.density_mean_twin(fpc, media, cfg), rtol=0,
                                       atol=0)
            for g, r in zip(again, ref):
                torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_brick_matches_flat_on_card(cuda, case, dtype):
    """At 64³ every 3-D plan has a brick walk; the brick kernel gives the
    flat kernel's bits on it (and on the other walks the probe times)."""
    cfg = dataclasses.replace(port_plan(case).config, nx=64, ny=64, nz=64)
    fpc, gpc, media = _card_inputs(cfg, dtype, cuda, 7)
    _plan, avec = lf._kernel_args(fpc, media, cfg, gpc, "test")
    ref = lf.plan_stepper(fpc, media, cfg, gpc, lf.pack(cfg), avec)(fpc, gpc)
    walks = [lf.brick_plan(cfg, dtype), lf.brick_plan(cfg, dtype, stages=2),
             lf.brick_plan(cfg, dtype, stage_bytes=lf.STAGE_BYTES // 4, threads=96)]
    assert all(w is not None for w in walks)
    for walk in walks:
        got = lf.plan_stepper(fpc, media, cfg, gpc, lf.pack(cfg, walk), avec)(fpc, gpc)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["porous_8", "mixed_8", "allface_d3q27", "allface_d3q27_mrt",
                                  "zeroth_order", "perturb_3d", "thermal"])
def test_halo_blocks_match_unsharded_on_card(cuda, case, dtype):
    """Blocks cut from one 64³ field at every split, their halos sliced from
    the neighbours (``block_halo``), each run on the walk ``walk_plan``
    gives it (the halo brick on one-lattice plans) and on the flat kernel
    (``pack(b, None, offs)``): put together, each equals the unsharded
    kernel bit for bit."""
    import itertools

    cfg = dataclasses.replace(port_plan(case).config, nx=64, ny=64, nz=64)
    fpc, gpc, media = _card_inputs(cfg, dtype, cuda, 11)
    ref = lf.fused_substep(fpc, media, cfg, gpc)
    for split in SPLITS:
        outs = {}
        for ij in itertools.product(range(split[0]), range(split[1])):
            b, offs = lf.shard_plan(cfg, split, ij)
            fb, fr = lf.block_halo(fpc, b, offs, 1)
            gb, gr = lf.block_halo(gpc, b, offs, 1) if gpc is not None else (None, None)
            mb, mr = lf.block_halo(media, b, offs, 0) if media is not None else (None, None)
            walk = lf.walk_plan(b, dtype, H100_SMS)
            assert (walk is None) == cfg.two_lattice
            _plan, avec = lf._kernel_args(fb, mb, b, gb, "test", offs)
            flat = lf.plan_stepper(fb, mb, b, gb, lf.pack(b, None, offs), avec)
            outs[ij] = (lf.fused_substep(fb, mb, b, gb, rings=(fr, gr, mr), offsets=offs),
                        flat(fb, gb, rings=(fr, gr, mr)))
        for form in range(2):
            for k in range(len(ref)):
                got = torch.cat([torch.cat([outs[(i, j)][form][k] for j in range(split[1])],
                                           dim=-2) for i in range(split[0])], dim=-3)
                torch.testing.assert_close(got, ref[k], rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("extent", [(33, 17), (800, 200), (1000, 333), (1025, 512)],
                         ids=lambda e: "x".join(map(str, e)))
def test_plane_kernel_matches_flat_on_card(cuda, extent, dtype):
    """The plane kernel (Kármán's Smagorinsky plan) on its own grid, on 37
    blocks (most cells streamed again after the mean) and on one, gives
    the flat kernel's bits, the flat kernel reading the twin's mean; the
    mean it writes equals the twin's on every grid (at 1025×512, 2050
    chunk sums, behind the second barrier)."""
    cfg = dataclasses.replace(port_plan("karman").config, nx=extent[0], ny=extent[1])
    fpc, gpc, media = _card_inputs(cfg, dtype, cuda, 7)
    _plan, avec = lf._kernel_args(fpc, media, cfg, gpc, "test")
    twin_mean = lf.density_mean_twin(fpc, media, cfg)
    ref = lf.plan_stepper(fpc, media, cfg, gpc, lf.pack(cfg), avec)(fpc, gpc, twin_mean)
    chosen = lf.plane_plan(cfg, dtype, torch.cuda.get_device_properties(cuda).multi_processor_count)
    for walk in (chosen, dataclasses.replace(chosen, grid=min(37, chosen.grid)),
                 dataclasses.replace(chosen, grid=1)):
        mean = torch.full((), float("nan"), dtype=dtype, device=cuda)
        got = lf.plan_stepper(fpc, media, cfg, gpc, lf.pack(cfg, walk), avec)(fpc, gpc, mean)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(mean, twin_mean, rtol=0, atol=0)


@pytest.mark.cuda
def test_graph_replay_never_runs_a_stale_plan(cuda):
    """The plan sits in constant memory, copied only when it changes on a
    live stream.  A substep captured into a CUDA graph carries its own
    copy, and after a capture every launch copies: a replay that rewrites
    the plan between two launches of another plan leaves both right.
    Kármán's plane plan is captured; the channel's flat plan runs before
    and after its replay; each equals its twin bit for bit."""
    a = dataclasses.replace(port_plan("karman").config, nx=64, ny=32)
    b = dataclasses.replace(port_plan("channel2d").config, nx=64, ny=32)
    fa, _ga, ma = _card_inputs(a, torch.float32, cuda, 3)
    fb, _gb, mb = _card_inputs(b, torch.float32, cuda, 4)
    ref_a = lf.fused_substep_twin(fa, ma, a)
    ref_b = lf.fused_substep_twin(fb, mb, b)
    step_a, step_b = lf.substepper(fa, ma, a), lf.substepper(fb, mb, b)
    step_a(fa), step_b(fb)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step_a(fa)
    runs = [(step_b(fb), ref_b)]
    graph.replay()
    runs += [(step_b(fb), ref_b), (captured, ref_a), (step_a(fa), ref_a)]
    torch.cuda.synchronize()
    for got, ref in runs:
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BIT_CASES)
def test_pallas_is_jnp_bit_for_bit_on_card(cuda, case):
    """On the card too, the kernel path equals the eager chain bit for bit
    in float32 (the kernel is built without fused multiply-adds)."""
    _bit_for_bit(case, "SINGLE", device=cuda)
