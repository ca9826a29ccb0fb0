"""The rest of the port's lattice Boltzmann computes against the JAX
package's, on the CPU, in float64: the two-phase chain
(LBMPhaseEquilibrium, LBMIsotropicGradient/Laplacian,
LBMComputeChemicalPotential, LBMComputeSurfaceForces), LBMDirichletBC and
LBMNeumannBC on every face and on wall and regional boundaries,
LBMSpecularReflectionBoundary on every face, and LBMTensorUnitConverter.

Tolerances: every buffer, every old slot and the residual after 3 steps
within 1e-10 (absolute; the distributions, densities and velocities are
O(1) or smaller), as tests/test_torch_lbm_fused.py holds the Zou-He decks.
Errors and the fused plan's refusals (``lbm_backend = PALLAS``): the JAX
package's type and message, word for word.  The `cuda` case holds the
card against the CPU port, float64, at 32³ and 32², within 1e-12.
"""

import numpy as np
import pytest
import torch

from marlin_tpu_torch import decks, hit
from marlin_tpu_torch import state as port_state
from marlin_tpu_torch.problem import TensorProblem

from tests.test_torch_lbm_fused import (ZOUHE_TOL, assert_state_parity, cuda,  # noqa: F401
                                        jx, media_file, run_jax, run_port)

TOL = ZOUHE_TOL
FACES = ["left", "right", "bottom", "top", "front", "back"]


def twophase(backend="JNP", n=32, substeps=5):
    return decks.TWOPHASE2D_DECK.format(n=n, substeps=substeps, backend=backend)


def region_media(n=8):
    """decks.porous_media with a block of region id 2 (fluid to the chain,
    the target of ``regional`` boundaries)."""
    media = decks.porous_media(n)
    media[n // 2:, : n // 2, 1:3] = 2
    return media


def pressure(boundary="left", bc="LBMDirichletBC", n=8, backend="JNP", media_h5="media.h5"):
    """decks.PRESSURE_DECK at n³ (its Neumann outlet on the right) with the
    condition under test, ``bc``, on ``boundary``: the Dirichlet inlet
    moved there, or a Neumann condition in its place."""
    text = decks.PRESSURE_DECK.format(n=n, substeps=3, backend=backend,
                                      media_h5=media_h5, inlet=boundary)
    if bc == "LBMNeumannBC":
        text = text.replace("type = LBMDirichletBC", "type = LBMNeumannBC").replace(
            "value = 1.01", "gradient = 0.002")
    if boundary == "regional":
        text = text.replace("boundary = regional", "boundary = regional\n      region_id = 2")
    return text


def _media_run(jx, text, media, tmp_path, steps=3):
    path = media_file(tmp_path, media)
    js = run_jax(jx, text.replace("media.h5", path), steps)
    ps = run_port(text, steps, arrays={"media": media})
    return js, ps


def test_twophase_chain_matches_jax(jx):
    """The droplet: φ = Σγ streamed with the fluid lattice, ∇φ and ∇²φ by
    the isotropic stencils, µ, the surface force into the Guo source and
    the velocity, γ_eq = w·φ.  The force moves the fluid, and φ and the
    fluid mass are conserved."""
    text = twophase()
    js, ps = run_jax(jx, text), run_port(text)
    assert_state_parity(js, ps, TOL)
    assert float(ps["buffers"]["velocity"].abs().max()) > 1e-8
    p = TensorProblem(hit.parse(text), device="cpu")
    s0 = p.init_state()
    for name in ("g", "f"):
        m0, m1 = s0["buffers"][name].sum(), ps["buffers"][name].sum()
        assert float(abs(m1 - m0)) < 1e-10 * float(m0), name


def test_isotropic_stencils_replicate_edges():
    """The 3×3 correlation pads by replicating the edge rows and columns
    (the reference's padScalarField), not by wrapping: a unit ramp along
    the first axis has half its inner slope on its first and last rows,
    and a Laplacian of ±1 there (a wrap would give ∓(n − 1)/2 on top).
    The kernels' orientation is the reference's: component 1 holds minus
    the slope along the first axis, component 0 the slope along the
    second."""
    n = 12
    p = TensorProblem(hit.parse(twophase(n=n)), device="cpu")
    grad = next(c for c in p.solve_computes if c.name == "grad_phi")
    lap = next(c for c in p.solve_computes if c.name == "laplacian_phi")
    x = torch.arange(n, dtype=torch.float64)[:, None, None].expand(n, n, 1)
    g = grad.apply({"phi": x}, {})["grad_phi"]
    l2 = lap.apply({"phi": x}, {})["laplacian_phi"][..., 0]
    np.testing.assert_allclose(g[1:-1, :, 0, 1].numpy(), -1.0, rtol=1e-12)
    np.testing.assert_allclose(g[[0, -1], :, 0, 1].numpy(), -0.5, rtol=1e-12)
    np.testing.assert_allclose(g[..., 0].numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(l2[1:-1].numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(l2[0].numpy(), 1.0, rtol=1e-12)
    np.testing.assert_allclose(l2[-1].numpy(), -1.0, rtol=1e-12)


@pytest.mark.parametrize("bc", ["LBMDirichletBC", "LBMNeumannBC"])
@pytest.mark.parametrize("boundary", FACES + ["wall", "regional"])
def test_equilibrium_bc_matches_jax(jx, bc, boundary, tmp_path):
    text = pressure(boundary, bc)
    js, ps = _media_run(jx, text, region_media(), tmp_path)
    assert_state_parity(js, ps, TOL)


def test_equilibrium_bc_masks_are_built_once(tmp_path):
    """The wall and regional masks live on the device, built at the first
    substep and reused; Neumann's face directions are tensors from build."""
    media = region_media()
    p = TensorProblem(hit.parse(pressure("wall")), device="cpu", arrays={"media": media})
    s = p.init_state()
    inlet = next(c for c in p.bc_computes if c.name == "inlet")
    assert inlet._mask is None
    for i in range(2):
        s = p.step(s, float(i), 1.0, 1.0, i == 0)
    mask = inlet._mask
    assert mask.dtype == torch.bool and mask.shape == media.shape + (1,)
    s = p.step(s, 2.0, 1.0, 1.0, False)
    assert inlet._mask is mask
    outlet = next(c for c in p.bc_computes if c.name == "outlet")
    st = p.lbm_stencil()
    assert outlet._dirs.tolist() == [int(st.op[d]) for d in st.left]


@pytest.mark.parametrize("stencil", ["LBMD3Q19", "LBMD3Q27"])
@pytest.mark.parametrize("boundary", FACES)
def test_specular_face_matches_jax(jx, stencil, boundary):
    text = decks.ALLFACE_DECK.format(n=7, stencil=stencil, backend="JNP")
    text = text.replace("type = LBMBounceBack\n      buffer = f\n      f_old = fpc\n"
                        f"      boundary = {boundary}",
                        "type = LBMSpecularReflectionBoundary\n      buffer = f\n"
                        f"      f_old = fpc\n      r = 0.3\n      boundary = {boundary}")
    assert "LBMSpecularReflectionBoundary" in text
    assert_state_parity(run_jax(jx, text), run_port(text), TOL)


def test_specular_channel_and_unit_converter_match_jax(jx):
    """decks.SPECULAR_CHANNEL_DECK: Dirichlet inlet, Neumann outlet,
    specular walls (r = 0.5) and the velocity in physical units."""
    text = decks.SPECULAR_CHANNEL_DECK.format(nx=40, ny=16, substeps=5, backend="JNP")
    js, ps = run_jax(jx, text), run_port(text)
    assert_state_parity(js, ps, TOL)
    v, vp = ps["buffers"]["velocity"], ps["buffers"]["velocity_physical"]
    assert torch.equal(vp, v * 0.05) and float(v.abs().max()) > 0


def channel(walls=True, feq=True, nx=40, ny=16, substeps=20):
    """decks.SPECULAR_CHANNEL_DECK (Dirichlet inlet 1.001, Neumann outlet,
    τ = 0.6), its specular walls kept or removed (periodic in y), and feq
    initialised to the starting equilibrium or left at zero."""
    text = decks.SPECULAR_CHANNEL_DECK.format(nx=nx, ny=ny, substeps=substeps, backend="JNP")
    if not walls:
        for b in ("bottom", "top"):
            block = (f"    [{b}]\n      type = LBMSpecularReflectionBoundary\n      buffer = f\n"
                     f"      f_old = fpc\n      r = 0.5\n      boundary = {b}\n    []\n")
            assert block in text
            text = text.replace(block, "")
    if not feq:
        block = ("    [initial_feq]\n      type = LBMEquilibrium\n      buffer = feq\n"
                 "      bulk = density\n      velocity = velocity\n    []\n")
        assert block in text
        text = text.replace(block, "")
    return text


@pytest.mark.parametrize("walls", [True, False], ids=["specular_walls", "periodic_y"])
def test_pressure_channel_stays_near_its_start(jx, walls):
    """The inlet at 1.001 drives the channel at τ = 0.6 gently, with its
    specular walls and without them: after 2 × 20 substeps both packages
    agree, the largest |u| is within twice the initial 0.01 and the density
    within [0.99, 1.01] (ROADMAP §3: the pumped flow came from a zero feq,
    not from the Neumann outlet)."""
    text = channel(walls)
    js, ps = run_jax(jx, text), run_port(text)
    assert_state_parity(js, ps, TOL)
    assert float(ps["buffers"]["velocity"].abs().max()) <= 0.02
    rho = ps["buffers"]["density"]
    assert 0.99 <= float(rho.min()) and float(rho.max()) <= 1.01


@pytest.mark.parametrize("walls", [True, False], ids=["specular_walls", "periodic_y"])
def test_zero_feq_doubles_the_boundary_columns(jx, walls):
    """The equilibrium conditions write feq_b + (f_old − feq): with feq
    still zero in the first substep, the inlet column's density becomes
    1 + 1.001 in both packages, walls or none, and the flow that follows
    leaves the gentle bounds above."""
    text = channel(walls, feq=False, substeps=1)
    js, ps = run_jax(jx, text, steps=2), run_port(text, steps=2)
    assert_state_parity(js, ps, TOL)
    np.testing.assert_allclose(ps["buffers"]["density"][0].numpy(), 2.001, rtol=1e-12)
    later = run_port(channel(walls, feq=False), steps=3)
    assert float(later["buffers"]["velocity"].abs().max()) > 0.02


def test_specular_partners_flip_the_normal():
    """Each incoming direction's partner has its normal component flipped;
    on D2Q9 every partner exists, so no fallback is taken there."""
    p = TensorProblem(hit.parse(decks.SPECULAR_CHANNEL_DECK.format(
        nx=10, ny=6, substeps=2, backend="JNP")), device="cpu")
    bottom = next(c for c in p.bc_computes if c.name == "bottom")
    st = p.lbm_stencil()
    dirs, bounce, partner = (t.tolist() for t in bottom._index)
    assert dirs == [int(d) for d in st.bottom]
    assert bounce == [int(st.op[d]) for d in dirs]
    for d, s in zip(dirs, partner):
        assert (st.ex[s], st.ey[s]) == (st.ex[d], -st.ey[d])


def _outcome(make):
    try:
        make()
        return "ran", None
    except Exception as e:  # the outcome itself is compared
        return type(e).__name__, str(e)


ERRORS = {
    "d3q19": ("LBMD2Q9", "LBMD3Q19"),
    "3d": ("dim = 2", "dim = 3\n  nz = 4"),
    "missing_tau_phi": ("      tau_phi = tau_phi\n      thickness = thickness\n    []\n  []\n"
                        "  [Solve]",
                        "      thickness = thickness\n    []\n  []\n  [Solve]"),
    "undeclared_sigma": ("sigma = sigma", "sigma = surface_tension"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_are_the_jax_errors(jx, case):
    old, new = ERRORS[case]
    text = twophase(n=8)
    if case == "3d":
        text = text.replace("LBMD2Q9", "LBMD3Q27")
    assert old in text
    text = text.replace(old, new, 1)
    ours = _outcome(lambda: run_port(text, steps=1))
    ref = _outcome(lambda: run_jax(jx, text, steps=1))
    assert ours == ref
    assert ours[0] != "ran"


REFUSED = {
    "twophase": lambda: twophase("PALLAS", n=8),
    "dirichlet": lambda: pressure("left", backend="PALLAS"),
    "neumann_wall": lambda: pressure("wall", "LBMNeumannBC", backend="PALLAS"),
    "specular": lambda: decks.SPECULAR_CHANNEL_DECK.format(nx=12, ny=6, substeps=3,
                                                           backend="PALLAS"),
    "unit_converter": lambda: decks.CHANNEL2D_DECK.format(
        nx=12, ny=6, substeps=3, backend="PALLAS").replace(
        "    [residual]", "    [convert]\n      type = LBMTensorUnitConverter\n"
        "      buffer = converted\n      tensor_buffer = velocity\n      constant = 3\n"
        "    []\n    [residual]"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_pallas_refusals_are_the_jax_message(jx, case, tmp_path):
    """On ``lbm_backend = PALLAS`` a deck with any of these computes fails
    in the fused plan with the JAX package's words; nothing falls back."""
    text = REFUSED[case]()
    media = region_media()
    path = media_file(tmp_path, media)
    ours = _outcome(lambda: run_port(text, arrays={"media": media}))
    ref = _outcome(lambda: run_jax(jx, text.replace("media.h5", path)))
    assert ours[0] == ref[0] == "FusedChainError"
    assert ours[1] == ref[1]
    assert "is not fusable" in ours[1]


@pytest.mark.cuda
def test_card_matches_cpu(cuda):
    """decks.PRESSURE_DECK at 32³ (Dirichlet inlet, Neumann outlet,
    bounce-back walls and media) and the two-phase deck at 32² on the card
    against the CPU port, float64, 3 steps: within 1e-12."""
    media = decks.porous_media(32)
    for text in (pressure("left", n=32), twophase(n=32)):
        text = text.replace("[Domain]", "[Domain]\n  floating_precision = DOUBLE")
        a = port_state.to_numpy(run_port(text, arrays={"media": media}))
        b = port_state.to_numpy(run_port(text, device=cuda, arrays={"media": media}))
        for name, ref in a["buffers"].items():
            np.testing.assert_allclose(b["buffers"][name], ref, rtol=0, atol=1e-12,
                                       err_msg=name)
