"""The plain references against marlin_tpu_torch on the CPU at 16³, on
each cell's route: every compared number of a sound run within its limit,
and far below it."""

import math

import pytest
import torch

from portbench import harness
from portbench.reference import ch_spectral, lbm_d3q19

from small import SMALL, run


@pytest.mark.parametrize("name", sorted(SMALL))
def test_program_matches_reference(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    for key, c in r["checks"].items():
        assert c["value"] < 0.2 * c["limit"], (key, c)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_every_compared_number_has_a_limit(name):
    r = run(name, seconds=0.2)
    assert set(r["checks"]) == set(harness.limits(name))


def test_ch_reference_steady_state_is_fixed():
    """A uniform field at a well of the free energy does not move."""
    k = ch_spectral.Constants(n=8, dt=1.0, substeps=10, rho_s=5.0, c_alpha=0.3,
                              c_beta=0.7, mobility=5.0, kappa=2.0)
    solver = ch_spectral.Solver(k, "cpu")
    c = torch.full((8, 8, 8), 0.3, dtype=torch.float64)
    out, mu, _ = solver.step(c, None, first=True)
    assert torch.allclose(out, c, atol=1e-14)
    assert float(mu.abs().max()) < 1e-14


def test_ch_reference_conserves_mass():
    k = ch_spectral.Constants(n=16, dt=1.0, substeps=10, rho_s=5.0, c_alpha=0.3,
                              c_beta=0.7, mobility=5.0, kappa=2.0)
    ic = ch_spectral.InitialField(c0=0.5, epsilon=0.01, delta=0.002,
                                  modes=((0.4, -0.8, 1.2, 0.3),))
    c0 = ch_spectral.initial_field(16, ic, "cpu")
    c, _ = ch_spectral.run_from_start(ch_spectral.Solver(k, "cpu"), c0, 3)
    assert math.isclose(float(c.mean()), float(c0.mean()), rel_tol=0, abs_tol=1e-13)


def test_lbm_reference_conserves_mass_and_rest():
    """Bounce-back conserves the fluid's mass; without a force, rest stays
    rest."""
    n = 16
    fluid = torch.ones((n, n, n), dtype=torch.bool)
    fluid[4:8, 4:8, 4:8] = False
    lat = lbm_d3q19.Lattice(fluid, lbm_d3q19.Constants(tau=0.8, force=(0.0, 0.0, 0.0),
                                                       substeps=5))
    f0 = lat.at_rest()
    out = lat.step(f0)
    assert torch.allclose(out["fpc"], f0, atol=1e-15)
    lat = lbm_d3q19.Lattice(fluid, lbm_d3q19.Constants(tau=0.8, force=(1e-4, 0.0, 0.0),
                                                       substeps=5))
    out = lat.step(f0)
    assert math.isclose(float(out["fpc"].sum()), float(f0.sum()), rel_tol=1e-13)
    assert float(out["velocity"][..., 0][fluid].mean()) > 0


def test_lbm_opposites():
    for q in range(lbm_d3q19.Q):
        p = lbm_d3q19.OPPOSITE[q]
        assert (lbm_d3q19.EX[p], lbm_d3q19.EY[p], lbm_d3q19.EZ[p]) == (
            -lbm_d3q19.EX[q], -lbm_d3q19.EY[q], -lbm_d3q19.EZ[q])
    assert math.isclose(sum(lbm_d3q19.WEIGHTS), 1.0)
