"""Shared by the tests: one run of a cell on the CPU at a small grid."""

from portbench import harness

#: the cells and their small grids (the medium's spheres need n >= 16)
SMALL = {"ch3d512_fused": 16, "ch3d512_default": 16, "lbm_porous256_fused": 16}
SEED = 2 ** 31 + 977  # a seed above 32 signed bits, as the driver's are


def run(name, seed=SEED, seconds=0.5, control=False):
    return harness.run_cell(name, seed, seconds, False, device="cpu",
                            sizes={"n": SMALL[name]}, control=control)
