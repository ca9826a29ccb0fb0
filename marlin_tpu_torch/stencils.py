"""Lattice Boltzmann stencils: D2Q9, D3Q19, D3Q27.

A copy of marlin_tpu/stencils.py (the JAX package's module imports no jax,
but the port imports nothing of the JAX package); the tables are the same
and tests/test_torch_lbm.py holds them equal.

Constants transcribed from the reference stencil tables
(reference: src/stencils/LBMD2Q9.C:22-88, LBMD3Q19.C:14-110,
LBMD3Q27.C:16-150; base fields include/stencils/
LatticeBoltzmannStencilBase.h:21-64): velocity sets, weights, opposite
indices, MRT transform M (inverse computed), relaxation matrix S, per-face
unknown-direction index sets, kinematic-viscosity relaxation indices.

All data is host-side numpy; computes move what they use to the device once.
"""

from __future__ import annotations

import numpy as np

from .registry import stencils


class Stencil:
    def __init__(self, name, params=None, problem=None):
        self.name = name
        self._build()
        self.M_inv = np.linalg.inv(self.M)
        # derived faces via opposite indices (reference D3Q19.C:100-106)
        if not hasattr(self, "right"):
            self.right = self.op[self.left]
        if not hasattr(self, "top"):
            self.top = self.op[self.bottom]
        if hasattr(self, "front") and not hasattr(self, "back"):
            self.back = self.op[self.front]
        # constant tables take the deck's floating precision (reference
        # stencils build with MooseTensor::floatTensorOptions()); without
        # this, f64 numpy tables silently promote a SINGLE-precision LBM
        # chain to f64
        if problem is not None:
            dtype = np.dtype(str(problem.domain.dtype).replace("torch.", ""))
            for attr, value in vars(self).items():
                if isinstance(value, np.ndarray) and value.dtype.kind == "f":
                    setattr(self, attr, value.astype(dtype))

    def _build(self):
        raise NotImplementedError


@stencils.register("LBMD2Q9")
class LBMD2Q9(Stencil):
    def _build(self):
        self.q = 9
        self.ex = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1])
        self.ey = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1])
        self.ez = np.zeros(9, dtype=int)
        self.weights = np.array(
            [4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, dtype=np.float64
        )
        self.op = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6])
        self.M = np.array(
            [
                [1, 1, 1, 1, 1, 1, 1, 1, 1],
                [-4, -1, -1, -1, -1, 2, 2, 2, 2],
                [4, -2, -2, -2, -2, 1, 1, 1, 1],
                [0, 1, 0, -1, 0, 1, -1, -1, 1],
                [0, -2, 0, 2, 0, 1, -1, -1, 1],
                [0, 0, 1, 0, -1, 1, 1, -1, -1],
                [0, 0, -2, 0, 2, 1, 1, -1, -1],
                [0, 1, -1, 1, -1, 0, 0, 0, 0],
                [0, 0, 0, 0, 0, 1, -1, 1, -1],
            ],
            dtype=np.float64,
        )
        self.S = np.diag(
            [1 / 1.0, 1 / 1.1, 1 / 1.2, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
        )
        self.id_kinematic_visc = np.array([7, 8])
        self.left = np.array([1, 5, 8])
        self.bottom = np.array([2, 5, 6])
        self.reorder_indices = np.array([6, 2, 5, 3, 0, 1, 7, 4, 8])
        self.neutral_x = np.array([0, 2, 4])  # directions with ex == 0
        self.neutral_y = np.array([0, 1, 3])


@stencils.register("LBMD3Q19")
class LBMD3Q19(Stencil):
    def _build(self):
        self.q = 19
        self.ex = np.array(
            [0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, 1, -1, -1, 1, 1, -1, -1]
        )
        self.ey = np.array(
            [0, 0, 0, 1, -1, 0, 0, 1, 1, -1, -1, 0, 0, 0, 0, 1, -1, 1, -1]
        )
        self.ez = np.array(
            [0, 1, -1, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1, -1, 0, 0, 0, 0]
        )
        self.weights = np.array(
            [1 / 3]
            + [1 / 18] * 6
            + [1 / 36] * 12,
            dtype=np.float64,
        )
        self.op = np.array(
            [0, 2, 1, 4, 3, 6, 5, 10, 9, 8, 7, 14, 13, 12, 11, 18, 17, 16, 15]
        )
        self.M = np.array(
            [
                [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
                [-30, -11, -11, -11, -11, -11, -11, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8],
                [12, -4, -4, -4, -4, -4, -4, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
                [0, 1, -1, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1, -1, 0, 0, 0, 0],
                [0, -4, 4, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1, -1, 0, 0, 0, 0],
                [0, 0, 0, 1, -1, 0, 0, 1, 1, -1, -1, 0, 0, 0, 0, 1, -1, 1, -1],
                [0, 0, 0, -4, 4, 0, 0, 1, 1, -1, -1, 0, 0, 0, 0, 1, -1, 1, -1],
                [0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, 1, -1, -1, 1, 1, -1, -1],
                [0, 0, 0, 0, 0, -4, 4, 0, 0, 0, 0, 1, 1, -1, -1, 1, 1, -1, -1],
                [0, 2, 2, -1, -1, -1, -1, 1, 1, 1, 1, 1, 1, 1, 1, -2, -2, -2, -2],
                [0, -4, -4, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, -2, -2, -2, -2],
                [0, 0, 0, 1, 1, -1, -1, 1, 1, 1, 1, -1, -1, -1, -1, 0, 0, 0, 0],
                [0, 0, 0, -2, -2, 2, 2, 1, 1, 1, 1, -1, -1, -1, -1, 0, 0, 0, 0],
                [0, 0, 0, 0, 0, 0, 0, 1, -1, -1, 1, 0, 0, 0, 0, 0, 0, 0, 0],
                [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, -1, -1, 1],
                [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, -1, -1, 1, 0, 0, 0, 0],
                [0, 0, 0, 0, 0, 0, 0, 1, -1, 1, -1, -1, 1, -1, 1, 0, 0, 0, 0],
                [0, 0, 0, 0, 0, 0, 0, -1, -1, 1, 1, 0, 0, 0, 0, 1, -1, 1, -1],
                [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, -1, -1, -1, -1, 1, 1],
            ],
            dtype=np.float64,
        )
        self.S = np.diag(
            [
                1 / 1.0, 1 / 1.19, 1 / 1.4, 1 / 1.4, 1.0, 1 / 1.0, 1.0,
                1 / 1.0, 1.0, 1.0, 1 / 1.4, 1.0, 1 / 1.4, 1.0, 1.0, 1.0,
                1 / 1.98, 1 / 1.98, 1 / 1.98,
            ]
        )
        self.id_kinematic_visc = np.array([9, 11, 13, 14, 15])
        self.left = np.array([5, 11, 12, 15, 16])
        self.bottom = np.array([3, 7, 8, 15, 17])
        self.front = np.array([1, 7, 9, 11, 13])
        self.neutral_x = np.array([0, 1, 2, 3, 4, 7, 8, 9, 10])


@stencils.register("LBMD3Q27")
class LBMD3Q27(Stencil):
    def _build(self):
        self.q = 27
        self.ex = np.array(
            [0, 1, -1, 0, 0, 0, 0, 1, 1, -1, -1, 1, 1, -1, -1, 0, 0, 0, 0,
             1, 1, 1, 1, -1, -1, -1, -1]
        )
        self.ey = np.array(
            [0, 0, 0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 0, 0, 0, 1, 1, -1, -1,
             1, -1, -1, 1, 1, -1, -1, 1]
        )
        self.ez = np.array(
            [0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1, -1,
             1, 1, -1, -1, 1, 1, -1, -1]
        )
        self.weights = np.array(
            [8 / 27]
            + [2 / 27] * 6
            + [1 / 54] * 12
            + [1 / 216] * 8,
            dtype=np.float64,
        )
        self.op = np.array(
            [0, 2, 1, 4, 3, 6, 5, 10, 9, 8, 7, 14, 13, 12, 11, 18, 17, 16, 15,
             25, 26, 23, 24, 21, 22, 19, 20]
        )
        # NOTE: this M is the REFERENCE's table verbatim (LBMD3Q27.C:50-78).
        # Its columns follow a rest-LAST direction ordering while ex/ey/ez
        # are rest-first (M[1]@w = 0.29, not 0 as for D2Q9/D3Q19) — an
        # upstream inconsistency kept for parity; no shipped deck pairs
        # D3Q27 with MRT.
        self.M = np.array(
            [
                [1.0] * 27,
                [1, 0, -1, 0, 0, 0, 1, -1, -1, 1, 1, 0, -1, 0, 1, 0, -1, 0, 1, -1, -1, 1, 1, -1, -1, 1, 0],
                [0, 1, 0, -1, 0, 0, 1, 1, -1, -1, 0, 1, 0, -1, 0, 1, 0, -1, 1, 1, -1, -1, 1, 1, -1, -1, 0],
                [0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, 1, 1, 1, -1, -1, -1, -1, 1, 1, 1, 1, -1, -1, -1, -1, 0],
                [-1, -1, -1, -1, -1, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, -2],
                [2, -1, 2, -1, -1, -1, 1, 1, 1, 1, 1, -2, 1, -2, 1, -2, 1, -2, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                [0, 1, 0, 1, -1, -1, 1, 1, 1, 1, -1, 0, -1, 0, -1, 0, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                [0, 0, 0, 0, 0, 0, 1, -1, 1, -1, 0, 0, 0, 0, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1, -1, 0],
                [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, -1, 0, -1, 0, 1, 1, 1, -1, -1, -1, -1, 1, 1, 0],
                [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, -1, 0, -1, 0, 1, 0, 1, -1, -1, 1, -1, 1, 1, -1, 0],
                [-4, 0, 4, 0, 0, 0, -1, 1, 1, -1, -1, 0, 1, 0, -1, 0, 1, 0, 2, -2, -2, 2, 2, -2, -2, 2, 0],
                [0, -4, 0, 4, 0, 0, -1, -1, 1, 1, 0, -1, 0, 1, 0, -1, 0, 1, 2, 2, -2, -2, 2, 2, -2, -2, 0],
                [0, 0, 0, 0, -4, 4, 0, 0, 0, 0, -1, -1, -1, -1, 1, 1, 1, 1, 2, 2, 2, 2, -2, -2, -2, -2, 0],
                [4, 0, -4, 0, 0, 0, -2, 2, 2, -2, -2, 0, 2, 0, -2, 0, 2, 0, 1, -1, -1, 1, 1, -1, -1, 1, 0],
                [0, 4, 0, -4, 0, 0, -2, -2, 2, 2, 0, -2, 0, 2, 0, -2, 0, 2, 1, 1, -1, -1, 1, 1, -1, -1, 0],
                [0, 0, 0, 0, 4, -4, 0, 0, 0, 0, -2, -2, -2, -2, 2, 2, 2, 2, 1, 1, 1, 1, -1, -1, -1, -1, 0],
                [0, 0, 0, 0, 0, 0, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 1, 1, 1, 1, 1, 1, 1, 1, 4],
                [4, 4, 4, 4, 4, 4, -2, -2, -2, -2, -2, -2, -2, -2, -2, -2, -2, -2, 1, 1, 1, 1, 1, 1, 1, 1, -8],
                [-4, 2, -4, 2, 2, 2, 1, 1, 1, 1, 1, -2, 1, -2, 1, -2, 1, -2, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                [0, -2, 0, -2, 2, 2, 1, 1, 1, 1, -1, 0, -1, 0, -1, 0, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                [0, 0, 0, 0, 0, 0, -2, 2, -2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1, -1, 0],
                [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -2, 0, 2, 0, 2, 0, -2, 1, 1, -1, -1, -1, -1, 1, 1, 0],
                [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -2, 0, 2, 0, 2, 0, -2, 0, 1, -1, -1, 1, -1, 1, 1, -1, 0],
                [0, 0, 0, 0, 0, 0, 1, -1, -1, 1, -1, 0, 1, 0, -1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                [0, 0, 0, 0, 0, 0, -1, -1, 1, 1, 0, 1, 0, -1, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, -1, 1, -1, -1, 1, -1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, -1, 1, -1, -1, 1, -1, 1, 0],
            ],
            dtype=np.float64,
        )
        self.S = np.diag(
            [
                0.0, 0.0, 0.0, 0.0, 1 / 1.54, 1 / 1.0, 1 / 1.0, 1 / 1.0,
                1 / 1.0, 1 / 1.0, 1 / 1.5, 1 / 1.5, 1 / 1.5, 1 / 1.83,
                1 / 1.83, 1 / 1.83, 1 / 1.4, 1 / 1.61, 1 / 1.98, 1 / 1.98,
                1 / 1.98, 1 / 1.98, 1 / 1.98, 1 / 1.74, 1 / 1.74, 1 / 1.74,
                1 / 1.74,
            ]
        )
        self.id_kinematic_visc = np.array([5, 6, 7, 8, 9])
        self.left = np.array([1, 7, 8, 11, 12, 19, 20, 21, 22])
        self.bottom = np.array([3, 7, 9, 15, 16, 19, 22, 23, 26])
        self.front = np.array([5, 11, 13, 15, 17, 19, 20, 23, 24])
        self.neutral_x = np.array([0, 3, 4, 5, 6, 15, 16, 17, 18])
        self.neutral_x_pos_y = np.array([3, 15, 16])
        self.neutral_x_pos_z = np.array([5, 15, 17])

    def __init__(self, name, params=None, problem=None):
        super().__init__(name, params, problem)
        self.neutral_x_neg_y = self.op[self.neutral_x_pos_y]
        self.neutral_x_neg_z = self.op[self.neutral_x_pos_z]
