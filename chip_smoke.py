#!/usr/bin/env python3
"""Smoke run of marlin_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, one line each, flushed as they finish:

0. toolchain: torch, CUDA, nvcc, the card's name and power limit;
1. build: the CUDA libraries of marlin_tpu_torch/csrc (the unordered FFT,
   the fused k-space update, the fused LBM substep) and the generated
   library of the 3-D Cahn-Hilliard µ fused into the forward lanes read,
   one nvcc each, all started together (and g++ of phase 20's native
   fparse library beside them), with ptxas's registers and spills
   of every FFT and LBM kernel, forward and inverse (and the register FFT
   kernels' shared memory), the LBM substep's flat and brick kernels.  The
   LBM substep library, the slowest to build, builds while phase 2's
   spectral rows, phases 3-6 and phase 12 run (phase 12 runs before the
   LBM phases); its report and phase 2's LBM rows follow phase 12.  A
   ``[time]`` line closes each group of phases;
2. kernels: each kernel at its 512³ main-path shapes (and at n = 64, 200,
   384) against its plain PyTorch twin, max error ≤ 1e-5 of the twin's
   largest magnitude; kernel, twin, bound and yardstick times, and which
   path (register, small or tile) each FFT shape takes, forward and
   inverse.  The small-extent path (b = n) over SMALL_SWEEP, kernels 1-4,
   and measured at benchmark 1a's 200² shapes, kernels 1-4, 1′ and 5: each
   also within 2.4e-7 of its largest output of the correctly rounded
   transform (torch.fft in complex128 rounded to complex64, the fused
   kernels' update in torch ops), device µs by the profiler beside the
   same-function torch call (or a composite) and the bound.  The LBM
   substep kernel (``lbm_substep``) at 256³ in float32 on nine plans (the
   porous deck's, the mixed deck's, a D3Q27 all-faces plan with a z body
   force, a zeroth-order Zou-He channel; the thermal deck's two lattices
   with buoyancy and the Guo source, the Pebbles deck's MRT on both
   lattices through media, an MRT D3Q27 all-faces plan, the porous deck
   with the Hermite projection, the collisionless chain), and at 9³ and
   33×17×20, each 256³ plan with the kernel it takes (the brick kernel,
   with its rows a brick, stages, threads and shared memory, or the flat
   one); the 256³ rows of the decks run in phases 7-10 beside their
   eager JNP substep.  The LBM kernels' bound takes their operations at
   half the float32 rate (built without FMA, each multiply and add issues
   alone).  The 2-D (D2Q9) plans at 800×200 and 4096×2048 in
   float32 (the channel with BGK and with MRT, the 2-D thermal pair, the
   Kármán plan: Smagorinsky with the projection, a perturbed inlet and the
   cylinder) and at 33×17 and 1000×333, each with the kernel it takes
   (the flat one; the Kármán plan the plane kernel, with its cooperative
   grid); the Kármán plan's mean density (``lbm_density_mean``, 7′,
   computed inside the plane kernel's launch) against its twin at the
   same extents, its own device time at the main extents taken as the
   plane launch's less the flat kernel's given the mean;
3. main path: the 3-D Cahn-Hilliard deck at 512³ through ``run_deck`` with
   ``fft_backend = PALLAS`` in float32 (10 substeps, 2 steps, dt = 1): the
   launch counters rise by exactly the count the path implies, c is finite
   and its mean (mass) stays within 1e-5 of the start;
4. library anchor: the same deck with ``fft_backend = DEFAULT`` (torch.fft);
   max |c_PALLAS − c_DEFAULT| ≤ 5e-5 (tests/test_pallas_fft.py's tolerance);
5. fused single-field path: the same deck on PALLAS with
   ``carry_reciprocal`` and ``fused_spectral``: exact launch counts, mass
   within 1e-5, max |c_fused − c_DEFAULT| ≤ 2e-4
   (tests/test_pallas_spectral.py's fused-versus-library tolerance);
6. fused N-field path: the 3-D two-field chain (decks.MULTI_3D_DECK: a
   Cahn-Hilliard field c and an Allen-Cahn field n1) at 512³, float32,
   10 substeps, 2 steps, dt = 0.05, fused and unfused (carry only):
   max |Δ| ≤ 5e-5 on c and n1, mass of c within 1e-5, one
   ``fwd_x_update_poly`` launch per fused substep;
7. LBM porous: ``decks.POROUS_DECK`` (D3Q19 BGK through the benchmark's
   sphere pack, ``decks.porous_media``, handed in as an array so no HDF5
   file is needed) at 256³, float32, 10 substeps × 3 steps, through
   ``run_deck`` with ``lbm_backend = PALLAS`` and ``JNP``: exactly 2 × 9
   ``lbm_substep`` launches on PALLAS and none on JNP; on f, fpc, density,
   velocity and speed max |PALLAS − JNP| ≤ 1e-5 of the JNP buffer's
   largest magnitude; the fluid mass Σρ (float64) within 1e-5 of its start
   on both; every buffer finite;
8. LBM mixed: ``decks.MIXED_DECK`` (bounce-back walls, Zou-He velocity
   inlet, zero-gradient outlet) the same way, without the mass check (the
   inlet and the outlet move mass);
9. LBM thermal: ``decks.THERMAL3D_DECK`` (two D3Q19 BGK lattices, f and
   the temperature g, Boussinesq buoyancy, Guo forcing, bounce-back plates
   and Zou-He temperature faces) the same way, on f, fpc, g, gpc, density,
   T and velocity, with the mass check; MLUPS count both lattices;
10. LBM Pebbles: ``decks.PEBBLES_DECK`` (MRT on both lattices through the
   benchmark's sphere pack, buoyancy, Guo forcing, Zou-He temperature
   faces, the residual on T) the same way;
11. LBM Kármán: ``decks.KARMAN_DECK`` (D2Q9, Smagorinsky with the Hermite
   projection, the cylinder of ``decks.karman_media``, a perturbed Zou-He
   inlet, a zero-gradient outlet) at 800×200, float32, 100 substeps × 3
   steps, on PALLAS and JNP: exactly 2 × 99 ``lbm_substep`` launches on
   PALLAS, each computing its mean density inside (``lbm_density_mean``
   counts them: no launch of its own), none on JNP; on f, fpc, feq,
   density, velocity and speed max |PALLAS − JNP| ≤ 1e-5 of the JNP
   buffer's largest magnitude; every buffer finite; ms a substep, MLUPS and
   peak device memory on both; then the host's µs a fused substep (the
   fused loop's wrapper, 1000 back-to-back calls at 800×200);
12. benchmark 1a: ``decks.BENCH_1A_DECK`` (the 2-D spinodal decomposition,
   the stand-in for the reference's 1a.i) at 200², 1000 substeps a step,
   through ``run_deck`` to its end (t = 10500, or the Terminator's
   ``change < 1e-4``), four times: DEFAULT (torch.fft) in float64, the
   card's reference (run first, while the libraries build: it needs no
   kernel of the port), and in float32, cut to its first 8 of 85 steps
   (``BENCH_1A_CUT``: room in the cold start for phases 17 and 20); PALLAS
   unfused in float32 (kernels 1-4 on the small-extent path at n = 200, in
   every substep and in the free-energy group), cut to its first 8
   (``BENCH_1A_CUT``: the host-bound route, its kernels held at
   200² by phase 2); each cut route's last F held within 1e-3 of the
   float64 run's at the same step; PALLAS with ``carry_reciprocal`` and
   ``fused_spectral`` in float32 (kernels 1′ with the 1a µ, 5, 4 and 2,
   and kernels 1-4 in the group).  Each after a warm-up of 1 step that
   builds and loads its kernels.  Gates: F(0) against a numpy float64
   evaluation of the same formula (1e-9 relative in float64, 1e-5 in
   float32); the same steps and final t in the uncut runs, the float64
   run's first steps in the cut ones; exact launch
   counts (none on DEFAULT); c_integral within 1e-10 (float64) or 1e-5
   (float32) of its start and mass (cbar's k = 0 slot) equal to it within
   the same bound at every step; c finite; each float32 run's F within
   1e-3 of the float64 run's while t ≤ 10, the fused run's final F within
   10%.
   Each run's seconds to the finished transient, ms a substep, steps,
   t_final, F_final, peak device memory and perf-graph sections, beside
   the card's name and power limit and the reference's 45 s on an L4;
13. outputs and restart: the PALLAS fused float32 1a deck at 200², 1000
   substeps a step, with XDMF frames of c (binary: the card's machine has
   no h5py), Exodus of c through a LAGRANGE aux variable and its
   ``ElementAverageValue``, a ``TensorHistogram`` of c and a checkpoint
   every 3 steps, run 6 steps, run 3, and resumed from that step-3
   checkpoint to 6 (``run_deck(recover=...)``), each in its own
   directory; the Kármán deck on PALLAS the same way, 4 steps resumed
   from step 2.  Gates: the resumed state (every buffer, among them c, the
   complex64 carried cbar and the LBM distributions, the history ring,
   solver entries, n_advances, old_dt) and postprocessor values equal the
   uninterrupted run's bit for bit; 1a's CSV rows and histogram files
   4-6 identical, ``xdmfdiff.compare`` of its frames 4-6 at zero
   tolerance, the step-6 ``.bin`` frame equal to c, the ``.e`` file read
   back with 7 times; launches exactly phase 12's count (no INITIAL
   group on the resumed run), Kármán's 99 a step after the first.  The
   perf graph's outputs seconds a step, checkpoint bytes and seconds to
   write and to read onto the card, and peak device memory, beside the
   card's name and power limit;
14. the rest of lattice Boltzmann and the spectral family's computes:
   (a) the two-phase droplet (``decks.TWOPHASE2D_DECK``, D2Q9 at 512², 3
   steps × 20 substeps, JNP) in float64 and float32: Σφ and the fluid mass
   within 1e-10 (float64) or 1e-5 (float32) of their start, float32 within
   1e-4 of float64's largest on φ and ρ, and the same deck on ``lbm_backend
   = PALLAS`` refused with the JAX package's words; (b) pressure-driven flow
   through the 256³ porous sample (``decks.PRESSURE_DECK``: Dirichlet
   inlet on the left face, then on the wall cells, Neumann outlet,
   bounce-back walls and media; float32, JNP, 2 steps × 5 substeps):
   finite, no kernel-7 launch; (c) the 800×200 channel with specular walls,
   Dirichlet inlet, Neumann outlet and the unit converter
   (``decks.SPECULAR_CHANNEL_DECK``, 3 steps × 40 substeps), max |u|
   within ``SPECULAR_MAX_U`` and float32 within 1e-4 of float64 on every
   buffer; (d) the spectral family at 512²
   (``decks.SMOOTHED_BOUNDARY_DECK``, 2 steps × 40 substeps) on DEFAULT
   float64, DEFAULT float32 and PALLAS float32 (kernels 1-4 on the register
   path): launches exactly ``sbm_launches``, PALLAS against DEFAULT
   float32 and float32 against float64 within each buffer's ``SBM_TOL`` of its
   largest (spectra compared on the half spectrum without the Nyquist row
   and column); (e) ``batch_fft`` on the 2a stand-in at 200²
   (``decks.OSTWALD_2A_DECK``, 2 steps × 20 substeps of 0.002) on the same three
   routes, off and on: PALLAS batched equal to unbatched bit for bit,
   DEFAULT within 1e-12 (float64) or 1e-6 (float32), the forward lanes
   launches a substep one a batch group, ms a substep with device time;
   (f) ``decks.BENCH_1A_LEGACY_DECK`` equal to ``BENCH_1A_DECK`` bit for
   bit over 2 steps × 100 substeps on DEFAULT float32 and PALLAS fused, launches phase
   12's formula.

15. the rest of the solver family and the iteration-driven timestepper:
   (a) ETDRK4 on the 3-D Cahn-Hilliard deck (``decks.CH3D_ETDRK4_DECK``) at
   512³, float32, 10 substeps × 2 steps, with the Cox-Matthews tables on
   PALLAS and DEFAULT (max |c_PALLAS − c_DEFAULT| ≤ 5e-5, mass within
   1e-5, kernels 1-4 launched as 4 group evaluations and 4 inverse
   transforms a substep imply) and with the reference's tables on PALLAS
   (one step; launches; whether c stays finite is printed: the CPU tests
   find those tables non-finite from 32³ on); then the Cox-Matthews order
   on the 1-D deck of tests/test_etdrk4_cox_matthews.py, float64 on the
   card, 4/8/64 substeps, in (3.5, 4.8); (b) SecantSolver and (c)
   BroydenSolver on the 2a stand-ins (``decks.OSTWALD_2A_SECANT_DECK``,
   ``..._BROYDEN_DECK``) at 200², 2 steps × 5 substeps, iteration-adaptive
   dt (Broyden's at a constant dt), on PALLAS float32 (kernels 1-4 on the
   small path), DEFAULT float64 and float32: every substep converged, c's
   integral within 1e-5 (float32) or 1e-10 (float64), the float32 routes
   within ``ITERATIVE_FIELD_TOL`` of DEFAULT float64, launches exactly the
   group evaluations and inverses the iteration counts imply, PALLAS
   batched equal to unbatched bit for bit; Broyden's M through a
   checkpoint bit for bit; then a start dt
   too large: a rejected step re-attempted at a quarter, time not advanced
   by it, dt not grown after; each route's ms, iterations and host syncs a
   substep, the secant's device busy share on PALLAS; (d) the coupled ABM
   (``decks.COUPLED_DECK``) at 512², predictor orders 1, 2, 4 with 0, 1, 2
   corrector steps, PALLAS float32 within 1e-5 of DEFAULT float64, which is
   within 1e-4 of the exact solution; (e) forward Euler
   (``decks.EXPLICIT_DECK``) at 1024² on PALLAS and DEFAULT (within 1e-5)
   and in real space, and LinearTensorPredictor's iterations on (b)'s deck.
16. FFT micromechanics (the deGeus Newton around matrix-free CG, one host
   fetch a CG iteration): kernels 1-4 at this path's tensor-valued shapes
   (9 × 128³ on the register path, 9 × 32³ and 4 × 96² on the small path)
   against their twins, device ms beside torch.fft and the byte bound;
   (a) ``decks.MECH_DECK`` at 128³, the analytic tangent, float32, 2 steps
   × 10 substeps, on PALLAS and DEFAULT: every substep converged, <F> the
   last substep's applied strain I + t·e01 within 1e-5, |F_PALLAS −
   F_DEFAULT| ≤ 2e-5, DEFAULT float32 after step 1 within 1e-4 of a
   one-step float64 run, kernels 1-4 launched 3 forward and 3 inverse a
   Green projection (one a CG iteration that ran, and the right-hand side
   and residuals of each solve); ms a step and a CG iteration, Newton and
   CG iterations, host fetches, the busy share and device operations a CG
   iteration, peak memory, the two forms of ``tangent_apply`` and the TF32
   setting; (b) the same at the shipped 32³, 1 step; (c)
   ``preconditioner = REFERENCE_MEDIUM`` at 31³ in float64 on DEFAULT
   under tests/test_cg.py's tight tolerances: F within 2e-6 and stress
   within 2e-5 of the plain solve, in fewer CG iterations; (d)
   ``decks.COUPLED_PF_MECH_DECK`` at 256³, float32, 2 steps × 10 substeps:
   |c_PALLAS − c_DEFAULT| ≤ 5e-5, mass within 1e-5, displacements finite
   with 0 < max|u| < 0.1, launches exact; (e) ComputeDisplacements and
   ComputeVonMisesStress on (a)'s final state as [Postprocess] computes:
   (129, 129, 129, 3), PALLAS within 1e-4 of DEFAULT's max|u|; (f) the AT2
   fracture deck (examples/phase_field_fracture/fracture.i, binary XDMF)
   at its 96², 4 of its 40 steps: PALLAS float32 against DEFAULT float64
   on d and its three postprocessors within ``FRACTURE_TOL``.
17. the NN Gibbs surrogate and NEML2 (ROADMAP §1 items 6-7): (a)
   ``decks.KKS_NN_3D_DECK`` (the two-field chain's µ's from one
   LibtorchGibbsEnergy, TorchScript run natively with autograd) with the
   ``"analytic"`` surrogate at 512³, float32, 2 steps × 10 substeps, on
   PALLAS and DEFAULT: against ``decks.KKS_PARSED_3D_DECK`` (the same G
   parsed) on PALLAS and PALLAS against DEFAULT, max |Δ| ≤ 5e-5 on c and
   n1; mass within 1e-5; kernels 1-4 launched exactly 4 forward and 2
   inverse transforms a substep; the module on the card in float32; three
   evaluations of one input equal bit for bit; TF32 off; the fused flags
   refused with the JAX package's words; (b) the ``"mlp"`` surrogate (2→32
   →32→1, tanh, seeded) at 256³: G and both jacobian groups within 1e-5 of
   their largest against a float64 evaluation of the module on the card,
   PALLAS against DEFAULT within 5e-5, ms a substep, the compute's ms (CUDA
   events), peak memory; (c) examples/neml2_creep/creep.i at its 64², 20
   steps, in float64 and float32 (its tolerance 1e-9, ``NEML2_F32_ABS_TOL``):
   the showcase's physics (tests/test_examples.py), every Newton solve
   converged, float32 within 1e-4 of float64 on ep and sm; then 1024²,
   5 steps; (d) ``decks.NEML2_PERZYNA_DECK`` at 128³, 3 steps (the
   implicit Perzyna update, n = 7 unknowns a point, host Newton with one
   fetch an iteration; the Miehe split of ``decks.NEML2_SPECTRAL_MODEL``):
   float32 within 1e-4 of float64 on Ep, ep, S, ψ⁺ and ψ⁻; Newton iterations
   a step, fetches, ms an iteration; eigvalsh at 128³ in chunks of 16384
   (cuSOLVER refuses one call) and the split's tangent finite at repeated
   eigenvalues.
18. the distributed modes (ROADMAP §1 item 8): (a) in one process, kernels
   5-6 in their slab form at 512³ (the rank's X-sharded block (512/p, 512,
   512) for p = 1, 2, 4, kernel 6 with two fields at p = 1, 2; p = 1 is
   (b)'s stack) against their twins, ms a launch beside serial kernel 5's;
   kernel 7's halo forms on the porous (media), all-faces D3Q27 and
   thermal (two lattices) plans at 256³ cut 2 and 4 ways along x and
   2 × 2 (porous also uncut: (b)'s world-of-one block, its ring its own
   periodic wrap), the mixed plan (Zou-He inlet, zero-gradient outlet) cut
   2 ways, and on the D2Q9 channel at 800×200 cut 2 and 4 ways: each
   block's halos sliced from its neighbours, each block run on the walk
   it gets (the halo brick on one-lattice 3-D blocks, the flat kernel on
   the others) and on the flat halo form, both forms' blocks put together
   equal to the unsharded flat kernel bit for bit and within 1e-5 of the
   twin; a block's ms in each form beside the flat and brick kernels on
   an unsharded plan of its shape and its byte bound, and the halo
   brick's registers and spills;
   (b) on a real NCCL group of world size 1 (formed here, destroyed
   after): decks.CH3D_DECK at 512³ float32 on FFT_SLAB, DEFAULT, PALLAS
   and PALLAS fused, 2 steps × 10 substeps: |c_slab − c_serial| ≤ 5e-5
   (fused 2e-4) against phases 3-5's end states, mass within 1e-5, kernel
   launches and all_to_alls exact, ms a substep beside phases 3-5's;
   MULTI_3D_DECK fused on the slab (5e-5 of phase 6's); POROUS_DECK at
   256³ on REAL_SPACE, PALLAS and JNP, 3 steps × 10 substeps, within 1e-5
   of phase 7's end states (PALLAS, the halo brick, with its bits),
   launches exact; one all_to_all of a 512³
   complex64 block and one halo ring of a 256³ D3Q19 block, ms; the NCCL
   version and the world size.
19. the mesh family on the same group: (a) CH3D on FFT_PENCIL, (b) ETDRK4
   on FFT_SLAB, DEFAULT and PALLAS, (c) the deGeus RVE on FFT_SLAB and
   FFT_PENCIL, (d) the Perzyna deck on FFT_SLAB, (e) the 3-D REAL_SPACE
   Laplacian on a (1, 1, 1) mesh, (f) kernels 1-4 in slab form at p = 2
   and 4 (``phase_mesh_family``).
20. the sharded checkpoint, the writers on a mesh and the native
   evaluator, on the same group, where the writers take the serial file
   form of a world of one (``phase_restart_mesh``): (a) decks.CH3D_DECK at
   256³ float32 (not 512³: that state's ~6 GiB would cost 15-20 s of the
   cold start to write and read) on the PALLAS fused slab, 2 steps × 10
   substeps, a checkpoint every step and an XDMF frame of c (.bin) each
   step; a fresh Transient resumed from step 1's checkpoint equals the
   uninterrupted run in every leaf bit for bit, its frame's bytes are c,
   its launches (kernels 1', 5s, 4 and 2, with 1 and 3) phase 18 (b)'s
   for one step; the checkpoint's bytes and its write and read seconds;
   (b) benchmark 1a at 200² DEFAULT float32 on FFT_SLAB, cut to 4 steps of
   100 substeps, with phase 13's outputs (Exodus of a LAGRANGE aux
   variable with ElementAverageValue, the histogram, XDMF, CSV),
   checkpointed at step 2 and resumed: the CSV rows, the histograms and
   the Exodus frames after the checkpoint bit for bit, the histogram
   counts 200², and c within 5e-5 of a serial run of the cut deck; (c)
   the native fparse library (g++, built in phase 1's pool beside the
   kernels): available, its build seconds, and fracture.i's ``${fparse}``
   constants equal to the Python engine's, hit.load taking the native
   engine for each.

Then one JSON line with every kernel's numbers (a kernel timed at more
than one main shape also lists each under ``shapes``; ``launches_by_path``
splits ``launches`` by the paths that reached it; the small-extent kernels
stand as their own entries, ``<wrapper> small``, timed at 200² and
launched by phase 12's PALLAS runs, phase 13's 1a runs and phase 14's 2a
and 1a runs; phase 13's Kármán runs add to ``lbm_substep``'s, phase 14's
512² spectral-family run and phase 16's 128³ and 256³ runs and phase 17's 512³ and
256³ runs to kernels 1-4's, phase 16's 32³ and 96² runs to the
small-extent entries; phase 16's
rows at its shapes stand under ``mechanics_shapes``; kernels 5-6's slab
form and kernel 7's halo branch stand as their own entries, ``<wrapper>
slab`` and ``lbm_substep halo``, timed by phase 18 (a) and launched by its
(b) runs and phase 20 (a)'s, kernels 1-4's slab rows by phase 19's ETDRK4
slab run and phase 20 (a)'s, whose kernel 1' launches join that row's;
``collective`` holds (b)'s all_to_all and halo ring ms) and, last, the JSON result line.  Any failure ends the run with a non-zero exit and no result line.
Needs one CUDA card; fails without one, and fails where the package is not
beside it.
"""

import concurrent.futures
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N = 512
SUBSTEPS = 10
STEPS = 2
MULTI_DT = 0.05
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12     # H100 SXM data sheet, float32 outside tensor cores
# csrc/lbm_substep.cu is built with -fmad=false: every multiply and add
# issues on its own, at half the rate that counts an FMA as two
F32_NO_FMA_FLOP_PER_S = F32_FLOP_PER_S / 2
KERNEL_TOL = 1e-5
# the small-extent path against torch.fft in complex128 rounded to complex64:
# 2 float32 ulps of the largest output (the kernel's rounding and the
# reference's)
C128_TOL = 2.4e-7
# b = n extents the small-extent kernels are held at: every radix, primes
# above 7, both ends of the range
SMALL_SWEEP = [8, 9, 12, 25, 49, 64, 97, 100, 125, 199, 200, 243, 343, 397, 400]
PATHS = {0: "tile", 1: "register", 2: "small"}
ANCHOR_TOL = 5e-5
FUSED_ANCHOR_TOL = 2e-4
MULTI_TOL = 5e-5
MASS_TOL = 1e-5
FUSED = "carry_reciprocal = true\n  fused_spectral = true"
LBM_N = 256
LBM_SUBSTEPS = 10  # the 3-D LBM decks (phases 7-10); Kármán has its own
LBM_STEPS = 3
LBM_ODD = [(9, 9, 9), (33, 17, 20)]
KARMAN = (800, 200)  # the reference cylinder.i's shipped extent
LBM_2D = [KARMAN, (4096, 2048)]  # the shipped 2-D size, and one above launch cost
LBM_ODD_2D = [(33, 17), (1000, 333)]  # 1000×333: the mean's chunked finish
KARMAN_SUBSTEPS = 100
BENCH_1A_N = 200  # benchmark 1a: 200², 1000 substeps a step, to t = 10500
BENCH_1A_SUBSTEPS = 1000
BENCH_1A_WARM_STEPS = 1  # a step runs every kernel of its run
BENCH_1A_F0_TOL = {torch.float64: 1e-9, torch.float32: 1e-5}  # relative
BENCH_1A_MASS_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}  # relative
BENCH_1A_EARLY = (10.0, 1e-3)  # float32 F within 1e-3 of float64's while t <= 10
BENCH_1A_FINAL_TOL = 0.10  # final F, float32 against float64 (relative)
PFHUB_F0 = 319.03  # PFHub's F(0) of benchmark 1a (prismspf, BASELINE.md:9)
REFERENCE_1A = "45 s and 277 MB on an NVIDIA L4 (the reference's, BASELINE.md:7)"
BENCH_1A_RUNS = {  # run: its route in marlin_tpu_torch.bench_1a_runs.ROUTES
    "DEFAULT float64": "D64", "DEFAULT float32": "D32",
    "PALLAS float32": "P32", "PALLAS fused float32": "F32",
}
# runs cut short, each to its first 8 of 85 steps (t = 11.4, past the t <= 10 gate):
# PALLAS float32 unfused, host-bound (55-66 s whole), its
# kernels held at 200² by phase 2 and its launches again in phases 13-15;
# DEFAULT float32 (room for phase 17; 42-46 s whole), torch.fft
# alone; 8 steps, not 12, make room for phase 20 (a cold run at 12 reached
# [done] at 298.5 s).  Each last F is held against the float64 run's at
# the same step, within BENCH_1A_EARLY's tolerance
BENCH_1A_CUT = {"PALLAS float32": 8, "DEFAULT float32": 8}
PROFILE_ATTEMPTS = 3  # device_ms: traces taken before an empty one fails
RESUME_1A = (6, 3)  # phase 13: steps of 1a, and the checkpoint's step
RESUME_KARMAN = (4, 2)  # the same for Kármán (100 substeps a step)
# phase 13's 1a outputs: c mapped to a LAGRANGE aux variable for Exodus and
# ElementAverageValue, XDMF frames of c (no h5py on the card), a histogram
OUTPUTS_1A = """
[TensorBuffers]
  [c]
    map_to_aux_variable = c_aux
  []
[]
[AuxVariables]
  [c_aux]
    family = LAGRANGE
  []
[]
[TensorOutputs]
  [xdmf]
    type = XDMFTensorOutput
    buffer = c
    enable_hdf5 = false
  []
[]
[VectorPostprocessors]
  [c_hist]
    type = TensorHistogram
    buffer = c
    min = 0
    max = 1
    bins = 100
  []
[]
"""


def say(*parts):
    print(*parts, flush=True)


def lap(phases, t_start):
    say(f"[time] phase {phases} done at {time.perf_counter() - t_start:.1f} s")


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps=10, warmup=2):
    """Mean device time of one call, by CUDA events over `reps` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, flops, flop_rate=F32_FLOP_PER_S):
    """Least time: bytes over the memory rate against flops over the
    float32 rate (``flop_rate``); returns (ms, "bytes" | "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fft_flops(rows, n):
    """The standard count, 5·n·log2 n flop a length-n transform."""
    return rows * 5 * n * math.log2(n)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def check(name, shape, got, ref):
    """max |got − ref| against 1e-5 of the twin's largest magnitude, over
    every output; returns the error."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = 0.0
    for g, r in zip(got, ref):
        e = (g - r).abs().max().item()
        mag = r.abs().max().item()
        assert e <= KERNEL_TOL * mag, (name, shape, e, mag)
        err = max(err, e)
    return err


def summarise(rows):
    """The mean over a kernel's main-shape rows; with more than one row,
    each row also stands on its own under ``shapes``, so that a loss at one
    shape is not hidden by a win at another."""
    k = len(rows)
    mean = lambda key: sum(r[key] for r in rows) / k
    out = {"max_abs_err": max(r["max_abs_err"] for r in rows),
           "ms": mean("ms"), "plain_ms": mean("plain_ms"),
           "bound_ms": mean("bound_ms"), "bound_by": rows[0]["bound_by"],
           "library_ms": None if rows[0]["library_ms"] is None else mean("library_ms")}
    if "yardstick_ms" in rows[0]:
        out["yardstick_ms"] = mean("yardstick_ms")
        out["yardstick"] = rows[0]["yardstick"]
    if "path" in rows[0]:  # the small-extent rows
        out["path"] = rows[0]["path"]
        out["c128_rel_err"] = max(r["c128_rel_err"] for r in rows)
    if k > 1:
        out["shapes"] = rows
    return out


def measure(name, shape, kernel, twin, library, n_bytes, flops, yardstick=None,
            flop_rate=F32_FLOP_PER_S):
    """One main-shape row: the check, then kernel, twin, library or
    composite yardstick times and the bound."""
    got = kernel()
    torch.cuda.synchronize()
    ref = twin()
    err = check(name, shape, got, ref)
    del got, ref
    ms = cuda_ms(kernel)
    plain = cuda_ms(twin, reps=3, warmup=1)
    lib = None if library is None else cuda_ms(library)
    bnd, by = bound_ms(n_bytes, flops, flop_rate)
    row = {"shape": list(shape), "max_abs_err": err, "ms": ms, "plain_ms": plain,
           "library_ms": lib, "bound_ms": bnd, "bound_by": by}
    text = (f"[kernels] {name} {tuple(shape)}: max_abs_err {err:.3e}, kernel "
            f"{ms:.3f} ms, twin {plain:.3f} ms, bound {bnd:.3f} ms ({by})")
    if lib is not None:
        text += f", torch.fft {lib:.3f} ms"
    if yardstick is not None:
        label, fn = yardstick
        row["yardstick"] = label
        row["yardstick_ms"] = cuda_ms(fn)
        text += f", {label} {row['yardstick_ms']:.3f} ms"
    say(text)
    return row


def fft_path(uf, name, n):
    """The path the library takes for wrapper ``name`` at extent n."""
    lib = uf.LIBRARY.load()
    which = lib.mtt_fwd_path if name.startswith("fwd") else lib.mtt_inv_path
    return PATHS[which(n, uf.base(n))]


class ExactTransforms:
    """Within the block, the plain twins' transforms are torch.fft in
    complex128 rounded once to complex64 (the inverse's real part to
    float32): the correctly rounded DFT of the same input, for extents with
    b = n (natural order).  The fused twins (kernels 1′ and 5) call the
    transform twins, so they give the exact transform and the update in
    torch ops."""
    NAMES = ("fwd_lanes_plain", "inv_lanes_plain", "fwd_sublanes_plain", "inv_sublanes_plain")

    def __init__(self, uf):
        self.uf = uf

    @staticmethod
    def fwd(x, dim):
        return torch.fft.fft(x.to(torch.complex128), dim=dim).to(torch.complex64)

    @staticmethod
    def inv(x, dim, real_output=False):
        y = torch.fft.ifft(x.to(torch.complex128), dim=dim)
        return y.real.to(torch.float32) if real_output else y.to(torch.complex64)

    def __enter__(self):
        self.saved = {k: getattr(self.uf, k) for k in self.NAMES}
        self.uf.fwd_lanes_plain = lambda x: self.fwd(x, -1)
        self.uf.inv_lanes_plain = lambda x, real_output=True: self.inv(x, -1, real_output)
        self.uf.fwd_sublanes_plain = lambda x: self.fwd(x, 1)
        self.uf.inv_sublanes_plain = lambda x: self.inv(x, 1)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.uf, k, v)


def check_c128(name, shape, got, exact):
    """max |got − exact| against C128_TOL of exact's largest magnitude, over
    every output; returns the error relative to that magnitude."""
    got = got if isinstance(got, tuple) else (got,)
    exact = exact if isinstance(exact, tuple) else (exact,)
    rel = 0.0
    for g, e in zip(got, exact):
        r = (g - e).abs().max().item() / e.abs().max().item()
        assert r <= C128_TOL, (name, shape, "complex128", r)
        rel = max(rel, r)
    return rel


def measure_1a(uf, name, path, shape, kernel, twin, library, n_bytes, flops,
               yardstick=None):
    """One row at benchmark 1a's 200² shapes: the kernel against its twin
    (KERNEL_TOL) and against the correctly rounded transform (C128_TOL),
    then device ms a call by the profiler of the kernel, the twin and the
    same-function torch call (``library``, (label, call)) or the composite
    ``yardstick`` (label, call), and the bound."""
    got = kernel()
    torch.cuda.synchronize()
    err = check(name, shape, got, twin())
    with ExactTransforms(uf):
        rel = check_c128(name, shape, got, twin())
    del got
    ms, plain = device_ms(kernel), device_ms(twin)
    lib = None if library is None else device_ms(library[1])
    bnd, by = bound_ms(n_bytes, flops)
    row = {"shape": list(shape), "path": path, "max_abs_err": err, "c128_rel_err": rel,
           "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bnd, "bound_by": by}
    text = (f"[kernels] {name} {tuple(shape)}: {path} path, max_abs_err {err:.3e} "
            f"(twin), {rel:.3e} of the largest output (complex128 rounded, limit "
            f"{C128_TOL}); device us: kernel {1e3 * ms:.2f}, twin {1e3 * plain:.2f}, "
            f"bound {1e3 * bnd:.3f} ({by})")
    if lib is not None:
        text += f", {library[0]} {1e3 * lib:.2f}"
    if yardstick is not None:
        label, fn = yardstick
        row["yardstick"] = label
        row["yardstick_ms"] = device_ms(fn)
        text += f", {label} {1e3 * row['yardstick_ms']:.2f}"
    say(text)
    return row


def phase_small_sweep(uf, dev, gen):
    """The small-extent kernels over SMALL_SWEEP, forward and inverse, lanes
    and sublanes, against their twins and the correctly rounded transform;
    each must take the small path."""
    shapes = {"fwd_lanes": ((64, None), torch.float32),
              "inv_lanes": ((64, None), torch.complex64),
              "fwd_sublanes": ((2, None, 64), torch.complex64),
              "inv_sublanes": ((2, None, 64), torch.complex64)}
    for name, (shape_of, dtype) in shapes.items():
        kernel, errs = getattr(uf, name), []
        for n in SMALL_SWEEP:
            path = fft_path(uf, name, n)
            assert path == "small" == uf.path(n), (name, n, path)
            shape = tuple(n if d is None else d for d in shape_of)
            x = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
            got = kernel(x)
            torch.cuda.synchronize()
            err = check(name, shape, got, getattr(uf, name + "_plain")(x))
            with ExactTransforms(uf):
                rel = check_c128(name, shape, got, getattr(uf, name + "_plain")(x))
            errs.append(f"{n}: {err:.1e} / {rel:.1e}")
        say(f"[kernels] {name} small path at n = {SMALL_SWEEP[0]}..{SMALL_SWEEP[-1]} "
            f"(max_abs_err against the twin / against complex128, relative): "
            + ", ".join(errs))


def phase_fft_kernels(uf, dev, gen):
    """Kernels 1-4 against their twins; the small-extent path over its sweep
    and, measured, at benchmark 1a's shapes."""
    def make(shape, dtype):
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev)

    plane = N * N
    main_shapes = {
        "fwd_lanes": [((plane, N), torch.float32)],
        "inv_lanes": [((plane, N), torch.complex64)],
        "fwd_sublanes": [((1, N, plane), torch.complex64),
                         ((N, N, N), torch.complex64)],
        "inv_sublanes": [((1, N, plane), torch.complex64),
                         ((N, N, N), torch.complex64)],
    }
    a = BENCH_1A_N  # benchmark 1a's shapes: lanes (200, 200), sublanes (1, 200, 200)
    small = {
        "fwd_lanes": [((4096, n), torch.float32) for n in (64, 200, 384)],
        "inv_lanes": [((4096, n), torch.complex64) for n in (64, 200, 384)],
        "fwd_sublanes": [((8, n, 300), torch.float32) for n in (64, 200, 384)],
        "inv_sublanes": [((8, n, 300), torch.complex64) for n in (64, 200, 384)],
    }
    shapes_1a = {"fwd_lanes": ((a, a), torch.float32),
                 "inv_lanes": ((a, a), torch.complex64),
                 "fwd_sublanes": ((1, a, a), torch.complex64),
                 "inv_sublanes": ((1, a, a), torch.complex64)}
    library = {
        "fwd_lanes": lambda x: torch.fft.fft(x, dim=-1),
        "inv_lanes": lambda x: torch.fft.ifft(x, dim=-1),
        "fwd_sublanes": lambda x: torch.fft.fft(x, dim=1),
        "inv_sublanes": lambda x: torch.fft.ifft(x, dim=1),
    }
    # the same function as one torch call at 1a's shapes (kernel 2's takes
    # .real, a view: one device kernel)
    labels_1a = {"fwd_lanes": "torch.fft.fft(x, -1)", "inv_lanes": "torch.fft.ifft(x, -1).real",
                 "fwd_sublanes": "torch.fft.fft(x, 1)", "inv_sublanes": "torch.fft.ifft(x, 1)"}
    results = {}
    phase_small_sweep(uf, dev, gen)
    for name in main_shapes:
        kernel = getattr(uf, name)
        twin = getattr(uf, name + "_plain")
        for shape, dtype in small[name]:
            x = make(shape, dtype)
            got = kernel(x)
            torch.cuda.synchronize()
            err = check(name, shape, got, twin(x))
            n = shape[1] if "sub" in name else shape[-1]
            say(f"[kernels] {name} {tuple(shape)} {str(dtype)[6:]}: "
                f"{fft_path(uf, name, n)} path, max_abs_err {err:.3e}")
        shape, dtype = shapes_1a[name]
        x = make(shape, dtype)
        call = library[name]
        same = (lambda: call(x).real) if name == "inv_lanes" else (lambda: call(x))
        out_bytes = x.numel() * (4 if name == "inv_lanes" else 8)
        results[name + " small"] = summarise([measure_1a(
            uf, name, fft_path(uf, name, a), shape, lambda: kernel(x),
            lambda: getattr(uf, name + "_plain")(x),
            (labels_1a[name], same),
            nbytes(x) + out_bytes + uf.small_plan_bytes(a), fft_flops(x.numel() // a, a))])
        del x
        rows = []
        for shape, dtype in main_shapes[name]:
            x = make(shape, dtype)
            n = shape[1] if "sub" in name else shape[-1]
            out_bytes = x.numel() * (4 if name == "inv_lanes" else 8)
            path = fft_path(uf, name, n)
            say(f"[kernels] {name} {tuple(shape)}: {path} path")
            rows.append(measure(
                name, shape, lambda: kernel(x), lambda: twin(x),
                lambda: library[name](x),
                nbytes(x) + out_bytes + n * 8,  # + the twiddle table
                fft_flops(x.numel() // n, n)))
            del x
        results[name] = summarise(rows)
    return results


def phase_fused_kernels(uf, sp, dev, gen, pre, k2):
    """fwd_lanes_pre, fwd_x_update and fwd_x_update_poly against their
    twins."""
    def make(shape, dtype, scale=1.0, shift=0.0):
        return shift + scale * torch.randn(shape, generator=gen, dtype=dtype, device=dev)

    results = {}
    # -- kernel 1 with the fused µ read: c-like values around 0.5
    pre_ops = pre.expr.cuda_source(pre.var).count("\n")  # one flop a statement
    a = BENCH_1A_N  # and benchmark 1a's (200, 200), the same µ in 2-D
    for shape in [(4096, n) for n in (64, 200, 384)]:
        x = make(shape, torch.float32, 0.05, 0.5)
        err = check("fwd_lanes_pre", shape, uf.fwd_lanes(x, pre=pre),
                    uf.fwd_lanes_plain(pre(x)))
        say(f"[kernels] fwd_lanes_pre {shape} float32: max_abs_err {err:.3e}")
    x = make((a, a), torch.float32, 0.05, 0.5)
    results["fwd_lanes_pre small"] = summarise([measure_1a(
        uf, "fwd_lanes_pre", fft_path(uf, "fwd_lanes", a), x.shape,
        lambda: uf.fwd_lanes(x, pre=pre), lambda: uf.fwd_lanes_plain(pre(x)), None,
        nbytes(x) + 2 * nbytes(x) + uf.small_plan_bytes(a),
        fft_flops(a, a) + pre_ops * x.numel(),
        ("composite µ (torch ops) + torch.fft.fft", lambda: torch.fft.fft(pre(x), dim=-1)))])
    x = make((N * N, N), torch.float32, 0.05, 0.5)
    results["fwd_lanes_pre"] = summarise([measure(
        "fwd_lanes_pre", x.shape, lambda: uf.fwd_lanes(x, pre=pre),
        lambda: uf.fwd_lanes_plain(pre(x)), None,
        nbytes(x) + 2 * nbytes(x) + N * 8,
        fft_flops(N * N, N) + pre_ops * x.numel(),
        ("composite µ (torch ops) + torch.fft.fft",
         lambda: torch.fft.fft(pre(x), dim=-1)))])
    del x

    # -- kernels 5 and 6: the last forward axis with the ABM update
    forms = {"lapsq_mobility": (5.0, ("lapsq", -10.0)),
             "sh_no_mobility": (None, ("sh", 0.025, 1.0))}
    args = (0.1, 1.5, -0.5)

    def tables(n, L):
        return (make((n,), torch.float32).abs().contiguous(),
                make((L,), torch.float32).abs().contiguous())

    def composite(m, u, o, kx2, kyz2, mobility, lin):
        """torch.fft.fft along x plus the update in torch ops (a yardstick:
        no single torch call computes the fused function)."""
        mb = torch.fft.fft(m, dim=0)
        k2 = kx2[:, None] + kyz2
        lb = (k2 * k2) * lin[1] if lin[0] == "lapsq" else (
            lin[1] - lin[2] ** 2 * (1.0 - k2) ** 2)
        return sp._update(mb, u, o, *args, lb,
                          None if mobility is None else -k2 * mobility)

    rows_1a = []
    for form, (mobility, lin) in forms.items():
        for n, L in [(64, 300), (200, 300), (384, 300)]:
            m, u, o = (make((n, L), torch.complex64) for _ in range(3))
            kx2, kyz2 = tables(n, L)
            err = check("fwd_x_update", (n, L),
                        sp.fwd_x_update(m, u, o, kx2, kyz2, *args, mobility, lin),
                        sp.fwd_x_update_plain(m, u, o, kx2, kyz2, *args, mobility, lin))
            say(f"[kernels] fwd_x_update {form} ({n}, {L}): max_abs_err {err:.3e}")
        # (200, 200): benchmark 1a's update, measured
        m, u, o = (make((a, a), torch.complex64) for _ in range(3))
        kx2a, kyz2a = tables(a, a)
        rows_1a.append(measure_1a(
            uf, f"fwd_x_update {form}", fft_path(uf, "fwd_sublanes", a), m.shape,
            lambda: sp.fwd_x_update(m, u, o, kx2a, kyz2a, *args, mobility, lin),
            lambda: sp.fwd_x_update_plain(m, u, o, kx2a, kyz2a, *args, mobility, lin),
            None, 5 * nbytes(m) + nbytes(kx2a, kyz2a) + uf.small_plan_bytes(a),
            fft_flops(a, a) + 25 * m.numel(),
            ("composite torch.fft.fft(dim=0) + update (torch ops)",
             lambda: composite(m, u, o, kx2a, kyz2a, mobility, lin))))
        del m, u, o
    results["fwd_x_update small"] = summarise(rows_1a)
    rows = []
    kx2, kyz2 = k2
    L = N * N
    for form, (mobility, lin) in forms.items():
        m, u, o = (make((N, L), torch.complex64) for _ in range(3))
        rows.append(measure(
            f"fwd_x_update {form}", m.shape,
            lambda: sp.fwd_x_update(m, u, o, kx2, kyz2, *args, mobility, lin),
            lambda: sp.fwd_x_update_plain(m, u, o, kx2, kyz2, *args, mobility, lin),
            None, 5 * nbytes(m) + nbytes(kx2, kyz2),
            fft_flops(L, N) + 25 * m.numel(),
            ("composite torch.fft.fft(dim=0) + update (torch ops)",
             lambda: composite(m, u, o, kx2, kyz2, mobility, lin))))
        del m, u, o
    results["fwd_x_update"] = summarise(rows)

    coef = np.asarray([[0.0, -5.0, 0.0, 0.0, -10.0],    # Cahn-Hilliard field
                       [1.0, 0.0, 0.0, -15.0, 0.0]],    # Allen-Cahn field
                      np.float32)
    rows8 = np.concatenate([np.tile(np.asarray(args, np.float32), (2, 1)), coef], 1)
    for n in (64, 200, 384):
        m, u, o = (make((2, n, 300), torch.complex64) for _ in range(3))
        kx2s, kyz2s = tables(n, 300)
        err = check("fwd_x_update_poly", (2, n, 300),
                    sp.fwd_x_update_poly(m, u, o, kx2s, kyz2s, rows8),
                    sp.fwd_x_update_poly_plain(m, u, o, kx2s, kyz2s, rows8))
        say(f"[kernels] fwd_x_update_poly (2, {n}, 300): max_abs_err {err:.3e}")
    m, u, o = (make((2, N, L), torch.complex64) for _ in range(3))
    # kernel 6 locked to kernel 5: field 0's row is the lapsq/mobility form
    lock = check("fwd_x_update_poly vs fwd_x_update", m[0].shape,
                 tuple(t[0] for t in sp.fwd_x_update_poly(m, u, o, kx2, kyz2, rows8)),
                 sp.fwd_x_update(m[0], u[0], o[0], kx2, kyz2, *args, 5.0,
                                 ("lapsq", -10.0)))
    say(f"[kernels] fwd_x_update_poly field 0 against fwd_x_update: "
        f"max_abs_err {lock:.3e}")

    def composite_poly():
        mb = torch.fft.fft(m, dim=1)
        k2t = kx2[:, None] + kyz2
        return [sp._update(mb[f], u[f], o[f], *args,
                           float(coef[f, 3]) * k2t + float(coef[f, 4]) * k2t * k2t,
                           float(coef[f, 0]) + float(coef[f, 1]) * k2t)
                for f in range(2)]

    results["fwd_x_update_poly"] = summarise([measure(
        "fwd_x_update_poly", m.shape,
        lambda: sp.fwd_x_update_poly(m, u, o, kx2, kyz2, rows8),
        lambda: sp.fwd_x_update_poly_plain(m, u, o, kx2, kyz2, rows8),
        None, 5 * nbytes(m) + nbytes(kx2, kyz2),
        2 * fft_flops(L, N) + 25 * m.numel(),
        ("composite torch.fft.fft(dim=1) + update (torch ops)", composite_poly))])
    del m, u, o
    torch.cuda.empty_cache()
    return results


# -- the fused LBM substep ---------------------------------------------------------


def lbm_flops(cfg):
    """Operations a cell: the density and momentum sums, u (three
    quotients, three sums, one product each), |u|², √, and per lattice and
    direction e·u, the equilibrium and the collision: BGK, or the MRT row
    (a product and a sum a non-zero entry), after the Hermite projection's
    sums where the plan has it; on two-lattice plans T, the force and the
    Guo source."""
    q = cfg.q
    nnz = [sum(1 for c in e if c) for e in cfg.e]
    per_q = sum(13 + max(0, k - 1) for k in nnz)
    ops = (q - 1) + sum(nnz) + 16
    if not cfg.collide:
        return ops
    lattices = [(cfg.msm, cfg.proj)]
    if cfg.two_lattice:
        lattices.append((cfg.msm2, cfg.proj2))
        ops += (q - 1) + 12  # T, the force, u += F/(2ρ)
    if cfg.force is not None and cfg.force.apply_tau:
        ops += sum(3 + max(0, k - 1) for k in nnz)
    for msm, proj in lattices:
        ops += per_q
        if msm is not None:
            ops += sum(2 * sum(1 for c in row if c) for row in msm)
        if proj:
            ops += 2 * sum(nnz) * 9 + 2 * q * 9
    if cfg.smag is not None:
        # the flux component, its square, two roots, two quotients, four
        # products and sums
        ops += sum(1 for e in cfg.e if e[0] * e[1]) + 10
    return ops


def lbm_rand(cfg, shape, gen, dev):
    w = torch.tensor(cfg.w, dtype=torch.float32, device=dev)
    return w[:, None, None, None] * (1.0 + 0.05 * torch.randn(
        (cfg.q,) + shape, generator=gen, device=dev))


def ptxas_report(log, describe):
    """One line per kernel of nvcc's -Xptxas=-v output that ``describe``
    names (it maps a mangled entry name to a label, or None to skip):
    registers and spill bytes."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = describe(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return out


def lbm_kernel_name(mangled):
    """lbm_substep_kernel or lbm_brick_kernel <Q, T, TWO, MRT(, HALO)> of a
    mangled entry name, or None."""
    m = re.search(r"lbm_(substep|brick)_kernelILi(\d+)E([fd])Lb([01])ELb([01])E(?:Lb([01])E)?",
                  mangled)
    if not m:
        return None
    kind, q, t, two, mrt, halo = m.groups()
    return (f"lbm_{kind}_kernel<{q}, {'float' if t == 'f' else 'double'}, "
            f"two={two}, mrt={mrt}{'' if halo is None else f', halo={halo}'}>")


FFT_KERNEL = re.compile(
    r"(reg_lanes|reg_sublanes|small_lanes|small_sublanes|tile_lanes|tile_sublanes)_kernel")
TEMPLATE_ARG = re.compile(r"L[ib](\d+)E|NS_(\d+)")


def template_args(mangled, i):
    """The template arguments of a mangled name whose list opens at
    ``mangled[i] == "I"``: ints and bools as digits, the port's functors
    (types in its anonymous namespace, ``NS_<len><name>``, with their own
    arguments) by name; returns (list, index past the list)."""
    out, i = [], i + 1
    while mangled[i] != "E":
        m = TEMPLATE_ARG.match(mangled, i)
        if m is None:
            raise ValueError(mangled)
        if m.group(1) is not None:
            out.append(m.group(1))
            i = m.end()
            continue
        name_end = m.end() + int(m.group(2))
        name, i = mangled[m.end():name_end], name_end
        if mangled[i] == "I":
            inner, i = template_args(mangled, i)
            name += f"<{', '.join(inner)}>"
        if mangled[i] != "E":
            raise ValueError(mangled)
        out.append(name)
        i += 1
    return out, i + 1


def fft_kernel_namer(uf):
    """A ``describe`` for ptxas_report: each FFT kernel with its template
    arguments (the epilogue InvStore marks an inverse kernel); a
    register-resident one (each N) also with the dynamic shared memory a
    block takes at that N."""
    def describe(mangled):
        k = FFT_KERNEL.search(mangled)
        if not k:
            return None
        kind = k.group(1)
        try:
            args = template_args(mangled, k.end())[0] if mangled[k.end()] == "I" else []
        except (ValueError, IndexError):
            return mangled
        label = f"{kind}_kernel<{', '.join(args)}>"
        if not kind.startswith("reg"):  # its shared memory goes by extent
            return label
        smem = uf.LIBRARY.load().mtt_smem(int(args[0]), 128, int(kind == "reg_sublanes"))
        return f"{label} ({smem} B shared memory)"
    return describe


def phase_lbm_kernel(lf, dev):
    """lbm_substep against its twin at 256³ (float32) on every 3-D plan,
    at 800×200 and 4096×2048 on every 2-D plan, and at odd extents; the
    density mean of the Smagorinsky plan against its twin at the same
    extents.  Returns the main-shape rows by plan (2-D plans by plan and
    extent) and the density mean's rows."""
    import dataclasses

    from marlin_tpu_torch.decks import karman_media
    from marlin_tpu_torch.lbm_probe import deck_plans

    gen = torch.Generator(device=dev).manual_seed(1)
    rows, mean_rows = {}, []
    for name, base in deck_plans().items():
        if base.two_d:
            shapes = [s + (1,) for s in LBM_ODD_2D + LBM_2D]
            main = [s + (1,) for s in LBM_2D]
        else:
            shapes = LBM_ODD + [(LBM_N,) * 3]
            main = [(LBM_N,) * 3]
        for shape in shapes:
            cfg = dataclasses.replace(base, nx=shape[0], ny=shape[1], nz=shape[2])
            fpc = lbm_rand(cfg, shape, gen, dev)
            gpc = lbm_rand(cfg, shape, gen, dev) if cfg.two_lattice else None
            media = None
            if cfg.has_media:
                # the code TensorProblem.lbm_media gives: 1 fluid, 0 solid
                if cfg.two_d:
                    # the cylinder at every extent: random media leave NaN
                    # (a zero-gradient face cell copying a solid neighbour)
                    m = torch.as_tensor(karman_media(*shape[:2]), device=dev)[..., None]
                elif shape in main:
                    m = torch.as_tensor(porous_media(shape[0]), device=dev)
                else:
                    m = torch.rand(shape, generator=gen, device=dev) > 0.2
                media = m.to(torch.int8).contiguous()
                fpc = torch.where(media == 0, 0.0, fpc)
                if gpc is not None:
                    gpc = torch.where(media == 0, 0.0, gpc).contiguous()
            fpc = fpc.contiguous()
            step = lf.substepper(fpc, media, cfg, gpc)  # the fused loop's wrapper
            kernel = lambda: step(fpc, gpc)
            twin = lambda: lf.fused_substep_twin(fpc, media, cfg, gpc)
            cells = math.prod(shape)
            lattices = 2 if cfg.two_lattice else 1
            n_bytes = (2 * lattices * nbytes(fpc) + cells * 4
                       + (cells if media is not None else 0))
            if cfg.smag is not None:
                mean_rows += lbm_mean_check(lf, fpc, media, cfg, shape, shape in main)
            if shape not in main:
                err = check(f"lbm_substep {name}", shape, kernel(), twin())
                say(f"[kernels] lbm_substep {name} {shape}: max_abs_err {err:.3e}")
                continue
            say(f"[kernels] lbm_substep {name} {shape}: {walk_text(lf, cfg, fpc.dtype)}")
            row = measure(f"lbm_substep {name}", (lattices, cfg.q) + shape, kernel,
                          twin, None, n_bytes, lbm_flops(cfg) * cells,
                          flop_rate=F32_NO_FMA_FLOP_PER_S)
            say(f"[kernels] lbm_substep {name} {shape}: "
                f"{lattices * cells / (row['ms'] * 1e3):.0f} MLUPS (byte bound "
                f"{lattices * cells / (row['bound_ms'] * 1e3):.0f})")
            rows[name if not cfg.two_d else f"{name} {shape[0]}x{shape[1]}"] = row
            del fpc, gpc, media
            torch.cuda.empty_cache()
    return rows, mean_rows


def walk_text(lf, cfg, dtype):
    """The kernel a plan takes and its walk."""
    walk = lf.walk_plan(cfg, dtype, torch.cuda.get_device_properties(0).multi_processor_count)
    if walk is None:
        return "flat kernel"
    if isinstance(walk, lf.PlanePlan):
        return (f"plane kernel, cooperative grid of {walk.grid} x {walk.threads} threads, "
                f"{min(cfg.nx * cfg.ny, walk.grid * walk.threads)} of {cfg.nx * cfg.ny} cells "
                f"held across the mean")
    return (f"brick kernel, by {walk.by}, {walk.stages} stages, {walk.threads} threads, "
            f"{walk.smem} B shared memory")


def lbm_mean_check(lf, fpc, media, cfg, shape, timed):
    """The Smagorinsky plan's mean density, computed inside the plane
    kernel's launch (7′: no launch of its own), against its twin, as the
    kernel's check: ≤ 1e-5 of the twin's magnitude.  On a main extent also
    its own device time, measured as a difference: the plane kernel's launch
    (the substep with its mean) less the flat kernel's launch of the same
    substep given the twin's mean, in turn (plane, flat, flat, plane); the
    twin's mean alone as the plain time, also by device time; the bound of
    its own work (each cell's q values and media byte read once, its q
    additions)."""
    plane = lf.substepper(fpc, media, cfg)  # the fused loop's wrapper
    _plan, avec = lf._kernel_args(fpc, media, cfg, None, "chip_smoke")
    flat = lf.plan_stepper(fpc, media, cfg, None, lf.pack(cfg), avec)

    def kernel():
        mean = torch.full((), float("nan"), dtype=fpc.dtype, device=fpc.device)
        plane(fpc, None, mean)
        return mean

    twin = lambda: lf.density_mean_twin(fpc, media, cfg)
    err = check("lbm_density_mean", shape, kernel(), twin())
    if not timed:
        say(f"[kernels] lbm_density_mean {shape} (inside lbm_substep): max_abs_err {err:.3e}")
        return []
    given = twin()
    with_mean, without = [], []
    for order in (0, 1):
        runs = [(with_mean, lambda: plane(fpc)), (without, lambda: flat(fpc, None, given))]
        for times, fn in (runs if order == 0 else runs[::-1]):
            times.append(device_ms(fn))
    ms = sum(with_mean) / 2 - sum(without) / 2
    plain = device_ms(twin)
    cells = math.prod(shape)
    n_bytes = cells * (cfg.q * fpc.element_size() + (media is not None))
    bnd, by = bound_ms(n_bytes, cells * cfg.q, F32_NO_FMA_FLOP_PER_S)
    say(f"[kernels] lbm_density_mean {shape} (inside lbm_substep): max_abs_err {err:.3e}, "
        f"device ms: plane launch {sum(with_mean) / 2:.4f} less flat launch given the mean "
        f"{sum(without) / 2:.4f} = {ms:.4f}, twin {plain:.4f}, bound {bnd:.4f} ({by})")
    torch.cuda.empty_cache()
    return [{"shape": list(shape), "max_abs_err": err, "ms": ms, "plain_ms": plain,
             "library_ms": None, "bound_ms": bnd, "bound_by": by,
             "plane_launch_ms": sum(with_mean) / 2, "flat_launch_ms": sum(without) / 2}]


def device_ms(fn, calls=20):
    """Device ms a call: the time of the kernels ``fn`` launches, by
    torch.profiler over ``calls`` calls (at 800×200 the host cannot keep
    the card busy, so CUDA events would time the host), its trace the
    device's activity alone (a twin's host trace takes seconds to read)."""
    return device_profile(fn, calls, cpu=False)[0]


def device_profile(fn, calls=20, warm=True, cpu=True):
    """(device ms, device operations) a call of ``fn``, by torch.profiler
    over ``calls`` calls (after one untraced call with ``warm``); without
    ``cpu`` the trace holds the device's activity alone (quicker to read
    where a call makes thousands of launches)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA] + (
        [torch.profiler.ProfilerActivity.CPU] if cpu else [])
    # a trace now and then comes back without its device activity: such a
    # trace is taken again, and three empty ones in a row fail the run
    for _attempt in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in device)
        if us > 0:
            return us / calls / 1e3, sum(e.count for e in device) / calls
        say(f"[profile] a trace of {calls} calls saw no device time; taking it again")
    raise AssertionError(f"the profiler saw no device time in {PROFILE_ATTEMPTS} traces")


LBM_PATHS = {
    # deck: (compared buffers, fluid mass conserved, lattices)
    "porous": (("f", "fpc", "density", "velocity", "speed"), True, 1),
    "mixed": (("f", "fpc", "density", "velocity", "speed"), False, 1),
    "thermal": (("f", "fpc", "g", "gpc", "density", "T", "velocity"), True, 2),
    "pebbles": (("f", "fpc", "g", "gpc", "density", "T", "velocity"), True, 2),
}


@functools.lru_cache(maxsize=None)
def _porous_media(n):
    from marlin_tpu_torch import decks

    return decks.porous_media(n)


def porous_media(n):
    """A copy of decks.porous_media(n), drawn once a run (a second at 256³
    on the host; phases 2, 7-10, 14 and 18 each take it)."""
    return _porous_media(n).copy()


def lbm_deck(name, backend):
    """(deck text at LBM_N³ in float32 with LBM_STEPS steps, arrays)."""
    import re

    from marlin_tpu_torch import decks

    fmt = dict(substeps=LBM_SUBSTEPS, backend=backend)
    arrays = None
    if name == "porous":
        deck = decks.POROUS_DECK.format(n=LBM_N, media_h5="media.h5", **fmt)
        arrays = {"media": porous_media(LBM_N)}
    elif name == "mixed":
        deck = decks.MIXED_DECK.format(n=LBM_N, **fmt)
    elif name == "thermal":
        deck = decks.THERMAL3D_DECK.format(n=LBM_N, **fmt)
    else:
        deck = decks.PEBBLES_DECK.format(nx=LBM_N, ny=LBM_N, nz=LBM_N,
                                         media_h5="media.h5", **fmt)
        arrays = {"media": porous_media(LBM_N)}
    deck = deck.replace("[Domain]", "[Domain]\n  floating_precision = SINGLE")
    deck = re.sub(r"\[Executioner\]\n(  .*\n)*\[\]\n", "", deck)
    assert "[Executioner]" not in deck, name
    deck += f"""
[Executioner]
  type = Transient
  num_steps = {LBM_STEPS}
[]
"""
    return deck, arrays


def lbm_run(name, backend, dev):
    """run_deck on an LBM deck at LBM_N³, float32; returns (transient, wall
    seconds, launches)."""
    from marlin_tpu_torch import hit
    from marlin_tpu_torch import lbm_fused as lf
    from marlin_tpu_torch.executioner import run_deck

    deck, arrays = lbm_deck(name, backend)
    lf.reset_launches()
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = run_deck(hit.parse(deck), output_dir=out_dir, device=dev, arrays=arrays)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return tr, wall, lf.launches()["lbm_substep"]


def lbm_substep_ms(tr, substeps=LBM_SUBSTEPS):
    """Device time of one more step of the finished run, a substep: the
    run's own steps warmed it (the eager JNP chain takes up to 0.2 s a
    substep at 256³, so one step is timed, not three)."""
    p, st = tr.problem, tr.state
    ms = cuda_ms(lambda: p.step(st, tr.time, 1.0, 1.0, False), reps=1, warmup=0)
    return ms / substeps


def fluid_mass(state, solid):
    rho = state["buffers"]["density"].double()
    return rho[~solid].sum().item()


def phase_lbm_path(name, dev):
    """One LBM deck on PALLAS and JNP: launches, PALLAS against JNP, mass,
    ms a substep and MLUPS.  Returns (PALLAS launches, PALLAS ms, JNP ms)."""
    keys, mass_check, lattices = LBM_PATHS[name]
    cells = LBM_N ** 3
    out = {}
    for backend in ("PALLAS", "JNP"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr, wall, launched = lbm_run(name, backend, dev)
        # the first MOOSE step runs no substeps; the last substep of each
        # step is the kernel's final form where the plan has one (one
        # lattice), else the eager chain's
        want = 0
        if backend == "PALLAS":
            eager_last = tr.problem._lbm_fused_plan.final is None
            want = (LBM_STEPS - 1) * (LBM_SUBSTEPS - eager_last)
        say(f"[lbm {name}] {backend} {LBM_N}^3, {LBM_STEPS} steps x {LBM_SUBSTEPS} "
            f"substeps: run_deck {wall:.2f} s, lbm_substep launches {launched} "
            f"(expected {want}), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        assert launched == want, (name, backend, launched, want)
        for k, v in tr.state["buffers"].items():
            assert bool(torch.isfinite(v).all()), (name, backend, k)
        ms = lbm_substep_ms(tr)
        say(f"[lbm {name}] {backend} {ms:.3f} ms/substep, "
            f"{lattices * cells / (ms * 1e3):.0f} MLUPS ({lattices} lattice"
            f"{'s' if lattices > 1 else ''})")
        problem = tr.problem
        solid = problem.lbm_solid_mask()
        if solid is None:
            solid = torch.zeros((LBM_N,) * 3, dtype=torch.bool, device=dev)
        else:
            say(f"[lbm {name}] solid fraction {solid.double().mean().item():.4f}")
        if mass_check:
            # the deck starts every fluid cell at density 1
            m0 = float((~solid).sum().item())
            m1 = fluid_mass(tr.state, solid)
            say(f"[lbm {name}] {backend} fluid mass {m0:.6f} -> {m1:.6f}")
            assert abs(m1 - m0) <= MASS_TOL * m0, (name, backend, m0, m1)
        out[backend] = (tr.state["buffers"], ms, launched)
        if name == "porous":  # phase 18's serial anchor
            SERIAL[f"porous {backend}"] = {k: tr.state["buffers"][k].cpu()
                                           for k in ("fpc", "density", "speed")}
        del tr, problem
    for k in keys:
        a, b = out["PALLAS"][0][k], out["JNP"][0][k]
        d = (a - b).abs().max().item()
        mag = b.abs().max().item()
        say(f"[lbm {name}] max|{k}_PALLAS - {k}_JNP| {d:.3e} (limit "
            f"{KERNEL_TOL} x {mag:.4e})")
        assert d <= KERNEL_TOL * mag, (name, k, d, mag)
    return out["PALLAS"][2], out["PALLAS"][1], out["JNP"][1]


def karman_deck(backend):
    """decks.KARMAN_DECK at its shipped 800×200 in float32, KARMAN_SUBSTEPS
    substeps × LBM_STEPS steps; (text, arrays)."""
    from marlin_tpu_torch import decks

    nx, ny = KARMAN
    deck = decks.KARMAN_DECK.format(nx=nx, ny=ny, substeps=KARMAN_SUBSTEPS,
                                    backend=backend)
    deck = deck.replace("[Domain]", "[Domain]\n  floating_precision = SINGLE")
    deck = deck.replace("  num_steps = 3\n", f"  num_steps = {LBM_STEPS}\n")
    return deck, {"binary_media": decks.karman_media(nx, ny)}


def phase_karman(dev):
    """The Kármán deck at 800×200 on PALLAS and JNP: launches, PALLAS
    against JNP, ms a substep, MLUPS, peak memory.  Returns (launches of
    PALLAS, PALLAS ms, JNP ms)."""
    from marlin_tpu_torch import hit
    from marlin_tpu_torch import lbm_fused as lf
    from marlin_tpu_torch.executioner import run_deck

    cells = KARMAN[0] * KARMAN[1]
    fused = (LBM_STEPS - 1) * (KARMAN_SUBSTEPS - 1)
    out = {}
    for backend in ("PALLAS", "JNP"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by earlier phases' live objects
        deck, arrays = karman_deck(backend)
        lf.reset_launches()
        with tempfile.TemporaryDirectory() as out_dir:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr = run_deck(hit.parse(deck), output_dir=out_dir, device=dev, arrays=arrays)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched = lf.launches()
        # one launch a fused substep, its mean density inside it
        want = ({"lbm_substep": fused, "lbm_density_mean": fused} if backend == "PALLAS"
                else {"lbm_substep": 0, "lbm_density_mean": 0})
        say(f"[karman] {backend} {KARMAN[0]}x{KARMAN[1]}, {LBM_STEPS} steps x "
            f"{KARMAN_SUBSTEPS} substeps: run_deck {wall:.2f} s, launches {launched} "
            f"(expected {want}), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, of which "
            f"{held / 2**30:.3f} GiB held before the run")
        assert launched == want, (backend, launched, want)
        for k, v in tr.state["buffers"].items():
            assert bool(torch.isfinite(v).all()), (backend, k)
        ms = lbm_substep_ms(tr, KARMAN_SUBSTEPS)
        say(f"[karman] {backend} {ms:.4f} ms/substep, {cells / (ms * 1e3):.0f} MLUPS; "
            f"max speed {tr.state['buffers']['speed'].max().item():.5f}")
        out[backend] = (tr.state["buffers"], ms, launched)
        del tr
    for k in ("f", "fpc", "feq", "density", "velocity", "speed"):
        a, b = out["PALLAS"][0][k], out["JNP"][0][k]
        d = (a - b).abs().max().item()
        mag = b.abs().max().item()
        say(f"[karman] max|{k}_PALLAS - {k}_JNP| {d:.3e} (limit {KERNEL_TOL} x {mag:.4e})")
        assert d <= KERNEL_TOL * mag, (k, d, mag)
    return out["PALLAS"][2], out["PALLAS"][1], out["JNP"][1]


HOST_CALLS = 1000


def karman_host_us(lf, dev):
    """The host's µs a fused Kármán substep at 800×200: the fused loop's
    wrapper (``substepper``'s step), HOST_CALLS back-to-back calls with one
    sync, over HOST_CALLS (the device's time a substep is well below it)."""
    import dataclasses

    from marlin_tpu_torch.decks import karman_media
    from marlin_tpu_torch.lbm_probe import deck_plans

    cfg = dataclasses.replace(deck_plans()["karman"], nx=KARMAN[0], ny=KARMAN[1])
    gen = torch.Generator(device=dev).manual_seed(2)
    media = torch.as_tensor(karman_media(*KARMAN), device=dev)[..., None].to(torch.int8)
    fpc = torch.where(media == 0, 0.0, lbm_rand(cfg, KARMAN + (1,), gen, dev)).contiguous()
    step = lf.substepper(fpc, media, cfg)
    step(fpc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        step(fpc)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / HOST_CALLS


def transient(deck, dt, buffer):
    return deck + f"""
[Executioner]
  type = Transient
  num_steps = {STEPS}
  dt = {dt}
[]
[Postprocessors]
  [mean]
    type = TensorAveragePostprocessor
    buffer = {buffer}
    execute_on = 'INITIAL TIMESTEP_END'
  []
  [max]
    type = TensorExtremeValuePostprocessor
    buffer = {buffer}
    value_type = MAX
  []
[]
[Outputs]
  csv = true
[]
"""


def ch3d_deck(backend, solver_extra=""):
    from marlin_tpu_torch.decks import CH3D_DECK

    deck = CH3D_DECK.format(n=N, substeps=SUBSTEPS).replace(
        "[Domain]",
        f"[Domain]\n  fft_backend = {backend}\n  floating_precision = SINGLE")
    if solver_extra:
        deck = deck.replace("[TensorSolver]", f"[TensorSolver]\n  {solver_extra}")
    return transient(deck, 1, "c")


def multi_deck(solver_extra):
    from marlin_tpu_torch.decks import MULTI_3D_DECK

    deck = MULTI_3D_DECK.format(
        n=N, domain_extra="fft_backend = PALLAS\n  floating_precision = SINGLE",
        solver_extra=solver_extra).replace("substeps = 5",
                                           f"substeps = {SUBSTEPS}")
    return transient(deck, MULTI_DT, "c")


def run_main_path(deck, dev):
    """run_deck on a deck (its CSV into a temporary directory); returns
    (transient, wall seconds)."""
    from marlin_tpu_torch import hit
    from marlin_tpu_torch.executioner import run_deck

    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = run_deck(hit.parse(deck), output_dir=out_dir, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return tr, wall


def substep_ms(tr, dt, reps=2):
    """Device time of ``reps`` more steps of the finished run, a substep
    (after one more untimed step where ``reps`` > 1)."""
    p, st = tr.problem, tr.state
    ms = cuda_ms(lambda: p.step(st, tr.time, dt, dt, False), reps=reps,
                 warmup=1 if reps > 1 else 0)
    return ms / SUBSTEPS


def mass(tr, label):
    rows = tr.csv.rows
    m0, m1 = rows[0]["mean"], rows[-1]["mean"]
    say(f"[{label}] mean(c) {m0:.9f} -> {m1:.9f}, max(c) {tr.pp_values['max']:.6f}")
    assert abs(m1 - m0) <= MASS_TOL, (label, m0, m1)


def counters(uf, sp):
    return {**uf.launches(), **sp.launches()}


def reset(uf, sp):
    uf.reset_launches()
    sp.reset_launches()


# -- benchmark 1a ------------------------------------------------------------------


def bench_1a_deck(run, warm=False):
    """decks.BENCH_1A_DECK at 200², 1000 substeps a step, for one of
    BENCH_1A_RUNS; the warm-up is BENCH_1A_WARM_STEPS steps without the perf
    graph."""
    from marlin_tpu_torch.bench_1a_runs import deck_text

    deck = deck_text(BENCH_1A_RUNS[run], BENCH_1A_N, BENCH_1A_SUBSTEPS)
    if warm:
        deck = deck.replace("  perf_graph = true\n", "")
    steps = BENCH_1A_WARM_STEPS if warm else BENCH_1A_CUT.get(run)
    if steps:
        deck = deck.replace("  end_time = 10500\n",
                            f"  end_time = 10500\n  num_steps = {steps}\n")
    return deck


def bench_1a_launches(run, steps, substeps, initial=True):
    """Each kernel's launches in a 2-D 1a run of ``steps`` steps: the solve
    chain's every substep, and the postprocess group (FFTGradientSquare of
    c: one forward transform, lanes then sublanes, and two inverse ones,
    sublanes then lanes) at INITIAL (``initial``: not on a run resumed from
    a checkpoint) and every TIMESTEP_END."""
    zero = {"fwd_lanes": 0, "fwd_lanes_pre": 0, "fwd_sublanes": 0, "inv_sublanes": 0,
            "inv_lanes": 0, "fwd_x_update": 0, "fwd_x_update_poly": 0}
    if not run.startswith("PALLAS"):
        return zero
    S, groups = substeps, steps + int(initial)
    if "fused" in run:
        # a step: the ū seed fft(c); S - 1 fused substeps, each µ fused into
        # the lanes read, the x axis with the update, and ifft(ū); the
        # trailing regular substep fft(µ) and ifft(ū) (fft(c) is pruned)
        solve = {"fwd_lanes": 2, "fwd_lanes_pre": S - 1, "fwd_sublanes": 2,
                 "fwd_x_update": S - 1, "inv_sublanes": S, "inv_lanes": S}
    else:
        # a substep: fft(µ) and fft(c), then ifft(ū)
        solve = {"fwd_lanes": 2 * S, "fwd_sublanes": 2 * S,
                 "inv_sublanes": S, "inv_lanes": S}
    group = {"fwd_lanes": 1, "fwd_sublanes": 1, "inv_sublanes": 2, "inv_lanes": 2}
    return {k: steps * solve.get(k, 0) + groups * group.get(k, 0) for k in zero}


def free_energy_numpy(n, full_spectrum):
    """F(0) of the 1a deck on its n² grid (h = 1), independent of both
    packages: the initial condition in numpy float64, its gradient by the
    periodic spectral derivative, f = 5(c−0.3)²(0.7−c)² + |∇c|² summed over
    the cells.  The initial condition is not periodic on the box, so the
    Nyquist frequencies carry weight and each backend's convention is
    followed: DEFAULT the reference's half spectrum along the last axis
    (numpy's rfft2, that axis' Nyquist positive), PALLAS the full spectrum
    (``full_spectrum``: numpy's fft2, the real part; every Nyquist
    negative).  At 200² the two differ by 1.2e-6 of F(0)."""
    x = np.arange(n) + 0.5
    X, Y = np.meshgrid(x, x, indexing="ij")
    c = 0.5 + 0.01 * (np.cos(0.105 * X) * np.cos(0.11 * Y)
                      + (np.cos(0.13 * X) * np.cos(0.087 * Y)) ** 2
                      + np.cos(0.025 * X - 0.15 * Y) * np.cos(0.07 * X - 0.02 * Y))
    kx = 2 * np.pi * np.fft.fftfreq(n, d=1.0)[:, None]
    if full_spectrum:
        ky = kx.T
        ch = np.fft.fft2(c)
        gx, gy = (np.fft.ifft2(1j * k * ch).real for k in (kx, ky))
    else:
        ky = 2 * np.pi * np.fft.rfftfreq(n, d=1.0)[None, :]
        ch = np.fft.rfft2(c)
        gx, gy = (np.fft.irfft2(1j * k * ch, s=(n, n)) for k in (kx, ky))
    return float(np.sum(5 * (c - 0.3) ** 2 * (0.7 - c) ** 2 + gx ** 2 + gy ** 2))


@functools.lru_cache(None)
def bench_1a_f0():
    """F(0) of benchmark 1a by numpy in float64, {full spectrum: F}."""
    f0_refs = {full: free_energy_numpy(BENCH_1A_N, full) for full in (False, True)}
    say(f"[1a] F(0) by numpy float64 {f0_refs[False]:.9f} (half spectrum, DEFAULT), "
        f"{f0_refs[True]:.9f} (full spectrum, PALLAS); PFHub, prismspf: {PFHUB_F0} "
        f"(information only)")
    return f0_refs


def phase_bench_1a(uf, sp, dev, smi, runs=tuple(BENCH_1A_RUNS), done=None):
    """Benchmark 1a whole, four times (BENCH_1A_RUNS), each after a warm-up
    of BENCH_1A_WARM_STEPS steps that builds and loads its kernels; the
    gates of each run, then, once every run is in ``done``, across runs.
    ``runs`` are the runs to make now, ``done`` the results of those made
    before (the float64 reference, which needs no kernel of the port, runs
    while the libraries build).  Returns {run: result}."""
    from marlin_tpu_torch import hit
    from marlin_tpu_torch.executioner import run_deck

    f0_refs = bench_1a_f0()
    out = dict(done or {})
    for run in runs:
        with tempfile.TemporaryDirectory() as out_dir:
            run_deck(hit.parse(bench_1a_deck(run, warm=True)), output_dir=out_dir,
                     device=dev)
            torch.cuda.synchronize()
            gc.collect()  # the earlier phases' problems, held in reference cycles
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            reset(uf, sp)
            t0 = time.perf_counter()
            tr = run_deck(hit.parse(bench_1a_deck(run)), output_dir=out_dir, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched = counters(uf, sp)
        rows = tr.csv.rows
        c = tr.state["buffers"]["c"]
        dtype = tr.problem.domain.dtype
        sub = tr.step_count * BENCH_1A_SUBSTEPS
        peak = torch.cuda.max_memory_allocated()
        say(f"[1a] {run}: {wall:.3f} s to t = {tr.time} ({tr.step_count} steps x "
            f"{BENCH_1A_SUBSTEPS} substeps), {1e3 * wall / sub:.5f} ms a substep, "
            f"F_final {rows[-1]['F']:.9f}, peak device memory {peak / 2**20:.1f} MiB "
            f"({held / 2**20:.1f} MiB held before the run); {smi}; beside "
            f"{REFERENCE_1A}")
        say(f"[1a] {run} perf graph: " + ", ".join(
            f"{name} {secs:.3f} s x{calls}" for name, (secs, calls)
            in sorted(tr.perf.sections.items(), key=lambda kv: -kv[1][0])))
        # -- the gates of one run
        want = bench_1a_launches(run, tr.step_count, BENCH_1A_SUBSTEPS)
        say(f"[1a] {run} launches {launched} (expected {want})")
        assert launched == want, (run, launched, want)
        assert c.shape == (BENCH_1A_N,) * 2 and c.dtype == dtype
        assert bool(torch.isfinite(c).all()), run
        f0, f0_ref = rows[0]["F"], f0_refs[run.startswith("PALLAS")]
        say(f"[1a] {run} F(0) {f0:.9f}, relative to numpy "
            f"{abs(f0 - f0_ref) / f0_ref:.3e} (limit {BENCH_1A_F0_TOL[dtype]})")
        assert abs(f0 - f0_ref) <= BENCH_1A_F0_TOL[dtype] * f0_ref, (run, f0, f0_ref)
        m0, tol = rows[0]["c_integral"], BENCH_1A_MASS_TOL[dtype]
        drift = max(abs(r["c_integral"] - m0) for r in rows) / m0
        slot = max(abs(r["mass"] - r["c_integral"]) for r in rows[1:]) / m0
        say(f"[1a] {run} c_integral drift {drift:.3e}, |mass - c_integral| {slot:.3e} "
            f"(relative, limit {tol}); c in [{rows[-1]['c_min']:.6f}, "
            f"{rows[-1]['c_max']:.6f}], last change {rows[-1]['change']:.3e}")
        assert drift <= tol and slot <= tol, (run, drift, slot)
        out[run] = (tr.step_count, tr.time, [(r["time"], r["F"]) for r in rows],
                    launched, wall)
        del tr, c
    if len(out) < len(BENCH_1A_RUNS):
        return out
    # -- across runs: the float64 DEFAULT run is the reference
    steps, t_end, ref, _l, _w = out["DEFAULT float64"]
    f_ref = dict(ref)
    t_early, early_tol = BENCH_1A_EARLY
    for run, (n, t, series, _l, _w) in out.items():
        if run in BENCH_1A_CUT:
            # the same times as the float64 run's first steps
            assert n == BENCH_1A_CUT[run] and [tt for tt, _F in series] == [
                tt for tt, _F in ref[:len(series)]], (run, n, t)
        else:
            assert (n, t) == (steps, t_end), (run, n, t, steps, t_end)
        if run == "DEFAULT float64":
            continue
        early = max(abs(F - f_ref[tt]) / f_ref[tt] for tt, F in series if tt <= t_early)
        last_t, last_F = series[-1]
        last = abs(last_F - f_ref[last_t]) / f_ref[last_t]
        last_tol = early_tol if run in BENCH_1A_CUT else BENCH_1A_FINAL_TOL
        say(f"[1a] {run} against DEFAULT float64: F while t <= {t_early} within "
            f"{early:.3e} (limit {early_tol}), {'last' if run in BENCH_1A_CUT else 'final'} F "
            f"(step {n}, t = {last_t}) {last:.3e} (limit {last_tol})")
        assert early <= early_tol and last <= last_tol, (run, early, last)
    cut = ", ".join(f"{r} cut to {k}" for r, k in BENCH_1A_CUT.items())
    say(f"[1a] every run {steps} steps to t = {t_end} ({cut}); {smi}")
    return out


# -- outputs and restart --------------------------------------------------------------


def states_equal(a, b):
    """Every buffer, history slot and solver entry bit for bit, and the
    advance count and dt ring."""
    for part in ("buffers", "old", "solver"):
        assert set(a[part]) == set(b[part]), part
        for k, v in a[part].items():
            w = b[part][k]
            if not isinstance(v, torch.Tensor):
                # an iterative solver's host counts
                assert v == w and type(v) is type(w), (part, k, v, w)
                continue
            assert v.dtype == w.dtype and v.shape == w.shape, (part, k)
            assert torch.equal(v, w), (part, k)
    assert a["n_advances"] == b["n_advances"], (a["n_advances"], b["n_advances"])
    assert a["old_dt"] == b["old_dt"], (a["old_dt"], b["old_dt"])


def resume_runs(deck, steps, at, out_dir, dev, counters_of, reset_all, arrays=None,
                mesh=None):
    """``deck`` run ``steps`` steps uninterrupted, ``at`` steps with a
    checkpoint at the end, and resumed from that checkpoint to ``steps``;
    each run_deck in its own directory under ``out_dir`` (on ``mesh`` where
    given), the launch counts set to 0 just before each and read just
    after.  Returns {run:
    (transient, launches, seconds)}."""
    from marlin_tpu_torch import hit
    from marlin_tpu_torch.executioner import run_deck

    def root(n, interval):
        r = hit.parse(deck)
        ex = r.child("Executioner")
        ex.set_param("num_steps", str(n))
        ex.set_param("checkpoint_interval", str(interval))
        return r

    out = {}
    for run, n, interval, recover in (
            ("full", steps, at, None), ("part", at, at, None),
            ("resumed", steps, at, "part")):
        reset_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = run_deck(root(n, interval), output_dir=os.path.join(out_dir, run), device=dev,
                      arrays=arrays, deck_stem="field", mesh=mesh,
                      recover=recover and out[recover][0].checkpoint_path)
        torch.cuda.synchronize()
        out[run] = (tr, counters_of(), time.perf_counter() - t0)
    return out


def text(*path):
    with open(os.path.join(*path)) as f:
        return f.read()


def checkpoint_seconds(tr, dev):
    """Seconds to write the finished transient's checkpoint again (the
    same file) and to read it onto the card; (write s, read s, state)."""
    from marlin_tpu_torch import checkpoint

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.save_checkpoint()
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, _meta = checkpoint.load(tr.checkpoint_path, dev)
    torch.cuda.synchronize()
    return write_s, time.perf_counter() - t0, state


def output_ms(tr):
    """ms of one more output of each kind on the finished run's state, its
    gates already read: each field output (XDMF with its writer thread
    joined; Exodus collects a frame), the vector postprocessors, the CSV."""
    def ms(fn):
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)

    out = {}
    for o in tr.tensor_outputs:
        if getattr(o, "wants_pp_values", False):
            call = lambda: o.output(tr.problem, tr.state, tr.time, pp_values=tr.pp_values)
        else:
            call = lambda: (o.output(tr.problem, tr.state, tr.time), o.wait())
        out[type(o).__name__] = ms(call)
    out["vector postprocessors"] = ms(lambda: tr._write_vpps("TIMESTEP_END"))
    out["CSV"] = ms(lambda: (tr.csv.add_row(tr.time, dict(tr.pp_values)), tr.csv.write()))
    return out


def truncated_xmf(path, keep_from, dest):
    """A copy of the XDMF series ``path`` without its first ``keep_from``
    frames (their .bin files stay where they are)."""
    import xml.etree.ElementTree as ET

    tree = ET.parse(path)
    for dom in tree.getroot():
        for grid in dom:
            if grid.get("CollectionType") == "Temporal":
                for frame in list(grid)[:keep_from]:
                    grid.remove(frame)
    tree.write(dest)
    return dest


def phase_outputs(uf, sp, lf, dev, smi):
    """Phase 13: benchmark 1a fused and Kármán with their field outputs,
    histogram and checkpoint, and each resumed from its checkpoint: bit for
    bit equal to the uninterrupted run, with exact launch counts.  Returns
    {path: launches} over the phase's runs."""
    import io

    from marlin_tpu_torch import xdmfdiff
    from marlin_tpu_torch.bench_1a_runs import deck_text
    from marlin_tpu_torch.exodus import read_exodus

    steps, at = RESUME_1A
    run = "PALLAS fused float32"
    deck = deck_text(BENCH_1A_RUNS[run], BENCH_1A_N, BENCH_1A_SUBSTEPS) + OUTPUTS_1A
    deck = deck.replace("  csv = true\n", "  csv = true\n  exodus = true\n").replace(
        "[Postprocessors]\n", "[Postprocessors]\n  [c_avg]\n    type = ElementAverageValue\n"
        "    variable = c_aux\n  []\n", 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by earlier phases' live objects
    launches = {}
    with tempfile.TemporaryDirectory() as out_dir:
        runs = resume_runs(deck, steps, at, out_dir, dev, lambda: counters(uf, sp),
                           lambda: reset(uf, sp))
        peak = torch.cuda.max_memory_allocated()
        full, _l, s_full = runs["full"]
        part = runs["part"][0]
        res, _l, s_res = runs["resumed"]
        for name, (_tr, got, _s) in runs.items():
            launches[f"13 outputs 1a {name}"] = got
        # -- launches: phase 12's formula
        for name, n, initial in (("full", steps, True), ("part", at, True),
                                 ("resumed", steps - at, False)):
            want = bench_1a_launches(run, n, BENCH_1A_SUBSTEPS, initial)
            got = runs[name][1]
            say(f"[outputs 1a] {name}: {runs[name][0].step_count} steps, launches {got} "
                f"(expected {want})")
            assert got == want, (name, got, want)
        # -- the resumed run against the uninterrupted one, bit for bit
        assert res.step_count == full.step_count == steps and res.time == full.time
        states_equal(res.state, full.state)
        assert res.state["buffers"]["cbar"].dtype == torch.complex64
        assert res.pp_values == full.pp_values, (res.pp_values, full.pp_values)
        d_full, d_res = (os.path.join(out_dir, r) for r in ("full", "resumed"))
        rows = lambda d: text(d, "out.csv").splitlines()
        assert rows(d_res)[1:] == rows(d_full)[at + 2:], "CSV rows after the checkpoint"
        assert len(rows(d_full)) == steps + 2
        for i in range(at + 1, steps + 1):
            name = f"out_c_hist_{i:04d}.csv"
            assert text(d_res, name) == text(d_full, name), name
        series = io.StringIO()
        tail = truncated_xmf(os.path.join(d_full, "field.xmf"), at + 1,
                             os.path.join(d_full, "field_tail.xmf"))
        fails = xdmfdiff.compare(tail, os.path.join(d_res, "field.xmf"), rtol=0.0, atol=0.0,
                                 out=series)
        say(f"[outputs 1a] xdmfdiff frames {at + 1}-{steps}, zero tolerance: {fails} "
            f"failures")
        assert fails == 0, series.getvalue()
        c = full.state["buffers"]["c"]
        frame = np.fromfile(os.path.join(d_full, f"field.c.{steps}.bin"), dtype=np.float32)
        assert np.array_equal(frame.reshape(BENCH_1A_N, BENCH_1A_N).T, c.cpu().numpy())
        exo = read_exodus(os.path.join(d_full, "out.e"))
        assert len(exo["time"]) == steps + 1 and exo["time"][-1] == full.time
        assert np.array_equal(exo["nodal"]["c_aux"][-1].reshape(
            BENCH_1A_N + 1, BENCH_1A_N + 1, order="F")[:-1, :-1], c.double().cpu().numpy())
        assert exo["glo"]["c_avg"][-1] == full.pp_values["c_avg"]
        # -- sizes and seconds
        path = part.checkpoint_path
        write_s, read_s, state = checkpoint_seconds(part, dev)
        states_equal(state, part.state)
        out_s, out_calls = full.perf.sections["outputs"]
        res_s, _calls = res.perf.sections["outputs"]
        say(f"[outputs 1a] {run} {BENCH_1A_N}^2, {steps} steps x {BENCH_1A_SUBSTEPS} "
            f"substeps: run_deck {s_full:.3f} s uninterrupted, {s_res:.3f} s resumed "
            f"({steps - at} steps); perf graph outputs {out_s:.4f} s in {out_calls} calls, "
            f"{out_s / steps:.5f} s a step (XDMF, Exodus, CSV, histogram; the first "
            f"scipy import and the Exodus file at the end), resumed run "
            f"{res_s / (steps - at):.5f} s a step; one more output, ms: "
            + ", ".join(f"{k} {v:.3f}" for k, v in output_ms(full).items())
            + f"; checkpoint {os.path.getsize(path)} bytes, written in "
            f"{write_s:.4f} s, read onto the card in {read_s:.4f} s; peak "
            f"device memory {peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB held before "
            f"the runs); {smi}")
        say(f"[outputs 1a] resumed run bit for bit: c, cbar ({res.state['buffers']['cbar'].dtype}),"
            f" the old ring, solver, n_advances {res.state['n_advances']}, old_dt "
            f"{res.state['old_dt']}, {len(res.pp_values)} pp values; CSV rows and "
            f"histograms {at + 1}-{steps}; .e {len(exo['time'])} times")
        del runs, full, part, res, state, c

    # -- Kármán on PALLAS
    steps, at = RESUME_KARMAN
    deck, arrays = karman_deck("PALLAS")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as out_dir:
        runs = resume_runs(deck, steps, at, out_dir, dev, lf.launches, lf.reset_launches,
                           arrays=arrays)
        peak = torch.cuda.max_memory_allocated()
        full, part, res = (runs[k][0] for k in ("full", "part", "resumed"))
        for name, n in (("full", steps - 1), ("part", at - 1), ("resumed", steps - at)):
            got = runs[name][1]
            want = {"lbm_substep": n * (KARMAN_SUBSTEPS - 1),
                    "lbm_density_mean": n * (KARMAN_SUBSTEPS - 1)}
            launches[f"13 outputs karman {name}"] = got
            say(f"[outputs karman] {name}: {runs[name][0].step_count} steps, launches "
                f"{got} (expected {want})")
            assert got == want, (name, got, want)
        assert res.step_count == full.step_count == steps
        for k in ("f", "feq", "density", "velocity", "speed"):
            assert torch.equal(res.state["buffers"][k], full.state["buffers"][k]), k
        states_equal(res.state, full.state)
        path = part.checkpoint_path
        write_s, read_s, state = checkpoint_seconds(part, dev)
        states_equal(state, part.state)
        say(f"[outputs karman] PALLAS {KARMAN[0]}x{KARMAN[1]}, {steps} steps x "
            f"{KARMAN_SUBSTEPS} substeps: run_deck {runs['full'][2]:.3f} s uninterrupted, "
            f"{runs['resumed'][2]:.3f} s resumed; resumed bit for bit (f, feq, density, "
            f"velocity, speed and the whole state); checkpoint {os.path.getsize(path)} "
            f"bytes, written in {write_s:.4f} s, read onto the card in {read_s:.4f} s; "
            f"peak device memory "
            f"{peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB held before the runs); {smi}")
        del runs, full, part, res, state
    return launches


# -- phase 14: the rest of lattice Boltzmann and the spectral family ----------------

TWOPHASE = (512, 3, 20)  # n, steps, substeps (the first step runs no substeps)
TWOPHASE_MASS_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}  # relative
PRECISION_TOL = 1e-4  # float32 against float64, of the float64 buffer's largest
PRESSURE = (256, 2, 5)
SPECULAR = (800, 200, 3, 40)
SPECULAR_MAX_U = 0.02  # twice the initial 0.01: a pumped channel shows as growth
SBM = (512, 2, 40)  # n, steps, substeps; dt 1 a step
# PALLAS against DEFAULT float32, and float32 against float64, each buffer of
# the spectral-family deck: max |Δ| over the reference buffer's largest.  Each
# limit is about twice the larger of the two readings on the H100 at SBM's
# depth (PERF.md §6 lists them side by side), at least 1e-6 and at most 1e-4
SBM_TOL = {
    "grad_c_sq": 1e-4, "lap_c": 1e-4, "grad_c": 1e-4, "c": 7e-5,
    "c_flux": 3e-5, "mu": 3e-5, "dfdc": 3e-5, "c_rate": 2e-5,
    "dF_deta": 7e-6, "eta": 6e-6, "eta_raw": 5e-6, "eta_rate": 5e-6,
    "etabar": 4e-6, "cbar": 3e-6, "mobility": 3e-6, "grad_c_peak": 2e-6,
    "dealias": 2e-6, "c_linear": 1e-6, "psi": 1e-6, "eta_linear": 1e-6,
    "L": 1e-6,
}
OSTWALD = (200, 2, 20)  # n, steps, substeps
OSTWALD_DT = 0.04  # a step: substeps of 0.002, where the explicit terms are stable
PROFILED_SUBSTEPS = 5  # the step whose device time the profiler reads
BATCH_TOL = {torch.float64: 1e-12, torch.float32: 1e-6}  # DEFAULT batched/unbatched
BATCH_FALLBACK_TOL = 1e-6  # PALLAS batched/unbatched where not bit for bit
LEGACY_1A = (2, 100)  # steps, substeps
TWOPHASE_REFUSAL = ("lbm_backend = PALLAS: solve compute 'grad_phi' "
                    "(LBMIsotropicGradient) is not fusable (use the default JNP backend)")
PRECISION = {"float64": "floating_precision = DOUBLE",
             "float32": "floating_precision = SINGLE"}
SPECTRAL_ROUTES = {"DEFAULT float64": "floating_precision = DOUBLE",
                   "DEFAULT float32": "floating_precision = SINGLE",
                   "PALLAS float32": "fft_backend = PALLAS\n  floating_precision = SINGLE"}
TOTALS = """
[Postprocessors]
  [{0}_total]
    type = TensorIntegralPostprocessor
    buffer = {0}
    execute_on = 'INITIAL TIMESTEP_END'
  []
  [{1}_total]
    type = TensorIntegralPostprocessor
    buffer = {1}
    execute_on = 'INITIAL TIMESTEP_END'
  []
[]
[Outputs]
  csv = true
[]
"""


def with_executioner(deck, steps, dt=1.0):
    """``deck`` with its [Executioner] block (if any) replaced by a
    Transient of ``steps`` steps of ``dt``."""
    deck = re.sub(r"\[Executioner\]\n(  .*\n)*\[\]\n", "", deck)
    assert "[Executioner]" not in deck
    return deck + (f"\n[Executioner]\n  type = Transient\n  num_steps = {steps}\n"
                   f"  dt = {dt}\n[]\n")


def all_launches():
    from marlin_tpu_torch import lbm_fused as lf
    from marlin_tpu_torch import spectral as sp
    from marlin_tpu_torch import unordered_fft as uf

    return {**uf.launches(), **sp.launches(), **lf.launches()}


def reset_all():
    from marlin_tpu_torch import lbm_fused as lf
    from marlin_tpu_torch import spectral as sp
    from marlin_tpu_torch import unordered_fft as uf

    uf.reset_launches()
    sp.reset_launches()
    lf.reset_launches()


def deck_run(deck, dev, arrays=None, mesh=None):
    """run_deck (on ``mesh`` where given) with every launch count set to 0
    just before and read just after: (transient, wall seconds, launches)."""
    from marlin_tpu_torch import hit
    from marlin_tpu_torch.executioner import run_deck

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all()
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = run_deck(hit.parse(deck), output_dir=out_dir, device=dev, arrays=arrays,
                      mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return tr, wall, all_launches()


def rel_diff(got, ref):
    """max |got − ref| over max |ref|, in float64."""
    got, ref = got.to(torch.complex128 if ref.is_complex() else torch.float64), \
        ref.to(torch.complex128 if ref.is_complex() else torch.float64)
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300)).item()


def finite(buffers, label):
    for k, v in buffers.items():
        assert bool(torch.isfinite(v).all()), (label, k)


def step_ms(tr, substeps, dt=1.0):
    """Wall ms a substep of the finished run: CUDA events over one more
    step."""
    p, st = tr.problem, tr.state
    return cuda_ms(lambda: p.step(st, tr.time, dt, dt, False), reps=1, warmup=0) / substeps


def step_device_ms(tr, substeps, dt=1.0):
    """Device ms a substep: the profiler's device time over a step of
    PROFILED_SUBSTEPS substeps of the same size (a trace of a whole step
    holds up to 10^5 events, which the profiler takes minutes to read)."""
    p, st = tr.problem, tr.state
    holder, attr = (p, "lbm_substeps") if p.is_lbm else (p.solver, "substeps")
    short = dt * PROFILED_SUBSTEPS / substeps
    setattr(holder, attr, PROFILED_SUBSTEPS)
    try:
        dev = device_ms(lambda: p.step(st, tr.time, short, short, False), calls=1)
    finally:
        setattr(holder, attr, substeps)
    return dev / PROFILED_SUBSTEPS


def phase_twophase(dev, smi):
    """(a) the two-phase droplet, D2Q9 JNP, float64 and float32: Σφ and the
    fluid mass conserved, float32 against float64 on φ and ρ, and the
    PALLAS refusal.  Returns {precision: ms a substep}."""
    from marlin_tpu_torch import decks
    from marlin_tpu_torch import lbm_fused as lf

    n, steps, substeps = TWOPHASE
    out, ms = {}, {}
    for prec in ("float64", "float32"):
        deck = decks.TWOPHASE2D_DECK.format(n=n, substeps=substeps, backend="JNP").replace(
            "[Domain]", f"[Domain]\n  {PRECISION[prec]}")
        tr, wall, launched = deck_run(with_executioner(deck, steps) + TOTALS.format(
            "phi", "density"), dev)
        dtype = tr.problem.domain.dtype
        assert launched["lbm_substep"] == 0, launched
        finite(tr.state["buffers"], f"twophase {prec}")
        rows = tr.csv.rows
        drifts = {}
        for key in ("phi_total", "density_total"):
            m0, m1 = rows[0][key], rows[-1][key]
            drifts[key] = abs(m1 - m0) / abs(m0)
            assert drifts[key] <= TWOPHASE_MASS_TOL[dtype], (prec, key, m0, m1)
        ms[prec] = step_ms(tr, substeps)
        speed = tr.state["buffers"]["velocity"].abs().max().item()
        say(f"[14 twophase] {prec} {n}^2, {steps} steps x {substeps} substeps: run_deck "
            f"{wall:.2f} s, {ms[prec]:.4f} ms a substep, "
            f"drift of sum(phi) {drifts['phi_total']:.3e}, of the fluid mass "
            f"{drifts['density_total']:.3e} (limit {TWOPHASE_MASS_TOL[dtype]}), max |u| "
            f"{speed:.3e}, lbm_substep launches 0, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        assert speed > 0, "the surface force moves no fluid"
        out[prec] = {k: tr.state["buffers"][k] for k in ("phi", "density")}
        del tr
    for k in ("phi", "density"):
        d = rel_diff(out["float32"][k], out["float64"][k])
        say(f"[14 twophase] float32 against float64: {k} {d:.3e} (limit {PRECISION_TOL})")
        assert d <= PRECISION_TOL, (k, d)
    deck = decks.TWOPHASE2D_DECK.format(n=n, substeps=substeps, backend="PALLAS").replace(
        "[Domain]", "[Domain]\n  floating_precision = SINGLE")
    try:
        deck_run(with_executioner(deck, 2), dev)
    except lf.FusedChainError as e:
        assert str(e) == TWOPHASE_REFUSAL, str(e)
        say(f"[14 twophase] lbm_backend = PALLAS refused: {e}")
    else:
        raise AssertionError("the two-phase deck ran on lbm_backend = PALLAS")
    return ms


def phase_pressure(dev, smi):
    """(b) pressure-driven flow through the 256³ porous sample: Dirichlet
    inlet (on the left face, then on the wall cells), Neumann outlet,
    bounce-back walls and media, JNP float32.  Returns {inlet: ms}."""
    from marlin_tpu_torch import decks

    n, steps, substeps = PRESSURE
    media = porous_media(n)
    ms = {}
    for inlet in ("left", "wall"):
        deck = decks.PRESSURE_DECK.format(n=n, substeps=substeps, backend="JNP",
                                          media_h5="media.h5", inlet=inlet)
        deck = with_executioner(deck.replace("[Domain]", "[Domain]\n  floating_precision = SINGLE"),
                                steps)
        tr, wall, launched = deck_run(deck, dev, arrays={"media": media})
        peak = torch.cuda.max_memory_allocated()
        assert launched["lbm_substep"] == 0, launched
        finite(tr.state["buffers"], f"pressure {inlet}")
        ms[inlet] = step_ms(tr, substeps)
        b = tr.state["buffers"]
        say(f"[14 pressure] inlet on {inlet}, {n}^3 float32, {steps} steps x {substeps} "
            f"substeps: run_deck {wall:.2f} s, {ms[inlet]:.3f} ms a substep "
            f"(phase 7's JNP porous beside it), max |u| "
            f"{b['velocity'].abs().max().item():.3e}, density in "
            f"[{b['density'].min().item():.5f}, {b['density'].max().item():.5f}], "
            f"lbm_substep launches 0, peak device memory {peak / 2**30:.2f} GiB; {smi}")
        del tr, b
    return ms


def phase_specular(dev, smi):
    """(c) the 800×200 channel with specular walls, Dirichlet inlet, Neumann
    outlet and the unit converter at τ = 0.6: max |u| within SPECULAR_MAX_U
    in each precision, float32 against float64.  Returns {precision: ms}."""
    from marlin_tpu_torch import decks

    nx, ny, steps, substeps = SPECULAR
    out, ms = {}, {}
    for prec in ("float64", "float32"):
        deck = decks.SPECULAR_CHANNEL_DECK.format(nx=nx, ny=ny, substeps=substeps,
                                                  backend="JNP")
        deck = with_executioner(deck.replace("[Domain]", f"[Domain]\n  {PRECISION[prec]}"),
                                steps)
        tr, wall, launched = deck_run(deck, dev)
        assert launched["lbm_substep"] == 0, launched
        finite(tr.state["buffers"], f"specular {prec}")
        ms[prec] = step_ms(tr, substeps)
        top_u = tr.state["buffers"]["velocity"].abs().max().item()
        rho = tr.state["buffers"]["density"]
        say(f"[14 specular] {prec} {nx}x{ny}, {steps} steps x {substeps} substeps: run_deck "
            f"{wall:.2f} s, {ms[prec]:.4f} ms a substep, max |u| {top_u:.4e} (limit "
            f"{SPECULAR_MAX_U}), density in [{rho.min().item():.6f}, {rho.max().item():.6f}]")
        assert top_u <= SPECULAR_MAX_U, (prec, top_u)
        out[prec] = tr.state["buffers"]
        del tr
    worst = sorted(((rel_diff(out["float32"][k], ref), k) for k, ref in out["float64"].items()),
                   reverse=True)
    say(f"[14 specular] float32 against float64, every buffer (limit {PRECISION_TOL}): "
        + ", ".join(f"{k} {d:.3e}" for d, k in worst))
    assert worst[0][0] <= PRECISION_TOL, worst[0]
    return ms


def spectral_half(u, n):
    """A spectrum on the DEFAULT layout's cells, without the Nyquist row and
    column (where the backends' conventions differ): the PALLAS full
    permuted spectrum put in natural order, then both cut to columns
    0..n/2−1 and the Nyquist row dropped."""
    from marlin_tpu_torch import unordered_fft as uf

    if u.shape[1] == n:  # PALLAS: permuted, full
        idx = torch.as_tensor(np.argsort(uf.true_k_order(n)), device=u.device)
        u = u.index_select(0, idx).index_select(1, idx)
    rows = torch.cat([torch.arange(n // 2), torch.arange(n // 2 + 1, n)]).to(u.device)
    return u[:, : n // 2].index_select(0, rows)


def sbm_launches(steps, substeps):
    """Kernels 1-4 in a PALLAS run of the spectral-family deck: each step
    the carried c̄ and η̄ seeded, 2 forward transforms; each substep 7
    forward (ReciprocalMatDiffusion 5: ψ, µ, the two flux components, the
    no-flux term; ReciprocalAllenCahn 1; GradientTensor 1) and 8 inverse
    (ReciprocalMatDiffusion 4, GradientTensor 2, the solver's 2), each in
    2-D one lanes and one sublanes launch; no transform at initialisation
    or in the postprocessors."""
    fwd, inv = steps * (2 + 7 * substeps), steps * 8 * substeps
    return {"fwd_lanes": fwd, "fwd_lanes_pre": 0, "fwd_sublanes": fwd,
            "inv_sublanes": inv, "inv_lanes": inv, "fwd_x_update": 0,
            "fwd_x_update_poly": 0, "lbm_substep": 0, "lbm_density_mean": 0}


def phase_spectral_family(dev, smi):
    """(d) the spectral family at 512² on DEFAULT float64, DEFAULT float32 and
    PALLAS float32: exact launches, PALLAS against DEFAULT float32 and
    float32 against float64 on every buffer.  Returns (PALLAS launches, {route:
    ms})."""
    from marlin_tpu_torch import decks

    n, steps, substeps = SBM
    out, ms, pallas_launches = {}, {}, None
    for route, domain in SPECTRAL_ROUTES.items():
        deck = decks.SMOOTHED_BOUNDARY_DECK.format(n=n, lo=n // 8, hi=7 * n // 8,
                                                   substeps=substeps, dt=1.0,
                                                   domain_extra=domain)
        tr, wall, launched = deck_run(deck, dev)
        want = sbm_launches(steps, substeps) if route.startswith("PALLAS") else \
            {k: 0 for k in sbm_launches(0, 0)}
        say(f"[14 spectral] {route} {n}^2, {steps} steps x {substeps} substeps: run_deck "
            f"{wall:.2f} s, launches {launched} (expected {want})")
        assert launched == want, (route, launched, want)
        if route.startswith("PALLAS"):
            pallas_launches = launched
        finite(tr.state["buffers"], route)
        ms[route] = step_ms(tr, substeps)
        pp = tr.pp_values
        say(f"[14 spectral] {route} {ms[route]:.4f} ms a substep; c_integral "
            f"{pp['c_integral']:.6e}, the integral of c(0)^2 "
            f"{pp['c_initial_square_integral']:.6e}, max of the |dc/dx_i|^2 envelope "
            f"{pp['grad_c_peak_max']:.6e}")
        out[route] = tr.state["buffers"]
        del tr
    for a, b in (("PALLAS float32", "DEFAULT float32"),
                 ("DEFAULT float32", "DEFAULT float64")):
        worst = []
        for k, ref in out[b].items():
            got = out[a][k]
            if got.shape != ref.shape:
                got, ref = spectral_half(got, n), spectral_half(ref, n)
            worst.append((rel_diff(got, ref), k))
        assert sorted(k for _, k in worst) == sorted(SBM_TOL), sorted(k for _, k in worst)
        say(f"[14 spectral] {a} against {b}, every buffer (its limit): "
            + ", ".join(f"{k} {d:.2e} ({SBM_TOL[k]:.0e})"
                        for d, k in sorted(worst, reverse=True)))
        over = [(k, d) for d, k in worst if d > SBM_TOL[k]]
        assert not over, (a, b, over)
    return pallas_launches, ms


def phase_batch_fft(dev, smi):
    """(e) batch_fft on the 2a stand-in at 200², three routes, batched and
    not.  Returns ({run: launches} of the PALLAS runs, {run: ms})."""
    from marlin_tpu_torch import decks

    n, steps, substeps = OSTWALD
    S = steps * substeps
    launches, ms = {}, {}
    for route, domain in SPECTRAL_ROUTES.items():
        runs = {}
        for batched in (False, True):
            deck = with_executioner(decks.OSTWALD_2A_DECK.format(
                n=n, substeps=substeps, domain_extra=domain,
                problem_extra="batch_fft = true" if batched else ""), steps, OSTWALD_DT)
            tr, wall, launched = deck_run(deck, dev)
            name = f"{route} {'batched' if batched else 'unbatched'}"
            finite(tr.state["buffers"], name)
            if route.startswith("PALLAS"):
                # 10 forward transforms and 5 inverse a substep: one lanes and
                # one sublanes launch each, or one each a batch group
                groups = (1, 1) if batched else (10, 5)
                want = {"fwd_lanes": groups[0] * S, "fwd_sublanes": groups[0] * S,
                        "inv_sublanes": groups[1] * S, "inv_lanes": groups[1] * S}
                got = {k: launched[k] for k in want}
                assert got == want, (name, launched, want)
                assert launched["fwd_lanes"] // S == groups[0]
                launches[f"14 2a {name}"] = launched
            else:
                assert not any(launched.values()), (name, launched)
            ms[name] = (step_ms(tr, substeps, OSTWALD_DT),
                        step_device_ms(tr, substeps, OSTWALD_DT))
            say(f"[14 2a] {name} {n}^2, {steps} steps x {substeps} substeps: run_deck "
                f"{wall:.2f} s, {ms[name][0]:.4f} ms a substep ({ms[name][1]:.4f} device), "
                f"forward lanes launches a substep {launched['fwd_lanes'] / S:g}")
            runs[batched] = tr.state
            del tr
        a, b = runs[False], runs[True]
        bitwise = all(torch.equal(b["buffers"][k], v) for k, v in a["buffers"].items())
        worst = max(rel_diff(b["buffers"][k], v) for k, v in a["buffers"].items())
        dtype = torch.float64 if "float64" in route else torch.float32
        if route.startswith("PALLAS"):
            tol = 0.0 if bitwise else BATCH_FALLBACK_TOL
            if not bitwise:
                say(f"[14 2a] FINDING: {route} batched differs from unbatched by {worst:.3e}")
        else:
            tol = BATCH_TOL[dtype]
        say(f"[14 2a] {route}: batched against unbatched bit for bit: {bitwise}; largest "
            f"relative difference {worst:.3e} (limit {tol})")
        assert worst <= tol, (route, worst)
    return launches, ms


def phase_legacy_1a(dev, smi):
    """(f) the legacy [TensorTimeIntegrators] form of benchmark 1a against
    BENCH_1A_DECK at 200², LEGACY_1A steps and substeps, DEFAULT float32
    and PALLAS fused float32: equal bit for bit, launches phase 12's
    formula.  Returns {run: launches}."""
    from marlin_tpu_torch import decks
    from marlin_tpu_torch.bench_1a_runs import ROUTES

    steps, substeps = LEGACY_1A
    launches = {}
    for run in ("DEFAULT float32", "PALLAS fused float32"):
        domain, solver = ROUTES[BENCH_1A_RUNS[run]]
        states = {}
        for form, template in (("legacy", decks.BENCH_1A_LEGACY_DECK),
                               ("solver", decks.BENCH_1A_DECK)):
            deck = template.format(n=BENCH_1A_N, substeps=substeps,
                                   domain_extra=domain, solver_extra=solver)
            deck = deck.replace("  end_time = 10500\n",
                                f"  end_time = 10500\n  num_steps = {steps}\n")
            tr, wall, launched = deck_run(deck, dev)
            launched = {k: launched[k] for k in bench_1a_launches(run, 1, 1)}
            want = bench_1a_launches(run, steps, substeps)
            say(f"[14 legacy 1a] {run} {form}: run_deck {wall:.2f} s, launches {launched} "
                f"(expected {want})")
            assert launched == want, (run, form, launched, want)
            if run.startswith("PALLAS"):
                launches[f"14 1a {run} {form}"] = launched
            states[form] = (tr.state, tr.pp_values)
            del tr
        states_equal(states["legacy"][0], states["solver"][0])
        assert states["legacy"][1] == states["solver"][1]
        say(f"[14 legacy 1a] {run}: [TensorTimeIntegrators] equals [TensorSolver] bit for "
            f"bit over {steps} steps x {substeps} substeps (state and pp values)")
    return launches


def phase_rest(dev, smi):
    """Phase 14: (a)-(f).  Returns {path: launches} of its PALLAS runs, by
    the kernels' path: "main" (the register path at 512²) and "small"
    (200²)."""
    t0 = time.perf_counter()
    phase_twophase(dev, smi)
    phase_pressure(dev, smi)
    phase_specular(dev, smi)
    sbm, _ms = phase_spectral_family(dev, smi)
    small = {}
    batch, _ms = phase_batch_fft(dev, smi)
    small.update(batch)
    small.update(phase_legacy_1a(dev, smi))
    say(f"[14] {time.perf_counter() - t0:.1f} s; {smi}")
    return {"main": {"14 spectral family PALLAS": sbm}, "small": small}


# -- phase 15: the rest of the solver family and the iteration-driven timestepper -------------

ETDRK4_RUNS = {  # run: (fft_backend, cox_matthews, steps)
    "PALLAS cox_matthews": ("PALLAS", True, STEPS),
    "DEFAULT cox_matthews": ("DEFAULT", True, STEPS),
    "PALLAS reference tables": ("PALLAS", False, 1),
}
ETDRK4_ORDER = (3.5, 4.8)  # tests/test_etdrk4_cox_matthews.py's bounds
ITERATIVE = (200, 2, 5)  # n, steps, substeps: benchmark 2a's grid
ITERATIVE_ROUTES = {"PALLAS float32": ("SINGLE", "fft_backend = PALLAS\n  floating_precision = SINGLE"),
                    "DEFAULT float64": ("DOUBLE", "floating_precision = DOUBLE"),
                    "DEFAULT float32": ("SINGLE", "floating_precision = SINGLE")}
ITERATIVE_MASS_TOL = {"SINGLE": 1e-5, "DOUBLE": 1e-10}  # relative, c's integral
# float32 (relative tolerance 1e-2) against DEFAULT float64 (the secant's
# 1e-9, Broyden's 1e-4), of the float64 field's largest: the CPU at 200²
# measured 7.2e-6 on c and at most 1.1e-4 on the order parameters (secant);
# the card 8.0e-6 and 1.1e-4 (secant), 2.0e-4 and 1.9e-4 (Broyden)
ITERATIVE_FIELD_TOL = {"SecantSolver": {"c": 5e-5, "n1": 5e-4, "n2": 5e-4, "n3": 5e-4, "n4": 5e-4},
                       "BroydenSolver": {k: 1e-3 for k in ("c", "n1", "n2", "n3", "n4")}}
BIG_DT_STEPS = {"SecantSolver": 2, "BroydenSolver": 1}  # each failed try: max_iterations a substep
COUPLED = (512, 2, 10, 0.01)  # n, steps, substeps, dt
COUPLED_CASES = [(1, 0), (2, 1), (4, 2)]  # (order, corrector steps)
COUPLED_TOL = 1e-5  # PALLAS float32 against DEFAULT float64, of its largest
COUPLED_EXACT_TOL = 1e-4  # DEFAULT float64 against the exact solution, of its largest
EXPLICIT = (1024, 2, 10, 5e-4)  # n, steps, substeps, dt: 0.05·2·512²·5e-5 = 1.3 < 2
EXPLICIT_TOL = 1e-5  # PALLAS against DEFAULT float32, of the largest


def solver_counts(tr):
    c = tr.problem.solver.counts
    return c.substeps, c.iterations, c.syncs, c.failed


def one_substep(tr, dt, fn):
    """``fn(step)`` with ``step()`` one more substep of a finished run (a
    step of one substep of dt/substeps from its state)."""
    p, st = tr.problem, tr.state
    n = p.solver.substeps
    p.solver.substeps = 1
    try:
        return fn(lambda: p.step(st, tr.time, dt / n, dt / n, False))
    finally:
        p.solver.substeps = n


def substep_wall_ms(tr, dt):
    """Wall ms of one more substep of a finished run, by CUDA events."""
    return one_substep(tr, dt, lambda step: cuda_ms(step, reps=1, warmup=0))


def iterative_step(tr, dt):
    """One more substep of a finished iterative run: (wall ms by CUDA
    events, its iterations, its host syncs)."""
    before = solver_counts(tr)
    ms = substep_wall_ms(tr, dt)
    _sub, its, syncs, _ = (a - b for a, b in zip(solver_counts(tr), before))
    return ms, its, syncs


def substep_device_ms(tr, dt):
    """(device ms, iterations) of one more substep of a finished iterative
    run, by the profiler (a whole step's trace takes long to read)."""
    before = solver_counts(tr)[1]
    ms = one_substep(tr, dt, lambda step: device_ms(step, calls=1))
    # device_ms makes the call twice: a warm-up and the traced one
    return ms, (solver_counts(tr)[1] - before) / 2


def phase_etdrk4(dev, smi):
    """(a) ETDRK4 on the 3-D Cahn-Hilliard deck at 512³, float32, 10
    substeps × 2 steps; then the Cox-Matthews order in float64.  Returns
    {run: launches} of the PALLAS runs."""
    from marlin_tpu_torch import decks, hit
    from marlin_tpu_torch.problem import TensorProblem

    launches, c = {}, {}
    for run, (backend, cm, steps) in ETDRK4_RUNS.items():
        S = steps * SUBSTEPS
        # each substep: four group evaluations of fft(µ) and fft(c) (one
        # lanes and two sublanes launches each) and four inverse transforms
        # (two sublanes, one lanes)
        want = {"fwd_lanes": 8 * S, "fwd_sublanes": 16 * S, "inv_lanes": 4 * S,
                "inv_sublanes": 8 * S, "fwd_lanes_pre": 0, "fwd_x_update": 0,
                "fwd_x_update_poly": 0}
        gc.collect()
        deck = transient(decks.CH3D_ETDRK4_DECK.format(
            n=N, substeps=SUBSTEPS, solver_extra="cox_matthews = true" if cm else "").replace(
                "[Domain]", f"[Domain]\n  fft_backend = {backend}\n  floating_precision = SINGLE"),
            1, "c").replace(f"num_steps = {STEPS}\n", f"num_steps = {steps}\n")
        tr, wall, launched = deck_run(deck, dev)
        got = {k: launched[k] for k in want}
        ms = f"{substep_wall_ms(tr, 1.0):.3f} ms a substep, " if cm else ""
        fin = bool(torch.isfinite(tr.state["buffers"]["c"]).all())
        say(f"[15a etdrk4] {run} {N}^3, {steps} steps x {SUBSTEPS} substeps: run_deck "
            f"{wall:.2f} s, {ms}group evaluations a step "
            f"{tr.problem.solver.group_evals_per_step()}, c finite {fin}, launches {got}; "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if backend == "PALLAS":
            assert got == want, (run, got, want)
            launches[f"15 etdrk4 {run}"] = launched
        else:
            assert not any(launched.values()), (run, launched)
        if cm:
            assert fin, run
            mass(tr, f"15a {run}")
            c[backend] = tr.state["buffers"]["c"]
            SERIAL[f"etdrk4 {backend}"] = c[backend].cpu()  # phase 19's anchors
        else:
            # the reference's tables divide by (L·dt)³, 2.3e-8 at the smallest
            # |L·dt| here: tests/test_torch_solvers.py finds them non-finite
            # from 32³ on, in float64 too
            say(f"[15a etdrk4] {run}: the reference's phi tables give c finite {fin} at "
                f"{N}^3 (non-finite from 32^3 on, in float64 too: the CPU tests)")
        del tr
    diff = (c["PALLAS"] - c["DEFAULT"]).abs().max().item()
    say(f"[15a etdrk4] cox_matthews max|c_PALLAS - c_DEFAULT| {diff:.3e} (limit {ANCHOR_TOL})")
    assert diff <= ANCHOR_TOL, diff
    del c
    gc.collect()
    # the fourth order of the Cox-Matthews tables, float64 on the card
    errors = []
    runs = {}
    for substeps in (64, 4, 8):
        p = TensorProblem(hit.parse(decks.ETDRK4_ORDER_DECK.format(
            substeps=substeps, cm="true")), device=dev)
        runs[substeps] = p.step(p.init_state(), 0.0, 0.5, 0.5, True)["buffers"]["u"]
    for substeps in (4, 8):
        errors.append((runs[substeps] - runs[64]).abs().max().item())
    order = math.log2(errors[0] / errors[1])
    say(f"[15a etdrk4] cox_matthews order on the 1-D Allen-Cahn deck, float64: errors "
        f"{errors[0]:.3e} (4 substeps), {errors[1]:.3e} (8); order {order:.3f} "
        f"(bounds {ETDRK4_ORDER})")
    assert ETDRK4_ORDER[0] < order < ETDRK4_ORDER[1], order
    return launches


def iterative_deck(solver, route, dt, steps, problem_extra="", constant_dt=False):
    """The 2a stand-in of ``solver`` at ITERATIVE's grid on a route."""
    from marlin_tpu_torch import decks

    n, _steps, substeps = ITERATIVE
    precision, domain = ITERATIVE_ROUTES[route]
    deck = (decks.OSTWALD_2A_SECANT_DECK if solver == "SecantSolver"
            else decks.OSTWALD_2A_BROYDEN_DECK).format(
        n=n, substeps=substeps, dt=dt, num_steps=steps, domain_extra=domain,
        problem_extra=problem_extra, solver_extra="",
        relative_tolerance=decks.OSTWALD_2A_TOL[(solver, precision)])
    if constant_dt:
        deck = re.sub(r"  \[TimeStepper\]\n(    .*\n)*  \[\]\n", f"  dt = {dt}\n", deck)
        assert "TimeStepper" not in deck
    return deck + "[Outputs]\n  csv = true\n[]\n"


def iterative_launches(substeps, iterations, failed, batched, stacked):
    """Kernel 1-4 launches of a PALLAS run of the 2a stand-in: every group
    evaluation (one a substep and one an iteration) transforms ten fields
    forward, one lanes and one sublanes launch each, or one of each a
    batch; every inverse of the five fields (the bootstrap or the first
    M·R, each iteration, a rollback) likewise."""
    evals = substeps + iterations
    inverses = (iterations if stacked else substeps + iterations) + failed
    fwd = 1 if batched else 10
    inv = 1 if batched else 5
    return {"fwd_lanes": fwd * evals, "fwd_sublanes": fwd * evals,
            "inv_lanes": inv * inverses, "inv_sublanes": inv * inverses}


def run_iterative(solver, route, dt, steps, dev, problem_extra="", constant_dt=False,
                  label=None):
    """One run of the 2a stand-in; checks its launches; returns (transient,
    launches, (c's integral at the start, at the end))."""
    deck = iterative_deck(solver, route, dt, steps, problem_extra, constant_dt)
    torch.cuda.synchronize()
    tr, wall, launched = deck_run(deck, dev)
    sub, its, syncs, failed = solver_counts(tr)
    name = label or f"{solver} {route}{' batched' if problem_extra else ''}"
    finite(tr.state["buffers"], name)
    if route.startswith("PALLAS"):
        want = iterative_launches(sub, its, failed if solver == "SecantSolver" else 0,
                                  bool(problem_extra), solver == "BroydenSolver")
        got = {k: launched[k] for k in want}
        assert got == want, (name, got, want)
    else:
        assert not any(launched.values()), (name, launched)
    rows = tr.csv.rows
    m0, m1 = rows[0]["c_total"], rows[-1]["c_total"]
    say(f"[15 {solver}] {name}: run_deck {wall:.2f} s, {steps} steps, substeps {sub}, "
        f"iterations a substep {its / sub:.2f}, syncs a substep {syncs / sub:.2f}, "
        f"not converged {failed}, rejected steps {tr.rejected_steps}, t {tr.time:.6g}, group "
        f"evaluations a step {rows[-1]['group_evals'] / steps:.1f}, c integral {m0:.12g} -> "
        f"{m1:.12g}")
    return tr, launched, (m0, m1)


def phase_iterative(solver, dev, smi):
    """(b) SecantSolver or (c) BroydenSolver on the 2a stand-in at 200²,
    2 steps × 5 substeps, on ITERATIVE_ROUTES, unbatched and batched; then
    the too-large start dt (DEFAULT float64).  Returns ({run: launches} of
    the PALLAS runs."""
    from marlin_tpu_torch import decks

    _n, steps, substeps = ITERATIVE
    dt, big_dt = decks.OSTWALD_2A_DT[solver]
    launches, fields = {}, {}
    for route, (precision, _domain) in ITERATIVE_ROUTES.items():
        # Broyden's routes run at a constant dt: its float32 and float64
        # iteration counts (1-5 and 14-50) fall on both sides of any one
        # window of the adaptive rule, which would move the routes to other
        # times; the secant's (4 and 14) fit its window
        runs = {}
        # batched against unbatched on PALLAS, where it holds bit for bit
        for extra in ("", "batch_fft = true")[:2 if route.startswith("PALLAS") else 1]:
            tr, launched, (m0, m1) = run_iterative(solver, route, dt, steps, dev, extra,
                                                   constant_dt=solver == "BroydenSolver")
            sub, its, syncs, failed = solver_counts(tr)
            assert failed == 0 and tr.rejected_steps == 0, (route, failed)
            assert abs(m1 - m0) <= ITERATIVE_MASS_TOL[precision] * abs(m0), (route, m0, m1)
            if route.startswith("PALLAS"):
                launches[f"15 {solver} {route}{' batched' if extra else ''}"] = launched
            if not extra:
                ms, its1, syncs1 = iterative_step(tr, tr._last_dt)
                busy = ""
                if route.startswith("PALLAS") and solver == "SecantSolver":
                    dev_ms, dev_its = substep_device_ms(tr, tr._last_dt)
                    busy = (f"; profiled substep: device {dev_ms:.4f} ms, {dev_its:g} iterations, "
                            f"busy {dev_ms / dev_its / (ms / its1):.1%} of the timed substep's "
                            f"wall ms an iteration")
                say(f"[15 {solver}] {route}: one more substep {ms:.4f} ms (CUDA events), "
                    f"{its1} iterations, {syncs1} host syncs{busy}")
                fields[route] = {k: tr.state["buffers"][k] for k in ("c", "n1", "n2", "n3", "n4")}
            runs[bool(extra)] = tr.state
            if solver == "BroydenSolver" and route.startswith("PALLAS") and not extra:
                broyden_resume(route, dt, dev, tr.state)
            del tr
        if route.startswith("PALLAS"):
            states_equal(runs[False], runs[True])
            say(f"[15 {solver}] {route}: batched equal to unbatched bit for bit (buffers, "
                f"history, solver entries)")
    ref = fields["DEFAULT float64"]
    for route in ("PALLAS float32", "DEFAULT float32"):
        diffs = {k: rel_diff(v, ref[k]) for k, v in fields[route].items()}
        say(f"[15 {solver}] {route} against DEFAULT float64, of its largest: "
            + ", ".join(f"{k} {d:.3e}" for k, d in diffs.items()))
        over = {k: d for k, d in diffs.items() if d > ITERATIVE_FIELD_TOL[solver][k]}
        assert not over, (route, over, ITERATIVE_FIELD_TOL[solver])
    # the too-large start dt: its first attempt fails, is re-attempted at a
    # quarter, and dt does not grow on the step after
    tr, _launched, _ = run_iterative(solver, "DEFAULT float64", big_dt, BIG_DT_STEPS[solver],
                                     dev, label=f"{solver} DEFAULT float64, start dt {big_dt}")
    dts = [b["time"] - a["time"] for a, b in zip(tr.csv.rows, tr.csv.rows[1:])]
    say(f"[15 {solver}] start dt {big_dt}: rejected steps {tr.rejected_steps}, accepted dt "
        f"{dts}")
    assert tr.rejected_steps >= 1, tr.rejected_steps
    # an accepted dt at most a quarter of the one before (the step's first
    # try, or the start dt), and the next no larger
    seq = [big_dt] + dts
    cuts = [i for i in range(1, len(seq)) if seq[i] <= seq[i - 1] * 0.25 * (1 + 1e-12)]
    assert cuts and all(seq[i + 1] <= seq[i] * (1 + 1e-12) for i in cuts
                        if i + 1 < len(seq)), seq
    assert abs(tr.time - sum(dts)) <= 1e-12 * tr.time
    del tr
    return launches


def broyden_resume(route, dt, dev, whole):
    """Broyden's M through a checkpoint: 1 step, its checkpoint, resumed
    to step 2, equal to the whole run bit for bit."""
    _n, steps, _substeps = ITERATIVE
    deck = iterative_deck("BroydenSolver", route, dt, steps, constant_dt=True)
    with tempfile.TemporaryDirectory() as out_dir:
        out = resume_runs(deck, steps, 1, out_dir, dev, all_launches, reset_all)
    resumed = out["resumed"][0].state
    states_equal(out["full"][0].state, resumed)
    states_equal(whole, resumed)
    say(f"[15 BroydenSolver] {route}: checkpoint after step 1 resumed to step {steps} equals "
        f"the whole run bit for bit, M {tuple(resumed['solver']['M'].shape)} included")


def phase_coupled(dev, smi):
    """(d) the coupled ABM on decks.COUPLED_DECK at 512²: PALLAS float32
    and DEFAULT float64 at COUPLED_CASES; PALLAS within COUPLED_TOL of
    DEFAULT, DEFAULT within COUPLED_EXACT_TOL of the exact solution.
    Returns {run: launches} of the PALLAS runs."""
    from marlin_tpu_torch import decks

    n, steps, substeps, dt = COUPLED
    S = steps * substeps
    launches = {}
    for order, cs in COUPLED_CASES:
        out = {}
        for route, domain in (("PALLAS float32", ITERATIVE_ROUTES["PALLAS float32"][1]),
                              ("DEFAULT float64", "floating_precision = DOUBLE")):
            deck = with_executioner(decks.COUPLED_DECK.format(
                n=n, h=decks.half_cell(n), substeps=substeps, order=order,
                corrector_steps=cs, domain_extra=domain, solver_extra=""), steps, dt)
            tr, wall, launched = deck_run(deck, dev)
            finite(tr.state["buffers"], route)
            # each group evaluation transforms u, v, N_u, N_v forward; each
            # solve transforms u and v back: one lanes and one sublanes
            # launch each
            want = {"fwd_lanes": 4 * S * (1 + cs), "fwd_sublanes": 4 * S * (1 + cs),
                    "inv_lanes": 2 * S * (1 + cs), "inv_sublanes": 2 * S * (1 + cs)}
            if route.startswith("PALLAS"):
                got = {k: launched[k] for k in want}
                assert got == want, (route, got, want)
                launches[f"15 coupled order {order} cs {cs}"] = launched
            else:
                assert not any(launched.values()), launched
            ms = step_ms(tr, substeps, dt)
            say(f"[15d coupled] order {order}, corrector steps {cs}, {route} {n}^2, {steps} "
                f"steps x {substeps} substeps: run_deck {wall:.2f} s, {ms:.4f} ms a substep, "
                f"group evaluations a step {tr.problem.solver.group_evals_per_step()}")
            out[route] = tr
        b0 = out["DEFAULT float64"].problem.init_state()["buffers"]
        exact = dict(zip("uv", decks.coupled_exact(b0["u"], b0["v"], steps * dt)))
        for k in "uv":
            d = rel_diff(out["PALLAS float32"].state["buffers"][k],
                         out["DEFAULT float64"].state["buffers"][k])
            e = rel_diff(out["DEFAULT float64"].state["buffers"][k], exact[k])
            say(f"[15d coupled] order {order}, cs {cs}: {k} PALLAS against DEFAULT {d:.3e} "
                f"(limit {COUPLED_TOL}); DEFAULT against exact {e:.3e} (limit "
                f"{COUPLED_EXACT_TOL})")
            assert d <= COUPLED_TOL and e <= COUPLED_EXACT_TOL, (order, cs, k, d, e)
        del out
    return launches


def phase_explicit(dev, smi):
    """(e) forward Euler on decks.EXPLICIT_DECK at 1024² (PALLAS and
    DEFAULT float32, then the real-space form), and LinearTensorPredictor
    on (b)'s deck.  Returns {run: launches} of the PALLAS runs."""
    from marlin_tpu_torch import decks

    n, steps, substeps, dt = EXPLICIT
    S = steps * substeps
    launches, u = {}, {}
    for route, template, domain in (
            ("PALLAS", decks.EXPLICIT_DECK, "fft_backend = PALLAS\n  floating_precision = SINGLE"),
            ("DEFAULT", decks.EXPLICIT_DECK, "floating_precision = SINGLE"),
            ("real space", decks.EXPLICIT_REAL_SPACE_DECK, "floating_precision = SINGLE")):
        deck = with_executioner(template.format(n=n, substeps=substeps, domain_extra=domain),
                                steps, dt)
        tr, wall, launched = deck_run(deck, dev)
        finite(tr.state["buffers"], route)
        if route == "PALLAS":
            want = {"fwd_lanes": S, "fwd_sublanes": S, "inv_lanes": S, "inv_sublanes": S}
            got = {k: launched[k] for k in want}
            assert got == want, (got, want)
            launches["15 forward Euler"] = launched
        else:
            assert not any(launched.values()), launched
        ms = step_ms(tr, substeps, dt)
        u[route] = tr.state["buffers"]["u"]
        say(f"[15e explicit] {route} {n}^2, {steps} steps x {substeps} substeps: run_deck "
            f"{wall:.2f} s, {ms:.4f} ms a substep")
        del tr
    d = rel_diff(u["PALLAS"], u["DEFAULT"])
    fd = rel_diff(u["real space"], u["DEFAULT"])
    say(f"[15e explicit] forward Euler PALLAS against DEFAULT {d:.3e} (limit {EXPLICIT_TOL}); "
        f"real space (finite differences) against spectral {fd:.3e}")
    assert d <= EXPLICIT_TOL, d
    # the predictor on (b)'s deck, float64: iterations a substep with and without
    predictors = "  [Predictors]\n" + "".join(f"""    [{k}]
      type = LinearTensorPredictor
      buffer = {k}
    []
""" for k in ("c", "n1", "n2", "n3", "n4")) + "  []\n"
    its = {}
    for label, extra in (("without", ""), ("with", predictors)):
        deck = iterative_deck("SecantSolver", "DEFAULT float64",
                              decks.OSTWALD_2A_DT["SecantSolver"][0], 2).replace(
            "  absolute_tolerance = 1e-9\n", "  absolute_tolerance = 1e-9\n" + extra)
        tr, _wall, _l = deck_run(deck, dev)
        sub, n_its, _s, failed = solver_counts(tr)
        its[label] = n_its / sub
        say(f"[15e predictor] secant 2a DEFAULT float64, 2 steps, {label} "
            f"LinearTensorPredictors on its five fields: iterations a substep {its[label]:.2f}, not "
            f"converged {failed}")
        del tr
    return launches


def phase_solvers(dev, smi):
    """Phase 15: (a)-(e).  Returns {path: launches} of its PALLAS runs, by
    the kernels' path: "main" (the register path: 512³, 512², 1024²) and
    "small" (200²)."""
    t0 = time.perf_counter()
    main_paths = phase_etdrk4(dev, smi)
    say(f"[15] (a) done at {time.perf_counter() - t0:.1f} s")
    small = {}
    for solver in ("SecantSolver", "BroydenSolver"):
        small.update(phase_iterative(solver, dev, smi))
        say(f"[15] {solver} done at {time.perf_counter() - t0:.1f} s")
    main_paths.update(phase_coupled(dev, smi))
    say(f"[15] (d) done at {time.perf_counter() - t0:.1f} s")
    main_paths.update(phase_explicit(dev, smi))
    say(f"[15] {time.perf_counter() - t0:.1f} s; {smi}")
    return {"main": main_paths, "small": small}

# -- phase 16: FFT micromechanics ----------------------------------------------------

MECH_N = 128  # (a) the deGeus RVE at 128³: kernels 1-4 on the register path
MECH_SHIPPED_N = 32  # (b) mech.i's shipped extent: the small path
MECH_STEPS = {MECH_N: 2, MECH_SHIPPED_N: 1}
MECH_DT = 0.01  # the deck's dt, 10 substeps a step
MECH_SUBSTEPS = 10
MECH_ROUTES = {"PALLAS float32": "fft_backend = PALLAS\n  floating_precision = SINGLE",
               "DEFAULT float32": "floating_precision = SINGLE"}
MECH_F64 = "floating_precision = DOUBLE"
MECH_MEAN_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # <F> against I + t·e01
MECH_ROUTE_TOL = 2e-5  # |F_PALLAS − F_DEFAULT| (tests/test_pallas_fft.py:317-337)
MECH_F64_TOL = 1e-4  # float32 after step 1 against float64 (test_mechanics_parallel.py)
MECH_TIGHT = ("l_tol = 1e-8", "nl_rel_tol = 1e-8", "nl_abs_tol = 1e-10")  # test_cg.py
PRECOND_SUBSTEPS = 2  # (c): one step, the second substep a solve under the ramp
# (c) runs at an odd extent: at an even one the Green operator is no
# projection on the Nyquist planes, and under the tight tolerances Newton
# exhausts nl_max_its with or without the preconditioner, in the JAX
# package too (ROADMAP §3); at 31³ it converges in three iterations
PRECOND_N = 31
PRECOND_TOL = {"F": 2e-6, "stress": 2e-5}  # tests/test_cg.py
COUPLED_MECH_N = 256  # (d) COUPLED_PF_MECH_DECK, STEPS × SUBSTEPS, dt 1
DISP_TOL = 1e-4  # (e) u PALLAS against DEFAULT, of max|u|
DISP_MAX = 0.1  # the JAX smoke test's bound on the eigenstrain displacements
FRACTURE_STEPS = 4  # (f) of fracture.i's 40, at its shipped 96²
FRACTURE_ROUTES = {"PALLAS float32": ["Domain/fft_backend=PALLAS",
                                      "Domain/floating_precision=SINGLE"],
                   "DEFAULT float64": ["Domain/floating_precision=DOUBLE"]}
# PALLAS float32 against DEFAULT float64 after 4 steps: d absolute, the
# postprocessors relative; ten to twenty times what the CPU's twins give
# (5.7e-7, 2.2e-7, 1.9e-6, 8.8e-6; PERF.md §6)
FRACTURE_TOL = {"d": 1e-5, "max_d": 5e-6, "crack_area": 2e-5, "max_sV": 2e-4}
MECH_POSTPROCESS = """  [Postprocess]
    [u]
      type = ComputeDisplacements
      buffer = u
      F = F
    []
    [sV]
      type = ComputeVonMisesStress
      buffer = sV
      stress = stress
    []
  []
"""
# the tensor-valued transforms of this path: a (…, 3, 3) field's 9
# components (a 2-D (…, 2, 2) field's 4) in front of the grid, one launch of
# each kernel an axis (marlin_tpu_torch/domain.py:fft)
MECH_KERNEL_SHAPES = {
    f"9 x {MECH_N}^3": {
        "fwd_lanes": [(9 * MECH_N ** 2, MECH_N)], "inv_lanes": [(9 * MECH_N ** 2, MECH_N)],
        "fwd_sublanes": [(9 * MECH_N, MECH_N, MECH_N), (9, MECH_N, MECH_N ** 2)],
        "inv_sublanes": [(9, MECH_N, MECH_N ** 2), (9 * MECH_N, MECH_N, MECH_N)]},
    f"9 x {MECH_SHIPPED_N}^3": {
        "fwd_lanes": [(9 * MECH_SHIPPED_N ** 2, MECH_SHIPPED_N)],
        "inv_lanes": [(9 * MECH_SHIPPED_N ** 2, MECH_SHIPPED_N)],
        "fwd_sublanes": [(9 * MECH_SHIPPED_N, MECH_SHIPPED_N, MECH_SHIPPED_N),
                         (9, MECH_SHIPPED_N, MECH_SHIPPED_N ** 2)],
        "inv_sublanes": [(9, MECH_SHIPPED_N, MECH_SHIPPED_N ** 2),
                         (9 * MECH_SHIPPED_N, MECH_SHIPPED_N, MECH_SHIPPED_N)]},
    "4 x 96^2": {"fwd_lanes": [(4 * 96, 96)], "inv_lanes": [(4 * 96, 96)],
                 "fwd_sublanes": [(4, 96, 96)], "inv_sublanes": [(4, 96, 96)]},
}
FFT_CALLS = {  # the same function as one torch call
    "fwd_lanes": lambda x: torch.fft.fft(x, dim=-1),
    "inv_lanes": lambda x: torch.fft.ifft(x, dim=-1).real,
    "fwd_sublanes": lambda x: torch.fft.fft(x, dim=1),
    "inv_sublanes": lambda x: torch.fft.ifft(x, dim=1),
}


def device_split(kernel, library, calls=20):
    """(kernel ms, library ms) a call, device time by one profiler trace of
    ``calls`` calls of each, split by name: the FFT kernels of
    csrc/fft_tile.cuh (``*lanes_kernel``) against the rest."""
    kernel()
    library()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _attempt in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(activities=acts) as prof:
            for fn in (kernel, library):
                for _ in range(calls):
                    fn()
            torch.cuda.synchronize()
        ours = theirs = 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if "lanes_kernel" in e.key:
                    ours += e.self_device_time_total
                else:
                    theirs += e.self_device_time_total
        if ours > 0 and theirs > 0:
            return ours / calls / 1e3, theirs / calls / 1e3
        say(f"[profile] a trace of {calls} calls saw no device time; taking it again")
    raise AssertionError(f"the profiler saw no device time in {PROFILE_ATTEMPTS} traces")


def phase_mech_kernels(uf, dev, gen):
    """Kernels 1-4 at the shapes of this path against their twins; the
    kernel beside the same-function torch call, device ms by the profiler
    (one trace a row; at 128³ by CUDA events, where the card is busy), the
    twin by CUDA events, and the byte bound.  Each CG iteration is one
    Green projection: one launch of each row's kernel (both sublanes shapes
    in 3-D).  Returns {(kernel, on the small path): rows}."""
    rows = {}
    for fields, shapes in MECH_KERNEL_SHAPES.items():
        for name, shape_list in shapes.items():
            kernel, twin = getattr(uf, name), getattr(uf, name + "_plain")
            for shape in shape_list:
                dtype = torch.float32 if name == "fwd_lanes" else torch.complex64
                x = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
                n = shape[1] if "sub" in name else shape[-1]
                path = fft_path(uf, name, n)
                got = kernel(x)
                torch.cuda.synchronize()
                err = check(name, shape, got, twin(x))
                del got
                if path == "small":
                    ms, lib = device_split(lambda: kernel(x), lambda: FFT_CALLS[name](x))
                else:
                    ms, lib = cuda_ms(lambda: kernel(x)), cuda_ms(lambda: FFT_CALLS[name](x))
                plain = cuda_ms(lambda: twin(x), reps=3, warmup=1)
                plan = uf.small_plan_bytes(n) if path == "small" else n * 8
                out_bytes = x.numel() * (4 if name == "inv_lanes" else 8)
                bnd, by = bound_ms(nbytes(x) + out_bytes + plan, fft_flops(x.numel() // n, n))
                row = {"fields": fields, "shape": list(shape), "path": path,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bnd, "bound_by": by, "launches_a_cg_iteration": 1}
                say(f"[16 kernels] {name} {fields} {tuple(shape)}: {path} path, max_abs_err "
                    f"{err:.3e}; ms: kernel {ms:.4f}, torch.fft {lib:.4f} ("
                    f"{'device, the profiler' if path == 'small' else 'CUDA events'}), twin "
                    f"{plain:.4f} (CUDA events), bound {bnd:.4f} ({by}); one launch a CG "
                    f"iteration")
                rows.setdefault((name, path == "small"), []).append(row)
                del x
    torch.cuda.empty_cache()
    return rows


def mech_text(n, domain, steps, extra=(), post=False, substeps=MECH_SUBSTEPS):
    """decks.MECH_DECK at n³ on ``domain``, ``steps`` steps; ``extra``
    lines in the FFTMechanics block; ``post`` adds ComputeDisplacements and
    ComputeVonMisesStress as [Postprocess] computes."""
    from marlin_tpu_torch import decks

    deck = decks.MECH_DECK.format(n=n, domain_extra=domain)
    strain = "        applied_macroscopic_strain = applied_strain\n"
    deck = deck.replace(strain, strain + "".join(f"        {line}\n" for line in extra))
    deck = deck.replace("  substeps = 10\n", f"  substeps = {substeps}\n")
    if post:
        deck = deck.replace("  [Solve]\n", MECH_POSTPROCESS + "  [Solve]\n", 1)
    return with_executioner(deck, steps, MECH_DT)


def mech_counts(tr):
    return dict(vars(tr.problem.get_compute("mech").counts))


def mech_run(text, dev, steps, first_f=False):
    """deck_run of a mechanics deck; with ``first_f`` it runs one step,
    keeps F, and runs the Transient on to ``steps``.  Returns (transient,
    wall seconds, launches, F after step 1 or None, peak MiB)."""
    tr, wall, _ = deck_run(with_executioner(text, 1, MECH_DT) if first_f else text, dev)
    F1 = None
    if first_f:
        F1 = tr.state["buffers"]["F"].clone()
        tr.num_steps = steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
    return tr, wall, all_launches(), F1, torch.cuda.max_memory_allocated() / 2**20


def projection_launches(P, dim):
    """Kernels 1-4's launches for P Green projections: a forward transform
    (the lanes kernel, then a sublanes kernel an axis) and an inverse one."""
    zero = {"fwd_lanes_pre": 0, "fwd_x_update": 0, "fwd_x_update_poly": 0}
    return {**zero, "fwd_lanes": P, "fwd_sublanes": (dim - 1) * P,
            "inv_sublanes": (dim - 1) * P, "inv_lanes": P}


def mech_gates(tr, launched, route, steps, label):
    """Every substep converged, <F> the last substep's applied strain,
    launches exactly the projections' (none on DEFAULT); returns the
    counts."""
    c = mech_counts(tr)
    F = tr.state["buffers"]["F"]
    assert c["failed"] == 0 and bool(tr.state["buffers"]["__converged_mech__"]), (label, c)
    want = torch.eye(3, dtype=torch.float64, device=F.device)
    want[0, 1] = (steps - 1) * MECH_DT + (MECH_SUBSTEPS - 1) * MECH_DT / MECH_SUBSTEPS
    mean_err = (F.double().mean((0, 1, 2)) - want).abs().max().item()
    say(f"[{label}] <F> against I + t·e01 (t = {want[0, 1].item():.3f}): {mean_err:.3e} "
        f"(limit {MECH_MEAN_TOL[F.dtype]})")
    assert mean_err <= MECH_MEAN_TOL[F.dtype], (label, mean_err)
    # one projection for each solve's right-hand side, each CG iteration that
    # ran and each Newton iteration's initial and final residual but the
    # first and the last
    P = c["projections"]
    assert P == 2 * c["newton"] - c["solves"] + c["cg_device"], (label, c)
    want_l = projection_launches(P, 3) if route.startswith("PALLAS") else {
        k: 0 for k in projection_launches(0, 3)}
    got = {k: launched[k] for k in want_l}
    say(f"[{label}] launches {got} (expected {want_l})")
    assert got == want_l, (label, got, want_l)
    return c


def mech_timing(tr, wall, steps, label, smi, profile):
    """ms a step (the run's wall over its steps), then one more substep of
    the finished run: its ms and ms a CG iteration by CUDA events, with
    ``profile`` under a profiler that records the device's activity alone
    (little host cost), for the busy share and the device operations a CG
    iteration; the run's counts."""
    p, st = tr.problem, tr.state
    c0 = mech_counts(tr)
    sub = MECH_DT / MECH_SUBSTEPS
    p.solver.substeps = 1
    try:
        one = lambda: p.step(st, tr.time, sub, sub, False)
        if profile:
            box = {}

            def timed():
                box["ms"] = cuda_ms(one, reps=1, warmup=0)

            dev_ms, ops = device_profile(timed, calls=1, warm=False, cpu=False)
            wall_sub = box["ms"]
        else:
            wall_sub, dev_ms, ops = cuda_ms(one, reps=1, warmup=0), None, None
        cg = mech_counts(tr)["cg_device"] - c0["cg_device"]
    finally:
        p.solver.substeps = MECH_SUBSTEPS
    ms_cg = wall_sub / max(cg, 1)
    busy = "" if dev_ms is None else (
        f", device {dev_ms:.2f} ms (busy {100 * dev_ms / wall_sub:.1f}%), "
        f"{ops / max(cg, 1):.1f} device operations a CG iteration")
    say(f"[{label}] {1e3 * wall / steps:.1f} ms a step; one more substep {wall_sub:.2f} ms "
        f"({cg} CG iterations: {ms_cg:.3f} ms a CG iteration, Newton's share in it){busy}; "
        f"over the run {c0['newton'] / c0['solves']:.2f} Newton iterations a substep, "
        f"{c0['cg'] / c0['newton']:.1f} CG iterations a Newton iteration, "
        f"{c0['fetches'] / c0['solves']:.1f} host fetches a substep; {smi}")


def phase_mech_rve(n, dev, smi):
    """(a) at 128³ or (b) at 32³: MECH_DECK on PALLAS and DEFAULT float32,
    DEFAULT float32 after step 1 against a one-step float64 run.  At 128³
    also ComputeDisplacements and ComputeVonMisesStress on the final state
    (e) and the two forms of tangent_apply.  Returns {run: launches}."""
    from marlin_tpu_torch.computes import mechanics as M

    steps, tag = MECH_STEPS[n], "16a" if n == MECH_N else "16b"
    F, F1, nodes, launches = {}, None, {}, {}
    for route, domain in MECH_ROUTES.items():
        if n == MECH_N:
            gc.collect()
        label = f"{tag} mech {route} {n}^3"
        first = route.startswith("DEFAULT")
        tr, wall, launched, f1, peak = mech_run(
            mech_text(n, domain, steps, post=n == MECH_N), dev, steps, first_f=first)
        say(f"[{label}] {steps} steps x {MECH_SUBSTEPS} substeps: run_deck {wall:.2f} s, "
            f"analytic tangent {tr.problem.get_compute('mech').analytic_tangent}, counts "
            f"{mech_counts(tr)}, peak device memory {peak:.1f} MiB")
        mech_gates(tr, launched, route, steps, label)
        if route.startswith("PALLAS"):
            launches[f"16 mech {n}^3 {route}"] = launched
        F[route] = tr.state["buffers"]["F"]
        if first:
            F1 = f1
        if n == MECH_N:
            reset_all()
            post = tr.problem.run_postprocess_computes(tr.state, tr.time)["buffers"]
            got = {k: v for k, v in all_launches().items() if v}
            u = post["u"]
            assert tuple(u.shape) == (n + 1,) * 3 + (3,), u.shape
            assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(post["sV"]).all())
            want = projection_launches(1, 3) if route.startswith("PALLAS") else {}
            assert got == {k: v for k, v in want.items() if v}, (label, got)
            if route.startswith("PALLAS"):
                launches[f"16 displacements {n}^3 {route}"] = all_launches()
            nodes[route] = (u, post["sV"])
            if route.startswith("PALLAS"):
                con = tr.problem.get_compute("hyper_elasticity")
                fields = con.tangent_fields(tr.state["buffers"])
                dF = torch.randn(F[route].shape, device=dev, generator=torch.Generator(
                    device=dev).manual_seed(16))
                forms = {"the port's broadcast products": con.tangent_apply,
                         "the JAX file's component sums": M.tangent_apply_components,
                         "batched torch.matmul": M.tangent_apply_matmul}
                ref = con.tangent_apply(fields, dF)
                text = []
                for form, fn in forms.items():
                    rel = ((fn(fields, dF) - ref).abs().max() / ref.abs().max()).item()
                    assert rel <= 1e-5, (form, rel)
                    # the card is busy at 128³: CUDA events time the device
                    ms_f = cuda_ms(lambda: fn(fields, dF), reps=3, warmup=1)
                    text.append(f"{form} {ms_f:.3f} ms, {rel:.1e} from the first")
                say(f"[{label}] tangent_apply at {n}^3 (CUDA events): " + "; ".join(text)
                    + " (TF32 matmul "
                    f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
                    f"{torch.backends.cudnn.allow_tf32})")
                del fields, dF, ref
        mech_timing(tr, wall, steps, label, smi, profile=n == MECH_N)
        del tr
    diff = (F["PALLAS float32"] - F["DEFAULT float32"]).abs().max().item()
    say(f"[{tag} mech {n}^3] max|F_PALLAS - F_DEFAULT| {diff:.3e} (limit {MECH_ROUTE_TOL})")
    assert diff <= MECH_ROUTE_TOL, diff
    tr64, wall64, _l, _f, peak64 = mech_run(mech_text(n, MECH_F64, 1), dev, 1)
    mech_gates(tr64, _l, "DEFAULT", 1, f"{tag} mech DEFAULT float64 {n}^3")
    d64 = (F1.double() - tr64.state["buffers"]["F"]).abs().max().item()
    say(f"[{tag} mech {n}^3] DEFAULT float64, 1 step: run_deck {wall64:.2f} s, counts "
        f"{mech_counts(tr64)}, peak {peak64:.1f} MiB; float32 after step 1 against it "
        f"{d64:.3e} (limit {MECH_F64_TOL})")
    assert d64 <= MECH_F64_TOL, d64
    del tr64, F, F1
    if nodes:
        (up, sp), (ud, sd) = nodes["PALLAS float32"], nodes["DEFAULT float32"]
        du = ((up - ud).abs().max() / ud.abs().max()).item()
        ds = ((sp - sd).abs().max() / sd.abs().max()).item()
        say(f"[16e displacements] ComputeDisplacements {tuple(up.shape)}, max|u| "
            f"{ud.abs().max().item():.4e}: PALLAS against DEFAULT {du:.3e} of max|u| (limit "
            f"{DISP_TOL}); ComputeVonMisesStress {ds:.3e} of max sV")
        assert du <= DISP_TOL, du
    return launches


def phase_mech_precond(dev, smi):
    """(c) REFERENCE_MEDIUM at PRECOND_N³, float64 on DEFAULT, test_cg.py's
    tight tolerances, against the unpreconditioned solve."""
    res = {}
    for pre in ("NONE", "REFERENCE_MEDIUM"):
        text = mech_text(PRECOND_N, MECH_F64, 1, MECH_TIGHT + (f"preconditioner = {pre}",),
                         substeps=PRECOND_SUBSTEPS)
        tr, wall, launched, _f, _peak = mech_run(text, dev, 1)
        c = mech_counts(tr)
        assert c["failed"] == 0 and not any(launched.values()), (pre, c)
        say(f"[16c precond] {pre} {PRECOND_N}^3 float64, 1 step x {PRECOND_SUBSTEPS} "
            f"substeps: run_deck {wall:.2f} s, {c['cg']} CG iterations in {c['newton']} Newton "
            f"iterations, {1e3 * wall / max(c['cg_device'], 1):.3f} ms a CG iteration")
        res[pre] = {k: tr.state["buffers"][k] for k in ("F", "stress")}
        res[pre]["cg"] = c["cg"]
        del tr
    for k, tol in PRECOND_TOL.items():
        d = (res["REFERENCE_MEDIUM"][k] - res["NONE"][k]).abs().max().item()
        say(f"[16c precond] max|{k} REFERENCE_MEDIUM - NONE| {d:.3e} (limit {tol})")
        assert d <= tol, (k, d)
    assert res["REFERENCE_MEDIUM"]["cg"] < res["NONE"]["cg"], res


def phase_coupled_mech(dev, smi):
    """(d) COUPLED_PF_MECH_DECK at 256³, float32, STEPS × SUBSTEPS, PALLAS
    and DEFAULT.  Returns {run: launches}."""
    from marlin_tpu_torch import decks

    c, launches = {}, {}
    S = STEPS * SUBSTEPS
    # a substep: fft of µ, c and the three displacements, ifft of the three
    # displacements and of ū
    want = {"fwd_lanes": 5 * S, "fwd_sublanes": 10 * S, "inv_sublanes": 8 * S,
            "inv_lanes": 4 * S, "fwd_lanes_pre": 0, "fwd_x_update": 0, "fwd_x_update_poly": 0}
    gc.collect()
    for route, domain in MECH_ROUTES.items():
        label = f"16d coupled {route} {COUPLED_MECH_N}^3"
        deck = transient(decks.COUPLED_PF_MECH_DECK.format(
            n=COUPLED_MECH_N, substeps=SUBSTEPS, domain_extra=domain), 1, "c")
        tr, wall, launched = deck_run(deck, dev)
        got = {k: launched[k] for k in want}
        say(f"[{label}] {STEPS} steps x {SUBSTEPS} substeps: run_deck {wall:.2f} s, "
            f"{step_ms(tr, SUBSTEPS):.3f} ms a substep, launches {got}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; {smi}")
        if route.startswith("PALLAS"):
            assert got == want, (label, got, want)
            launches[f"16 coupled {route}"] = launched
        else:
            assert not any(launched.values()), (label, launched)
        mass(tr, label)
        b = tr.state["buffers"]
        finite({k: b[k] for k in ("c", "disp_x", "disp_y", "disp_z")}, label)
        umax = max(b[k].abs().max().item() for k in ("disp_x", "disp_y", "disp_z"))
        say(f"[{label}] max|u| {umax:.3e} (bounds 0, {DISP_MAX})")
        assert 0 < umax < DISP_MAX, umax
        c[route] = b["c"]
        del tr, b
    diff = (c["PALLAS float32"] - c["DEFAULT float32"]).abs().max().item()
    say(f"[16d coupled] max|c_PALLAS - c_DEFAULT| {diff:.3e} (limit {ANCHOR_TOL})")
    assert diff <= ANCHOR_TOL, diff
    return launches


def phase_fracture(dev, smi):
    """(f) the AT2 fracture deck (examples/phase_field_fracture/fracture.i)
    at its shipped 96², FRACTURE_STEPS of its 40 steps, its XDMF output
    binary (no h5py on the card): PALLAS float32 against DEFAULT float64 on
    d and the deck's three postprocessors.  Returns {run: launches}."""
    from marlin_tpu_torch import decks, hit
    from marlin_tpu_torch.executioner import run_deck

    out, launches = {}, {}
    for route, over in FRACTURE_ROUTES.items():
        reset_all()
        root = hit.load(decks.FRACTURE_DECK, over + [
            f"Executioner/num_steps={FRACTURE_STEPS}", "TensorOutputs/xdmf/enable_hdf5=false"])
        with tempfile.TemporaryDirectory() as out_dir:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr = run_deck(root, output_dir=out_dir, device=dev, deck_stem="fracture")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            frames = sorted(os.listdir(out_dir))
        launched = all_launches()
        c = mech_counts(tr)
        S = tr.step_count * tr.problem.solver.substeps
        label = f"16f fracture {route}"
        say(f"[{label}] {tr.step_count} steps x {tr.problem.solver.substeps} substeps at 96^2: "
            f"run_deck {wall:.2f} s, analytic tangent "
            f"{tr.problem.get_compute('mech').analytic_tangent}, counts {c}, pp {tr.pp_values}, "
            f"{len(frames)} output files")
        assert c["failed"] == 0 and bool(tr.state["buffers"]["__converged_mech__"]), c
        finite({k: tr.state["buffers"][k] for k in ("d", "F", "sV", "H")}, label)
        P = c["projections"]
        assert P == 2 * c["newton"] - c["solves"] + c["cg_device"], c
        # a substep: the projections, fft of Nreal and d, ifft of ū
        want = projection_launches(P, 2)
        want.update({"fwd_lanes": P + 2 * S, "fwd_sublanes": P + 2 * S,
                     "inv_sublanes": P + S, "inv_lanes": P + S})
        got = {k: launched[k] for k in want}
        if route.startswith("PALLAS"):
            say(f"[{label}] launches {got} (expected {want})")
            assert got == want, (got, want)
            launches[f"16 fracture {route}"] = launched
        else:
            assert not any(launched.values()), launched
        out[route] = (tr.state["buffers"]["d"].double(), dict(tr.pp_values))
        del tr
    (dp, pp), (dd, pd) = out["PALLAS float32"], out["DEFAULT float64"]
    errs = {"d": (dp - dd).abs().max().item()}
    errs.update({k: abs(pp[k] - pd[k]) / abs(pd[k]) for k in ("max_d", "crack_area", "max_sV")})
    say(f"[16f fracture] PALLAS float32 against DEFAULT float64: {errs} (limits "
        f"{FRACTURE_TOL}; d absolute, the postprocessors relative); {smi}")
    for k, tol in FRACTURE_TOL.items():
        assert errs[k] <= tol, (k, errs[k], tol)
    return launches


def phase_mechanics(uf, dev, smi):
    """Phase 16: FFT micromechanics.  Returns (the kernel rows at its
    shapes, {run: launches} on the register path, on the small path)."""
    t0 = time.perf_counter()
    # the earlier phases' garbage once, then out of every later collection:
    # the collections between this phase's runs scan only its own objects
    gc.collect()
    gc.freeze()
    gen = torch.Generator(device=dev).manual_seed(16)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    parts = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        return out

    rows = part("kernels", phase_mech_kernels, uf, dev, gen)
    register = part("(a) 128^3", phase_mech_rve, MECH_N, dev, smi)
    small = part("(b) 32^3", phase_mech_rve, MECH_SHIPPED_N, dev, smi)
    part("(c)", phase_mech_precond, dev, smi)
    register.update(part("(d)", phase_coupled_mech, dev, smi))
    small.update(part("(f)", phase_fracture, dev, smi))
    say(f"[16] FFT micromechanics in {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
        + f"; TF32 off: matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
        f"{torch.backends.cudnn.allow_tf32})")
    return rows, register, small


# -- the NN Gibbs surrogate and NEML2 ------------------------------------------------

KKS_N = 512  # (a) the analytic surrogate on the two-field chain, 2 steps x 10 substeps
KKS_MLP_N = 256  # (b) the MLP surrogate
SURROGATE_TOL = 1e-5  # (b) float32 G and jacobian against float64, of the largest
KKS_REFUSAL = "Compute 'gibbs' has outputs ['G', 'dGdn1', 'mu_c']"  # the JAX words
CREEP_DECK = os.path.join(HERE, "examples", "neml2_creep", "creep.i")
CREEP_STEPS = 20  # (c) creep.i's own, at its shipped 64²
CREEP_BIG = (1024, 5)  # then 1024², 5 steps
NEML2_N = 128  # (d) the Perzyna deck and the spectral split
NEML2_STEPS = 3
NEML2_DT = 0.1
NEML2_TOL = 1e-4  # (c), (d): float32 against float64, of the float64 buffer's largest
# ImplicitUpdate's absolute tolerance in float32, through the compute's
# cli_args: the models' own (creep.i's default 1e-10, the Perzyna model's
# 1e-9) sit at or below float32's rounding of a residual (unknowns of 5e-4 to
# 5e-3, ulp 6e-11 to 5e-10, some ten operations), where CPU runs took the
# 50-iteration cap at every step of creep.i and at the Perzyna deck's third
NEML2_F32_ABS_TOL = {"creep": "1e-9", "perzyna": "1e-8"}


def kks_deck(deck, model, backend, n, solver_extra=""):
    return transient(deck.format(
        n=n, model=model, solver_extra=solver_extra,
        domain_extra=f"fft_backend = {backend}\n  floating_precision = SINGLE").replace(
        "substeps = 5", f"substeps = {SUBSTEPS}"), MULTI_DT, "c")


def kks_launches():
    """Kernels 1-4 on the unfused two-field chain, a substep: the group's
    four forward transforms (µ_c, µ_n1, c, n1: one lanes and two sublanes
    launches each) and the inverse of c and n1 (two sublanes, one lanes)."""
    n_sub = STEPS * SUBSTEPS
    return {"fwd_lanes": 4 * n_sub, "fwd_lanes_pre": 0, "fwd_sublanes": 8 * n_sub,
            "inv_sublanes": 4 * n_sub, "inv_lanes": 2 * n_sub, "fwd_x_update": 0,
            "fwd_x_update_poly": 0}


def max_rel(got, ref):
    """max |got - ref| over the largest |ref| (0 where both vanish)."""
    scale = ref.abs().max().item()
    diff = (got.double() - ref.double()).abs().max().item()
    return diff / scale if scale else diff


def step_ms_once(tr):
    """Device ms a substep of one more step of a finished run (CUDA events;
    the run warmed every kernel of its step)."""
    p, st = tr.problem, tr.state
    return cuda_ms(lambda: p.step(st, tr.time, MULTI_DT, MULTI_DT, False),
                   reps=1, warmup=0) / SUBSTEPS


def gibbs_gates(gibbs, tr, dev, label):
    """The surrogate's module on the card in float32; three evaluations of
    the final state's rows equal bit for bit; the compute's device ms."""
    held = list(gibbs.model.parameters()) + list(gibbs.model.buffers())
    assert all(t.device.type == dev.type and t.dtype == torch.float32 for t in held), label
    b = tr.state["buffers"]
    X = torch.stack([b["n1"], b["c"]], -1).reshape(-1, 2)
    runs = [gibbs.evaluate(X) for _ in range(3)]
    assert all(torch.equal(G, runs[0][0]) and torch.equal(J, runs[0][1])
               for G, J in runs[1:]), label
    ms = cuda_ms(lambda: gibbs.apply(b, {}), reps=3, warmup=1)
    say(f"[17] {label}: module on {held[0].device if held else dev} "
        f"({len(held)} tensors, float32), 3 evaluations bit for bit; the compute "
        f"{ms:.3f} ms (CUDA events)")
    return X, ms


def phase_surrogate(uf, sp, dev, tmp, smi):
    """Phase 17 (a) and (b): the NN Gibbs surrogate on the two-field chain.
    Returns {run: launches}."""
    from marlin_tpu_torch import decks, hit
    from marlin_tpu_torch.computes.nn import gibbs_and_jacobian
    from marlin_tpu_torch.executioner import run_deck

    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    analytic = decks.gibbs_surrogate("analytic", os.path.join(tmp, "analytic.pt"))
    launches = {}
    # (a) 512³: PALLAS, its parsed twin, DEFAULT
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset(uf, sp)
    tr, wall = run_main_path(kks_deck(decks.KKS_NN_3D_DECK, analytic, "PALLAS", KKS_N), dev)
    launched = counters(uf, sp)
    say(f"[17] (a) KKS surrogate {KKS_N}^3 PALLAS float32, {STEPS} steps x {SUBSTEPS} "
        f"substeps: run_deck {wall:.2f} s, launches {launched}")
    assert launched == kks_launches(), (launched, kks_launches())
    launches["kks 512 PALLAS"] = launched
    mass(tr, "17a")
    finite(tr.state["buffers"], "17a")
    peak = torch.cuda.max_memory_allocated() / 2**30
    gibbs_gates(tr.problem.get_compute("gibbs"), tr, dev, "(a) analytic")
    ms_nn = step_ms_once(tr)
    fields = {k: tr.state["buffers"][k].clone() for k in ("c", "n1")}
    del tr
    tr, wall_p = run_main_path(kks_deck(decks.KKS_PARSED_3D_DECK, "", "PALLAS", KKS_N), dev)
    ms_parsed = step_ms_once(tr)
    for k, v in fields.items():
        d = (v - tr.state["buffers"][k]).abs().max().item()
        say(f"[17] (a) max|{k}_surrogate - {k}_parsed| (PALLAS) {d:.3e} (limit {ANCHOR_TOL})")
        assert d <= ANCHOR_TOL, (k, d)
    del tr
    tr, wall_d = run_main_path(kks_deck(decks.KKS_NN_3D_DECK, analytic, "DEFAULT", KKS_N), dev)
    ms_default = step_ms_once(tr)
    for k, v in fields.items():
        d = (v - tr.state["buffers"][k]).abs().max().item()
        say(f"[17] (a) max|{k}_PALLAS - {k}_DEFAULT| (surrogate) {d:.3e} (limit {ANCHOR_TOL})")
        assert d <= ANCHOR_TOL, (k, d)
    del tr, fields
    say(f"[17] (a) ms a substep: surrogate PALLAS {ms_nn:.3f}, parsed twin PALLAS "
        f"{ms_parsed:.3f}, surrogate DEFAULT {ms_default:.3f}; run_deck {wall:.2f} / "
        f"{wall_p:.2f} / {wall_d:.2f} s; peak device memory {peak:.2f} GiB; {smi}")
    # the fused flags: refused with the JAX package's words
    fused = kks_deck(decks.KKS_NN_3D_DECK, analytic, "PALLAS", 16, FUSED)
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            run_deck(hit.parse(fused), output_dir=out_dir, device=dev)
        raise AssertionError("the fused path took the surrogate deck")
    except Exception as e:  # noqa: BLE001 - the words are the gate
        assert str(e) == KKS_REFUSAL, repr(e)
    say(f"[17] (a) carry_reciprocal + fused_spectral refused: {KKS_REFUSAL!r}")

    # (b) the MLP surrogate at 256³
    mlp = decks.gibbs_surrogate("mlp", os.path.join(tmp, "mlp.pt"), seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset(uf, sp)
    tr, wall = run_main_path(kks_deck(decks.KKS_NN_3D_DECK, mlp, "PALLAS", KKS_MLP_N), dev)
    launches["kks mlp 256 PALLAS"] = counters(uf, sp)
    assert launches["kks mlp 256 PALLAS"] == kks_launches(), launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    mass(tr, "17b")
    gibbs = tr.problem.get_compute("gibbs")
    X, ms_compute = gibbs_gates(gibbs, tr, dev, "(b) mlp")
    G32, J32 = gibbs.evaluate(X)
    G64, J64 = gibbs_and_jacobian(torch.jit.load(mlp, map_location=dev).double(), X.double())
    errs = {"G": max_rel(G32, G64), "dGdn1": max_rel(J32[:, 0], J64[:, 0]),
            "mu_c": max_rel(J32[:, 1], J64[:, 1])}
    say(f"[17] (b) float32 module against float64 on the card, of the largest: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (limit {SURROGATE_TOL})")
    assert max(errs.values()) <= SURROGATE_TOL, errs
    ms_mlp = step_ms_once(tr)
    fields = {k: tr.state["buffers"][k].clone() for k in ("c", "n1")}
    del tr, X, G32, J32, G64, J64
    tr, wall_d = run_main_path(kks_deck(decks.KKS_NN_3D_DECK, mlp, "DEFAULT", KKS_MLP_N), dev)
    for k, v in fields.items():
        d = (v - tr.state["buffers"][k]).abs().max().item()
        say(f"[17] (b) max|{k}_PALLAS - {k}_DEFAULT| {d:.3e} (limit {ANCHOR_TOL})")
        assert d <= ANCHOR_TOL, (k, d)
    say(f"[17] (b) MLP surrogate {KKS_MLP_N}^3: {ms_mlp:.3f} ms a substep (PALLAS), the "
        f"compute {ms_compute:.3f} ms, DEFAULT {step_ms_once(tr):.3f} ms a substep; "
        f"run_deck {wall:.2f} / {wall_d:.2f} s; peak device memory {peak:.2f} GiB; {smi}")
    del tr, fields
    return launches


def neml2_model_of(tr, name):
    return tr.problem.get_compute(name).model


def run_creep(dev, tmp, overrides):
    from marlin_tpu_torch import hit
    from marlin_tpu_torch.executioner import run_deck

    out_dir = tempfile.mkdtemp(dir=tmp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = run_deck(hit.load(CREEP_DECK, overrides), output_dir=out_dir, device=dev,
                  deck_dir=os.path.dirname(CREEP_DECK))
    torch.cuda.synchronize()
    return tr, time.perf_counter() - t0


def creep_physics(tr, label):
    """tests/test_examples.py::test_neml2_creep_showcase's assertions: the
    stress below the elastic value, 0 <= ep <= e, the hot side relaxed
    more than ten times as far as the cold side."""
    b = tr.state["buffers"]
    sm, ep = b["sm"].double(), b["ep"].double()
    e = torch.broadcast_to(b["e"].double(), sm.shape)
    tol = 1e-6 if b["sm"].dtype == torch.float64 else 1e-5
    assert bool((sm <= 1000.0 * e + tol).all()), label
    assert bool((ep >= -1e-12).all()) and bool((ep <= e + 1e-9).all()), label
    nx = sm.shape[0]
    cold = (1000.0 * e - sm)[: nx // 4].mean().item()
    hot = (1000.0 * e - sm)[-nx // 4:].mean().item()
    assert hot > 10 * max(cold, 1e-9), (label, hot, cold)
    return hot, cold


def phase_neml2(dev, tmp, smi):
    """Phase 17 (c) and (d): NEML2 on the card."""
    from marlin_tpu_torch import decks, hit
    from marlin_tpu_torch.computes import neml2
    from marlin_tpu_torch.executioner import run_deck

    # (c) examples/neml2_creep/creep.i at its 64², all 20 steps, both precisions
    runs = {}
    f32_tol = ("TensorComputes/Solve/creep/cli_args=Models/impl/absolute_tolerance="
               + NEML2_F32_ABS_TOL["creep"])
    for prec in ("DOUBLE", "SINGLE"):
        tr, wall = run_creep(dev, tmp, [f"Domain/floating_precision={prec}"]
                             + ([f32_tol] if prec == "SINGLE" else []))
        assert tr.step_count == CREEP_STEPS, tr.step_count
        finite(tr.state["buffers"], f"17c {prec}")
        hot, cold = creep_physics(tr, f"17c {prec}")
        model = neml2_model_of(tr, "creep")
        counts = model.counts
        assert max(counts.log) < model.miter, (prec, counts.log)
        say(f"[17] (c) creep.i 64^2 {prec}: {wall:.2f} s for {tr.step_count} steps, "
            f"Newton {counts.iterations} iterations ({counts.log}), {counts.fetches} "
            f"fetches; relaxed hot {hot:.4e}, cold {cold:.4e}")
        runs[prec] = tr.state["buffers"]
    for k in ("ep", "sm"):
        d = max_rel(runs["SINGLE"][k], runs["DOUBLE"][k])
        say(f"[17] (c) creep.i float32 against float64: {k} {d:.3e} of the largest "
            f"(limit {NEML2_TOL})")
        assert d <= NEML2_TOL, (k, d)
    n, steps = CREEP_BIG
    tr, wall = run_creep(dev, tmp, [f"Domain/nx={n}", f"Domain/ny={n}",
                                    "Domain/floating_precision=SINGLE", f32_tol,
                                    f"Executioner/num_steps={steps}"])
    finite(tr.state["buffers"], "17c 1024")
    model = neml2_model_of(tr, "creep")
    counts = model.counts
    assert max(counts.log) < model.miter, counts.log
    say(f"[17] (c) creep.i {n}^2 float32, {steps} steps: {wall:.2f} s, "
        f"{1e3 * wall / steps:.1f} ms a step, Newton {counts.log}, {counts.fetches} fetches")
    del tr, runs

    # (d) the Perzyna deck and the spectral split at 128³
    model = os.path.join(tmp, "perzyna.i")
    spectral = os.path.join(tmp, "spectral.i")
    with open(model, "w") as f:
        f.write(decks.NEML2_PERZYNA_MODEL)
    with open(spectral, "w") as f:
        f.write(decks.NEML2_SPECTRAL_MODEL)
    out = {}
    for prec, cli in (("DOUBLE", ""), ("SINGLE", "cli_args = 'Models/impl/absolute_"
                                                  f"tolerance={NEML2_F32_ABS_TOL['perzyna']}'")):
        text = decks.NEML2_PERZYNA_DECK.format(
            n=NEML2_N, domain_extra=f"floating_precision = {prec}", dt=NEML2_DT,
            steps=NEML2_STEPS, model=model, spectral_model=spectral, cli_args=cli)
        with tempfile.TemporaryDirectory() as out_dir:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr = run_deck(hit.parse(text), output_dir=out_dir, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        b = tr.state["buffers"]
        finite(b, f"17d {prec}")
        comp = tr.problem.get_compute("perzyna")
        counts = comp.model.counts
        assert max(counts.log) < comp.model.miter, (prec, counts.log)
        steps_log, fetches = list(counts.log), counts.fetches
        # one more solve from the virgin state at the last step's strain
        virgin = {**b, "Ep_old": torch.zeros_like(b["Ep_old"]),
                  "ep_old": torch.zeros_like(b["ep_old"])}
        ms_solve = cuda_ms(lambda: comp.apply(virgin, {}), reps=1, warmup=0)
        its = counts.log[-1]
        say(f"[17] (d) Perzyna {NEML2_N}^3 {prec}: {wall:.2f} s for {NEML2_STEPS} steps; "
            f"Newton iterations a step {steps_log}, {fetches} fetches; a solve from the virgin state {ms_solve:.1f} ms for {its} iterations "
            f"({ms_solve / max(its, 1):.2f} ms an iteration, the first residual and the "
            f"final forward included); plastic share {(b['ep'] > 0).double().mean().item():.3f}")
        out[prec] = {k: b[k] for k in ("Ep", "ep", "S", "psi", "psi_inactive")}
        if prec == "DOUBLE":  # phase 19's anchor: the Newton log and the end state
            SERIAL["perzyna"] = (steps_log[:NEML2_STEPS],
                                 {k: v.cpu() for k, v in out[prec].items()})
        del tr, b, virgin
    for k in out["DOUBLE"]:
        d = max_rel(out["SINGLE"][k], out["DOUBLE"][k])
        say(f"[17] (d) float32 against float64: {k} {d:.3e} of the largest "
            f"(limit {NEML2_TOL})")
        assert d <= NEML2_TOL, (k, d)
    # eigvalsh at 128³ and its tangent at repeated eigenvalues, on the card
    E = torch.randn((NEML2_N,) * 3 + (3, 3), device=dev, generator=torch.Generator(
        device=dev).manual_seed(17))
    E = 0.5 * (E + E.transpose(-1, -2))
    ms_eig = cuda_ms(lambda: neml2.eigvalsh_3x3(E), reps=3, warmup=1)
    whole = {}
    for dtype in (torch.float32, torch.float64):  # one call over the whole batch
        try:
            whole[dtype] = f"{cuda_ms(lambda: torch.linalg.eigvalsh(E.to(dtype)), 1, 1):.2f} ms"
        except RuntimeError as e:
            whole[dtype] = f"refused ({str(e).splitlines()[0][:60]})"
    psis = neml2.load_neml2_model(spectral, "psis", device=dev)
    for point in ([0.0] * 6, [0.01, 0, 0, 0, 0, 0], [0.01, 0.01, 0.01, 0, 0, 0]):
        x = torch.tensor([point] * 4, device=dev)
        _, tan = torch.func.jvp(lambda e: psis.forward({"forces/Em": e}),
                                (x,), (torch.ones_like(x),))
        assert all(bool(torch.isfinite(t).all()) for t in tan.values()), point
    say(f"[17] (d) eigvalsh on ({NEML2_N}^3, 3, 3) float32 {ms_eig:.2f} ms in chunks of "
        f"{neml2.EIGVALSH_CHUNK} (CUDA events); one call: float32 {whole[torch.float32]}, "
        f"float64 {whole[torch.float64]}; the split's tangent finite at E = 0, uniaxial "
        f"and hydrostatic; {smi}")


def phase_surrogate_neml2(uf, sp, dev, smi):
    """Phase 17: the NN Gibbs surrogate and NEML2.  Returns {run: launches}."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        launches = phase_surrogate(uf, sp, dev, tmp, smi)
        t_ab = time.perf_counter() - t
        phase_neml2(dev, tmp, smi)
    say(f"[17] the NN surrogate and NEML2 in {time.perf_counter() - t0:.1f} s ((a)-(b) "
        f"{t_ab:.1f} s; TF32 off: matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
        f"{torch.backends.cudnn.allow_tf32})")
    return launches


# -- 18: the distributed modes --------------------------------------------------------
SLAB_P = (1, 2, 4)  # (a) kernel 5's slab form at 512³ cut p ways
SLAB_POLY_P = (1, 2)  # (a) kernel 6's: p = 1 is (b)'s world-of-one stack
HALO_PLANS = {  # (a) kernel 7's halo forms: plan -> (shape, [(px, py), ...]);
    # (1, 1) is (b)'s world-of-one block, its ring its own periodic wrap
    "porous": ((LBM_N,) * 3, [(1, 1), (2, 1), (4, 1), (2, 2)]),
    "allface_d3q27": ((LBM_N,) * 3, [(2, 1), (4, 1)]),
    "mixed": ((LBM_N,) * 3, [(2, 1)]),  # the post-stream faces' global path
    "thermal": ((LBM_N,) * 3, [(2, 1), (2, 2)]),
    "channel2d": (KARMAN + (1,), [(2, 1), (4, 1)]),
}
SLAB_TOL = {"DEFAULT": ANCHOR_TOL, "PALLAS": ANCHOR_TOL, "PALLAS fused": FUSED_ANCHOR_TOL}
SLAB_ROUTES = {"DEFAULT": ("DEFAULT", ""), "PALLAS": ("PALLAS", ""),
               "PALLAS fused": ("PALLAS", FUSED)}
SERIAL = {}  # host copies of phases 3-7's end states, for phase 18's gates


def nccl_world_of_one(dev):
    """A real NCCL process group of world size 1 on this process's card (a
    tcp store on a free localhost port), and its mesh's NCCL version."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", dev.index or 0))
    return ".".join(str(v) for v in torch.cuda.nccl.version())


def slab_kernel_rows(sp, dev, gen, serial_ms):
    """(a) kernels 5-6 in their slab form at 512³: the rank's X-sharded block
    (512/p, 512, 512) for p in SLAB_P (kernel 6: two fields, p in
    SLAB_POLY_P), against the twin, ms a launch beside serial kernel 5's
    (phase 2) and the byte bound."""
    def make(shape, dtype):
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev)

    args = (0.1, 1.5, -0.5)
    rows = []
    for p in SLAB_P:
        shape = (N // p, N, N)
        m, u, o = (make(shape, torch.complex64) for _ in range(3))
        ky2 = make((N,), torch.float32).abs().contiguous()
        kxz2 = make((shape[0] * N,), torch.float32).abs().contiguous()
        row = measure(f"fwd_x_update slab p={p}", shape,
                      lambda: sp.fwd_x_update(m, u, o, ky2, kxz2, *args, 5.0, ("lapsq", -10.0)),
                      lambda: sp.fwd_x_update_plain(m, u, o, ky2, kxz2, *args, 5.0,
                                                    ("lapsq", -10.0)),
                      None, 5 * nbytes(m) + nbytes(ky2, kxz2),
                      fft_flops(shape[0] * N, N) + 25 * m.numel())
        say(f"[18a] fwd_x_update slab p={p} {shape}: {row['ms']:.3f} ms a launch "
            f"({row['ms'] * p:.3f} ms for the whole grid's {p} blocks), serial kernel 5 at "
            f"{N}^3 {serial_ms:.3f} ms")
        rows.append(row)
        del m, u, o
    coef = np.asarray([[0.0, -5.0, 0.0, 0.0, -10.0], [1.0, 0.0, 0.0, -15.0, 0.0]], np.float32)
    rows8 = np.concatenate([np.tile(np.asarray(args, np.float32), (2, 1)), coef], 1)
    poly = []
    for p in SLAB_POLY_P:
        shape = (2, N // p, N, N)
        m, u, o = (make(shape, torch.complex64) for _ in range(3))
        ky2 = make((N,), torch.float32).abs().contiguous()
        kxz2 = make((N // p * N,), torch.float32).abs().contiguous()
        row = measure(f"fwd_x_update_poly slab p={p}", shape,
                      lambda: sp.fwd_x_update_poly(m, u, o, ky2, kxz2, rows8),
                      lambda: sp.fwd_x_update_poly_plain(m, u, o, ky2, kxz2, rows8),
                      None, 5 * nbytes(m) + nbytes(ky2, kxz2),
                      2 * fft_flops(N // p * N, N) + 25 * m.numel())
        say(f"[18a] fwd_x_update_poly slab p={p} {shape}: {row['ms']:.3f} ms a launch")
        poly.append(row)
        del m, u, o
        torch.cuda.empty_cache()
    return rows, poly


def halo_kernel_rows(lf, dev):
    """(a) kernel 7's halo forms: each plan of HALO_PLANS cut as its splits
    say, each block's halos sliced from its neighbours (lf.block_halo), run
    block by block on the walk the block gets (lf.walk_plan: the halo brick
    on one-lattice 3-D blocks, else the flat kernel) and on the flat halo
    form (``pack(b, None, offs)``); the blocks put together equal the
    unsharded flat kernel bit for bit and the twin within 1e-5.  ms a
    block's launch of each form beside the flat and the brick kernel on an
    unsharded plan of the block's shape, and the block's byte bound (the
    rings included)."""
    import dataclasses
    import itertools

    from marlin_tpu_torch.lbm_probe import deck_plans

    gen = torch.Generator(device=dev).manual_seed(18)
    plans = deck_plans()
    rows = []
    for name, (shape, splits) in HALO_PLANS.items():
        cfg = dataclasses.replace(plans[name], nx=shape[0], ny=shape[1], nz=shape[2])
        fpc = lbm_rand(cfg, shape, gen, dev).contiguous()
        gpc = lbm_rand(cfg, shape, gen, dev).contiguous() if cfg.two_lattice else None
        media = None
        if cfg.has_media:
            media = torch.as_tensor(porous_media(shape[0]), device=dev).to(torch.int8).contiguous()
            fpc = torch.where(media == 0, 0.0, fpc).contiguous()
        _plan, avec = lf._kernel_args(fpc, media, cfg, gpc, "chip_smoke")
        whole = lf.plan_stepper(fpc, media, cfg, gpc, lf.pack(cfg), avec)(fpc, gpc)
        twin = lf.fused_substep_twin(fpc, media, cfg, gpc)
        torch.cuda.synchronize()
        for split in splits:
            blocks, outs = {}, {}
            for ij in itertools.product(range(split[0]), range(split[1])):
                b, offs = lf.shard_plan(cfg, split, ij)
                fb, fr = lf.block_halo(fpc, b, offs, 1)
                gb, gr = lf.block_halo(gpc, b, offs, 1) if gpc is not None else (None, None)
                mb, mr = (lf.block_halo(media, b, offs, 0) if media is not None
                          else (None, None))
                _plan, avec_b = lf._kernel_args(fb, mb, b, gb, "chip_smoke", offs)
                flat_halo = lf.plan_stepper(fb, mb, b, gb, lf.pack(b, None, offs), avec_b)
                blocks[ij] = (b, offs, fb, gb, mb, (fr, gr, mr), flat_halo)
                outs[ij] = (lf.fused_substep(fb, mb, b, gb, rings=(fr, gr, mr), offsets=offs),
                            flat_halo(fb, gb, rings=(fr, gr, mr)))
            err = 0.0
            for form, k in itertools.product(range(2), range(len(whole))):
                got = torch.cat([torch.cat([outs[(i, j)][form][k] for j in range(split[1])],
                                           dim=-2) for i in range(split[0])], dim=-3)
                assert torch.equal(got, whole[k]), (name, split, form, k)
                err = max(err, check(f"lbm_substep halo {name} {split}", shape, got, twin[k]))
            b, offs, fb, gb, mb, rings, flat_halo = blocks[(0, 0)]
            block_walk = lf.walk_plan(b, fb.dtype, torch.cuda.get_device_properties(dev)
                                      .multi_processor_count)
            step = lf.substepper(fb, mb, b, gb, offs)
            ms = cuda_ms(lambda: step(fb, gb, rings=rings))
            ms_flat_halo = cuda_ms(lambda: flat_halo(fb, gb, rings=rings))
            local = dataclasses.replace(cfg, nx=b.nx, ny=b.ny)
            flat = lf.plan_stepper(fb, mb, local, gb, lf.pack(local), avec)
            ms_flat = cuda_ms(lambda: flat(fb, gb))
            walk = lf.walk_plan(local, fb.dtype, torch.cuda.get_device_properties(dev)
                                .multi_processor_count)
            ms_brick = None
            if walk is not None and not isinstance(walk, lf.PlanePlan):
                brick = lf.plan_stepper(fb, mb, local, gb, lf.pack(local, walk), avec)
                ms_brick = cuda_ms(lambda: brick(fb, gb))
            plain = cuda_ms(lambda: lf.fused_substep_twin(fb, mb, b, gb, rings, offs), reps=2,
                            warmup=1)
            lattices = 2 if cfg.two_lattice else 1
            cells = b.nx * b.ny * b.nz
            n_bytes = (2 * lattices * nbytes(fb) + cells * 4 + (cells if mb is not None else 0)
                       + nbytes(*[r for r in rings if r is not None]))
            bnd, by = bound_ms(n_bytes, lbm_flops(b) * cells, F32_NO_FMA_FLOP_PER_S)
            form = "flat" if block_walk is None else "brick"
            say(f"[18a] lbm_substep halo {name} {shape} split {split}: both forms' blocks equal "
                f"the flat kernel bit for bit, twin max_abs_err {err:.3e}; block "
                f"{(b.nx, b.ny, b.nz)} takes the {form} form: {ms:.3f} ms a launch "
                f"({bnd / ms:.0%} of its bound), flat halo form {ms_flat_halo:.3f} ms; unsharded "
                f"flat {ms_flat:.3f} ms, brick {'-' if ms_brick is None else f'{ms_brick:.3f}'} "
                f"ms; twin {plain:.3f} ms, bound {bnd:.3f} ms ({by})")
            rows.append({"shape": [name, list(shape), list(split)], "walk": form,
                         "max_abs_err": err, "ms": ms, "flat_halo_ms": ms_flat_halo,
                         "plain_ms": plain, "library_ms": None, "bound_ms": bnd,
                         "bound_by": by, "flat_ms": ms_flat, "brick_ms": ms_brick})
            del blocks, outs
        del fpc, gpc, media, whole, twin
        torch.cuda.empty_cache()
    for line in ptxas_report(lf.LIBRARY.log, lbm_kernel_name):
        if "halo=1" in line:
            say(f"[18a] ptxas {line}")
    return rows


def slab_deck(route, dev):
    """CH3D_DECK at 512³ float32 on FFT_SLAB over the world-of-one mesh."""
    backend, extra = SLAB_ROUTES[route]
    return ch3d_deck(backend, extra).replace("[Domain]",
                                             "[Domain]\n  parallel_mode = FFT_SLAB")


def mesh_run(deck, dev, mesh, arrays=None):
    from marlin_tpu_torch import hit
    from marlin_tpu_torch.executioner import run_deck

    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = run_deck(hit.parse(deck), output_dir=out_dir, device=dev, mesh=mesh,
                      arrays=arrays)
        torch.cuda.synchronize()
    return tr, time.perf_counter() - t0


def serial_diff(v, ref):
    """max|v − ref| for ``ref`` a host copy in SERIAL, on v's device (a
    512³ difference on the host takes a second)."""
    return (v - ref.to(v.device)).abs().max().item()


def step_copy_ms(tr, dt):
    """(device ms, leaves) of the copy that TensorProblem.step makes on an
    FFT mesh: the leaves that one step leaves strided, made contiguous
    (what keeps a resumed run the uninterrupted one bit for bit)."""
    p = tr.problem
    raw = p._step(tr.state, tr.time, dt, dt, False)
    strided = [v for part in ("buffers", "old", "solver") for v in raw[part].values()
               if isinstance(v, torch.Tensor) and not v.is_contiguous()]
    ms = cuda_ms(lambda: [v.contiguous() for v in strided], reps=5) if strided else 0.0
    return ms, len(strided)


def phase_distributed(uf, sp, lf, dev, smi, serial_ms, version):
    """Phase 18: the distributed modes.  (a) kernels 5-6 in slab form and
    kernel 7's halo branch at P > 1 in one process; (b) the decks on the
    NCCL group of world size 1 (``version`` its NCCL's).  Returns (rows,
    launches of (b))."""
    import torch.distributed as dist

    from marlin_tpu_torch import parallel

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(181)
    slab_rows, poly_rows = slab_kernel_rows(sp, dev, gen, serial_ms["kernel5"])
    halo_rows = halo_kernel_rows(lf, dev)
    t_a = time.perf_counter() - t0

    launches = {}
    mesh = parallel.make_mesh("FFT_SLAB")
    say(f"[18b] NCCL {version}, world size {dist.get_world_size()}, mesh {mesh}")
    n_sub = STEPS * SUBSTEPS
    for route in SLAB_ROUTES:
        reset(uf, sp)
        parallel.reset_calls()
        tr, wall = mesh_run(slab_deck(route, dev), dev, mesh)
        got = counters(uf, sp)
        calls = parallel.calls()
        S = SUBSTEPS
        if route == "DEFAULT":
            want = {k: 0 for k in got}
            a2a = 3 * n_sub
        elif route == "PALLAS":
            want = {"fwd_lanes": 2 * n_sub, "fwd_lanes_pre": 0,
                    "fwd_sublanes": 4 * n_sub, "inv_sublanes": 2 * n_sub,
                    "inv_lanes": n_sub, "fwd_x_update": 0, "fwd_x_update_poly": 0}
            a2a = 3 * n_sub
        else:
            want = {"fwd_lanes": STEPS * 2, "fwd_lanes_pre": STEPS * (S - 1),
                    "fwd_sublanes": STEPS * (2 + (S - 1) + 2),
                    "fwd_x_update": STEPS * (S - 1), "fwd_x_update_poly": 0,
                    "inv_sublanes": STEPS * 2 * S, "inv_lanes": STEPS * S}
            a2a = STEPS * (2 * S + 1)
        assert got == want, (route, got, want)
        assert calls["all_to_all"] == a2a, (route, calls, a2a)
        launches[f"slab {route}"] = got
        c = tr.state["buffers"]["c"]
        assert c.shape == (N, N, N) and bool(torch.isfinite(c).all()), route
        mass(tr, f"18b slab {route}")
        d = serial_diff(c, SERIAL[route])
        ms = substep_ms(tr, 1.0, reps=1)
        copy_ms, copied = step_copy_ms(tr, 1.0)
        say(f"[18b] CH3D {N}^3 FFT_SLAB {route}: run_deck {wall:.2f} s, {ms:.3f} "
            f"ms/substep (serial {serial_ms[route]:.3f}; of it the step's copy of {copied} "
            f"strided leaves, {copy_ms:.3f} ms a step), max|c_slab - c_serial| "
            f"{d:.3e} (limit {SLAB_TOL[route]}), launches exact, all_to_all {a2a}")
        assert d <= SLAB_TOL[route], (route, d)
        del tr, c
        torch.cuda.empty_cache()
    # the collective layer: one all_to_all of a 512³ complex64 block
    blk = torch.randn((N, N, N), generator=gen, dtype=torch.complex64, device=dev)
    a2a_ms = cuda_ms(lambda: parallel.all_to_all(mesh, blk, 0, 1), reps=5)
    say(f"[18b] all_to_all of a {N}^3 complex64 block at world size 1: {a2a_ms:.3f} ms "
        f"(3 a substep unfused, 2 fused)")
    del blk
    reset(uf, sp)
    tr, wall = mesh_run(multi_deck(FUSED).replace(
        "[Domain]", "[Domain]\n  parallel_mode = FFT_SLAB"), dev, mesh)
    got = counters(uf, sp)
    assert got["fwd_x_update_poly"] == STEPS * (SUBSTEPS - 1), got
    launches["slab multi fused"] = got
    mass(tr, "18b slab multi")
    for k in ("c", "n1"):
        d = serial_diff(tr.state["buffers"][k], SERIAL[f"multi {k}"])
        say(f"[18b] MULTI_3D {N}^3 FFT_SLAB fused: max|{k}_slab - {k}_serial| {d:.3e} "
            f"(limit {MULTI_TOL})")
        assert d <= MULTI_TOL, (k, d)
    say(f"[18b] MULTI_3D fused slab {substep_ms(tr, MULTI_DT, reps=1):.3f} ms/substep, "
        f"run_deck {wall:.2f} s")
    del tr
    torch.cuda.empty_cache()

    lmesh = parallel.make_mesh("REAL_SPACE")
    for backend in ("PALLAS", "JNP"):
        deck, arrays = lbm_deck("porous", backend)
        deck = deck.replace("[Domain]", "[Domain]\n  parallel_mode = REAL_SPACE")
        lf.reset_launches()
        parallel.reset_calls()
        tr, wall = mesh_run(deck, dev, lmesh, arrays)
        n = lf.launches()["lbm_substep"]
        want = (LBM_STEPS - 1) * (LBM_SUBSTEPS - 1) if backend == "PALLAS" else 0
        assert n == want, (backend, n, want)
        launches[f"real_space porous {backend}"] = {"lbm_substep": n}
        worst, equal = 0.0, True
        for k, ref in SERIAL[f"porous {backend}"].items():
            v = tr.state["buffers"][k]
            assert bool(torch.isfinite(v).all()), (backend, k)
            ref = ref.to(dev)
            d = (v - ref).abs().max().item()
            mag = ref.abs().max().item()
            assert d <= KERNEL_TOL * mag, (backend, k, d, mag)
            worst = max(worst, d / mag)
            equal = equal and torch.equal(v, ref)
            del ref
        # the halo brick of the world-of-one block gives the serial brick's bits
        assert equal or backend != "PALLAS", backend
        ms = lbm_substep_ms(tr)
        say(f"[18b] POROUS {LBM_N}^3 REAL_SPACE {backend}: run_deck {wall:.2f} s, "
            f"{ms:.3f} ms/substep (serial {serial_ms['porous ' + backend]:.3f}), "
            f"lbm_substep launches {n}, exchanges {parallel.calls()['exchange']}, "
            f"max relative |slab - serial| {worst:.3e} (limit {KERNEL_TOL}), "
            f"{'equal bits' if equal else 'bits differ'}")
        del tr
        torch.cuda.empty_cache()
    fpc = torch.rand((19,) + (LBM_N,) * 3, generator=gen, device=dev)
    ring_ms = cuda_ms(lambda: parallel.halo_ring(lmesh, fpc, 1, False), reps=5)
    say(f"[18b] halo ring of a {LBM_N}^3 D3Q19 float32 block at world size 1: "
        f"{ring_ms:.3f} ms (one a fused substep)")
    del fpc
    torch.cuda.empty_cache()
    say(f"[18] distributed modes in {time.perf_counter() - t0:.1f} s ((a) {t_a:.1f} s); "
        f"{smi}")
    rows = {"fwd_x_update slab": summarise(slab_rows),
            "fwd_x_update_poly slab": summarise(poly_rows),
            "lbm_substep halo": {
                **summarise(halo_rows),
                "forms": {"brick": "lbm_brick_kernel<Q, T, false, MRT, true> (one-lattice "
                                   "3-D blocks)",
                          "flat": "lbm_substep_kernel<Q, T, TWO, MRT> with LbmPlan.halo "
                                  "(two-lattice and 2-D blocks; flat_halo_ms on every row)"}},
            "collective": {"all_to_all_ms": a2a_ms, "halo_ring_ms": ring_ms}}
    return rows, launches

# -- 19: the mesh family ----------------------------------------------------------------

MESH_SUBSTEPS = 2  # (a) the pencil's CH3D run: STEPS steps of 2 substeps
PENCIL_TOL = 5e-5  # (a) c against the serial DEFAULT run (float32)
MESH_MECH_SUBSTEPS = 2  # (c) one step: the first substep unloaded, the second a solve
MESH_MECH_TOL = 1e-4  # (c) F and stress (tests/test_mechanics_parallel.py:94-98)
NEML2_MESH_TOL = 1e-10  # (d) float64, of each buffer's largest
LAP_N = 512  # (e) LAPLACIAN_RS_DECK 3-D, float32, the 5-point stencil
LAP_TOL = 1e-6  # (e) u against serial
SLAB_FFT_P = (2, 4)  # (f) kernels 1-4 in slab form: the blocks of p ranks
SLAB_FFT = {  # (f) name -> (block, the wrapper's view of it, dtype)
    "fwd_lanes slab": ("y", lambda b, p: (N * N // p, N), torch.float32),
    "fwd_sublanes slab": ("y", lambda b, p: (1, N, N * N // p), torch.complex64),
    "inv_sublanes slab": ("y", lambda b, p: (1, N, N * N // p), torch.complex64),
    "inv_lanes slab": ("y", lambda b, p: (N * N // p, N), torch.complex64),
    "fwd_sublanes slab x": ("x", lambda b, p: (N // p, N, N), torch.complex64),
    "inv_sublanes slab x": ("x", lambda b, p: (N // p, N, N), torch.complex64),
}


def slab_fft_rows(uf, dev, gen):
    """(f) kernels 1-4 in the slab form of fft_slab_pallas and its inverse:
    for p in SLAB_FFT_P, rank 0's Y-sharded block (N, N/p, N) (kernel 1
    along z, 3 and 4 along x, 2 along z with a real output) and X-sharded
    block (N/p, N, N) (3 and 4 along y), each cut from one 512³ field,
    against the twin within 1e-5 of its largest value; ms a launch, the
    twin's, torch.fft's and the byte bound."""
    library = {"fwd_lanes": lambda x: torch.fft.fft(x, dim=-1),
               "inv_lanes": lambda x: torch.fft.ifft(x, dim=-1).real,
               "fwd_sublanes": lambda x: torch.fft.fft(x, dim=1),
               "inv_sublanes": lambda x: torch.fft.ifft(x, dim=1)}
    rows = {}
    for name, (cut, view, dtype) in SLAB_FFT.items():
        base = name.split()[0]
        field = torch.randn((N,) * 3, generator=gen, dtype=dtype, device=dev)
        for p in SLAB_FFT_P:
            blk = (field[:, :N // p] if cut == "y" else field[:N // p]).contiguous()
            x = blk.reshape(view(blk, p))
            kernel, twin = getattr(uf, base), getattr(uf, base + "_plain")
            if base == "inv_lanes":
                run_k = lambda: kernel(x, real_output=True)
                run_t = lambda: twin(x, real_output=True)
            else:
                run_k, run_t = (lambda: kernel(x)), (lambda: twin(x))
            got = run_k()
            torch.cuda.synchronize()
            err = check(f"{name} p={p}", tuple(x.shape), got, run_t())
            del got
            n = x.shape[1] if "sub" in base else x.shape[-1]
            out_bytes = x.numel() * (4 if base == "inv_lanes" else 8)
            bnd, by = bound_ms(nbytes(x) + out_bytes + n * 8, fft_flops(x.numel() // n, n))
            row = {"shape": list(x.shape), "p": p, "max_abs_err": err,
                   "ms": cuda_ms(run_k, reps=5), "plain_ms": cuda_ms(run_t, reps=1, warmup=1),
                   "library_ms": cuda_ms(lambda: library[base](x), reps=5),
                   "bound_ms": bnd, "bound_by": by}
            say(f"[19f] {name} p={p} {tuple(x.shape)}: max_abs_err {err:.3e}, kernel "
                f"{row['ms']:.3f} ms, twin {row['plain_ms']:.3f} ms, torch.fft "
                f"{row['library_ms']:.3f} ms, bound {bnd:.3f} ms ({by})")
            rows.setdefault(base + " slab", []).append(row)
            del blk, x
        del field
        torch.cuda.empty_cache()
    return {k: summarise(v) for k, v in rows.items()}


def phase_mesh_family(uf, sp, dev, smi, version):
    """Phase 19: the mesh family over phase 18's NCCL group of world size 1: (a)
    CH3D on FFT_PENCIL, (b) ETDRK4 on FFT_SLAB, DEFAULT and PALLAS, (c) the
    deGeus RVE on FFT_SLAB and FFT_PENCIL, (d) the Perzyna deck on
    FFT_SLAB, (e) the 3-D REAL_SPACE Laplacian on a (1, 1, 1) mesh, (f)
    kernels 1-4 in slab form at p = 2 and 4.  Returns (rows, launches)."""
    import torch.distributed as dist

    from marlin_tpu_torch import decks, parallel

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(191)
    rows = slab_fft_rows(uf, dev, gen)
    t_f = time.perf_counter() - t0
    launches = {}
    slab = parallel.make_mesh("FFT_SLAB")
    pencil = parallel.make_mesh("FFT_PENCIL", shape=(1, 1))
    say(f"[19] NCCL {version}, world size {dist.get_world_size()}, meshes {slab}, "
        f"{pencil}")

    # (a) CH3D on the pencil, beside serial and the slab
    n_sub = STEPS * MESH_SUBSTEPS
    deck = ch3d_deck("DEFAULT").replace(f"substeps = {SUBSTEPS}",
                                         f"substeps = {MESH_SUBSTEPS}")
    ms, c = {}, {}
    for route, mode, mesh in (("serial", "NONE", None), ("slab", "FFT_SLAB", slab),
                              ("pencil", "FFT_PENCIL", pencil)):
        parallel.reset_calls()
        tr, wall, got = deck_run(deck.replace(
            "[Domain]", f"[Domain]\n  parallel_mode = {mode}"), dev, mesh=mesh)
        calls = parallel.calls()["all_to_all"]
        want = {"serial": 0, "slab": 3 * n_sub, "pencil": 6 * n_sub}[route]
        assert calls == want, (route, calls, want)
        assert not any(got.values()), (route, got)
        c[route] = tr.state["buffers"]["c"]
        assert c[route].shape == (N, N, N) and bool(torch.isfinite(c[route]).all())
        mass(tr, f"19a {route}")
        ms[route] = cuda_ms(lambda: tr.problem.step(tr.state, tr.time, 1.0, 1.0, False),
                            reps=2, warmup=1) / MESH_SUBSTEPS
        say(f"[19a] CH3D {N}^3 DEFAULT float32 {route}, {STEPS} steps x "
            f"{MESH_SUBSTEPS} substeps: run_deck {wall:.2f} s, {ms[route]:.3f} "
            f"ms/substep, all_to_all {calls}")
        del tr
    for route in ("slab", "pencil"):
        d = (c[route] - c["serial"]).abs().max().item()
        say(f"[19a] max|c_{route} - c_serial| {d:.3e} (limit {PENCIL_TOL})")
        assert d <= PENCIL_TOL, (route, d)
    say(f"[19a] ms/substep: pencil {ms['pencil']:.3f}, slab {ms['slab']:.3f}, serial "
        f"{ms['serial']:.3f}; two all_to_all a transform on the pencil, one on the slab")
    del c
    torch.cuda.empty_cache()

    # (b) ETDRK4 on the slab, on both backends, against phase 15's serial runs
    for backend in ("DEFAULT", "PALLAS"):
        S = STEPS * SUBSTEPS
        want = ({"fwd_lanes": 8 * S, "fwd_sublanes": 16 * S, "inv_lanes": 4 * S,
                 "inv_sublanes": 8 * S} if backend == "PALLAS" else {})
        deck = transient(decks.CH3D_ETDRK4_DECK.format(
            n=N, substeps=SUBSTEPS, solver_extra="cox_matthews = true").replace(
                "[Domain]", f"[Domain]\n  parallel_mode = FFT_SLAB\n  fft_backend = "
                f"{backend}\n  floating_precision = SINGLE"), 1, "c")
        parallel.reset_calls()
        tr, wall, got = deck_run(deck, dev, mesh=slab)
        got = {k: v for k, v in got.items() if v}
        assert got == want, (backend, got, want)
        launches[f"19 etdrk4 slab {backend}"] = got
        mass(tr, f"19b {backend}")
        d = serial_diff(tr.state["buffers"]["c"], SERIAL[f"etdrk4 {backend}"])
        say(f"[19b] ETDRK4 {N}^3 FFT_SLAB {backend} float32, {STEPS} x {SUBSTEPS}: "
            f"run_deck {wall:.2f} s, {substep_wall_ms(tr, 1.0):.3f} ms a substep, "
            f"all_to_all {parallel.calls()['all_to_all']}, launches {got}, "
            f"max|c_slab - c_serial| {d:.3e} (limit {ANCHOR_TOL})")
        assert d <= ANCHOR_TOL, (backend, d)
        del tr
        torch.cuda.empty_cache()

    # (c) the deGeus RVE on the slab and the pencil, against serial runs of
    # the same layouts (a pencil's half axis is x; at an even extent the
    # Green operator's Nyquist planes follow it)
    text = mech_text(MECH_N, MECH_ROUTES["DEFAULT float32"], 1,
                     substeps=MESH_MECH_SUBSTEPS)
    for mode, mesh in (("FFT_SLAB", slab), ("FFT_PENCIL", pencil)):
        deck = text.replace("[Domain]", f"[Domain]\n  parallel_mode = {mode}")
        runs = {}
        for where, m in (("serial", None), ("mesh", mesh)):
            tr, wall, _ = deck_run(deck, dev, mesh=m)
            cnt = mech_counts(tr)
            assert bool(tr.state["buffers"]["__converged_mech__"]), (mode, where)
            # one more step, timed by CUDA events: ms a CG iteration is
            # its time over its CG iterations (the Newton work between
            # them included)
            comp = tr.problem.get_compute("mech")
            before = dict(vars(comp.counts))
            ms_step = cuda_ms(lambda: tr.problem.step(tr.state, tr.time, MECH_DT,
                                                      MECH_DT, False), reps=1, warmup=0)
            extra = {k: v - before[k] for k, v in vars(comp.counts).items()}
            runs[where] = (tr.state["buffers"], cnt, ms_step / max(extra["cg_device"], 1),
                           extra)
            del tr, comp
        (sb, sc, s_ms, _), (mb, mc, m_ms, mx) = runs["serial"], runs["mesh"]
        assert (mc["newton"], mc["cg"]) == (sc["newton"], sc["cg"]), (mode, mc, sc)
        assert sc["reductions"] == 0 and mc["reductions"] >= 3 * mc["cg_device"], mc
        worst = {k: (mb[k] - sb[k]).abs().max().item() for k in ("F", "stress")}
        say(f"[19c] RVE {MECH_N}^3 DEFAULT float32 {mode}, 1 step x "
            f"{MESH_MECH_SUBSTEPS} substeps: Newton {mc['newton']}, CG {mc['cg']} "
            f"(serial {sc['newton']}, {sc['cg']}), group reductions "
            f"{mc['reductions']}; one more step {m_ms:.3f} ms a CG iteration with "
            f"{mx['reductions'] / max(mx['cg_device'], 1):.2f} group reductions each "
            f"(serial {s_ms:.3f}); max|F - F_serial| {worst['F']:.3e}, "
            f"max|stress - stress_serial| {worst['stress']:.3e} (limit {MESH_MECH_TOL})")
        assert max(worst.values()) <= MESH_MECH_TOL, (mode, worst)
        del runs, sb, mb
        torch.cuda.empty_cache()

    # (d) the Perzyna deck on the slab against phase 17's float64 run
    log, want_b = SERIAL["perzyna"]
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "perzyna.i")
        spectral = os.path.join(tmp, "spectral.i")
        with open(model, "w") as f:
            f.write(decks.NEML2_PERZYNA_MODEL)
        with open(spectral, "w") as f:
            f.write(decks.NEML2_SPECTRAL_MODEL)
        tr, wall, _ = deck_run(decks.NEML2_PERZYNA_DECK.format(
            n=NEML2_N, domain_extra="floating_precision = DOUBLE\n  parallel_mode = "
            "FFT_SLAB", dt=NEML2_DT, steps=NEML2_STEPS, model=model,
            spectral_model=spectral, cli_args=""), dev, mesh=slab)
    got_log = list(tr.problem.get_compute("perzyna").model.counts.log)
    worst = max(max_rel(tr.state["buffers"][k], v.to(dev)) for k, v in want_b.items())
    say(f"[19d] Perzyna {NEML2_N}^3 float64 FFT_SLAB: {wall:.2f} s, Newton a step "
        f"{got_log} (serial {log}), largest relative difference {worst:.3e} (limit "
        f"{NEML2_MESH_TOL})")
    assert got_log == log and worst <= NEML2_MESH_TOL, (got_log, log, worst)
    del tr

    # (e) the 3-D REAL_SPACE Laplacian on a (1, 1, 1) mesh: every axis
    # wraps through its own exchange
    real = parallel.make_mesh("REAL_SPACE", shape=(1, 1, 1))
    deck = decks.laplacian_rs(3, LAP_N, stencil=5, substeps=MESH_SUBSTEPS,
                              domain_extra="floating_precision = SINGLE")
    u = {}
    for where, m in (("serial", None), ("mesh", real)):
        parallel.reset_calls()
        tr, wall, _ = deck_run(deck, dev, mesh=m)
        u[where] = tr.state["buffers"]["u"]
        ex = parallel.calls()["exchange"]
        say(f"[19e] LAPLACIAN_RS {LAP_N}^3 float32 {where}: run_deck {wall:.2f} s, "
            f"exchanges {ex}")
        assert ex == (0 if m is None else 3 * 2 * MESH_SUBSTEPS), (where, ex)
        del tr
    d = (u["mesh"] - u["serial"]).abs().max().item()
    say(f"[19e] max|u_mesh - u_serial| {d:.3e} (limit {LAP_TOL})")
    assert bool(torch.isfinite(u["mesh"]).all()) and d <= LAP_TOL, d
    del u
    torch.cuda.empty_cache()
    say(f"[19] the mesh family in {time.perf_counter() - t0:.1f} s ((f) {t_f:.1f} s); {smi}")
    return rows, launches


# -- 20: the sharded checkpoint, the writers on a mesh, the native evaluator --------------

RESTART_N = 256  # (a) CH3D fused slab: 256³, not 512³ (the state's ~6 GiB would cost
# 15-20 s of the cold start to write and read; PERF.md gives the 512³ figure)
RESTART_STEPS = 2  # (a) steps of SUBSTEPS, step 1's checkpoint written
RESTART_1A = (4, 2, 100)  # (b) 1a DEFAULT float32 on the slab: steps, checkpoint, substeps
RESTART_1A_TOL = 5e-5  # (b) c of the mesh run against the serial run of the cut deck
FRACTURE_DECK = os.path.join(HERE, "examples", "phase_field_fracture", "fracture.i")
RESTART_XDMF = """
[TensorOutputs]
  [field]
    type = XDMFTensorOutput
    buffer = c
    enable_hdf5 = false
    execute_on = TIMESTEP_END
  []
[]
"""


def transient_of(deck, dev, mesh, out_dir, overrides=()):
    """run_deck's Transient of ``deck`` on ``mesh``, built but not run
    (its [TensorOutputs] under the stem "field")."""
    from marlin_tpu_torch import hit
    from marlin_tpu_torch.executioner import Transient
    from marlin_tpu_torch.outputs import build_tensor_outputs
    from marlin_tpu_torch.problem import TensorProblem

    root = hit.parse(deck)
    hit.apply_cli_args(root, list(overrides))
    problem = TensorProblem(root, device=dev, mesh=mesh)
    tr = Transient(problem, exec_node=root.children.get("Executioner"),
                   outputs_node=root.children.get("Outputs"),
                   user_objects_node=root.children.get("UserObjects"), output_dir=out_dir)
    tout = root.children.get("TensorOutputs")
    if tout is not None:
        tr.tensor_outputs.extend(build_tensor_outputs(tout, problem, output_dir=out_dir,
                                                      default_file_base="field"))
    return tr


def restart_slab(uf, sp, dev, mesh, smi):
    """(a) CH3D at RESTART_N³ float32 on the PALLAS fused slab, its
    checkpoint of step 1 written (``checkpoint_interval = 1``; step 2's
    save, which nothing reads, is skipped) and an XDMF frame of c; a fresh
    Transient resumed from step 1's checkpoint equals the uninterrupted run
    bit for bit, its frame's bytes are c, its launches one step's.  Returns
    its launches."""
    n, S = RESTART_N, SUBSTEPS
    deck = ch3d_deck("PALLAS", FUSED).replace("[Domain]", "[Domain]\n  parallel_mode = FFT_SLAB")
    deck = deck.replace(f"nx = {N}", f"nx = {n}").replace(f"ny = {N}", f"ny = {n}").replace(
        f"nz = {N}", f"nz = {n}").replace(f"xmax = {N}", f"xmax = {n}").replace(
        f"ymax = {N}", f"ymax = {n}").replace(f"zmax = {N}", f"zmax = {n}") + RESTART_XDMF
    one_step = {"fwd_lanes": 2, "fwd_lanes_pre": S - 1, "fwd_sublanes": 2 + (S - 1) + 2,
                "fwd_x_update": S - 1, "fwd_x_update_poly": 0, "inv_sublanes": 2 * S,
                "inv_lanes": S}
    with tempfile.TemporaryDirectory() as out_dir:
        # the uninterrupted run: its checkpoint of step 1 kept aside
        full = transient_of(deck, dev, mesh, os.path.join(out_dir, "full"), [
            f"Executioner/num_steps={RESTART_STEPS}", "Executioner/checkpoint_interval=1"])
        step1 = os.path.join(out_dir, "step1.npz")
        writes = []
        save = full.save_checkpoint

        def save_and_keep():
            if full.step_count != 1:
                return
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save()
            writes.append(time.perf_counter() - t0)
            os.replace(full.checkpoint_path, step1)

        full.save_checkpoint = save_and_keep
        reset(uf, sp)
        full.run()
        got_full = counters(uf, sp)
        want_full = {k: RESTART_STEPS * v for k, v in one_step.items()}
        assert got_full == want_full, (got_full, want_full)
        size = os.path.getsize(step1)
        # the resumed run: a fresh Transient from step 1's file
        res = transient_of(deck, dev, mesh, os.path.join(out_dir, "resumed"), [
            f"Executioner/num_steps={RESTART_STEPS}", "Executioner/checkpoint_interval=0"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res.recover(step1)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        reset(uf, sp)
        res.run()
        got = counters(uf, sp)
        say(f"[20a] CH3D {n}^3 PALLAS fused FFT_SLAB, {RESTART_STEPS} steps x {S} substeps: "
            f"launches uninterrupted {got_full}, resumed (1 step) {got} (expected {one_step})")
        assert got == one_step, (got, one_step)
        assert res.step_count == full.step_count == RESTART_STEPS and res.time == full.time
        states_equal(res.state, full.state)
        assert res.state["buffers"]["cbar"].dtype == torch.complex64
        c = full.state["buffers"]["c"]
        frame = np.fromfile(os.path.join(out_dir, "resumed", "field.c.0.bin"), dtype=np.float32)
        assert np.array_equal(frame.reshape(n, n, n).transpose(2, 1, 0), c.cpu().numpy())
        say(f"[20a] resumed bit for bit (every leaf, n_advances {res.state['n_advances']}, "
            f"old_dt {res.state['old_dt']}); its XDMF frame is c's bytes; checkpoint "
            f"{size} bytes, written in {writes[0]:.3f} s ({size / writes[0] / 1e9:.3f} GB/s), "
            f"read onto the card in {read_s:.3f} s ({size / read_s / 1e9:.3f} GB/s); {smi}")
    return got_full, got, {"bytes": size, "write_s": writes[0], "read_s": read_s}


def restart_1a(dev, mesh, smi):
    """(b) benchmark 1a at 200² DEFAULT float32 on the slab, cut to
    RESTART_1A, with phase 13's outputs (XDMF, Exodus of a LAGRANGE aux
    variable and ElementAverageValue, the histogram, CSV): the uninterrupted
    run keeps its checkpoint of the step ``at`` (its later save, which
    nothing reads, skipped), a fresh Transient resumes from it, and the
    rows, the histograms and the Exodus frames after the checkpoint equal
    the uninterrupted run's bit for bit, the histogram counts the cell
    count; c is within RESTART_1A_TOL of a serial run of the cut deck
    (without the outputs, which c does not read)."""
    from marlin_tpu_torch import hit
    from marlin_tpu_torch.bench_1a_runs import deck_text
    from marlin_tpu_torch.executioner import run_deck
    from marlin_tpu_torch.exodus import read_exodus

    steps, at, substeps = RESTART_1A
    n = BENCH_1A_N
    plain = deck_text(BENCH_1A_RUNS["DEFAULT float32"], n, substeps).replace(
        "  perf_graph = true\n", "")
    deck = (plain + OUTPUTS_1A).replace(
        "  csv = true\n", "  csv = true\n  exodus = true\n").replace(
        "[Postprocessors]\n", "[Postprocessors]\n  [c_avg]\n    type = ElementAverageValue\n"
        "    variable = c_aux\n  []\n", 1)
    slab = deck.replace("[Domain]", "[Domain]\n  parallel_mode = FFT_SLAB")
    with tempfile.TemporaryDirectory() as out_dir:
        d_full, d_res = (os.path.join(out_dir, r) for r in ("full", "resumed"))
        kept = os.path.join(out_dir, "at.npz")
        t0 = time.perf_counter()
        full = transient_of(slab, dev, mesh, d_full, [
            f"Executioner/num_steps={steps}", f"Executioner/checkpoint_interval={at}"])
        save = full.save_checkpoint

        def save_at():
            if full.step_count == at:
                save()
                os.replace(full.checkpoint_path, kept)

        full.save_checkpoint = save_at
        full.run()
        res = transient_of(slab, dev, mesh, d_res, [
            f"Executioner/num_steps={steps}", "Executioner/checkpoint_interval=0"])
        res.recover(kept)
        res.run()
        wall = time.perf_counter() - t0
        assert res.step_count == full.step_count == steps and res.time == full.time
        states_equal(res.state, full.state)
        rows = lambda d: text(d, "out.csv").splitlines()
        assert rows(d_res)[1:] == rows(d_full)[at + 2:], "CSV rows after the checkpoint"
        for i in range(at + 1, steps + 1):
            name = f"out_c_hist_{i:04d}.csv"
            assert text(d_res, name) == text(d_full, name), name
            counts = [float(r.split(",")[1]) for r in text(d_full, name).splitlines()[1:]]
            assert sum(counts) == n * n, (name, sum(counts))
        ef, er = (read_exodus(os.path.join(d, "out.e")) for d in (d_full, d_res))
        assert len(er["time"]) == steps - at and np.array_equal(er["time"], ef["time"][at + 1:])
        for kind in ("nodal", "glo"):
            for key, vals in ef[kind].items():
                assert np.array_equal(er[kind][key], vals[at + 1:]), (kind, key)
        root = hit.parse(plain)
        root.child("Executioner").set_param("num_steps", str(steps))
        serial = run_deck(root, output_dir=os.path.join(out_dir, "serial"), device=dev)
        d = (full.state["buffers"]["c"] - serial.state["buffers"]["c"]).abs().max().item()
        say(f"[20b] 1a {n}^2 DEFAULT float32 FFT_SLAB, {steps} steps x {substeps} substeps, "
            f"checkpoint at {at}: uninterrupted and resumed in {wall:.2f} s; CSV rows, "
            f"histograms (counts {n * n}) and Exodus frames {at + 1}-{steps} bit for bit; "
            f"max|c_slab - c_serial| {d:.3e} (limit {RESTART_1A_TOL}); {smi}")
        assert d <= RESTART_1A_TOL, d


def native_check(build_s):
    """(c) the native fparse evaluator: built beside the kernels in phase 1,
    and the ``${fparse}`` constants of fracture.i, which phase 16 runs,
    equal the Python engine's."""
    from marlin_tpu_torch import hit, native
    from marlin_tpu_torch.expression import Ops, parse

    assert native.available()
    exprs = re.findall(r"\$\{fparse\s+([^}]*)\}", text(FRACTURE_DECK))
    assert exprs
    for e in exprs:
        scope = {"pi": math.pi, "e": math.e}
        got, want = native.eval_scalar(e, scope), float(parse(e).evaluate(scope, Ops()))
        assert got == want, (e, got, want)
    calls = []
    real = native.eval_scalar

    def counted(expr, env=None):
        calls.append(expr)
        return real(expr, env)

    native.eval_scalar = counted
    try:
        hit.load(FRACTURE_DECK)
    finally:
        native.eval_scalar = real
    assert len(calls) == len(exprs), (calls, exprs)
    say(f"[20c] native fparse: {os.path.relpath(native.library_path(), HERE)} built in "
        f"{build_s:.2f} s (phase 1's pool); fracture.i's {len(exprs)} fparse constants equal "
        f"the Python engine's, and hit.load took the native engine for each")


def phase_restart_mesh(uf, sp, dev, smi, native_build_s):
    """Phase 20 on phase 18's NCCL group of world size 1: (a) the slab
    route's checkpoint, (b) the writers and resume on a 2-D slab, (c) the
    native evaluator.  Returns ({path: launches}, checkpoint figures)."""
    from marlin_tpu_torch import parallel

    t0 = time.perf_counter()
    mesh = parallel.make_mesh("FFT_SLAB")
    got_full, got_res, figures = restart_slab(uf, sp, dev, mesh, smi)
    torch.cuda.empty_cache()
    restart_1a(dev, mesh, smi)
    native_check(native_build_s)
    say(f"[20] sharded checkpoint, writers on a mesh, native fparse in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"20 restart slab full": got_full, "20 restart slab resumed": got_res}, figures


def main():
    if not torch.cuda.is_available():
        say("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
        return 1
    sys.path.insert(0, HERE)
    from marlin_tpu_torch import hit
    from marlin_tpu_torch import lbm_fused as lf
    from marlin_tpu_torch import native
    from marlin_tpu_torch import spectral as sp
    from marlin_tpu_torch import unordered_fft as uf
    from marlin_tpu_torch.decks import CH3D_DECK
    from marlin_tpu_torch.problem import TensorProblem

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # -- 1 (started first): build, one nvcc a library, all at once, and g++ of
    # phase 20's native fparse library beside them ------------------------------
    # the LBM substep library takes the longest: the spectral phases (2's FFT
    # rows, 3-6, 12) run while it builds, and its rows of phase 2 wait for it
    pool = concurrent.futures.ThreadPoolExecutor(5)

    def timed_build(lib):
        t0 = time.perf_counter()
        lib.build()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    libs = {"unordered_fft": uf.LIBRARY, "spectral_update": sp.LIBRARY,
            "lbm_substep": lf.LIBRARY}
    cold = {k: not os.path.exists(lib.path()) for k, lib in libs.items()}
    builds = {k: pool.submit(timed_build, lib) for k, lib in libs.items()}
    native_build = pool.submit(timed_build, native)
    # -- 0: toolchain ---------------------------------------------------------
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc = run([uf._nvcc(), "--version"]).splitlines()[-1]
    say(f"[toolchain] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, nvcc: {nvcc}")

    # -- 1, the generated library: the plan of the fused deck gives the µ of
    # the lanes kernel's read; its library is named by the generated source,
    # the same at every extent (the deck's constants wait for the g++ build)
    small = TensorProblem(hit.parse(CH3D_DECK.format(n=16, substeps=2).replace(
        "[Domain]", "[Domain]\n  fft_backend = PALLAS\n  floating_precision = SINGLE"
    ).replace("[TensorSolver]", f"[TensorSolver]\n  {FUSED}")), device=dev)
    pre = sp.match_chain(small.solver).pre
    key = "fwd_lanes_pre (Cahn-Hilliard µ)"
    libs[key] = pre.library
    cold[key] = not os.path.exists(pre.library.path())
    builds[key] = pool.submit(timed_build, pre.library)

    def loaded(keys):
        for k in keys:
            seconds = builds[k].result()
            libs[k].load()
            say(f"[build] {'built' if cold[k] else 'reused'} {k}: "
                f"{os.path.relpath(libs[k].path(), HERE)} in {seconds:.2f} s")

    # phase 12's float64 reference run needs torch.fft alone: it runs while
    # the libraries build, the rest of phase 12 after phase 6
    ref_1a = phase_bench_1a(uf, sp, dev, smi, runs=["DEFAULT float64"])
    lap("12 (benchmark 1a: DEFAULT float64, beside the builds)", t_start)
    spectral = ("unordered_fft", "spectral_update", "fwd_lanes_pre (Cahn-Hilliard µ)")
    loaded(spectral)
    for k in spectral:
        for line in ptxas_report(libs[k].log, fft_kernel_namer(uf)):
            say(f"[build] ptxas {k}: {line}")
    lap("1 (spectral libraries)", t_start)

    # -- 2: kernels against their twins (the FFT and k-space update rows) --------
    # inputs drawn on the card: a 512³ complex draw takes seconds on the host
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = phase_fft_kernels(uf, dev, gen)
    dom = TensorProblem(hit.parse(CH3D_DECK.format(n=N, substeps=2).replace(
        "[Domain]", "[Domain]\n  fft_backend = PALLAS\n  floating_precision = SINGLE")),
        device=dev).domain
    kernels.update(phase_fused_kernels(uf, sp, dev, gen, pre, sp._k2_tables(dom)))
    del dom
    lap("2 (spectral kernels)", t_start)

    # -- 3: the main path -----------------------------------------------------
    reset(uf, sp)
    tr, wall = run_main_path(ch3d_deck("PALLAS"), dev)
    launches = counters(uf, sp)
    n_sub = STEPS * SUBSTEPS
    # each substep: mubar = fft(mu) and cbar = fft(c), each one lanes and two
    # sublanes launches; c = ifft(ū), two sublanes and one lanes launch
    expected = {"fwd_lanes": 2 * n_sub, "fwd_lanes_pre": 0,
                "fwd_sublanes": 4 * n_sub, "inv_sublanes": 2 * n_sub,
                "inv_lanes": n_sub, "fwd_x_update": 0, "fwd_x_update_poly": 0}
    say(f"[main] PALLAS {N}^3, {STEPS} steps x {SUBSTEPS} substeps: "
        f"run_deck {wall:.2f} s, launches {launches}")
    assert launches == expected, (launches, expected)
    c_pallas = tr.state["buffers"]["c"]
    SERIAL["PALLAS"] = c_pallas.cpu()  # phase 18's serial anchors
    assert c_pallas.shape == (N, N, N) and c_pallas.dtype == torch.float32
    assert bool(torch.isfinite(c_pallas).all())
    mass(tr, "main")
    say(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ms_pallas = substep_ms(tr, 1.0)
    say(f"[main] PALLAS {ms_pallas:.3f} ms/substep")
    del tr

    # -- 4: the library anchor -------------------------------------------------
    tr_def, wall_def = run_main_path(ch3d_deck("DEFAULT"), dev)
    ms_default = substep_ms(tr_def, 1.0)
    c_default = tr_def.state["buffers"]["c"]
    SERIAL["DEFAULT"] = c_default.cpu()
    diff = (c_default - c_pallas).abs().max().item()
    say(f"[anchor] DEFAULT run_deck {wall_def:.2f} s, {ms_default:.3f} ms/substep; "
        f"PALLAS {ms_pallas:.3f} ms/substep; max|c_PALLAS - c_DEFAULT| {diff:.3e} "
        f"(limit {ANCHOR_TOL})")
    assert diff <= ANCHOR_TOL, diff
    del tr_def, c_pallas

    # -- 5: the fused single-field path ----------------------------------------
    reset(uf, sp)
    torch.cuda.reset_peak_memory_stats()
    tr, wall = run_main_path(ch3d_deck("PALLAS", FUSED), dev)
    fused_launches = counters(uf, sp)
    # per step (3-D): the ū seed fft(c), 1 lanes + 2 sublanes; each of the
    # S-1 fused substeps 1 lanes with µ fused + 1 sublanes + 1 fwd_x_update
    # + 2 inverse sublanes + 1 inverse lanes; the trailing regular substep
    # fft(µ), 1 lanes + 2 sublanes, and ifft(ū), 2 sublanes + 1 lanes
    S = SUBSTEPS
    expected = {"fwd_lanes": STEPS * 2, "fwd_lanes_pre": STEPS * (S - 1),
                "fwd_sublanes": STEPS * (2 + (S - 1) + 2),
                "fwd_x_update": STEPS * (S - 1), "fwd_x_update_poly": 0,
                "inv_sublanes": STEPS * 2 * S, "inv_lanes": STEPS * S}
    say(f"[fused] PALLAS fused {N}^3, {STEPS} steps x {S} substeps: run_deck "
        f"{wall:.2f} s, launches {fused_launches}")
    assert fused_launches == expected, (fused_launches, expected)
    c_fused = tr.state["buffers"]["c"]
    SERIAL["PALLAS fused"] = c_fused.cpu()
    assert c_fused.shape == (N, N, N) and bool(torch.isfinite(c_fused).all())
    mass(tr, "fused")
    diff_f = (c_fused - c_default).abs().max().item()
    ms_fused = substep_ms(tr, 1.0)
    say(f"[fused] {ms_fused:.3f} ms/substep (PALLAS {ms_pallas:.3f}, DEFAULT "
        f"{ms_default:.3f}); max|c_fused - c_DEFAULT| {diff_f:.3e} (limit "
        f"{FUSED_ANCHOR_TOL}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    assert diff_f <= FUSED_ANCHOR_TOL, diff_f
    del tr, c_fused, c_default

    # -- 6: the fused N-field path ------------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset(uf, sp)
    tr_m, wall_m = run_main_path(multi_deck(FUSED), dev)
    multi_launches = counters(uf, sp)
    say(f"[multi] fused {N}^3, 2 fields, {STEPS} steps x {S} substeps: run_deck "
        f"{wall_m:.2f} s, launches {multi_launches}")
    assert multi_launches["fwd_x_update_poly"] == STEPS * (S - 1), multi_launches
    assert multi_launches["fwd_x_update"] == multi_launches["fwd_lanes_pre"] == 0
    assert min(multi_launches[k] for k in ("fwd_lanes", "fwd_sublanes",
                                           "inv_sublanes", "inv_lanes")) > 0
    mass(tr_m, "multi")
    ms_multi = substep_ms(tr_m, MULTI_DT)
    fields = {k: tr_m.state["buffers"][k] for k in ("c", "n1")}
    SERIAL.update({f"multi {k}": v.cpu() for k, v in fields.items()})
    del tr_m
    tr_u, wall_u = run_main_path(multi_deck("carry_reciprocal = true"), dev)
    ms_multi_unfused = substep_ms(tr_u, MULTI_DT)
    for k, v in fields.items():
        assert bool(torch.isfinite(v).all()), k
        d = (v - tr_u.state["buffers"][k]).abs().max().item()
        say(f"[multi] max|{k}_fused - {k}_unfused| {d:.3e} (limit {MULTI_TOL})")
        assert d <= MULTI_TOL, (k, d)
    say(f"[multi] fused {ms_multi:.3f} ms/substep, unfused (carry) "
        f"{ms_multi_unfused:.3f} ms/substep (run_deck {wall_u:.2f} s); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del tr_u, fields
    lap("3-6 (3-D spectral paths)", t_start)

    # -- 12: benchmark 1a, the 200² spinodal decomposition whole --------------------
    # run before the LBM phases: its host-bound runs need only the spectral
    # libraries, and the LBM library goes on building meanwhile
    launches_1a = {run: v[3] for run, v in phase_bench_1a(
        uf, sp, dev, smi, [r for r in BENCH_1A_RUNS if r not in ref_1a], ref_1a).items()}
    lap("12 (benchmark 1a)", t_start)

    # -- 1 and 2, the rest: the LBM substep library and its kernel rows -----------
    loaded(["lbm_substep"])
    pool.shutdown()
    say(f"[build] all libraries in {time.perf_counter() - t0:.2f} s (the spectral "
        f"phases ran meanwhile)")
    for line in ptxas_report(lf.LIBRARY.log, lbm_kernel_name):
        say(f"[build] ptxas {line}")
    lbm_rows, mean_rows = phase_lbm_kernel(lf, dev)
    say("[kernels] ok")
    lap("2 (LBM kernels)", t_start)

    # -- 7 to 10: the LBM paths ------------------------------------------------
    lbm_launches = 0
    lbm_ms = {}
    for name in LBM_PATHS:
        launched, ms_pallas_lbm, ms_jnp_lbm = phase_lbm_path(name, dev)
        lbm_launches += launched
        lbm_ms[name] = (ms_pallas_lbm, ms_jnp_lbm)
        say(f"[lbm {name}] lbm_substep {lbm_rows[name]['ms']:.3f} ms a launch "
            f"(bound {lbm_rows[name]['bound_ms']:.3f}); ms/substep PALLAS "
            f"{ms_pallas_lbm:.3f}, JNP {ms_jnp_lbm:.3f}")

    # -- 11: the 2-D Kármán path -------------------------------------------------
    karman_launches, ms_pallas_k, ms_jnp_k = phase_karman(dev)
    kname = f"karman {KARMAN[0]}x{KARMAN[1]}"
    lbm_launches += karman_launches["lbm_substep"]
    lbm_ms[kname] = (ms_pallas_k, ms_jnp_k)
    say(f"[karman] lbm_substep {lbm_rows[kname]['ms']:.4f} ms a launch, its mean density "
        f"inside (bound {lbm_rows[kname]['bound_ms']:.4f}); ms/substep PALLAS "
        f"{ms_pallas_k:.4f}, JNP {ms_jnp_k:.4f}")
    host_us = karman_host_us(lf, dev)
    say(f"[karman] host {host_us:.2f} us a fused substep at {KARMAN[0]}x{KARMAN[1]} (the fused "
        f"loop's wrapper, {HOST_CALLS} back-to-back calls, one sync)")
    lbm = summarise([lbm_rows[name] for name in list(LBM_PATHS) + [kname]])
    lbm["yardstick"] = "the eager JNP substep (run_deck, lbm_backend = JNP)"
    lbm["yardstick_ms"] = sum(jnp for _p, jnp in lbm_ms.values()) / len(lbm_ms)
    # every plan's own row, each at its main extent
    lbm["plans"] = lbm_rows
    kernels["lbm_substep"] = lbm
    kernels["lbm_density_mean"] = summarise(mean_rows[:1])
    kernels["lbm_density_mean"]["plans"] = {f"karman {x}x{y}": row
                                            for (x, y), row in zip(LBM_2D, mean_rows)}
    kernels["lbm_density_mean"]["note"] = (
        "no launch of its own: launches counts the lbm_substep launches that computed the "
        "mean inside; ms is that launch's device time less the flat lbm_substep launch "
        "given the mean; plain_ms is density_mean_twin's device time")

    lap("7-11 (LBM paths)", t_start)

    # -- 13: outputs and restart -------------------------------------------------------
    launches_13 = phase_outputs(uf, sp, lf, dev, smi)
    lap("13 (outputs and restart)", t_start)

    # -- 14: the rest of lattice Boltzmann and the spectral family -----------------------
    launches_14 = phase_rest(dev, smi)
    lap("14 (two-phase, pressure, specular LBM; spectral family; batch_fft; legacy 1a)",
        t_start)

    # -- 15: the rest of the solver family and the iteration-driven timestepper ----------
    launches_15 = phase_solvers(dev, smi)
    lap("15 (ETDRK4, secant, Broyden, coupled ABM, forward Euler, predictor)", t_start)

    # -- 16: FFT micromechanics -------------------------------------------------------
    mech_rows, launches_16, launches_16_small = phase_mechanics(uf, dev, smi)
    for (name, on_small), rows in mech_rows.items():
        kernels[f"{name} small" if on_small else name]["mechanics_shapes"] = rows
    lap("16 (FFT micromechanics: deGeus RVE, preconditioner, eigenstrain chain, "
        "displacements, AT2 fracture)", t_start)

    # -- 17: the NN Gibbs surrogate and NEML2 -------------------------------------------
    launches_17 = phase_surrogate_neml2(uf, sp, dev, smi)
    lap("17 (NN Gibbs surrogate, NEML2)", t_start)

    # -- 18 and 19: the distributed modes and the mesh family, on one NCCL group -------------
    import torch.distributed as dist

    version = nccl_world_of_one(dev)
    try:
        dist_rows, launches_18 = phase_distributed(uf, sp, lf, dev, smi, {
            "kernel5": kernels["fwd_x_update"]["ms"], "DEFAULT": ms_default,
            "PALLAS": ms_pallas, "PALLAS fused": ms_fused,
            "porous PALLAS": lbm_ms["porous"][0], "porous JNP": lbm_ms["porous"][1]},
            version)
        lap("18 (distributed modes: slab and halo kernels, NCCL world of one)", t_start)
        slab_fft, launches_19 = phase_mesh_family(uf, sp, dev, smi, version)
        lap("19 (mesh family: pencil, ETDRK4 slab, sharded mechanics and NEML2, z cut)",
            t_start)
        # -- 20: the sharded checkpoint and the writers on the same group ------------------
        launches_20, _figures = phase_restart_mesh(uf, sp, dev, smi, native_build.result())
    finally:
        dist.destroy_process_group()
    SERIAL.clear()
    lap("20 (sharded checkpoint, writers on a mesh, native fparse)", t_start)
    say(f"[done] {time.perf_counter() - t_start:.1f} s")

    # -- result -----------------------------------------------------------------
    table = [
        ("fwd_lanes", "unordered_fft.cu", "marlin_tpu/pallas_fft.py:237", launches),
        ("inv_lanes", "unordered_fft.cu", "marlin_tpu/pallas_fft.py:276", launches),
        ("fwd_sublanes", "unordered_fft.cu", "marlin_tpu/pallas_fft.py:340", launches),
        ("inv_sublanes", "unordered_fft.cu", "marlin_tpu/pallas_fft.py:355", launches),
        ("fwd_lanes_pre", "fft_tile.cuh", "marlin_tpu/pallas_fft.py:237",
         fused_launches),
        ("fwd_x_update", "spectral_update.cu", "marlin_tpu/pallas_spectral.py:120",
         fused_launches),
        ("fwd_x_update_poly", "spectral_update.cu",
         "marlin_tpu/pallas_spectral.py:203", multi_launches),
        ("lbm_substep", "lbm_substep.cu", "marlin_tpu/pallas_lbm.py:224",
         {"lbm_substep": lbm_launches}),
        ("lbm_density_mean", "lbm_substep.cu", "marlin_tpu/pallas_lbm.py:687",
         karman_launches),
    ]
    # the small-extent kernels, timed at benchmark 1a's 200²: their launches
    # are those of the 1a runs and of the 2a stand-ins' (every transform
    # there is at n = 200)
    paths_1a = {f"1a {run}": counts for run, counts in launches_1a.items()
                if run.startswith("PALLAS")}
    paths_1a.update({k: v for k, v in launches_13.items() if " 1a " in k})
    paths_1a.update(launches_14["small"])
    paths_1a.update(launches_15["small"])
    paths_1a.update(launches_16_small)
    paths_karman = {k: v for k, v in launches_13.items() if " karman " in k}
    paths_14 = {**launches_14["main"], **launches_15["main"], **launches_16, **launches_17}
    # phase 20's slab runs: kernel 1' on its own row, 5s on the slab row
    # (entry_dist), kernels 1-4 on the slab FFT rows (entry_slab_fft)
    paths_14.update({k: {"fwd_lanes_pre": v["fwd_lanes_pre"]} for k, v in launches_20.items()})
    launches_18.update(launches_20)
    launches_19.update(launches_20)
    table_small = [
        ("fwd_lanes", "small_lanes_kernel<Identity, Store>", "marlin_tpu/pallas_fft.py:237"),
        ("inv_lanes", "small_lanes_kernel<Identity, InvStore>", "marlin_tpu/pallas_fft.py:276"),
        ("fwd_sublanes", "small_sublanes_kernel<Store>", "marlin_tpu/pallas_fft.py:340"),
        ("inv_sublanes", "small_sublanes_kernel<InvStore>", "marlin_tpu/pallas_fft.py:355"),
        ("fwd_lanes_pre", "small_lanes_kernel<Pre, Store>", "marlin_tpu/pallas_fft.py:237"),
        ("fwd_x_update", "small_sublanes_kernel<Update>", "marlin_tpu/pallas_spectral.py:120"),
    ]

    def entry(name, src, replaces, counts):
        # phase 13's Kármán runs launch the LBM kernel too
        by_path = {"main": counts[name], **{k: v[name] for k, v in paths_karman.items()
                                            if v.get(name)},
                   **{k: v[name] for k, v in paths_14.items() if v.get(name)}}
        return {"name": name, "route": "cuda",
                "source": f"marlin_tpu_torch/csrc/{src}", "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                **kernels[name]}

    def entry_small(name, kernel, replaces):
        by_path = {k: v[name] for k, v in paths_1a.items() if v.get(name)}
        return {"name": f"{name} small", "kernel": kernel, "route": "cuda",
                "source": "marlin_tpu_torch/csrc/fft_tile.cuh", "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                **kernels[f"{name} small"]}

    def entry_dist(name, src, replaces, runs):
        # the slab and halo forms: launched by phase 18's (b) runs
        base = name.split()[0]
        by_path = {k: v[base] for k, v in launches_18.items() if k in runs and v.get(base)}
        return {"name": name, "route": "cuda",
                "source": f"marlin_tpu_torch/csrc/{src}", "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                **dist_rows[name]}

    table_dist = [
        ("fwd_x_update slab", "spectral_update.cu", "marlin_tpu/pallas_spectral.py:308",
         ("slab PALLAS fused", "20 restart slab full", "20 restart slab resumed")),
        ("fwd_x_update_poly slab", "spectral_update.cu", "marlin_tpu/pallas_spectral.py:336",
         ("slab multi fused",)),
        ("lbm_substep halo", "lbm_substep.cu", "marlin_tpu/pallas_lbm.py:224",
         ("real_space porous PALLAS",)),
    ]
    def entry_slab_fft(name, replaces):
        # kernels 1-4 in slab form: launched by phase 19's ETDRK4 slab PALLAS run
        base = name.split()[0]
        by_path = {k: v[base] for k, v in launches_19.items() if v.get(base)}
        return {"name": name, "route": "cuda", "source": "marlin_tpu_torch/csrc/unordered_fft.cu",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, **slab_fft[name]}

    table_slab_fft = [
        ("fwd_lanes slab", "marlin_tpu/pallas_fft.py:237"),
        ("fwd_sublanes slab", "marlin_tpu/pallas_fft.py:340"),
        ("inv_sublanes slab", "marlin_tpu/pallas_fft.py:355"),
        ("inv_lanes slab", "marlin_tpu/pallas_fft.py:276"),
    ]
    line = {"kernels": [entry(*row) for row in table]
            + [entry_small(*row) for row in table_small]
            + [entry_dist(*row) for row in table_dist]
            + [entry_slab_fft(*row) for row in table_slab_fft],
            "collective": dist_rows["collective"]}
    for k in line["kernels"]:
        assert k["launches"] > 0, (k["name"], k["launches_by_path"])
    say(json.dumps(line))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
