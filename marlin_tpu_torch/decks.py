"""In-repo decks the port's smoke run and tests drive.

Copies of decks of the JAX package's benchmark and tests, which import
jax and so may not be imported by the port; tests/test_torch_deck.py holds
each copy equal to its original.

- ``CH3D_DECK``: bench.py's ``_CH3D_DECK``, the 3-D semi-implicit
  Cahn-Hilliard solve, formatted with ``n`` (grid extent per axis) and
  ``substeps``.
- ``CH_DECK``, ``SH_DECK``, ``MULTI_DECK``: tests/test_pallas_spectral.py's
  ``_CH`` (2-D Cahn-Hilliard, 128²), ``_SH`` (2-D Swift-Hohenberg, 128²)
  and ``_MULTI`` (a coupled Cahn-Hilliard field c and Allen-Cahn field n1,
  64², the benchmark-2a shape), formatted with ``domain_extra`` and
  ``solver_extra`` (lines added to [Domain] and [TensorSolver]).
- ``MULTI_3D_DECK``: the 3-D variant of ``_MULTI``, formatted also with
  ``n`` (nx, ny, nz, xmax, ymax, zmax); at n = 16 it is
  tests/test_pallas_spectral.py's ``_mk_multi_3d_deck()``.
- ``POROUS_DECK``, ``MIXED_DECK``: bench.py's ``_POROUS_DECK`` (D3Q19 BGK
  through a sphere pack: binary media with obstacle bounce-back and a body
  force; formatted with ``n``, ``substeps``, ``backend`` and ``media_h5``,
  the media file) and ``_MIXED_DECK`` (D3Q19 BGK channel: bounce-back walls,
  a Zou-He velocity inlet and a zero-gradient outlet; ``n``, ``substeps``,
  ``backend``), the production LBM decks; ``porous_media`` draws the
  porous benchmark's media.
- ``ALLFACE_DECK``, ``MEDIA_DECK``, ``INLET_OUTLET_DECK``:
  tests/test_pallas_lbm.py's ``_ALLFACE_DECK`` (bounce-back on all six
  faces; ``n``, ``stencil``, ``backend``), ``_MEDIA_DECK`` (a box obstacle
  in h5 media; ``backend``, ``media_h5``) and ``_INLET_OUTLET_DECK``
  (``backend``).
- ``THERMAL3D_DECK``: bench.py's ``_THERMAL3D_DECK`` (the 3-D thermal
  double-distribution deck: two D3Q19 BGK lattices, f and the temperature
  g, Boussinesq buoyancy, Guo forcing, bounce-back plates and Zou-He
  temperature faces; ``n``, ``substeps``, ``backend``).
- ``PEBBLES_DECK``: tests/test_pallas_lbm.py's ``_THERMAL_3D_DECK`` (the
  Pebbles pattern: MRT on both lattices, binary media with obstacle
  bounce-back, buoyancy and Guo forcing, Zou-He temperature faces, the
  residual on T), with its extents and substeps as fields: ``nx``, ``ny``,
  ``nz``, ``substeps``, ``backend``, ``media_h5`` (the media, or
  ``media.h5`` with the array handed in as ``arrays=``).
- ``PROJECTED_DECK``: ``POROUS_DECK`` with the Hermite projection
  (``projection = true``) on its collision.
- ``COLLISIONLESS_DECK``: ``INLET_OUTLET_DECK`` at 6×5×5 without its
  equilibrium, its collision and its bounce-back faces, streamed with
  ``f_old = f`` (the collisionless chain); ``backend``.

The 2-D decks below are the port's own, not copies: the reference decks
of their patterns are not in the repository.

- ``BENCH_1A_DECK``: benchmark 1a, the PFHub spinodal decomposition (the
  reference's benchmarks/01_spinodal_decomposition/1a.i, which is not in
  the repository; this deck stands in for it).  Built from what the repo
  holds: the initial condition, µ, M̄ and κ̄̄ of
  ``__graft_entry__._CH_DECK``; bench.py's ``build_run`` schedule (dt0 1,
  growth 1.1, dtmax 300, end time 10500, stop when ``change < 1e-4``);
  and its free energy f = 5(c−0.3)²(0.7−c)² + |∇c|² (bench.py:258-263,
  κ/2 = 1), computed by a ``[Postprocess]`` group.  Postprocessors: F
  and c_integral (also at INITIAL, so CSV row 0 holds F(0) and the
  starting mass), change, c_min, c_max, mass (the k = 0 slot of cbar),
  dt_crit (1/max|κ̄̄|) and F_per_cell.  ``[Outputs]`` writes the CSV and
  the perf graph.  Formatted with ``n`` (nx = ny = xmax = ymax; 1a is
  200), ``substeps`` (1a: 1000), ``domain_extra`` and ``solver_extra``.

- ``CHANNEL2D_DECK``: a D2Q9 BGK channel (the pattern of the reference's
  test/tests/lbm/channel2D.i): bounce-back walls on the bottom and top, a
  Zou-He velocity inlet on the left, a zero-gradient outlet on the right;
  ``nx``, ``ny``, ``substeps``, ``backend``.  ``CHANNEL2D_MRT_DECK`` is the
  same with the MRT collision.
- ``THERMAL2D_DECK``: ``THERMAL3D_DECK`` made 2-D (D2Q9 on both
  lattices, the temperature's z ripple dropped, buoyancy along x); ``n``,
  ``substeps``, ``backend``.
- ``KARMAN_DECK``: the Kármán vortex street of bench.py:1687
  ``bench_lbm_karman`` (the reference's
  examples/lbm/Karman-vortex/cylinder.i, shipped at 800×200): D2Q9, the
  Smagorinsky collision with the Hermite projection, obstacle bounce-back
  around a cylinder (``karman_media``, handed in as ``arrays=
  {"binary_media": ...}``), a perturbed Zou-He inlet on the left, a
  zero-gradient outlet on the right, bounce-back on the bottom and top;
  ``nx``, ``ny``, ``substeps``, ``backend``.
- ``TWOPHASE2D_DECK``: a static droplet (radius n/8, interface thickness
  4) in a periodic D2Q9 box, the two-phase chain: the fluid lattice f and
  the phase lattice g streamed together, φ = Σg, ∇φ and ∇²φ by the
  isotropic stencils, the chemical potential, the surface force into the
  Guo source and the velocity, g's equilibrium w·φ; ``n``, ``substeps``,
  ``backend``.  It stands in for the reference's two-phase decks, which
  are not in the repository.
- ``PRESSURE_DECK``: ``POROUS_DECK`` driven by pressure instead of a body
  force (a permeability estimate on a micro-CT subvolume): an
  ``LBMDirichletBC`` inlet of density 1.01 on ``inlet`` (a face, or
  ``wall``: the cells next to the media), an ``LBMNeumannBC`` outlet on
  the right, bounce-back on the other four faces and the media; the
  fields of ``POROUS_DECK`` and ``inlet``.
- ``SPECULAR_CHANNEL_DECK``: ``CHANNEL2D_DECK`` with an
  ``LBMDirichletBC`` inlet (1.001), an ``LBMNeumannBC`` outlet,
  ``LBMSpecularReflectionBoundary`` walls (r = 0.5) and the velocity in
  physical units (``LBMTensorUnitConverter``, 0.05), and feq set to the
  initial equilibrium: both equilibrium conditions write feq_b + (f_old −
  feq), so a feq left at zero (every buffer starts at zero, as in the
  reference) doubles the boundary columns' populations in the first
  substep (inlet density 2.001), a shock that blows the walled channel up
  within 200 substeps; ``nx``, ``ny``, ``substeps``, ``backend``, no
  [Executioner].
- ``SMOOTHED_BOUNDARY_DECK``: the spectral family's computes together,
  a smoothed-boundary Cahn-Hilliard field c and Allen-Cahn field η: ψ from
  ``SmoothRectangleCompute`` (TANH, the box [lo, hi]²), c(0) from a
  composed ``[Functions]`` ParsedFunction through ``MooseFunctionTensor``,
  the flux by ``ReciprocalMatDiffusion`` with ψ and a c-dependent
  mobility, µ with a ``FiniteDifferenceLaplacian`` term, η's rate by
  ``ReciprocalAllenCahn`` masked by ψ, a HOULI ``DeAliasingTensor`` on
  both nonlinear terms, ``GradientTensor`` squared into a
  ``RunningMaximum``, a ``FunctionElementIntegral`` postprocessor, c̄ and
  η̄ carried (``carry_reciprocal``); ``n``, ``lo``, ``hi``, ``substeps``,
  ``dt``, ``domain_extra``.  Mean-free fields in the stable wells of both
  free energies and a slow mobility, so that float32 stays within 1e-4 of
  float64 on every buffer over 200 substeps.  The port's own: the
  reference's smoothed-boundary decks are not in the repository.
- ``OSTWALD_2A_DECK``: benchmark 2a, Ostwald ripening (the reference's
  benchmarks/02_oswald_ripening/2a.i, not in the repository; this deck
  stands in for it until it is): c and four order parameters with the
  free energy and initial condition of PFHub benchmark 2 (Jokisaari et
  al., Comput. Mater. Sci. 126 (2017) 139), five parsed chemical
  potentials, 10 forward and 5 inverse transforms a substep (bench.py's
  ``bench_2a``); ``n``, ``substeps``, ``domain_extra``, ``problem_extra``
  (``batch_fft = true`` there).
- ``BENCH_1A_LEGACY_DECK``: ``BENCH_1A_DECK`` in the reference 1a.i's
  legacy form, a ``[TensorTimeIntegrators]`` FFTSemiImplicit block with
  ``[Problem] spectral_solve_substeps``; ``solver_extra`` goes to
  ``[Problem]`` (carry_reciprocal and fused_spectral are taken from
  there).

The solver family's decks, the port's own as well: the reference decks
they stand in for are not in the repository, and replace them once they
are.

- ``CH3D_ETDRK4_DECK``: ``CH3D_DECK``'s Cahn-Hilliard under ETDRK4Solver
  (L̄ = −Mκk⁴, N̄ = M̄·µ̄ with M̄ = −Mk²), for the reference's
  test/tests/solvers/etdrk4_diffusion.i; ``n``, ``substeps``,
  ``solver_extra`` (``cox_matthews = true``).  The reference's phi tables
  divide by (L·dt)³ and turn non-finite from 32³ on here; the Cox-Matthews
  tables do not.
- ``ETDRK4_ORDER_DECK``: tests/test_etdrk4_cox_matthews.py's 1-D deck
  (``substeps``, ``cm``), for the fourth-order check on the card.
- ``OSTWALD_2A_SECANT_DECK``, ``OSTWALD_2A_BROYDEN_DECK``:
  ``OSTWALD_2A_DECK`` under SecantSolver and BroydenSolver, for the
  reference's benchmarks/02_oswald_ripening/2a_secant.i and 2a_broyden.i:
  ``max_iterations`` (30, 60), ``relative_tolerance`` (a field: 1e-9 and
  1e-4 in float64, 1e-2 in float32, ``OSTWALD_2A_TOL``), a
  TensorSolveIterationAdaptiveDT around ``optimal_iterations`` (10 ± 8,
  30 ± 20), postprocessors c_total, iterations
  (``TensorSolverIterations``) and group_evals; ``n``, ``substeps``,
  ``dt``, ``num_steps``, ``domain_extra``, ``problem_extra``,
  ``solver_extra``, ``relative_tolerance``.  ``OSTWALD_2A_DT`` holds each
  one's start dt, where every substep converges at 5 substeps a step, and
  a larger one whose first attempts fail (at 64² and above).  Broyden's
  initial inverse Jacobian is −I (``initial_jacobian_guess = -1``).
- ``COUPLED_DECK``: two fields u and v with diffusion (−0.1k², −0.2k²), an
  explicit decay −0.3 in N̄ and a constant off-diagonal coupling 0.5
  (``linear_offdiag``, row 0, column 1) under
  AdamsBashforthMoultonCoupled, for the reference's
  test/tests/solvers/coupled.i: each mode evolves as exp(E·t)
  (``COUPLED_RATES``; the reference's stacking reads the coupling
  transposed), and the fields are even about the half cell (``h =
  half_cell(n)``), so their spectra are real and the solve's real cast
  drops nothing; ``n``, ``h``, ``substeps``, ``order``,
  ``corrector_steps``, ``domain_extra``, ``solver_extra``
  (``assume_symmetric = true``).
- ``EXPLICIT_DECK``: spectral diffusion ū' = −0.05k²ū under
  ForwardEulerSolver; ``EXPLICIT_REAL_SPACE_DECK`` the same under
  RealSpaceForwardEuler with a FiniteDifferenceLaplacian; ``n``,
  ``substeps``, ``domain_extra``.
- ``MECH_DECK``: bench.py's ``_MECH_DECK``, the stand-in for the
  reference's examples/degeus_mechanics/mech.i (the deGeus hyperelastic
  RVE: two phases of PhaseMechanicsTest, HyperElasticIsotropic,
  FFTMechanics' Newton and CG under a MacroscopicShearTensor ramp, 10
  substeps a step of ForwardEulerSolver forwarding Fnew to F), its box
  2π written out (bench's ``${fparse 2*pi}``); ``n``, ``domain_extra``.
  ``MECH_2D_DECK`` is its 2-D form.
- ``COUPLED_PF_MECH_DECK``: the stand-in for the reference's absent
  test/tests/tensor_compute/coupled_pf_mech.i: ``CH3D_DECK``'s
  Cahn-Hilliard chain with the small-strain eigenstrain solve,
  FFTQuasistaticElasticity giving the displacements from c̄ and
  FFTElasticChemicalPotential adding its µ̄ into the nonlinear term; µ =
  λ = 1 and e0 = 0.01, small, so the elastic term perturbs the chain (a
  few 1e-3 of µ̄) and the displacements stay far below 0.1; ``n``,
  ``substeps``, ``domain_extra``.
- ``FRACTURE_DECK``: the path of examples/phase_field_fracture/fracture.i
  (AT2 phase-field fracture on FFT micromechanics, 96²), the JAX package's
  showcase deck, loaded as it is by both packages.

Stand-ins for the reference's test decks of the distributed modes, which
are not in the repository (the port's own; each runs in both packages):

- ``GRADIENT_DECK``: for test/tests/gradient/gradient.i (40³, the
  reference's slab and pencil spec): a smooth field's spectral gradients
  (``FFTGradient`` along x, y and z, ``FFTGradientSquare``) and their
  extrema, mean and integral in the CSV; ``n``, ``domain_extra``.
- ``LAPLACIAN_RS_DECK``: for test/tests/real_space/laplacian.i: explicit
  diffusion u' = 0.02·∇²u by ``FiniteDifferenceLaplacian`` under
  ``RealSpaceForwardEuler`` on a REAL_SPACE grid, u's extrema and mean and
  ∇²u's integral in the CSV; formatted by ``laplacian_rs(dim, n, ...)``
  (2-D or 3-D, stencil width 3 or 5).
"""

import os

import numpy as np
import torch

CH3D_DECK = """
[Domain]
  dim = 3
  nx = {n}
  ny = {n}
  nz = {n}
  xmax = {n}
  ymax = {n}
  zmax = {n}
[]
[TensorComputes]
  [Initialize]
    [c]
      type = ParsedCompute
      buffer = c
      extra_symbols = true
      expression = 'c0+epsilon*(cos(0.105*x)*cos(0.11*y)*cos(0.09*z)+(cos(0.13*x)*cos(0.087*y))^2+cos(0.025*x-0.15*z)*cos(0.07*x-0.02*y))'
      constant_names = 'c0 epsilon'
      constant_expressions = '0.5 0.01'
    []
    [Mbar]
      type = ReciprocalLaplacianFactor
      factor = 5
      buffer = Mbar
    []
    [kappabarbar]
      type = ReciprocalLaplacianSquareFactor
      factor = -10
      buffer = kappabarbar
    []
  []
  [Solve]
    [mu]
      type = ParsedCompute
      buffer = mu
      expression = 'rho_s*(c-c_alpha)^2*(c_beta-c)^2'
      constant_names = 'rho_s c_alpha c_beta'
      constant_expressions = '5 0.3 0.7'
      derivatives = c
      inputs = c
    []
    [mubar]
      type = ForwardFFT
      buffer = mubar
      input = mu
    []
    [Mbarmubar]
      type = ParsedCompute
      buffer = Mbarmubar
      expression = 'Mbar*mubar'
      inputs = 'Mbar mubar'
    []
    [cbar]
      type = ForwardFFT
      buffer = cbar
      input = c
    []
  []
[]
[TensorSolver]
  type = AdamsBashforthMoulton
  buffer = c
  reciprocal_buffer = cbar
  linear_reciprocal = kappabarbar
  nonlinear_reciprocal = Mbarmubar
  substeps = {substeps}
[]
[Problem]
  type = TensorProblem
[]
"""

CH_DECK = """
[Domain]
  dim = 2
  nx = 128
  ny = 128
  xmax = 128
  ymax = 128
  {domain_extra}
[]
[TensorComputes]
  [Initialize]
    [c]
      type = ParsedCompute
      buffer = c
      extra_symbols = true
      expression = 'c0+epsilon*(cos(0.196349540849362*x)*cos(0.14726215563702*y)+(cos(0.098174770424681*x)*cos(0.245436926061703*y))^2)'
      constant_names = 'c0 epsilon'
      constant_expressions = '0.5 0.01'
    []
    [Mbar]
      type = ReciprocalLaplacianFactor
      factor = 5
      buffer = Mbar
    []
    [kappabarbar]
      type = ReciprocalLaplacianSquareFactor
      factor = -10
      buffer = kappabarbar
    []
  []
  [Solve]
    [mu]
      type = ParsedCompute
      buffer = mu
      expression = 'rho_s*(c-c_alpha)^2*(c_beta-c)^2'
      constant_names = 'rho_s c_alpha c_beta'
      constant_expressions = '5 0.3 0.7'
      derivatives = c
      inputs = c
    []
    [mubar]
      type = ForwardFFT
      buffer = mubar
      input = mu
    []
    [Mbarmubar]
      type = ParsedCompute
      buffer = Mbarmubar
      expression = 'Mbar*mubar'
      inputs = 'Mbar mubar'
    []
    [cbar]
      type = ForwardFFT
      buffer = cbar
      input = c
    []
  []
[]
[TensorSolver]
  type = AdamsBashforthMoulton
  buffer = c
  reciprocal_buffer = cbar
  linear_reciprocal = kappabarbar
  nonlinear_reciprocal = Mbarmubar
  substeps = 5
  {solver_extra}
[]
[Problem]
  type = TensorProblem
[]
"""

SH_DECK = """
[Domain]
  dim = 2
  nx = 128
  ny = 128
  xmax = 188.49555921538757
  ymax = 188.49555921538757
  {domain_extra}
[]
[TensorComputes]
  [Initialize]
    [psi]
      type = ParsedCompute
      buffer = psi
      extra_symbols = true
      expression = '0.035+0.03*cos(0.3*x)*cos(0.4*y)+0.02*(cos(0.23*x+0.11*y))^2'
    []
    [linear]
      type = SwiftHohenbergLinear
      buffer = linear
      alpha = 1
      r = 0.025
    []
  []
  [Solve]
    [psi3]
      type = ParsedCompute
      buffer = psi3
      expression = '0.20*psi^2-psi^3'
      inputs = psi
    []
    [psibar]
      type = ForwardFFT
      buffer = psibar
      input = psi
    []
    [psi3bar]
      type = ForwardFFT
      buffer = psi3bar
      input = psi3
    []
  []
[]
[TensorSolver]
  type = AdamsBashforthMoulton
  buffer = psi
  reciprocal_buffer = psibar
  linear_reciprocal = linear
  nonlinear_reciprocal = psi3bar
  substeps = 5
  {solver_extra}
[]
[Problem]
  type = TensorProblem
[]
"""

MULTI_DECK = """
[Domain]
  dim = 2
  nx = 64
  ny = 64
  xmax = 64
  ymax = 64
  {domain_extra}
[]
[TensorComputes]
  [Initialize]
    [c]
      type = ParsedCompute
      buffer = c
      extra_symbols = true
      expression = '0.5+0.01*(cos(0.196349540849362*x)*cos(0.294524311274043*y)+(cos(0.392699081698724*x)*cos(0.196349540849362*y))^2)'
    []
    [n1]
      type = ParsedCompute
      buffer = n1
      extra_symbols = true
      expression = '0.1+0.05*cos(0.098174770424681*x)*cos(0.196349540849362*y)'
    []
    [Lbar]
      type = ReciprocalLaplacianFactor
      buffer = Lbar
    []
    [MkappaL2bar]
      type = ReciprocalLaplacianSquareFactor
      factor = -15
      buffer = MkappaL2bar
    []
    [kappaLbar]
      type = ReciprocalLaplacianFactor
      factor = 15
      buffer = kappaLbar
    []
  []
  [Solve]
    [mu_c]
      type = ParsedCompute
      buffer = mu_c
      expression = '(2*(c-0.3)^2*(0.7-c)^2 + n1^2*c)*5'
      derivatives = c
      inputs = 'c n1'
    []
    [mu_n1]
      type = ParsedCompute
      buffer = mu_n1
      expression = '(n1^2*(1-n1)^2 + n1^2*c)*(-5)'
      derivatives = n1
      inputs = 'c n1'
    []
    [mu_c_bar]
      type = ForwardFFT
      buffer = mu_c_bar
      input = mu_c
    []
    [mu_n1_bar]
      type = ForwardFFT
      buffer = mu_n1_bar
      input = mu_n1
    []
    [Mbar_mu_c_bar]
      type = ParsedCompute
      buffer = Mbar_mu_c_bar
      expression = 'Lbar*mu_c_bar'
      inputs = 'Lbar mu_c_bar'
    []
    [c_bar]
      type = ForwardFFT
      buffer = c_bar
      input = c
    []
    [n1_bar]
      type = ForwardFFT
      buffer = n1_bar
      input = n1
    []
  []
[]
[TensorSolver]
  type = AdamsBashforthMoulton
  buffer = 'c n1'
  reciprocal_buffer = 'c_bar n1_bar'
  linear_reciprocal = 'MkappaL2bar kappaLbar'
  nonlinear_reciprocal = 'Mbar_mu_c_bar mu_n1_bar'
  substeps = 5
  predictor_order = 2
  corrector_order = 2
  corrector_steps = 0
  {solver_extra}
[]
[Problem]
  type = TensorProblem
[]
"""

MULTI_3D_DECK = """
[Domain]
  dim = 3
  nx = {n}
  ny = {n}
  nz = {n}
  xmax = {n}
  ymax = {n}
  zmax = {n}
  {domain_extra}
[]
[TensorComputes]
  [Initialize]
    [c]
      type = ParsedCompute
      buffer = c
      extra_symbols = true
      expression = '0.5+0.01*(cos(0.785398163397448*x)*cos(0.392699081698724*y)*cos(0.392699081698724*z)+(cos(0.392699081698724*x)*cos(0.196349540849362*y))^2)'
    []
    [n1]
      type = ParsedCompute
      buffer = n1
      extra_symbols = true
      expression = '0.1+0.05*cos(0.392699081698724*x)*cos(0.392699081698724*y)*cos(0.785398163397448*z)'
    []
    [Lbar]
      type = ReciprocalLaplacianFactor
      buffer = Lbar
    []
    [MkappaL2bar]
      type = ReciprocalLaplacianSquareFactor
      factor = -15
      buffer = MkappaL2bar
    []
    [kappaLbar]
      type = ReciprocalLaplacianFactor
      factor = 15
      buffer = kappaLbar
    []
  []
  [Solve]
    [mu_c]
      type = ParsedCompute
      buffer = mu_c
      expression = '(2*(c-0.3)^2*(0.7-c)^2 + n1^2*c)*5'
      derivatives = c
      inputs = 'c n1'
    []
    [mu_n1]
      type = ParsedCompute
      buffer = mu_n1
      expression = '(n1^2*(1-n1)^2 + n1^2*c)*(-5)'
      derivatives = n1
      inputs = 'c n1'
    []
    [mu_c_bar]
      type = ForwardFFT
      buffer = mu_c_bar
      input = mu_c
    []
    [mu_n1_bar]
      type = ForwardFFT
      buffer = mu_n1_bar
      input = mu_n1
    []
    [Mbar_mu_c_bar]
      type = ParsedCompute
      buffer = Mbar_mu_c_bar
      expression = 'Lbar*mu_c_bar'
      inputs = 'Lbar mu_c_bar'
    []
    [c_bar]
      type = ForwardFFT
      buffer = c_bar
      input = c
    []
    [n1_bar]
      type = ForwardFFT
      buffer = n1_bar
      input = n1
    []
  []
[]
[TensorSolver]
  type = AdamsBashforthMoulton
  buffer = 'c n1'
  reciprocal_buffer = 'c_bar n1_bar'
  linear_reciprocal = 'MkappaL2bar kappaLbar'
  nonlinear_reciprocal = 'Mbar_mu_c_bar mu_n1_bar'
  substeps = 5
  predictor_order = 2
  corrector_order = 2
  corrector_steps = 0
  {solver_extra}
[]
[Problem]
  type = TensorProblem
[]
"""


# -- lattice Boltzmann ---------------------------------------------------------

POROUS_DECK = """
[Domain]
  dim = 3
  nx = {n}
  ny = {n}
  nz = {n}
  mesh_mode = DUMMY
[]
[Stencil]
  [s]
    type = LBMD3Q19
  []
[]
[TensorBuffers]
  [f]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [feq]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [fpc]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [velocity]
    type = LBMTensorBuffer
    buffer_type = mv
  []
  [density]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [speed]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [media]
    type = LBMTensorBuffer
    buffer_type = ms
    is_integer = true
    file = {media_h5}
  []
[]
[TensorComputes]
  [Initialize]
    [initial_density]
      type = LBMConstantTensor
      buffer = density
      constants = 1.0
    []
    [initial_velocity]
      type = LBMConstantTensor
      buffer = velocity
      constants = '0.0 0.0 0.0'
    []
    [initial_equilibrium]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [initial_distribution]
      type = LBMEquilibrium
      buffer = f
      bulk = density
      velocity = velocity
    []
    [initial_distribution_pc]
      type = LBMEquilibrium
      buffer = fpc
      bulk = density
      velocity = velocity
    []
  []
  [Solve]
    [equilibrium]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [collision]
      type = LBMBGKCollision
      buffer = fpc
      f = f
      feq = feq
      tau0 = 0.8
    []
    [density]
      type = LBMComputeDensity
      buffer = density
      f = f
    []
    [velocity]
      type = LBMComputeVelocity
      buffer = velocity
      f = f
      rho = density
      add_body_force = true
      body_force_x = 0.0001
    []
    [speed]
      type = LBMComputeVelocityMagnitude
      buffer = speed
      velocity = velocity
    []
    [residual]
      type = LBMComputeResidual
      buffer = speed
      speed = speed
    []
  []
  [Boundary]
    [wall]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = wall
    []
  []
[]
[TensorSolver]
  type = LBMStream
  buffer = f
  f_old = fpc
[]
[Problem]
  type = LatticeBoltzmannProblem
  substeps = {substeps}
  binary_media = media
  lbm_backend = {backend}
[]
"""

MIXED_DECK = """
[Domain]
  dim = 3
  nx = {n}
  ny = {n}
  nz = {n}
  mesh_mode = DUMMY
[]
[Stencil]
  [s]
    type = LBMD3Q19
  []
[]
[TensorBuffers]
  [f]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [feq]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [fpc]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [velocity]
    type = LBMTensorBuffer
    buffer_type = mv
  []
  [density]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [speed]
    type = LBMTensorBuffer
    buffer_type = ms
  []
[]
[TensorComputes]
  [Initialize]
    [initial_density]
      type = LBMConstantTensor
      buffer = density
      constants = 1.0
    []
    [initial_velocity]
      type = LBMConstantTensor
      buffer = velocity
      constants = '0.01 0.0 0.0'
    []
    [initial_equilibrium]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [initial_distribution]
      type = LBMEquilibrium
      buffer = f
      bulk = density
      velocity = velocity
    []
    [initial_distribution_pc]
      type = LBMEquilibrium
      buffer = fpc
      bulk = density
      velocity = velocity
    []
  []
  [Solve]
    [density]
      type = LBMComputeDensity
      buffer = density
      f = f
    []
    [velocity]
      type = LBMComputeVelocity
      buffer = velocity
      f = f
      rho = density
    []
    [feq]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [collision]
      type = LBMBGKCollision
      buffer = fpc
      f = f
      feq = feq
      tau0 = 0.6
    []
    [speed]
      type = LBMComputeVelocityMagnitude
      buffer = speed
      velocity = velocity
    []
    [residual]
      type = LBMComputeResidual
      buffer = speed
      speed = speed
    []
  []
  [Boundary]
    [top]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = top
    []
    [bottom]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = bottom
    []
    [front]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = front
    []
    [back]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = back
    []
    [inlet]
      type = LBMFixedFirstOrderBC
      buffer = f
      f = f
      value = 0.01
      boundary = left
    []
    [outlet]
      type = LBMMicroscopicZeroGradientBC
      buffer = f
      boundary = right
    []
  []
[]
[TensorSolver]
  type = LBMStream
  buffer = f
  f_old = fpc
[]
[Problem]
  type = LatticeBoltzmannProblem
  substeps = {substeps}
  lbm_backend = {backend}
[]
[Executioner]
  type = Transient
  num_steps = 3
[]
"""

ALLFACE_DECK = """
[Domain]
  dim = 3
  nx = {n}
  ny = 10
  nz = 12
  mesh_mode = DUMMY
[]
[Stencil]
  [s]
    type = {stencil}
  []
[]
[TensorBuffers]
  [f]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [feq]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [fpc]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [velocity]
    type = LBMTensorBuffer
    buffer_type = mv
  []
  [density]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [speed]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [vx]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [vy]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [vz]
    type = LBMTensorBuffer
    buffer_type = ms
  []
[]
[TensorComputes]
  [Initialize]
    [initial_density]
      type = LBMConstantTensor
      buffer = density
      constants = 1.0
    []
    [vx]
      type = ParsedCompute
      buffer = vx
      extra_symbols = true
      expression = '0.01*sin(x*6.28)'
    []
    [vy]
      type = ParsedCompute
      buffer = vy
      extra_symbols = true
      expression = '0.02*cos(y*6.28)'
    []
    [vz]
      type = LBMConstantTensor
      buffer = vz
      constants = 0.0
    []
    [initial_velocity]
      type = LBMStackTensors
      buffer = velocity
      inputs = 'vx vy vz'
    []
    [initial_equilibrium]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [initial_distribution]
      type = LBMEquilibrium
      buffer = f
      bulk = density
      velocity = velocity
    []
    [initial_distribution_pc]
      type = LBMEquilibrium
      buffer = fpc
      bulk = density
      velocity = velocity
    []
  []
  [Solve]
    [equilibrium]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [collision]
      type = LBMBGKCollision
      buffer = fpc
      f = f
      feq = feq
      tau0 = 0.8
    []
    [density]
      type = LBMComputeDensity
      buffer = density
      f = f
    []
    [velocity]
      type = LBMComputeVelocity
      buffer = velocity
      f = f
      rho = density
      add_body_force = true
      body_force_x = 0.0001
      body_force_z = -0.00005
    []
    [speed]
      type = LBMComputeVelocityMagnitude
      buffer = speed
      velocity = velocity
    []
    [residual]
      type = LBMComputeResidual
      buffer = speed
      speed = speed
    []
  []
  [Boundary]
    [top]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = top
    []
    [bottom]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = bottom
    []
    [left]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = left
    []
    [right]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = right
    []
    [front]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = front
    []
    [back]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = back
    []
  []
[]
[TensorSolver]
  type = LBMStream
  buffer = f
  f_old = fpc
[]
[Problem]
  type = LatticeBoltzmannProblem
  substeps = 6
  lbm_backend = {backend}
[]
"""

MEDIA_DECK = """
[Domain]
  dim = 3
  nx = 8
  ny = 12
  nz = 10
  mesh_mode = DUMMY
[]
[Stencil]
  [s]
    type = LBMD3Q19
  []
[]
[TensorBuffers]
  [f]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [feq]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [fpc]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [velocity]
    type = LBMTensorBuffer
    buffer_type = mv
  []
  [density]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [speed]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [media]
    type = LBMTensorBuffer
    buffer_type = ms
    is_integer = true
    file = {media_h5}
  []
[]
[TensorComputes]
  [Initialize]
    [initial_density]
      type = LBMConstantTensor
      buffer = density
      constants = 1.0
    []
    [initial_velocity]
      type = LBMConstantTensor
      buffer = velocity
      constants = '0.01 0.0 0.0'
    []
    [initial_equilibrium]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [initial_distribution]
      type = LBMEquilibrium
      buffer = f
      bulk = density
      velocity = velocity
    []
    [initial_distribution_pc]
      type = LBMEquilibrium
      buffer = fpc
      bulk = density
      velocity = velocity
    []
  []
  [Solve]
    [equilibrium]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [collision]
      type = LBMBGKCollision
      buffer = fpc
      f = f
      feq = feq
      tau0 = 0.9
    []
    [density]
      type = LBMComputeDensity
      buffer = density
      f = f
    []
    [velocity]
      type = LBMComputeVelocity
      buffer = velocity
      f = f
      rho = density
      add_body_force = true
      body_force_x = 0.0002
    []
    [speed]
      type = LBMComputeVelocityMagnitude
      buffer = speed
      velocity = velocity
    []
    [residual]
      type = LBMComputeResidual
      buffer = speed
      speed = speed
    []
  []
  [Boundary]
    [top]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = top
    []
    [bottom]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = bottom
    []
    [wall]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = wall
    []
  []
[]
[TensorSolver]
  type = LBMStream
  buffer = f
  f_old = fpc
[]
[Problem]
  type = LatticeBoltzmannProblem
  substeps = 6
  binary_media = media
  lbm_backend = {backend}
[]
"""

INLET_OUTLET_DECK = """
[Domain]
  dim = 3
  nx = 12
  ny = 10
  nz = 10
  mesh_mode = DUMMY
[]
[Stencil]
  [s]
    type = LBMD3Q19
  []
[]
[TensorBuffers]
  [f]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [feq]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [fpc]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [velocity]
    type = LBMTensorBuffer
    buffer_type = mv
  []
  [density]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [speed]
    type = LBMTensorBuffer
    buffer_type = ms
  []
[]
[TensorComputes]
  [Initialize]
    [initial_density]
      type = LBMConstantTensor
      buffer = density
      constants = 1.0
    []
    [initial_velocity]
      type = LBMConstantTensor
      buffer = velocity
      constants = '0.01 0.0 0.0'
    []
    [initial_f]
      type = LBMEquilibrium
      buffer = f
      bulk = density
      velocity = velocity
    []
    [initial_fpc]
      type = LBMEquilibrium
      buffer = fpc
      bulk = density
      velocity = velocity
    []
  []
  [Solve]
    [density]
      type = LBMComputeDensity
      buffer = density
      f = f
    []
    [velocity]
      type = LBMComputeVelocity
      buffer = velocity
      f = f
      rho = density
    []
    [feq]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [collision]
      type = LBMBGKCollision
      buffer = fpc
      f = f
      feq = feq
      tau0 = 0.6
    []
    [speed]
      type = LBMComputeVelocityMagnitude
      buffer = speed
      velocity = velocity
    []
    [residual]
      type = LBMComputeResidual
      buffer = speed
      speed = speed
    []
  []
  [Boundary]
    [top]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = top
    []
    [bottom]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = bottom
    []
    [front]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = front
    []
    [back]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = back
    []
    [inlet]
      type = LBMFixedFirstOrderBC
      buffer = f
      f = f
      value = 0.01
      boundary = left
    []
    [outlet]
      type = LBMMicroscopicZeroGradientBC
      buffer = f
      boundary = right
    []
  []
[]
[TensorSolver]
  type = LBMStream
  buffer = f
  f_old = fpc
[]
[Problem]
  type = LatticeBoltzmannProblem
  substeps = 6
  lbm_backend = {backend}
[]
[Executioner]
  type = Transient
  num_steps = 3
[]
"""


THERMAL3D_DECK = """
[Domain]
  dim = 3
  nx = {n}
  ny = {n}
  nz = {n}
  xmax = {n}
  ymax = {n}
  zmax = {n}
  mesh_mode = DUMMY
[]
[Stencil]
  [s]
    type = LBMD3Q19
  []
[]
[TensorBuffers]
  [f]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [feq]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [fpc]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [g]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [geq]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [gpc]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [density]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [T]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [velocity]
    type = LBMTensorBuffer
    buffer_type = mv
  []
  [F]
    type = LBMTensorBuffer
    buffer_type = mv
  []
[]
[TensorComputes]
  [Initialize]
    [density]
      type = LBMConstantTensor
      buffer = density
      constants = 'rho0'
    []
    [velocity]
      type = LBMConstantTensor
      buffer = velocity
      constants = '0.0 0.0 0.0'
    []
    [temperature]
      type = ParsedCompute
      buffer = T
      expression = '1.1 - 0.1*x/{n} + 0.005*sin(y/8)*sin(z/8)'
      extra_symbols = true
    []
    [eq_f]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [eq_f_total]
      type = LBMEquilibrium
      buffer = f
      bulk = density
      velocity = velocity
    []
    [eq_f_pc]
      type = LBMEquilibrium
      buffer = fpc
      bulk = density
      velocity = velocity
    []
    [eq_g]
      type = LBMEquilibrium
      buffer = geq
      bulk = T
      velocity = velocity
    []
    [eq_g_total]
      type = LBMEquilibrium
      buffer = g
      bulk = T
      velocity = velocity
    []
    [eq_g_pc]
      type = LBMEquilibrium
      buffer = gpc
      bulk = T
      velocity = velocity
    []
  []
  [Solve]
    [Temperature]
      type = LBMComputeDensity
      buffer = T
      f = g
    []
    [Fluid_density]
      type = LBMComputeDensity
      buffer = density
      f = f
    []
    [Fluid_velocity]
      type = LBMComputeVelocity
      buffer = velocity
      f = f
      rho = density
      forces = F
      enable_forces = true
    []
    [Eq_temperature]
      type = LBMEquilibrium
      buffer = geq
      bulk = T
      velocity = velocity
    []
    [Collision_temperature]
      type = LBMBGKCollision
      buffer = gpc
      f = g
      feq = geq
      tau0 = tau_T
    []
    [Compute_forces]
      type = LBMComputeForces
      buffer = F
      rho0 = 'rho0'
      temperature = T
      T0 = T_0
      enable_buoyancy = true
      gravity = g
      gravity_direction = 0
    []
    [Eq_fluid]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [Collision_fluid]
      type = LBMBGKCollision
      buffer = fpc
      f = f
      feq = feq
      tau0 = tau_f
    []
    [Apply_forces]
      type = LBMApplyForces
      buffer = fpc
      velocity = velocity
      rho = density
      forces = F
      tau0 = tau_f
    []
  []
  [Boundary]
    [plate_left]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = left
    []
    [plate_right]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = right
    []
    [hot_left]
      type = LBMFixedZerothOrderBC
      buffer = g
      f = g
      value = T_H
      boundary = left
    []
    [cold_right]
      type = LBMFixedZerothOrderBC
      buffer = g
      f = g
      value = T_C
      boundary = right
    []
  []
[]
[TensorSolver]
  type = LBMStream
  buffer = 'f g'
  f_old = 'fpc gpc'
[]
[Problem]
  type = LatticeBoltzmannProblem
  scalar_constant_names = 'rho0 T_0  T_C  T_H  tau_f tau_T  g'
  scalar_constant_values = '1.0  1.05 1.0  1.1  0.7   0.7   0.0001'
  substeps = {substeps}
  lbm_backend = {backend}
[]
[Executioner]
  type = Transient
  num_steps = 1
[]
"""

PEBBLES_DECK = """
[Domain]
  dim = 3
  nx = {nx}
  ny = {ny}
  nz = {nz}
  mesh_mode = DUMMY
[]
[Stencil]
  [s]
    type = LBMD3Q19
  []
[]
[TensorBuffers]
  [f]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [feq]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [fpc]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [g]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [geq]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [gpc]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [velocity]
    type = LBMTensorBuffer
    buffer_type = mv
  []
  [density]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [T]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [F]
    type = LBMTensorBuffer
    buffer_type = mv
  []
  [media]
    type = LBMTensorBuffer
    buffer_type = ms
    is_integer = true
    file = {media_h5}
  []
[]
[TensorComputes]
  [Initialize]
    [density]
      type = LBMConstantTensor
      buffer = density
      constants = 1.0
    []
    [velocity]
      type = LBMConstantTensor
      buffer = velocity
      constants = '0.0 0.0 0.0'
    []
    [temperature]
      type = ParsedCompute
      buffer = T
      expression = '1.0 + 0.05 * sin(x / 2.0) * cos(y / 3.0) * cos(z / 5.0)'
      extra_symbols = true
    []
    [feq0]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [f0]
      type = LBMEquilibrium
      buffer = f
      bulk = density
      velocity = velocity
    []
    [fpc0]
      type = LBMEquilibrium
      buffer = fpc
      bulk = density
      velocity = velocity
    []
    [geq0]
      type = LBMEquilibrium
      buffer = geq
      bulk = T
      velocity = velocity
    []
    [g0]
      type = LBMEquilibrium
      buffer = g
      bulk = T
      velocity = velocity
    []
    [gpc0]
      type = LBMEquilibrium
      buffer = gpc
      bulk = T
      velocity = velocity
    []
  []
  [Solve]
    [Temperature]
      type = LBMComputeDensity
      buffer = T
      f = g
    []
    [Density]
      type = LBMComputeDensity
      buffer = density
      f = f
    []
    [Forces]
      type = LBMComputeForces
      buffer = F
      rho0 = 1.0
      rho = density
      temperature = T
      T0 = 1.0
      enable_buoyancy = true
      gravity = 0.0005
      gravity_direction = 2
    []
    [Velocity]
      type = LBMComputeVelocity
      buffer = velocity
      f = f
      rho = density
      forces = F
      enable_forces = true
    []
    [Geq]
      type = LBMEquilibrium
      buffer = geq
      bulk = T
      velocity = velocity
    []
    [Gcoll]
      type = LBMMRTCollision
      buffer = gpc
      f = g
      feq = geq
      tau0 = 0.8
    []
    [Feq]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [Fcoll]
      type = LBMMRTCollision
      buffer = fpc
      f = f
      feq = feq
      tau0 = 0.6
    []
    [Apply]
      type = LBMApplyForces
      buffer = fpc
      rho = density
      forces = F
      tau0 = 0.6
    []
    [Residual]
      type = LBMComputeResidual
      buffer = T
      speed = T
    []
  []
  [Boundary]
    [wall]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = wall
    []
    [top]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = back
    []
    [bottom]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = front
    []
    [hot_bottom]
      type = LBMFixedZerothOrderBC
      buffer = g
      f = g
      value = 1.1
      boundary = left
    []
    [cold_top]
      type = LBMFixedZerothOrderBC
      buffer = g
      f = g
      value = 1.0
      boundary = right
    []
  []
[]
[TensorSolver]
  type = LBMStream
  buffer = 'f g'
  f_old = 'fpc gpc'
[]
[Problem]
  type = LatticeBoltzmannProblem
  substeps = {substeps}
  lbm_backend = {backend}
  is_binary_media = true
  binary_media = media
[]
[Executioner]
  type = Transient
  num_steps = 3
[]
"""

# decks.POROUS_DECK with the Hermite projection on its collision
PROJECTED_DECK = POROUS_DECK.replace("tau0 = 0.8\n", "tau0 = 0.8\n      projection = true\n")

COLLISIONLESS_DECK = """
[Domain]
  dim = 3
  nx = 6
  ny = 5
  nz = 5
  mesh_mode = DUMMY
[]
[Stencil]
  [s]
    type = LBMD3Q19
  []
[]
[TensorBuffers]
  [f]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [feq]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [fpc]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [velocity]
    type = LBMTensorBuffer
    buffer_type = mv
  []
  [density]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [speed]
    type = LBMTensorBuffer
    buffer_type = ms
  []
[]
[TensorComputes]
  [Initialize]
    [initial_density]
      type = LBMConstantTensor
      buffer = density
      constants = 1.0
    []
    [initial_velocity]
      type = LBMConstantTensor
      buffer = velocity
      constants = '0.01 0.0 0.0'
    []
    [initial_f]
      type = LBMEquilibrium
      buffer = f
      bulk = density
      velocity = velocity
    []
    [initial_fpc]
      type = LBMEquilibrium
      buffer = fpc
      bulk = density
      velocity = velocity
    []
  []
  [Solve]
    [density]
      type = LBMComputeDensity
      buffer = density
      f = f
    []
    [velocity]
      type = LBMComputeVelocity
      buffer = velocity
      f = f
      rho = density
    []
    [speed]
      type = LBMComputeVelocityMagnitude
      buffer = speed
      velocity = velocity
    []
    [residual]
      type = LBMComputeResidual
      buffer = speed
      speed = speed
    []
  []
  [Boundary]
    [inlet]
      type = LBMFixedFirstOrderBC
      buffer = f
      f = f
      value = 0.01
      boundary = left
    []
    [outlet]
      type = LBMMicroscopicZeroGradientBC
      buffer = f
      boundary = right
    []
  []
[]
[TensorSolver]
  type = LBMStream
  buffer = f
  f_old = f
[]
[Problem]
  type = LatticeBoltzmannProblem
  substeps = 6
  lbm_backend = {backend}
[]
[Executioner]
  type = Transient
  num_steps = 3
[]
"""

CHANNEL2D_DECK = """
[Domain]
  dim = 2
  nx = {nx}
  ny = {ny}
  mesh_mode = DUMMY
[]
[Stencil]
  [s]
    type = LBMD2Q9
  []
[]
[TensorBuffers]
  [f]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [feq]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [fpc]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [velocity]
    type = LBMTensorBuffer
    buffer_type = mv
  []
  [density]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [speed]
    type = LBMTensorBuffer
    buffer_type = ms
  []
[]
[TensorComputes]
  [Initialize]
    [initial_density]
      type = LBMConstantTensor
      buffer = density
      constants = 1.0
    []
    [initial_velocity]
      type = LBMConstantTensor
      buffer = velocity
      constants = '0.01 0.0'
    []
    [initial_f]
      type = LBMEquilibrium
      buffer = f
      bulk = density
      velocity = velocity
    []
    [initial_fpc]
      type = LBMEquilibrium
      buffer = fpc
      bulk = density
      velocity = velocity
    []
  []
  [Solve]
    [density]
      type = LBMComputeDensity
      buffer = density
      f = f
    []
    [velocity]
      type = LBMComputeVelocity
      buffer = velocity
      f = f
      rho = density
    []
    [feq]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [collision]
      type = LBMBGKCollision
      buffer = fpc
      f = f
      feq = feq
      tau0 = 0.6
    []
    [speed]
      type = LBMComputeVelocityMagnitude
      buffer = speed
      velocity = velocity
    []
    [residual]
      type = LBMComputeResidual
      buffer = speed
      speed = speed
    []
  []
  [Boundary]
    [bottom]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = bottom
    []
    [top]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = top
    []
    [inlet]
      type = LBMFixedFirstOrderBC
      buffer = f
      f = f
      value = 0.01
      boundary = left
    []
    [outlet]
      type = LBMMicroscopicZeroGradientBC
      buffer = f
      boundary = right
    []
  []
[]
[TensorSolver]
  type = LBMStream
  buffer = f
  f_old = fpc
[]
[Problem]
  type = LatticeBoltzmannProblem
  substeps = {substeps}
  lbm_backend = {backend}
[]
[Executioner]
  type = Transient
  num_steps = 3
[]
"""

# CHANNEL2D_DECK with the MRT collision
CHANNEL2D_MRT_DECK = CHANNEL2D_DECK.replace("type = LBMBGKCollision",
                                            "type = LBMMRTCollision")

# THERMAL3D_DECK made 2-D: D2Q9 on both lattices, no z ripple
THERMAL2D_DECK = THERMAL3D_DECK
for _old, _new in (("dim = 3", "dim = 2"), ("  nz = {n}\n", ""), ("  zmax = {n}\n", ""),
                   ("type = LBMD3Q19", "type = LBMD2Q9"),
                   ("constants = '0.0 0.0 0.0'", "constants = '0.0 0.0'"),
                   ("*sin(z/8)", "")):
    assert _old in THERMAL2D_DECK, _old
    THERMAL2D_DECK = THERMAL2D_DECK.replace(_old, _new)
del _old, _new

# The port's stand-ins for the reference cylinder.i's parameters: τ₀ = 0.52
# (ν = 0.0067), C_s = 0.1, an inlet speed of 0.05 (Mach 0.087, Re = 300 on
# the shipped cylinder's diameter of 40 cells), the whole grid starting at
# the inlet speed.
KARMAN_DECK = """
[Domain]
  dim = 2
  nx = {nx}
  ny = {ny}
  mesh_mode = DUMMY
[]
[Stencil]
  [d2q9]
    type = LBMD2Q9
  []
[]
[TensorBuffers]
  [f]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [feq]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [fpc]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [velocity]
    type = LBMTensorBuffer
    buffer_type = mv
  []
  [density]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [speed]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [binary_media]
    type = LBMTensorBuffer
    buffer_type = ms
    is_integer = true
    file = binary_media.h5
  []
[]
[TensorComputes]
  [Initialize]
    [initial_density]
      type = LBMConstantTensor
      buffer = density
      constants = 1.0
    []
    [initial_velocity]
      type = LBMConstantTensor
      buffer = velocity
      constants = 'u_inlet 0.0'
    []
    [initial_f]
      type = LBMEquilibrium
      buffer = f
      bulk = density
      velocity = velocity
    []
    [initial_fpc]
      type = LBMEquilibrium
      buffer = fpc
      bulk = density
      velocity = velocity
    []
  []
  [Solve]
    [density]
      type = LBMComputeDensity
      buffer = density
      f = f
    []
    [velocity]
      type = LBMComputeVelocity
      buffer = velocity
      f = f
      rho = density
    []
    [feq]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [collision]
      type = LBMSmagorinskyCollision
      buffer = fpc
      f = f
      feq = feq
      tau0 = tau
      Cs = C_s
      projection = true
    []
    [speed]
      type = LBMComputeVelocityMagnitude
      buffer = speed
      velocity = velocity
    []
    [residual]
      type = LBMComputeResidual
      buffer = speed
      speed = speed
    []
  []
  [Boundary]
    [bottom]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = bottom
    []
    [top]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = top
    []
    [cylinder]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = wall
    []
    [inlet]
      type = LBMFixedFirstOrderBC
      buffer = f
      f = f
      value = u_inlet
      perturb = true
      boundary = left
    []
    [outlet]
      type = LBMMicroscopicZeroGradientBC
      buffer = f
      boundary = right
    []
  []
[]
[TensorSolver]
  type = LBMStream
  buffer = f
  f_old = fpc
[]
[Problem]
  type = LatticeBoltzmannProblem
  scalar_constant_names = 'tau  C_s u_inlet'
  scalar_constant_values = '0.52 0.1 0.05'
  substeps = {substeps}
  binary_media = binary_media
  lbm_backend = {backend}
[]
[Executioner]
  type = Transient
  num_steps = 3
[]
"""


def karman_media(nx: int, ny: int) -> np.ndarray:
    """The cylinder of bench.py:1707-1709 (bench_lbm_karman): an (nx, ny)
    int64 array, 1 fluid and 0 solid inside the disc of radius ny // 10
    around (nx // 5, ny // 2)."""
    x, y = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    media = np.ones((nx, ny), dtype=np.int64)
    media[(x - nx // 5) ** 2 + (y - ny // 2) ** 2 <= (ny // 10) ** 2] = 0
    return media


def porous_media(n: int, seed: int = 42) -> np.ndarray:
    """The binary media of bench.py's porous benchmark (bench_lbm_porous):
    an (n, n, n) int64 array, 1 fluid and 0 solid, with max(8, (n // r)³ //
    24) spheres of radius r = max(2, n // 16) at centres drawn from
    RandomState(seed), periodic.  The same draws and the same cells as the
    benchmark's loop, but each sphere is set over its periodic bounding box
    (radius r) instead of the whole grid."""
    rng = np.random.RandomState(seed)
    media = np.ones((n, n, n), dtype=np.int64)
    r = max(2, n // 16)
    off = np.arange(-r, r + 1)
    ox, oy, oz = np.meshgrid(off, off, off, indexing="ij")
    ball = ox * ox + oy * oy + oz * oz <= r * r
    ox, oy, oz = ox[ball], oy[ball], oz[ball]
    for _ in range(max(8, (n // r) ** 3 // 24)):
        c = rng.randint(0, n, 3)
        # per axis, |offset| <= r reaches every cell within periodic
        # distance r once per image, so repeated cells (n < 2r + 1) only
        # repeat the write
        media.flat[(((c[0] + ox) % n) * n + (c[1] + oy) % n) * n
                   + (c[2] + oz) % n] = 0
    return media


BENCH_1A_DECK = """
[Domain]
  dim = 2
  nx = {n}
  ny = {n}
  xmax = {n}
  ymax = {n}
  {domain_extra}
[]
[TensorComputes]
  [Initialize]
    [c]
      type = ParsedCompute
      buffer = c
      extra_symbols = true
      expression = 'c0+epsilon*(cos(0.105*x)*cos(0.11*y)+(cos(0.13*x)*cos(0.087*y))^2+cos(0.025*x-0.15*y)*cos(0.07*x-0.02*y))'
      constant_names = 'c0 epsilon'
      constant_expressions = '0.5 0.01'
    []
    [Mbar]
      type = ReciprocalLaplacianFactor
      factor = 5
      buffer = Mbar
    []
    [kappabarbar]
      type = ReciprocalLaplacianSquareFactor
      factor = -10
      buffer = kappabarbar
    []
  []
  [Solve]
    [mu]
      type = ParsedCompute
      buffer = mu
      expression = 'rho_s*(c-c_alpha)^2*(c_beta-c)^2'
      constant_names = 'rho_s c_alpha c_beta'
      constant_expressions = '5 0.3 0.7'
      derivatives = c
      inputs = c
    []
    [mubar]
      type = ForwardFFT
      buffer = mubar
      input = mu
    []
    [Mbarmubar]
      type = ParsedCompute
      buffer = Mbarmubar
      expression = 'Mbar*mubar'
      inputs = 'Mbar mubar'
    []
    [cbar]
      type = ForwardFFT
      buffer = cbar
      input = c
    []
  []
  [Postprocess]
    [gradient_energy]
      type = FFTGradientSquare
      buffer = gradient_energy
      input = c
      factor = 1
      execute_on = 'INITIAL TIMESTEP_END'
    []
    [f]
      type = ParsedCompute
      buffer = f
      expression = 'rho_s*(c-c_alpha)^2*(c_beta-c)^2 + gradient_energy'
      constant_names = 'rho_s c_alpha c_beta'
      constant_expressions = '5 0.3 0.7'
      inputs = 'c gradient_energy'
      execute_on = 'INITIAL TIMESTEP_END'
    []
  []
[]
[TensorSolver]
  type = AdamsBashforthMoulton
  buffer = c
  reciprocal_buffer = cbar
  linear_reciprocal = kappabarbar
  nonlinear_reciprocal = Mbarmubar
  substeps = {substeps}
  {solver_extra}
[]
[Problem]
  type = TensorProblem
[]
[Postprocessors]
  [F]
    type = TensorIntegralPostprocessor
    buffer = f
    execute_on = 'INITIAL TIMESTEP_END'
  []
  [c_integral]
    type = TensorIntegralPostprocessor
    buffer = c
    execute_on = 'INITIAL TIMESTEP_END'
  []
  [change]
    type = TensorIntegralChangePostprocessor
    buffer = c
  []
  [c_min]
    type = TensorExtremeValuePostprocessor
    buffer = c
    value_type = MIN
  []
  [c_max]
    type = TensorExtremeValuePostprocessor
    buffer = c
    value_type = MAX
  []
  [mass]
    type = ReciprocalIntegral
    buffer = cbar
  []
  [dt_crit]
    type = SemiImplicitCriticalTimeStep
    buffer = kappabarbar
  []
  [F_per_cell]
    type = ParsedPostprocessor
    expression = 'F / ({n} * {n})'
    pp_names = F
  []
[]
[UserObjects]
  [terminator]
    type = Terminator
    expression = 'change < 1e-4'
  []
[]
[Executioner]
  type = Transient
  end_time = 10500
  dtmax = 300
  [TimeStepper]
    type = IterationAdaptiveDT
    dt = 1
    growth_factor = 1.1
  []
[]
[Outputs]
  csv = true
  perf_graph = true
[]
"""


_BC_IN_OUT = """    [{name}]
      type = {type}
      buffer = f
      f_old = fpc
      feq = feq
      rho = density
      velocity = velocity
      {value}
      boundary = {boundary}
    []
"""


def _bounce(name, boundary):
    return (f"    [{name}]\n      type = LBMBounceBack\n      buffer = f\n"
            f"      f_old = fpc\n      boundary = {boundary}\n    []\n")


TWOPHASE2D_DECK = """
[Domain]
  dim = 2
  nx = {n}
  ny = {n}
  mesh_mode = DUMMY
[]
[Stencil]
  [s]
    type = LBMD2Q9
  []
[]
[TensorBuffers]
  [f]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [feq]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [fpc]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [g]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [geq]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [gpc]
    type = LBMTensorBuffer
    buffer_type = df
  []
  [velocity]
    type = LBMTensorBuffer
    buffer_type = mv
  []
  [forces]
    type = LBMTensorBuffer
    buffer_type = mv
  []
  [grad_phi]
    type = LBMTensorBuffer
    buffer_type = mv
  []
  [density]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [phi]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [laplacian_phi]
    type = LBMTensorBuffer
    buffer_type = ms
  []
  [mu]
    type = LBMTensorBuffer
    buffer_type = ms
  []
[]
[TensorComputes]
  [Initialize]
    [initial_phi]
      type = ParsedCompute
      buffer = phi
      extra_symbols = true
      expression = '0.5 + 0.5*tanh(2*(0.125 - sqrt((x - 0.5)^2 + (y - 0.5)^2))*{n}/thickness)'
      constant_names = thickness
      constant_expressions = 4
    []
    [initial_density]
      type = LBMConstantTensor
      buffer = density
      constants = 1.0
    []
    [initial_velocity]
      type = LBMConstantTensor
      buffer = velocity
      constants = '0.0 0.0'
    []
    [initial_f]
      type = LBMEquilibrium
      buffer = f
      bulk = density
      velocity = velocity
    []
    [initial_fpc]
      type = LBMEquilibrium
      buffer = fpc
      bulk = density
      velocity = velocity
    []
    [initial_g]
      type = LBMPhaseEquilibrium
      buffer = g
      phi = phi
      grad_phi = grad_phi
      tau_phi = tau_phi
      thickness = thickness
    []
    [initial_gpc]
      type = LBMPhaseEquilibrium
      buffer = gpc
      phi = phi
      grad_phi = grad_phi
      tau_phi = tau_phi
      thickness = thickness
    []
  []
  [Solve]
    [phi]
      type = LBMComputeDensity
      buffer = phi
      f = g
    []
    [grad_phi]
      type = LBMIsotropicGradient
      buffer = grad_phi
      scalar_field = phi
    []
    [laplacian_phi]
      type = LBMIsotropicLaplacian
      buffer = laplacian_phi
      scalar_field = phi
    []
    [mu]
      type = LBMComputeChemicalPotential
      buffer = mu
      phi = phi
      laplacian_phi = laplacian_phi
      thickness = thickness
      sigma = sigma
    []
    [forces]
      type = LBMComputeSurfaceForces
      buffer = forces
      chemical_potential = mu
      grad_phi = grad_phi
    []
    [density]
      type = LBMComputeDensity
      buffer = density
      f = f
    []
    [velocity]
      type = LBMComputeVelocity
      buffer = velocity
      f = f
      rho = density
      enable_forces = true
      forces = forces
    []
    [feq]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [collision]
      type = LBMBGKCollision
      buffer = fpc
      f = f
      feq = feq
      tau0 = tau0
    []
    [surface_tension]
      type = LBMApplyForces
      buffer = fpc
      rho = density
      forces = forces
      tau0 = tau0
    []
    [geq]
      type = LBMPhaseEquilibrium
      buffer = geq
      phi = phi
      grad_phi = grad_phi
      tau_phi = tau_phi
      thickness = thickness
    []
    [phase_collision]
      type = LBMBGKCollision
      buffer = gpc
      f = g
      feq = geq
      tau0 = tau_phi
    []
  []
[]
[TensorSolver]
  type = LBMStream
  buffer = 'f g'
  f_old = 'fpc gpc'
[]
[Problem]
  type = LatticeBoltzmannProblem
  substeps = {substeps}
  lbm_backend = {backend}
  scalar_constant_names = 'tau0 tau_phi thickness sigma'
  scalar_constant_values = '1.0 1.0 4.0 0.01'
[]
"""

PRESSURE_DECK = POROUS_DECK.replace("""      add_body_force = true
      body_force_x = 0.0001
""", "").replace("""  [Boundary]
    [wall]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = wall
    []
  []""", "  [Boundary]\n" + "".join(
    _bounce(b, b) for b in ("bottom", "top", "front", "back", "wall")) + _BC_IN_OUT.format(
        name="inlet", type="LBMDirichletBC", value="value = 1.01", boundary="{inlet}")
    + _BC_IN_OUT.format(name="outlet", type="LBMNeumannBC", value="gradient = 0",
                        boundary="right") + "  []")

SPECULAR_CHANNEL_DECK = CHANNEL2D_DECK.replace("""    [initial_fpc]""", """    [initial_feq]
      type = LBMEquilibrium
      buffer = feq
      bulk = density
      velocity = velocity
    []
    [initial_fpc]""").replace("""    [velocity]
      type = LBMTensorBuffer
      buffer_type = mv
    []""", """    [velocity]
      type = LBMTensorBuffer
      buffer_type = mv
    []
    [velocity_physical]
      type = LBMTensorBuffer
      buffer_type = mv
    []""").replace("""    [residual]
      type = LBMComputeResidual""", """    [velocity_physical]
      type = LBMTensorUnitConverter
      buffer = velocity_physical
      tensor_buffer = velocity
      constant = 0.05
    []
    [residual]
      type = LBMComputeResidual""").replace("""  [Boundary]
    [bottom]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = bottom
    []
    [top]
      type = LBMBounceBack
      buffer = f
      f_old = fpc
      boundary = top
    []
    [inlet]
      type = LBMFixedFirstOrderBC
      buffer = f
      f = f
      value = 0.01
      boundary = left
    []
    [outlet]
      type = LBMMicroscopicZeroGradientBC
      buffer = f
      boundary = right
    []
  []""", "  [Boundary]\n" + "".join(
    f"    [{b}]\n      type = LBMSpecularReflectionBoundary\n      buffer = f\n"
    f"      f_old = fpc\n      r = 0.5\n      boundary = {b}\n    []\n"
    for b in ("bottom", "top")) + _BC_IN_OUT.format(
        name="inlet", type="LBMDirichletBC", value="value = 1.001", boundary="left")
    + _BC_IN_OUT.format(name="outlet", type="LBMNeumannBC", value="gradient = 0",
                        boundary="right") + "  []").replace("""[Executioner]
  type = Transient
  num_steps = 3
[]
""", "")

SMOOTHED_BOUNDARY_DECK = """
[Domain]
  dim = 2
  nx = {n}
  ny = {n}
  xmax = {n}
  ymax = {n}
  {domain_extra}
[]
[Functions]
  [c_wave]
    type = ParsedFunction
    expression = 'c0 + amp*cos(2*pi*x/len)*cos(2*pi*y/len)'
    symbol_names = 'c0 amp len'
    symbol_values = '0 0.1 8'
  []
  [c_initial]
    type = ParsedFunction
    expression = 'wave + 0.01*sin(6*pi*x/{n})'
    symbol_names = wave
    symbol_values = c_wave
  []
  [c_initial_square]
    type = ParsedFunction
    expression = 'c*c'
    symbol_names = c
    symbol_values = c_initial
  []
[]
[TensorComputes]
  [Initialize]
    [psi]
      type = SmoothRectangleCompute
      buffer = psi
      x1 = {lo}
      x2 = {hi}
      y1 = {lo}
      y2 = {hi}
      profile = TANH
      int_width = 8
      inside = 1
      outside = 0.001
    []
    [c]
      type = MooseFunctionTensor
      buffer = c
      function = c_initial
    []
    [eta]
      type = ParsedCompute
      buffer = eta
      extra_symbols = true
      expression = '0.05*cos(2*pi*x/{n})*sin(4*pi*y/{n})'
    []
    [L]
      type = ConstantTensor
      buffer = L
      real = 0.05
    []
    [dealias]
      type = DeAliasingTensor
      buffer = dealias
      method = HOULI
    []
    [c_linear]
      type = ReciprocalLaplacianSquareFactor
      buffer = c_linear
      factor = -0.1
    []
    [eta_linear]
      type = ReciprocalLaplacianFactor
      buffer = eta_linear
      factor = 0.05
    []
  []
  [Solve]
    [mobility]
      type = ParsedCompute
      buffer = mobility
      expression = '0.01*(1 - 0.5*c*(1 - c))'
      inputs = c
    []
    [lap_c]
      type = FiniteDifferenceLaplacian
      buffer = lap_c
      input = c
      stencil_width = 5
    []
    [dfdc]
      type = ParsedCompute
      buffer = dfdc
      expression = '5*(c - 0.3)^2*(0.7 - c)^2'
      derivatives = c
      inputs = c
    []
    [mu]
      type = ParsedCompute
      buffer = mu
      expression = 'dfdc - 0.1*lap_c'
      inputs = 'dfdc lap_c'
    []
    [c_flux]
      type = ReciprocalMatDiffusion
      buffer = c_flux
      chemical_potential = mu
      mobility = mobility
      psi = psi
    []
    [c_rate]
      type = ParsedCompute
      buffer = c_rate
      expression = 'dealias*c_flux'
      inputs = 'dealias c_flux'
    []
    [dF_deta]
      type = ParsedCompute
      buffer = dF_deta
      expression = 'eta^2*(1 - eta)^2 + 0.1*eta*c'
      derivatives = eta
      inputs = 'eta c'
    []
    [eta_raw]
      type = ReciprocalAllenCahn
      buffer = eta_raw
      dF_chem_deta = dF_deta
      L = L
      psi = psi
    []
    [eta_rate]
      type = ParsedCompute
      buffer = eta_rate
      expression = 'dealias*eta_raw'
      inputs = 'dealias eta_raw'
    []
    [cbar]
      type = ForwardFFT
      buffer = cbar
      input = c
    []
    [etabar]
      type = ForwardFFT
      buffer = etabar
      input = eta
    []
    [grad_c]
      type = GradientTensor
      buffer = grad_c
      input = c
    []
    [grad_c_sq]
      type = ParsedCompute
      buffer = grad_c_sq
      expression = 'grad_c*grad_c'
      inputs = grad_c
    []
    [grad_c_peak]
      type = RunningMaximum
      buffer = grad_c_peak
      input = grad_c_sq
    []
  []
[]
[TensorSolver]
  type = AdamsBashforthMoulton
  buffer = 'c eta'
  reciprocal_buffer = 'cbar etabar'
  linear_reciprocal = 'c_linear eta_linear'
  nonlinear_reciprocal = 'c_rate eta_rate'
  substeps = {substeps}
  predictor_order = 2
  carry_reciprocal = true
[]
[Problem]
  type = TensorProblem
[]
[Postprocessors]
  [c_initial_square_integral]
    type = FunctionElementIntegral
    function = c_initial_square
  []
  [c_integral]
    type = TensorIntegralPostprocessor
    buffer = c
  []
  [grad_c_peak_max]
    type = TensorExtremeValuePostprocessor
    buffer = grad_c_peak
    value_type = MAX
  []
[]
[Executioner]
  type = Transient
  num_steps = 2
  dt = {dt}
[]
"""


def _ostwald_2a_free_energy() -> str:
    """The chemical free energy of PFHub benchmark 2 (Jokisaari et al.,
    Comput. Mater. Sci. 126 (2017) 139): f = ρ²(c − c_α)²(1 − h) +
    ρ²(c_β − c)²·h + w·g, h = Σ η_i³(6η_i² − 15η_i + 10), g = Σ η_i²(1 −
    η_i)² + α Σ_{i≠j} η_i²η_j², with ρ² = 2, c_α = 0.3, c_β = 0.7, w = 1,
    α = 5."""
    eta = [f"n{i}" for i in range(1, 5)]
    h = " + ".join(f"{n}^3*(6*{n}^2 - 15*{n} + 10)" for n in eta)
    g = " + ".join(f"{n}^2*(1 - {n})^2" for n in eta)
    pairs = " + ".join(f"{a}^2*{b}^2" for i, a in enumerate(eta) for b in eta[i + 1:])
    return (f"2*(c - 0.3)^2*(1 - ({h})) + 2*(0.7 - c)^2*({h}) + ({g}) "
            f"+ 10*({pairs})")


def _ostwald_2a_eta(i: int) -> str:
    """η_i(x, y) of the benchmark's initial condition, ε_η = 0.1, ψ = 1.5."""
    a = 0.01 * i
    return (f"0.1*(cos({a:g}*x - 4)*cos({0.007 + a:g}*y) + cos({0.11 + a:g}*x)"
            f"*cos({0.11 + a:g}*y) + 1.5*(cos({0.046 + 0.001 * i:g}*x + "
            f"{0.0405 + 0.001 * i:g}*y)*cos({0.031 + 0.001 * i:g}*x - "
            f"{0.004 + 0.001 * i:g}*y))^2)^2")


def _ostwald_2a_deck() -> str:
    names = ["c", "n1", "n2", "n3", "n4"]
    f = _ostwald_2a_free_energy()
    ic = "".join(f"""    [{n}]
      type = ParsedCompute
      buffer = {n}
      extra_symbols = true
      expression = '{_ostwald_2a_eta(i)}'
    []
""" for i, n in enumerate(names[1:], 1))
    mus = "".join(f"""    [mu_{n}]
      type = ParsedCompute
      buffer = mu_{n}
      expression = '({f})*{"1" if n == "c" else "(-5)"}'
      derivatives = {n}
      inputs = 'c n1 n2 n3 n4'
    []
""" for n in names)
    mu_bars = "".join(f"""    [mu_{n}_bar]
      type = ForwardFFT
      buffer = mu_{n}_bar
      input = mu_{n}
    []
""" for n in names)
    bars = "".join(f"""    [{n}_bar]
      type = ForwardFFT
      buffer = {n}_bar
      input = {n}
    []
""" for n in names)
    return """
[Domain]
  dim = 2
  nx = {n}
  ny = {n}
  xmax = {n}
  ymax = {n}
  {domain_extra}
[]
[TensorComputes]
  [Initialize]
    [c]
      type = ParsedCompute
      buffer = c
      extra_symbols = true
      expression = '0.5 + 0.05*(cos(0.105*x)*cos(0.11*y) + (cos(0.13*x)*cos(0.087*y))^2 + cos(0.025*x - 0.15*y)*cos(0.07*x - 0.02*y))'
    []
""".replace("{", "{{").replace("}", "}}").replace("{{n}}", "{n}").replace(
        "{{domain_extra}}", "{domain_extra}") + (ic + """    [M_bar]
      type = ReciprocalLaplacianFactor
      factor = 5
      buffer = M_bar
    []
    [c_linear]
      type = ReciprocalLaplacianSquareFactor
      factor = -15
      buffer = c_linear
    []
    [eta_linear]
      type = ReciprocalLaplacianFactor
      factor = 15
      buffer = eta_linear
    []
  []
  [Solve]
""" + mus + mu_bars + """    [M_mu_c_bar]
      type = ParsedCompute
      buffer = M_mu_c_bar
      expression = 'M_bar*mu_c_bar'
      inputs = 'M_bar mu_c_bar'
    []
""" + bars + """  []
[]
""").replace("{", "{{").replace("}", "}}") + """[TensorSolver]
  type = AdamsBashforthMoulton
  buffer = 'c n1 n2 n3 n4'
  reciprocal_buffer = 'c_bar n1_bar n2_bar n3_bar n4_bar'
  linear_reciprocal = 'c_linear eta_linear eta_linear eta_linear eta_linear'
  nonlinear_reciprocal = 'M_mu_c_bar mu_n1_bar mu_n2_bar mu_n3_bar mu_n4_bar'
  substeps = {substeps}
  predictor_order = 2
[]
[Problem]
  type = TensorProblem
  {problem_extra}
[]
"""


OSTWALD_2A_DECK = _ostwald_2a_deck()

BENCH_1A_LEGACY_DECK = BENCH_1A_DECK.replace("""[TensorSolver]
  type = AdamsBashforthMoulton
  buffer = c
  reciprocal_buffer = cbar
  linear_reciprocal = kappabarbar
  nonlinear_reciprocal = Mbarmubar
  substeps = {substeps}
  {solver_extra}
[]
[Problem]
  type = TensorProblem
[]""", """[TensorTimeIntegrators]
  [c]
    type = FFTSemiImplicit
    buffer = c
    reciprocal_buffer = cbar
    linear_reciprocal = kappabarbar
    nonlinear_reciprocal = Mbarmubar
    history_size = 1
  []
[]
[Problem]
  type = TensorProblem
  spectral_solve_substeps = {substeps}
  {solver_extra}
[]""")
assert BENCH_1A_LEGACY_DECK != BENCH_1A_DECK

CH3D_ETDRK4_DECK = CH3D_DECK.replace("""  type = AdamsBashforthMoulton
  buffer = c""", """  type = ETDRK4Solver
  buffer = c""").replace("""  substeps = {substeps}
[]""", """  substeps = {substeps}
  {solver_extra}
[]""")
assert CH3D_ETDRK4_DECK.count("ETDRK4Solver") == 1 and "{solver_extra}" in CH3D_ETDRK4_DECK

_OSTWALD_2A_ABM = """[TensorSolver]
  type = AdamsBashforthMoulton
  buffer = 'c n1 n2 n3 n4'
  reciprocal_buffer = 'c_bar n1_bar n2_bar n3_bar n4_bar'
  linear_reciprocal = 'c_linear eta_linear eta_linear eta_linear eta_linear'
  nonlinear_reciprocal = 'M_mu_c_bar mu_n1_bar mu_n2_bar mu_n3_bar mu_n4_bar'
  substeps = {substeps}
  predictor_order = 2
[]"""

_OSTWALD_2A_ITERATIVE = """[TensorSolver]
  type = <solver>
  buffer = 'c n1 n2 n3 n4'
  reciprocal_buffer = 'c_bar n1_bar n2_bar n3_bar n4_bar'
  linear_reciprocal = 'c_linear eta_linear eta_linear eta_linear eta_linear'
  nonlinear_reciprocal = 'M_mu_c_bar mu_n1_bar mu_n2_bar mu_n3_bar mu_n4_bar'
  substeps = {substeps}
  max_iterations = <max_iterations>
  relative_tolerance = {relative_tolerance}
  absolute_tolerance = 1e-9
  <iteration_extra>
  {solver_extra}
[]
[Postprocessors]
  [c_total]
    type = TensorIntegralPostprocessor
    buffer = c
    execute_on = 'INITIAL TIMESTEP_END'
  []
  [iterations]
    type = TensorSolverIterations
  []
  [group_evals]
    type = ComputeGroupExecutionCount
  []
[]
[Executioner]
  type = Transient
  num_steps = {num_steps}
  [TimeStepper]
    type = TensorSolveIterationAdaptiveDT
    dt = {dt}
    optimal_iterations = <optimal_iterations>
    iteration_window = <iteration_window>
    growth_factor = 1.5
    cutback_factor = 0.5
    cutback_factor_at_failure = 0.25
  []
[]"""


def _ostwald_2a_iterative(**fields) -> str:
    """``OSTWALD_2A_DECK`` with its ABM block replaced by an iterative
    solver, its postprocessors and an iteration-adaptive Transient; the
    <field> tokens of the template filled from ``fields``."""
    block = _OSTWALD_2A_ITERATIVE
    for key, value in fields.items():
        block = block.replace(f"<{key}>", str(value))
    assert "<" not in block and _OSTWALD_2A_ABM in OSTWALD_2A_DECK
    return OSTWALD_2A_DECK.replace(_OSTWALD_2A_ABM, block)


OSTWALD_2A_SECANT_DECK = _ostwald_2a_iterative(
    solver="SecantSolver", max_iterations=30, iteration_extra="",
    optimal_iterations=10, iteration_window=8)

OSTWALD_2A_BROYDEN_DECK = _ostwald_2a_iterative(
    solver="BroydenSolver", max_iterations=60,
    iteration_extra="initial_jacobian_guess = -1",
    optimal_iterations=30, iteration_window=20)

#: the start dt of each iterative 2a deck at which every substep converges
#: (five substeps a step), and one too large, whose first attempt fails
OSTWALD_2A_DT = {"SecantSolver": (0.01, 0.1), "BroydenSolver": (2e-4, 1e-2)}

#: relative tolerances of the iterative 2a decks: the reference's 1e-9 in
#: float64; in float32 the residual stalls at the FFT round trip's rounding
#: of c's mean (|R| ~ 1e-2 at 200², up to 3e-3 of |R0|), so 1e-2 there.
#: Broyden's per-point rank-one update wanders near 1e-5 of |R0| on this
#: five-field deck, so its float64 tolerance is 1e-4.
OSTWALD_2A_TOL = {("SecantSolver", "DOUBLE"): "1e-9", ("SecantSolver", "SINGLE"): "1e-2",
                  ("BroydenSolver", "DOUBLE"): "1e-4", ("BroydenSolver", "SINGLE"): "1e-2"}


def half_cell(n: int) -> str:
    """π/n, the half cell of a 2π box of n cells: a field even about it has
    a real spectrum on the cell-centred grid."""
    return repr(np.pi / n)


COUPLED_DECK = """
[Domain]
  dim = 2
  nx = {n}
  ny = {n}
  xmax = 6.283185307179586
  ymax = 6.283185307179586
  {domain_extra}
[]
[TensorComputes]
  [Initialize]
    [u]
      type = ParsedCompute
      buffer = u
      extra_symbols = true
      expression = 'cos(x - {h}) + 0.5*cos(2*(y - {h}))'
    []
    [v]
      type = ParsedCompute
      buffer = v
      extra_symbols = true
      expression = '0.8*cos(2*(x - {h}))*cos(y - {h})'
    []
    [Lu]
      type = ReciprocalLaplacianFactor
      factor = 0.1
      buffer = Lu
    []
    [Lv]
      type = ReciprocalLaplacianFactor
      factor = 0.2
      buffer = Lv
    []
    [Luv]
      type = ConstantReciprocalTensor
      real = 0.5
      buffer = Luv
    []
  []
  [Solve]
    [Nu]
      type = ParsedCompute
      buffer = Nu
      expression = '-0.3*u'
      inputs = u
    []
    [Nv]
      type = ParsedCompute
      buffer = Nv
      expression = '-0.3*v'
      inputs = v
    []
    [Nubar]
      type = ForwardFFT
      buffer = Nubar
      input = Nu
    []
    [Nvbar]
      type = ForwardFFT
      buffer = Nvbar
      input = Nv
    []
    [ubar]
      type = ForwardFFT
      buffer = ubar
      input = u
    []
    [vbar]
      type = ForwardFFT
      buffer = vbar
      input = v
    []
  []
[]
[TensorSolver]
  type = AdamsBashforthMoultonCoupled
  buffer = 'u v'
  reciprocal_buffer = 'ubar vbar'
  linear_reciprocal = 'Lu Lv'
  nonlinear_reciprocal = 'Nubar Nvbar'
  linear_offdiag = Luv
  linear_offdiag_rows = 0
  linear_offdiag_cols = 1
  substeps = {substeps}
  predictor_order = {order}
  corrector_order = {order}
  corrector_steps = {corrector_steps}
  {solver_extra}
[]
[Problem]
  type = TensorProblem
[]
"""

#: the coupled deck's operator: ū' = E ū per mode, E[r][s] = Lmap(s, r) − 0.3
#: δ_rs with Lmap(0, 0) = −0.1k², Lmap(1, 1) = −0.2k², Lmap(0, 1) = 0.5 (and
#: Lmap(1, 0) = 0.5 under assume_symmetric): the reference's stacking reads
#: the coupling transposed
COUPLED_RATES = {"diffusivity": (0.1, 0.2), "coupling": 0.5, "explicit": -0.3}


def coupled_exact(u0, v0, t, symmetric=False):
    """``COUPLED_DECK``'s exact (u, v) at ``t`` from (u0, v0) on its 2π box:
    each mode of the float64 fields times exp(E·t) (``COUPLED_RATES``)."""
    n = u0.shape
    k2 = sum(torch.as_tensor(f * f, dtype=torch.float64, device=u0.device)
             for f in torch.meshgrid(torch.fft.fftfreq(n[0], 1.0 / n[0], dtype=torch.float64),
                                     torch.fft.rfftfreq(n[1], 1.0 / n[1], dtype=torch.float64),
                                     indexing="ij"))
    E = torch.zeros(k2.shape + (2, 2), dtype=torch.float64, device=u0.device)
    E[..., 0, 0] = -COUPLED_RATES["diffusivity"][0] * k2 + COUPLED_RATES["explicit"]
    E[..., 1, 1] = -COUPLED_RATES["diffusivity"][1] * k2 + COUPLED_RATES["explicit"]
    E[..., 1, 0] = COUPLED_RATES["coupling"]
    if symmetric:
        E[..., 0, 1] = COUPLED_RATES["coupling"]
    x = torch.stack([torch.fft.rfftn(u0.double()), torch.fft.rfftn(v0.double())], -1)
    y = (torch.linalg.matrix_exp(E * t).to(x.dtype) @ x.unsqueeze(-1))[..., 0]
    return tuple(torch.fft.irfftn(y[..., i], s=n) for i in range(2))

EXPLICIT_DECK = """
[Domain]
  dim = 2
  nx = {n}
  ny = {n}
  xmax = 6.283185307179586
  ymax = 6.283185307179586
  {domain_extra}
[]
[TensorComputes]
  [Initialize]
    [u]
      type = ParsedCompute
      buffer = u
      extra_symbols = true
      expression = 'cos(x) + 0.5*sin(3*y) + 0.2*cos(5*x + 2*y)'
    []
    [Lbar]
      type = ReciprocalLaplacianFactor
      factor = 0.05
      buffer = Lbar
    []
  []
  [Solve]
    [ubar]
      type = ForwardFFT
      buffer = ubar
      input = u
    []
    [dubar]
      type = ParsedCompute
      buffer = dubar
      expression = 'Lbar*ubar'
      inputs = 'Lbar ubar'
    []
  []
[]
[TensorSolver]
  type = ForwardEulerSolver
  buffer = u
  reciprocal_buffer = ubar
  time_derivative_reciprocal = dubar
  substeps = {substeps}
[]
[Problem]
  type = TensorProblem
[]
"""

EXPLICIT_REAL_SPACE_DECK = EXPLICIT_DECK.replace("""  [Solve]
    [ubar]
      type = ForwardFFT
      buffer = ubar
      input = u
    []
    [dubar]
      type = ParsedCompute
      buffer = dubar
      expression = 'Lbar*ubar'
      inputs = 'Lbar ubar'
    []
  []""", """  [Solve]
    [du]
      type = FiniteDifferenceLaplacian
      buffer = du
      input = u
      factor = 0.05
    []
  []""").replace("""  type = ForwardEulerSolver
  buffer = u
  reciprocal_buffer = ubar
  time_derivative_reciprocal = dubar""", """  type = RealSpaceForwardEuler
  buffer = u
  time_derivative = du""")
assert "RealSpaceForwardEuler" in EXPLICIT_REAL_SPACE_DECK and "dubar" not in EXPLICIT_REAL_SPACE_DECK

#: tests/test_etdrk4_cox_matthews.py's DECK: 1-D Allen-Cahn-type u − u³ under
#: ETDRK4Solver, formatted with ``substeps`` and ``cm`` (cox_matthews)
ETDRK4_ORDER_DECK = """
[Domain]
  dim = 1
  nx = 64
  xmax = 6.283185307179586
  floating_precision = DOUBLE
[]
[TensorBuffers]
  [u][]
  [ubar][]
  [Lbar][]
  [Nbar][]
  [mu][]
[]
[TensorComputes]
  [Initialize]
    [u]
      type = ParsedCompute
      buffer = u
      extra_symbols = true
      expression = '0.1*sin(x) + 0.05*cos(2*x)'
    []
    [Lbar]
      type = ReciprocalLaplacianFactor
      factor = 1
      buffer = Lbar
    []
  []
  [Solve]
    [mu]
      type = ParsedCompute
      buffer = mu
      expression = 'u - u^3'
      inputs = u
    []
    [Nbar]
      type = ForwardFFT
      buffer = Nbar
      input = mu
    []
    [ubar]
      type = ForwardFFT
      buffer = ubar
      input = u
    []
  []
[]
[TensorSolver]
  type = ETDRK4Solver
  buffer = u
  reciprocal_buffer = ubar
  linear_reciprocal = Lbar
  nonlinear_reciprocal = Nbar
  substeps = {substeps}
  cox_matthews = {cm}
[]
[Problem]
  type = TensorProblem
[]
"""

MECH_DECK = """[Domain]
  dim = 3
  nx = {n}
  ny = {n}
  nz = {n}
  xmax = 6.283185307179586
  ymax = 6.283185307179586
  zmax = 6.283185307179586
  mesh_mode = DUMMY
  {domain_extra}
[]
[TensorComputes]
  [Initialize]
    [Finit]
      type = RankTwoIdentity
      buffer = F
    []
    [phase]
      type = PhaseMechanicsTest
      buffer = phase
    []
    [K]
      type = ParsedCompute
      buffer = K
      expression = '(1-phase)*Ka + phase*Kb'
      inputs = phase
      constant_names = 'Ka Kb'
      constant_expressions = '0.833 8.33'
    []
    [mu]
      type = ParsedCompute
      buffer = mu
      expression = '(1-phase)*mua + phase*mub'
      inputs = phase
      constant_names = 'mua mub'
      constant_expressions = '0.386 3.86'
    []
  []
  [Solve]
    [hyper_elasticity]
      type = HyperElasticIsotropic
      buffer = stress
      F = Fnew
      K = K
      mu = mu
    []
    [root]
      [applied_strain]
        type = MacroscopicShearTensor
        buffer = applied_strain
      []
      [mech]
        type = FFTMechanics
        buffer = Fnew
        F = F
        K = K
        mu = mu
        l_tol = 1e-2
        nl_rel_tol = 2e-2
        nl_abs_tol = 2e-2
        constitutive_model = hyper_elasticity
        stress = stress
        applied_macroscopic_strain = applied_strain
      []
    []
  []
[]
[TensorSolver]
  type = ForwardEulerSolver
  root_compute = root
  forward_buffer = F
  forward_buffer_new = Fnew
  substeps = 10
[]
[Executioner]
  type = Transient
  num_steps = 100
  dt = 0.01
[]
"""

MECH_2D_DECK = MECH_DECK.replace("  dim = 3\n", "  dim = 2\n").replace(
    "  nz = {n}\n", "").replace("  zmax = 6.283185307179586\n", "")

COUPLED_PF_MECH_DECK = CH3D_DECK.replace("""    [cbar]
      type = ForwardFFT
      buffer = cbar
      input = c
    []
""", """    [cbar]
      type = ForwardFFT
      buffer = cbar
      input = c
    []
    [displacements]
      type = FFTQuasistaticElasticity
      displacements = 'disp_x disp_y disp_z'
      cbar = cbar
      mu = 1
      lambda = 1
      e0 = 0.01
    []
    [mubar_el]
      type = FFTElasticChemicalPotential
      buffer = mubar_el
      displacements = 'disp_x disp_y disp_z'
      cbar = cbar
      mu = 1
      lambda = 1
      e0 = 0.01
    []
""").replace("expression = 'Mbar*mubar'\n      inputs = 'Mbar mubar'",
             "expression = 'Mbar*(mubar+mubar_el)'\n      inputs = 'Mbar mubar mubar_el'").replace(
    "  zmax = {n}\n", "  zmax = {n}\n  {domain_extra}\n")

FRACTURE_DECK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "examples", "phase_field_fracture", "fracture.i")


# -- the NN Gibbs surrogate and NEML2 ---------------------------------------------

_KKS_MU = """    [mu_c]
      type = ParsedCompute
      buffer = mu_c
      expression = '(2*(c-0.3)^2*(0.7-c)^2 + n1^2*c)*5'
      derivatives = c
      inputs = 'c n1'
    []
    [mu_n1]
      type = ParsedCompute
      buffer = mu_n1
      expression = '(n1^2*(1-n1)^2 + n1^2*c)*(-5)'
      derivatives = n1
      inputs = 'c n1'
    []
"""
assert _KKS_MU in MULTI_3D_DECK

#: the surrogate's Gibbs energy G(n1, c): its dG/dc is MULTI_3D_DECK's µ_c
#: and its −dG/dn1 that deck's µ_n1
KKS_G = "5*(2*(c-0.3)^2*(0.7-c)^2 + n1^2*(1-n1)^2 + n1^2*c)"

_KKS_MU_N1 = """    [mu_n1]
      type = ParsedCompute
      buffer = mu_n1
      expression = '-dGdn1'
      inputs = dGdn1
    []
"""

KKS_NN_3D_DECK = MULTI_3D_DECK.replace(_KKS_MU, """    [gibbs]
      type = LibtorchGibbsEnergy
      buffer = G
      phase_fractions = n1
      concentrations = c
      domega_detas = dGdn1
      chem_pots = mu_c
      libtorch_model_file = {model}
    []
""" + _KKS_MU_N1)

KKS_PARSED_3D_DECK = MULTI_3D_DECK.replace(_KKS_MU, f"""    [G]
      type = ParsedCompute
      buffer = G
      expression = '{KKS_G}'
      inputs = 'n1 c'
    []
    [dGdn1]
      type = ParsedCompute
      buffer = dGdn1
      expression = '{KKS_G}'
      derivatives = n1
      inputs = 'n1 c'
    []
    [mu_c]
      type = ParsedCompute
      buffer = mu_c
      expression = '{KKS_G}'
      derivatives = c
      inputs = 'n1 c'
    []
""" + _KKS_MU_N1)


def _kks_gibbs(n1, c):
    return 5.0 * (2.0 * (c - 0.3) ** 2 * (0.7 - c) ** 2 + n1 ** 2 * (1.0 - n1) ** 2
                  + n1 ** 2 * c)


class AnalyticGibbs(torch.nn.Module):
    """KKS_G on rows (n1, c), elementwise."""

    def forward(self, x):
        return _kks_gibbs(x[:, 0], x[:, 1])


class MLPGibbs(torch.nn.Module):
    """KKS_G plus a small MLP correction (2→32→32→1, tanh), scaled by
    ``scale``; its weights drawn from numpy's generator seeded with
    ``seed``, so that every torch version builds the same model."""

    def __init__(self, seed: int, width: int = 32, scale: float = 0.01):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.l1 = torch.nn.Linear(2, width)
        self.l2 = torch.nn.Linear(width, width)
        self.l3 = torch.nn.Linear(width, 1)
        with torch.no_grad():
            for layer in (self.l1, self.l2, self.l3):
                bound = 1.0 / np.sqrt(layer.in_features)
                layer.weight.copy_(torch.from_numpy(
                    rng.uniform(-bound, bound, tuple(layer.weight.shape))))
                layer.bias.copy_(torch.from_numpy(rng.uniform(-bound, bound, layer.out_features)))
        self.scale = scale

    def forward(self, x):
        h = torch.tanh(self.l2(torch.tanh(self.l1(x))))
        return _kks_gibbs(x[:, 0], x[:, 1]) + self.scale * self.l3(h).squeeze(1)


def gibbs_surrogate(kind: str, path: str, seed: int = 0) -> str:
    """Save the surrogate ``kind`` as a TorchScript module at ``path`` (the
    weights both packages load): ``"analytic"``, KKS_G as an elementwise
    scripted module; ``"mlp"``, KKS_G plus MLPGibbs's seeded correction.
    Returns ``path``."""
    model = {"analytic": AnalyticGibbs, "mlp": lambda: MLPGibbs(seed)}[kind]()
    torch.jit.save(torch.jit.script(model.eval()), path)
    return path


#: tests/test_neml2.py::test_neml2_implicit_perzyna_viscoplasticity's
#: model.i: elasticity on Ee = E − Ep, von Mises, linear hardening,
#: Perzyna flow, normality, associative flow, backward Euler on Ep (Mandel
#: 6) and ep (1) under ImplicitUpdate, n = 7 unknowns a point
NEML2_PERZYNA_MODEL = """
[Models]
  [elastic_strain]
    type = SR2LinearCombination
    from_var = 'forces/E state/internal/Ep'
    to_var = 'state/internal/Ee'
    coefficients = '1 -1'
  []
  [elasticity]
    type = LinearIsotropicElasticity
    strain = 'state/internal/Ee'
    stress = 'state/S'
    coefficients = '200e3 0.3'
    coefficient_types = 'YOUNGS_MODULUS POISSONS_RATIO'
  []
  [vm]
    type = SR2Invariant
    invariant_type = VONMISES
    tensor = 'state/S'
    invariant = 'state/internal/sm'
  []
  [hard]
    type = LinearIsotropicHardening
    hardening_modulus = 1000
  []
  [yield]
    type = YieldFunction
    yield_stress = 100
    stress_measure = 'state/internal/sm'
    isotropic_hardening = 'state/internal/k'
  []
  [flow]
    type = PerzynaPlasticFlowRate
    reference_stress = 50
    exponent = 2
  []
  [normality]
    type = Normality
    stress = 'state/S'
    flow_direction = 'state/internal/NM'
  []
  [epflow]
    type = AssociativePlasticFlow
    plastic_strain_rate = 'state/internal/Ep_rate'
  []
  [eprate]
    type = AssociativeIsotropicPlasticHardening
  []
  [integ_Ep]
    type = SR2BackwardEulerTimeIntegration
    variable = 'state/internal/Ep'
  []
  [integ_ep]
    type = ScalarBackwardEulerTimeIntegration
    variable = 'state/internal/ep'
  []
  [system]
    type = ComposedModel
    models = 'elastic_strain elasticity vm hard yield flow normality
              epflow eprate integ_Ep integ_ep'
  []
  [impl]
    type = ImplicitUpdate
    implicit_model = system
    absolute_tolerance = 1e-9
    relative_tolerance = 1e-12
  []
[]
"""

#: the Miehe tension/compression split of the strain energy of E less a
#: thermal eigenstrain α·T·I (so that the principal strains take both signs
#: where T is high)
NEML2_SPECTRAL_MODEL = """
[Models]
  [eigen]
    type = ThermalEigenstrain
    CTE = 1e-5
    reference_temperature = 0
    temperature = 'forces/T'
    eigenstrain = 'forces/Eg'
  []
  [mechanical]
    type = SR2LinearCombination
    from_var = 'forces/E forces/Eg'
    to_var = 'forces/Em'
    coefficients = '1 -1'
  []
  [psis]
    type = StrainEnergyDensity
    lambda = 100.0
    mu = 50.0
    decomposition = SPECTRAL
    strain = 'forces/Em'
  []
  [split]
    type = ComposedModel
    models = 'eigen mechanical psis'
  []
[]
"""

NEML2_PERZYNA_DECK = """
[Domain]
  dim = 3
  nx = {n}
  ny = {n}
  nz = {n}
  {domain_extra}
[]
[TensorBuffers]
  [dir]
    type = SR2Tensor
  []
  [E]
    type = SR2Tensor
  []
  [Ep_old]
    type = SR2Tensor
  []
  [Ep]
    type = SR2Tensor
  []
  [S]
    type = SR2Tensor
  []
  [ep_old][]
  [ep][]
  [t_now][]
  [t_old][]
  [T][]
  [psi][]
  [psi_inactive][]
[]
[TensorComputes]
  [Initialize]
    [dir]
      type = ConstantTensor
      buffer = dir
      real = 1
    []
  []
  [Solve]
    [t_now]
      type = ParsedCompute
      buffer = t_now
      expression = 't'
      extra_symbols = true
    []
    [t_old]
      type = ParsedCompute
      buffer = t_old
      expression = 't - {dt}'
      extra_symbols = true
    []
    [E]
      type = ParsedCompute
      buffer = E
      expression = 'dir*0.002*t*(1+x)'
      inputs = dir
      extra_symbols = true
    []
    [T]
      type = ParsedCompute
      buffer = T
      expression = '200*t*y'
      extra_symbols = true
    []
    [perzyna]
      type = NEML2TensorCompute
      neml2_input_file = {model}
      neml2_model = impl
      marlin_inputs = 'E Ep_old ep_old t_now t_old'
      neml2_inputs = 'forces/E old_state/internal/Ep old_state/internal/ep forces/t old_forces/t'
      neml2_outputs = 'state/internal/Ep state/internal/ep state/S'
      marlin_outputs = 'Ep ep S'
      {cli_args}
    []
    [psi]
      type = NEML2TensorCompute
      neml2_input_file = {spectral_model}
      neml2_model = split
      marlin_inputs = 'E T'
      neml2_inputs = 'forces/E forces/T'
      neml2_outputs = 'state/internal/psi state/internal/psi_inactive'
      marlin_outputs = 'psi psi_inactive'
    []
  []
[]
[TensorSolver]
  type = ForwardEulerSolver
  forward_buffer = 'Ep_old ep_old'
  forward_buffer_new = 'Ep ep'
[]
[Problem]
  type = TensorProblem
[]
[Executioner]
  type = Transient
  num_steps = {steps}
  dt = {dt}
[]
"""


# -- stand-ins for the distributed modes' reference decks ------------------------

GRADIENT_DECK = """
[Domain]
  dim = 3
  nx = {n}
  ny = {n}
  nz = {n}
  xmax = 6.283185307179586
  ymax = 6.283185307179586
  zmax = 6.283185307179586
  {domain_extra}
[]
[TensorComputes]
  [Initialize]
    [c]
      type = ParsedCompute
      buffer = c
      extra_symbols = true
      expression = 'sin(x)*cos(2*y) + 0.5*cos(3*z)*sin(y) + 0.25*sin(x+z)'
    []
  []
  [Solve]
    [dcdx]
      type = FFTGradient
      buffer = dcdx
      input = c
      direction = X
    []
    [dcdy]
      type = FFTGradient
      buffer = dcdy
      input = c
      direction = Y
    []
    [dcdz]
      type = FFTGradient
      buffer = dcdz
      input = c
      direction = Z
    []
    [grad_sq]
      type = FFTGradientSquare
      buffer = grad_sq
      input = c
    []
  []
[]
[Postprocessors]
  [dcdx_max]
    type = TensorExtremeValuePostprocessor
    buffer = dcdx
    value_type = MAX
  []
  [dcdy_min]
    type = TensorExtremeValuePostprocessor
    buffer = dcdy
    value_type = MIN
  []
  [dcdz_mean]
    type = TensorAveragePostprocessor
    buffer = dcdz
  []
  [grad_sq_integral]
    type = TensorIntegralPostprocessor
    buffer = grad_sq
  []
[]
[Problem]
  type = TensorProblem
[]
[Executioner]
  type = Transient
  num_steps = 2
  dt = 1
[]
[Outputs]
  csv = true
[]
"""

LAPLACIAN_RS_DECK = """
[Domain]
  dim = {dim}
  {extents}
  parallel_mode = REAL_SPACE
  {domain_extra}
[]
[TensorComputes]
  [Initialize]
    [u]
      type = ParsedCompute
      buffer = u
      extra_symbols = true
      expression = '{ic}'
    []
  []
  [Solve]
    [lap]
      type = FiniteDifferenceLaplacian
      buffer = lap
      input = u
      factor = 0.02
      stencil_width = {stencil}
    []
  []
[]
[TensorSolver]
  type = RealSpaceForwardEuler
  buffer = u
  time_derivative = lap
  substeps = {substeps}
[]
[Postprocessors]
  [u_max]
    type = TensorExtremeValuePostprocessor
    buffer = u
    value_type = MAX
  []
  [u_min]
    type = TensorExtremeValuePostprocessor
    buffer = u
    value_type = MIN
  []
  [u_mean]
    type = TensorAveragePostprocessor
    buffer = u
  []
  [lap_integral]
    type = TensorIntegralPostprocessor
    buffer = lap
  []
[]
[Problem]
  type = TensorProblem
[]
[Executioner]
  type = Transient
  num_steps = {num_steps}
  dt = {dt}
[]
[Outputs]
  csv = true
[]
"""

#: the initial field of LAPLACIAN_RS_DECK by dimension: low modes and one
#: short one along each axis, so that the halo of every cut axis matters
LAPLACIAN_RS_IC = {2: "cos(x) + 0.5*sin(3*y) + 0.2*cos(7*x + 2*y)",
                   3: "cos(x) + 0.5*sin(3*y) + 0.2*cos(7*x + 2*y) + 0.3*sin(5*z - x)"}


def laplacian_rs(dim: int, n: int, stencil: int = 3, substeps: int = 4,
                 num_steps: int = 2, domain_extra: str = "") -> str:
    """LAPLACIAN_RS_DECK on an n^dim grid of side 2π, dt a stable fraction
    of the explicit limit (h²/(4·dim·0.02) a substep)."""
    names = "xyz"[:dim]
    extents = "\n  ".join([f"n{a} = {n}" for a in names]
                          + [f"{a}max = 6.283185307179586" for a in names])
    h = 6.283185307179586 / n
    dt = 0.5 * h * h / (4 * dim * 0.02) * substeps
    return LAPLACIAN_RS_DECK.format(dim=dim, extents=extents, ic=LAPLACIAN_RS_IC[dim],
                                    stencil=stencil, substeps=substeps,
                                    num_steps=num_steps, dt=repr(dt),
                                    domain_extra=domain_extra)
