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
"""

import numpy as np

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
