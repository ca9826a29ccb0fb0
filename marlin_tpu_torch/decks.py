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
"""

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
