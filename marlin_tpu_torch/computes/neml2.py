"""NEML2-equivalent constitutive-model path (the port of
marlin_tpu/computes/neml2.py).

The reference wraps the NEML2 constitutive-model library: a NEML2 HIT input
file declares [Models], and NEML2TensorCompute maps marlin buffers onto the
model's input/output variables (reference
src/tensor_computes/NEML2TensorCompute.C:1-120, test/tests/neml2/).

The same 56 model types as the JAX package, under the same names and
parameters.  Each model is a plain class whose ``forward(env)`` maps a dict
of named tensors (``forces/E``, ``state/S``, ...) to a dict of tensors,
evaluated eagerly; constants live on the device the model was loaded for.

Two loops that the JAX package runs as ``lax.while_loop`` are host loops
here: ImplicitUpdate's field-wide Newton and J2RadialReturn's return-map
Newton.  Each tests its condition before the body, as ``lax.while_loop``
does, so the iteration counts equal the JAX package's, and fetches one
flag an iteration (max |R| over the finite points against the tolerance).
``counts`` on each keeps the solves, iterations and fetches.
ImplicitUpdate's per-point Jacobian is built from n forward-mode columns
(``torch.func.jvp``, the n tangents batched into one pass by
``torch.func.vmap``), the counterpart of the JAX package's n ``jax.jvp``
columns, and solved with smallsolve.small_solve (the JAX package's pivot
rule).  ``torch.maximum``/``torch.minimum`` stand where the JAX package
uses ``jnp.maximum``/``jnp.minimum``/``jnp.clip``: both split the tangent
in half at a tie, where ``torch.clamp`` would pass it whole.

Three departures from the JAX package, each a load-time refusal it does
not make: a missing optional float-or-variable parameter is (None, None)
(the JAX package raises a TypeError), a ``nan``/``inf`` literal there is a
named parameter error (the JAX package takes it as a constant), and a
Kocks-Mecking slope A > 0 is a named error (the JAX package accepts it and
gives a negative rate sensitivity).
"""

from __future__ import annotations

import functools
import math
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from .. import device as _device
from .. import perf
from ..parallel import all_reduce
from ..params import Params
from ..registry import computes
from ..smallsolve import small_solve
from .base import ComputeError, Spec, TensorCompute

_VOL = (1.0, 1.0, 1.0, 0.0, 0.0, 0.0)

_CONSTS: Dict[tuple, torch.Tensor] = {}


def _const(value, dtype, device):
    """``value`` (a python number, or nested tuples of them) as a tensor of
    ``dtype`` on ``device``, made once and then reused, so that the Newton
    loops' residual evaluations make no host-to-device copy.  Keyed by the
    value's repr, which tells -0.0 from 0.0 and matches nan with itself."""
    key = (repr(value), dtype, device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(value, dtype=dtype, device=device)
    return t


def _tuples(a):
    """A numpy array as nested tuples of python floats: a _const value."""
    return tuple(_tuples(r) for r in a) if np.ndim(a) > 1 else tuple(map(float, a))


class NEML2Error(Exception):
    pass


@dataclass
class NewtonCounts:
    """What a host Newton loop saw since its model was built: solves,
    iterations, device-to-host fetches (one a condition test), and each
    solve's iteration count in order (``log``)."""

    solves: int = 0
    iterations: int = 0
    fetches: int = 0
    log: List[int] = field(default_factory=list)


class _NEML2Model:
    #: the domain's mesh, set by NEML2TensorCompute: the host Newton loops'
    #: maxima are taken over it
    mesh = None

    def __init__(self, name: str, params: Params, device=None):
        self.name = name
        self.device = torch.device(device) if device is not None else _device.resolve()

    def const(self, value, dtype=torch.float64):
        """A constant on the model's device."""
        return _const(value, dtype, self.device)

    def forward(self, env: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


def _float_or_var(params, key, required=True):
    """Parameters that accept a float literal OR a variable name (e.g. a
    temperature-dependent quantity produced by a sibling model).  Returns
    (var_name_or_None, float_or_None); a missing optional key is
    (None, None), and a non-finite literal is a parameter error."""
    raw = params.get_str(key, required=required)
    if raw is None:
        return None, None
    try:
        value = float(raw)
    except ValueError:
        return raw, None
    if not math.isfinite(value):
        params.error(key, f"'{raw}' is not a finite number")
    return None, value


def _maximum(x, c):
    """jnp.maximum(x, c) for a scalar c: the tangent splits at a tie."""
    return torch.maximum(x, c if isinstance(c, torch.Tensor) else _const(c, x.dtype, x.device))


def _minimum(x, c):
    return torch.minimum(x, c if isinstance(c, torch.Tensor) else _const(c, x.dtype, x.device))


def _clip(x, lo, hi):
    """jnp.clip: maximum then minimum."""
    return _minimum(_maximum(x, lo), hi)


def _where(cond, a, b):
    """jnp.where with python scalars on either side."""
    like = a if isinstance(a, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = _const(a, like.dtype, like.device)
    if not isinstance(b, torch.Tensor):
        b = _const(b, like.dtype, like.device)
    return torch.where(cond, a, b)


def _vol_mask(x):
    return _const(_VOL, x.dtype, x.device)


def _safe_pow(x, n):
    """x**n for x >= 0 with a FINITE jvp at x = 0 (the pow's derivative
    blows up there for n < 1, and an inf Jacobian column NaNs the whole
    grid inside ImplicitUpdate).  Double-where construction: the primal
    stays exact (0**n = 0) while the pow always sees a positive floor, so
    at x <= floor both maximum() and where() route the tangent to the
    constant side.  Callers feeding signed quantities take |x| (and
    re-apply the sign) or clamp first."""
    x_safe = _maximum(x, 1e-12)
    return _where(x > 0.0, x_safe ** n, 0.0)


def _mises(x):
    """sqrt(max(3/2·dev(x):dev(x), 0)) on Mandel 6-vectors, and dev(x)."""
    tr = x[..., 0] + x[..., 1] + x[..., 2]
    dev = x - (tr / 3.0)[..., None] * _vol_mask(x)
    return torch.sqrt(_maximum(1.5 * torch.sum(dev * dev, -1), 0.0)), dev


def _elastic_moduli(params, types, coeffs):
    vals = dict(zip([t.upper() for t in types], coeffs))
    if {"YOUNGS_MODULUS", "POISSONS_RATIO"} <= set(vals):
        E, nu = vals["YOUNGS_MODULUS"], vals["POISSONS_RATIO"]
        return E / (3.0 * (1.0 - 2.0 * nu)), E / (2.0 * (1.0 + nu))
    if {"BULK_MODULUS", "SHEAR_MODULUS"} <= set(vals):
        return vals["BULK_MODULUS"], vals["SHEAR_MODULUS"]
    params.error("coefficient_types",
                 "supported pairs: YOUNGS_MODULUS+POISSONS_RATIO or "
                 f"BULK_MODULUS+SHEAR_MODULUS (got {types})")


# -- (a) algebra, elasticity, invariants, time integration ------------------------


class ScalarMultiplication(_NEML2Model):
    """to_var = coefficient * Π from_var (NEML2 ScalarMultiplication;
    `reciprocal` flags invert individual factors)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.from_var = params.get_str_vector("from_var", required=True)
        self.to_var = params.get_str("to_var", required=True)
        self.coefficient = params.get_float("coefficient", 1.0)
        from ..params import _BOOL_FALSE, _BOOL_TRUE

        recip = params.get_str_vector("reciprocal", [])
        for r in recip:
            if r.lower() not in _BOOL_TRUE | _BOOL_FALSE:
                params.error("reciprocal", f"cannot parse '{r}' as a bool")
        self.reciprocal = [r.lower() in _BOOL_TRUE for r in recip] or [
            False
        ] * len(self.from_var)
        if len(self.reciprocal) != len(self.from_var):
            params.error("reciprocal", "one flag per from_var")

    def forward(self, env):
        out = self.const(self.coefficient)
        for v, rec in zip(self.from_var, self.reciprocal):
            out = out / env[v] if rec else out * env[v]
        return {self.to_var: out}


class ScalarLinearCombination(_NEML2Model):
    """to_var = Σ coefficient_i * from_var_i (NEML2 ScalarLinearCombination)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.from_var = params.get_str_vector("from_var", required=True)
        self.to_var = params.get_str("to_var", required=True)
        self.coefficients = params.get_float_vector(
            "coefficients", [1.0] * len(self.from_var))
        if len(self.coefficients) != len(self.from_var):
            params.error("coefficients", "one coefficient per from_var")

    def forward(self, env):
        out = None
        for c, v in zip(self.coefficients, self.from_var):
            term = c * env[v]
            out = term if out is None else out + term
        return {self.to_var: out}


class ScalarParameterToState(_NEML2Model):
    """to_var = value (NEML2 ScalarParameterToState: constant parameter)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.to_var = params.get_str("to_var", required=True)
        self.value = params.get_float("value", required=True)

    def forward(self, env):
        return {self.to_var: self.const(self.value)}


class LinearIsotropicElasticity(_NEML2Model):
    """S = 3K·vol(E) + 2G·dev(E) on Mandel-notation SR2 fields (trailing
    axis 6: [xx, yy, zz, √2·yz, √2·xz, √2·xy]) — NEML2's
    LinearIsotropicElasticity.  `coefficients` + `coefficient_types`
    accept YOUNGS_MODULUS/POISSONS_RATIO or BULK_MODULUS/SHEAR_MODULUS
    pairs; `compliance = true` inverts the map (stress -> strain)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.strain = params.get_str("strain", "forces/E")
        self.stress = params.get_str("stress", "state/S")
        self.compliance = params.get_bool("compliance", False)
        coeffs = params.get_float_vector("coefficients", required=True)
        types = params.get_str_vector("coefficient_types", required=True)
        if len(coeffs) != 2 or len(types) != 2:
            params.error("coefficients",
                         "exactly two (value, type) pairs are supported")
        self.K, self.G = _elastic_moduli(params, types, coeffs)
        self.from_var = [self.stress if self.compliance else self.strain]
        self.to_var = self.strain if self.compliance else self.stress

    def forward(self, env):
        x = env[self.from_var[0]]
        if x.shape[-1] != 6:
            raise NEML2Error(
                f"LinearIsotropicElasticity '{self.name}' expects a Mandel "
                f"SR2 field (trailing axis 6), got shape {tuple(x.shape)}")
        tr = x[..., 0] + x[..., 1] + x[..., 2]
        vol = (tr / 3.0)[..., None] * _vol_mask(x)
        dev = x - vol
        if self.compliance:  # strain from stress: E = vol(S)/3K + dev(S)/2G
            out = vol / (3.0 * self.K) + dev / (2.0 * self.G)
        else:
            out = 3.0 * self.K * vol + 2.0 * self.G * dev
        return {self.to_var: out}


class SR2Invariant(_NEML2Model):
    """Scalar invariant of a Mandel SR2 field — NEML2's SR2Invariant.
    VONMISES = sqrt(3/2 · dev(S):dev(S)), I1 = trace, I2 = ½(tr²−tr(S²)),
    EFFECTIVE_STRAIN = sqrt(2/3 · S:S)."""

    TYPES = ("VONMISES", "I1", "I2", "EFFECTIVE_STRAIN")

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.tensor = params.get_str("tensor", "state/S")
        self.to_var = params.get_str("invariant", "state/s")
        self.invariant_type = params.get_str(
            "invariant_type", required=True).upper()
        if self.invariant_type not in self.TYPES:
            params.error("invariant_type",
                         f"supported: {self.TYPES} (got {self.invariant_type})")
        self.from_var = [self.tensor]

    def forward(self, env):
        s = env[self.tensor]
        tr = s[..., 0] + s[..., 1] + s[..., 2]
        if self.invariant_type == "I1":
            out = tr
        elif self.invariant_type == "I2":
            s_contract = torch.sum(s * s, -1)  # tr(S²) in Mandel
            out = 0.5 * (tr * tr - s_contract)
        elif self.invariant_type == "EFFECTIVE_STRAIN":
            out = torch.sqrt(2.0 / 3.0 * torch.sum(s * s, -1))
        else:  # VONMISES
            vol = (tr / 3.0)[..., None] * _vol_mask(s)
            dev = s - vol
            out = torch.sqrt(1.5 * torch.sum(dev * dev, -1))
        return {self.to_var: out}


def _state_var(params, key="variable"):
    var = params.get_str(key, required=True)
    return var if "/" in var else f"state/{var}"


class ScalarForwardEulerTimeIntegration(_NEML2Model):
    """s = s_old + ṡ·(t − t_old) — NEML2's ForwardEulerTimeIntegration
    <Scalar>.  The target lives on state/<var>, its rate on
    state/<var>_rate, the previous value on old_state/<var> (the full
    sub-path kept), and times on forces/t and old_forces/t."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.to_var = _state_var(params)
        self.rate = f"{self.to_var}_rate"
        self.old = "old_" + self.to_var
        self.t = params.get_str("time", "forces/t")
        self.t_old = f"old_{self.t}"
        self.from_var = [self.rate, self.old, self.t, self.t_old]

    def forward(self, env):
        return {self.to_var: env[self.old]
                + env[self.rate] * (env[self.t] - env[self.t_old])}


class SR2LinearCombination(ScalarLinearCombination):
    """to_var = Σ coefficient_i · from_var_i on Mandel SR2 fields (NEML2
    SR2LinearCombination — e.g. elastic strain = total − plastic)."""


class SR2ForwardEulerTimeIntegration(ScalarForwardEulerTimeIntegration):
    """s = s_old + ṡ·(t − t_old) on Mandel SR2 variables — NEML2's
    ForwardEulerTimeIntegration<SR2>."""

    def forward(self, env):
        dt = env[self.t] - env[self.t_old]
        return {self.to_var: env[self.old] + env[self.rate] * dt[..., None]}


class VecForwardEulerTimeIntegration(SR2ForwardEulerTimeIntegration):
    """s = s_old + ṡ·dt on trailing-axis-3 Vec variables (NEML2
    ForwardEulerTimeIntegration<Vec>; e.g. the MRP orientation)."""

    NCOMP = 3


class ScalarBackwardEulerTimeIntegration(_NEML2Model):
    """residual/<var> = s − s_old − ṡ·(t − t_old) — NEML2's
    BackwardEulerTimeIntegration<Scalar>: the implicit residual on NEML2's
    residual axis, consumed by ImplicitUpdate's Newton solve."""

    NCOMP = 1
    emits_residual = True

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.state_var = _state_var(params)
        if not self.state_var.startswith("state/"):
            params.error("variable",
                         "implicit integration targets a state/ variable")
        self.rate = f"{self.state_var}_rate"
        self.old = "old_" + self.state_var
        self.t = params.get_str("time", "forces/t")
        self.t_old = f"old_{self.t}"
        self.to_var = self.state_var.replace("state/", "residual/", 1)
        self.from_var = [self.state_var, self.rate, self.old,
                         self.t, self.t_old]

    def forward(self, env):
        dt = env[self.t] - env[self.t_old]
        return {self.to_var: env[self.state_var] - env[self.old]
                - env[self.rate] * dt}


class SR2BackwardEulerTimeIntegration(ScalarBackwardEulerTimeIntegration):
    """residual/<var> = S − S_old − Ṡ·(t − t_old) on Mandel SR2 variables
    (NEML2 BackwardEulerTimeIntegration<SR2>)."""

    NCOMP = 6

    def forward(self, env):
        dt = env[self.t] - env[self.t_old]
        return {self.to_var: env[self.state_var] - env[self.old]
                - env[self.rate] * dt[..., None]}


class VecBackwardEulerTimeIntegration(SR2BackwardEulerTimeIntegration):
    """Implicit residual on trailing-axis-3 Vec variables (NEML2
    BackwardEulerTimeIntegration<Vec>)."""

    NCOMP = 3


class ScalarVariableRate(_NEML2Model):
    """ṡ = (s − s_old)/(t − t_old) (NEML2 ScalarVariableRate)."""

    NCOMP = 1

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.var = _state_var(params)
        self.old = "old_" + self.var
        self.t = params.get_str("time", "forces/t")
        self.t_old = f"old_{self.t}"
        self.to_var = params.get_str("rate", self.var + "_rate")
        self.from_var = [self.var, self.old, self.t, self.t_old]

    def forward(self, env):
        dt = env[self.t] - env[self.t_old]
        return {self.to_var: (env[self.var] - env[self.old]) / dt}


class SR2VariableRate(ScalarVariableRate):
    """Ṡ = (S − S_old)/(t − t_old) on Mandel SR2 variables (NEML2
    SR2VariableRate)."""

    NCOMP = 6

    def forward(self, env):
        dt = env[self.t] - env[self.t_old]
        return {self.to_var: (env[self.var] - env[self.old]) / dt[..., None]}


class ArrheniusParameter(_NEML2Model):
    """p(T) = p0·exp(−Q/(R·T)) (NEML2 ArrheniusParameter; R defaults to the
    gas constant in J/mol/K)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.p0 = params.get_float("reference_value", required=True)
        self.Q = params.get_float("activation_energy", required=True)
        self.R = params.get_float("ideal_gas_constant", 8.31446261815324)
        self.T = params.get_str("temperature", "forces/T")
        self.to_var = params.get_str("parameter", required=True)
        self.from_var = [self.T]

    def forward(self, env):
        return {self.to_var: self.p0 * torch.exp(-self.Q / (self.R * env[self.T]))}


class ThermalEigenstrain(_NEML2Model):
    """Isotropic thermal-expansion eigenstrain Eg = α·(T − T0)·I on the
    Mandel SR2 axis (NEML2 ThermalEigenstrain)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.alpha = params.get_float("CTE", required=True)
        self.T0 = params.get_float("reference_temperature", required=True)
        self.T = params.get_str("temperature", "forces/T")
        self.to_var = params.get_str("eigenstrain", "forces/Eg")
        self.from_var = [self.T]

    def forward(self, env):
        vol = self.alpha * (env[self.T] - self.T0)
        zero = torch.zeros_like(vol)
        return {self.to_var: torch.stack([vol, vol, vol, zero, zero, zero], -1)}


class ComposedModel(_NEML2Model):
    """Dependency-ordered composition of sibling [Models] (NEML2
    ComposedModel): sub-model outputs feed later sub-models' inputs; the
    composite's from_var is every input no sibling produces, and every
    produced variable is exposed as an output."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        names = params.get_str_vector("models", required=True)
        root = params.node.parent  # the [Models] block
        subs = []
        for n in names:
            node = root.children.get(n)
            if node is None:
                raise NEML2Error(
                    f"ComposedModel '{name}': sub-model '{n}' not found "
                    f"(available: {sorted(root.children)})")
            sp = Params(node)
            mtype = sp.get_str("type", required=True)
            if mtype not in _MODEL_TYPES:
                raise NEML2Error(
                    f"ComposedModel '{name}': sub-model '{n}' has "
                    f"unsupported type '{mtype}'")
            subs.append(_MODEL_TYPES[mtype](n, sp, self.device))
        produced = set()
        for m in subs:
            produced.update(_as_list(m.to_var))
        self.models = subs
        self.from_var = sorted(
            {v for m in subs for v in getattr(m, "from_var", [])} - produced)
        self.to_var = sorted(produced)

    def forward(self, env):
        env = dict(env)
        pending = list(self.models)
        out = {}
        while pending:
            progressed = False
            for m in list(pending):
                if all(v in env for v in getattr(m, "from_var", [])):
                    res = m.forward(env)
                    env.update(res)
                    out.update(res)
                    pending.remove(m)
                    progressed = True
            if not progressed:
                missing = {m.name: [v for v in getattr(m, "from_var", [])
                                    if v not in env] for m in pending}
                raise NEML2Error(
                    f"ComposedModel '{self.name}': unresolvable inputs "
                    f"{missing} (cycle or unmapped variable)")
        return out


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


# -- (b) the implicit update --------------------------------------------------------


def _find_backward_euler(model):
    """Walk a (possibly composed) model for its implicit-residual members
    (BackwardEulerTimeIntegration and any other residual emitter, e.g.
    RateIndependentPlasticFlowConstraint)."""
    if getattr(model, "emits_residual", False):
        return [model]
    if isinstance(model, ComposedModel):
        found = []
        for m in model.models:
            found.extend(_find_backward_euler(m))
        return found
    return []


def _finite_abs_max(r, mesh=None):
    """max |r| over the finite entries (0 where none is), over the mesh."""
    return all_reduce(mesh, torch.where(torch.isfinite(r), r.abs(),
                                        torch.zeros_like(r)).max(), "max")


class ImplicitUpdate(_NEML2Model):
    """NEML2's ImplicitUpdate: Newton-solve the implicit model's residual
    R(state) = 0 for the integrated state variables, then expose the solved
    state (and every other output of the inner model at the solution).

    The unknowns at every grid point are packed into one trailing axis
    u ∈ R^n (scalar vars one slot, Mandel SR2 vars six, Vec vars three);
    the per-point Jacobian is built from n forward-mode columns of the
    residual (``torch.func.jvp`` over the n unit tangents, batched into one
    pass by ``torch.func.vmap``: exact, no finite differences), and a
    field-wide Newton runs as a host loop with an unrolled elementwise
    solve (smallsolve.py) of the (..., n, n) systems.

    Convergence: max|R| over the finite points < absolute_tolerance, or <
    relative_tolerance × max|R₀| (non-finite points excluded: one diverged
    point must not freeze or disable every other point's convergence);
    `miter` bounds the iteration count (non-convergence leaves the last
    iterate; a NaN stays in the output to surface the divergence).  The
    condition is tested before each iteration, one fetch a test; on a mesh
    the maxima are the whole grid's, so every rank runs the same
    iterations."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        inner_name = params.get_str("implicit_model", required=True)
        root = params.node.parent
        node = root.children.get(inner_name)
        if node is None:
            raise NEML2Error(
                f"ImplicitUpdate '{name}': implicit_model '{inner_name}' "
                f"not found (available: {sorted(root.children)})")
        sp = Params(node)
        mtype = sp.get_str("type", required=True)
        if mtype not in _MODEL_TYPES:
            raise NEML2Error(
                f"ImplicitUpdate '{name}': implicit_model '{inner_name}' "
                f"has unsupported type '{mtype}'")
        self.inner = _MODEL_TYPES[mtype](inner_name, sp, self.device)
        self.abs_tol = params.get_float("absolute_tolerance", 1e-10)
        self.rel_tol = params.get_float("relative_tolerance", 1e-8)
        self.miter = params.get_int("miter", 50)
        self.counts = NewtonCounts()

        be = _find_backward_euler(self.inner)
        if not be:
            raise NEML2Error(
                f"ImplicitUpdate '{name}': implicit_model '{inner_name}' "
                "contains no BackwardEulerTimeIntegration member — nothing "
                "to solve for")
        # (state var, component count, residual var) per unknown, in a
        # stable order; the packed unknown vector follows this layout
        self.specs = [(m.state_var, m.NCOMP, m.to_var) for m in be]
        unknowns = {s for s, _, _ in self.specs}
        self.from_var = sorted(set(getattr(self.inner, "from_var", [])) - unknowns)
        self.to_var = sorted(
            unknowns | {v for v in _as_list(self.inner.to_var)
                        if not v.startswith("residual/")})

    def _unpack(self, u, base):
        """u (..., n) -> env with the unknown state vars filled in."""
        e = dict(base)
        i = 0
        for var, nc, _ in self.specs:
            e[var] = u[..., i] if nc == 1 else u[..., i:i + nc]
            i += nc
        return e

    def _pack(self, values, shape):
        cols = []
        for (var, nc, rvar), r in zip(self.specs, values):
            cols.append(torch.broadcast_to(r, shape)[..., None] if nc == 1
                        else torch.broadcast_to(r, shape + (nc,)))
        dtype = functools.reduce(torch.promote_types, [c.dtype for c in cols])
        return torch.cat([c.to(dtype) for c in cols], -1)

    def forward(self, env):
        n = sum(nc for _, nc, _ in self.specs)
        # initial guess: the old state (NEML2's default Newton seed)
        guess = {var: env["old_" + var] for var, _, _ in self.specs}
        probe = self.inner.forward({**env, **guess})
        # the residuals carry the full broadcast grid shape (forces enter
        # through the chain) — derive the common per-point layout from them
        shape = tuple(torch.broadcast_shapes(*[
            probe[rvar].shape if nc == 1 else probe[rvar].shape[:-1]
            for _, nc, rvar in self.specs]))
        u0 = self._pack([guess[var] for var, _, _ in self.specs], shape)

        def res_fn(u):
            res = self.inner.forward(self._unpack(u, env))
            return self._pack([res[rvar] for _, _, rvar in self.specs], shape)

        r = res_fn(u0)
        tol = torch.maximum(_const(self.abs_tol, u0.dtype, u0.device),
                            self.rel_tol * _finite_abs_max(r, self.mesh))
        eye = torch.eye(n, dtype=u0.dtype, device=u0.device)

        def tangents(u):
            return torch.broadcast_to(eye.reshape((n,) + (1,) * (u.ndim - 1) + (n,)),
                                      (n,) + tuple(u.shape))

        u, it = u0, 0
        counts = self.counts
        while it < self.miter:
            counts.fetches += 1
            perf.count("fetches")
            if not bool(_finite_abs_max(r, self.mesh) > tol):
                break
            # n exact forward-mode columns, one pass: the n unit tangents
            # batched by vmap (the JAX package's n jax.jvp calls)
            jac = torch.func.vmap(lambda t: torch.func.jvp(res_fn, (u,), (t,))[1],
                                  out_dims=-1)(tangents(u))
            u = u - small_solve(jac, r)
            r = res_fn(u)
            it += 1
        counts.solves += 1
        counts.iterations += it
        counts.log.append(it)

        solved = self._unpack(u, env)
        out = self.inner.forward(solved)
        result = {var: solved[var] for var, _, _ in self.specs}
        for k, v in out.items():
            if not k.startswith("residual/"):
                result[k] = v
        return result


# -- (c) plasticity, hardening, creep, damage ---------------------------------------


class VoceIsotropicHardening(_NEML2Model):
    """k(ep) = R·(1 − exp(−d·ep)) (NEML2 VoceIsotropicHardening)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.R = params.get_float("saturated_hardening", required=True)
        self.d = params.get_float("saturation_rate", required=True)
        self.ep = params.get_str("equivalent_plastic_strain", "state/internal/ep")
        self.to_var = params.get_str("isotropic_hardening", "state/internal/k")
        self.from_var = [self.ep]

    def forward(self, env):
        return {self.to_var: self.R * (1.0 - torch.exp(-self.d * env[self.ep]))}


class LinearIsotropicHardening(_NEML2Model):
    """k(ep) = K·ep (NEML2 LinearIsotropicHardening)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.K = params.get_float("hardening_modulus", required=True)
        self.ep = params.get_str("equivalent_plastic_strain", "state/internal/ep")
        self.to_var = params.get_str("isotropic_hardening", "state/internal/k")
        self.from_var = [self.ep]

    def forward(self, env):
        return {self.to_var: self.K * env[self.ep]}


class PerzynaPlasticFlowRate(_NEML2Model):
    """Perzyna viscoplastic flow rate γ̇ = (⟨f⟩/η)^n with overstress f
    (NEML2 PerzynaPlasticFlowRate).  `reference_stress` and `exponent`
    accept a float literal OR a variable name (the Kocks-Mecking pair);
    a variable exponent takes the safe pow at ⟨f⟩ = 0."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.eta_var, self.eta = _float_or_var(params, "reference_stress")
        self.n_var, self.n = _float_or_var(params, "exponent")
        self.f = params.get_str("flow_function", "state/internal/fp")
        self.to_var = params.get_str("flow_rate", "state/internal/gamma_rate")
        self.from_var = [self.f] + [v for v in (self.eta_var, self.n_var) if v]

    def forward(self, env):
        eta = env[self.eta_var] if self.eta_var else self.eta
        n = env[self.n_var] if self.n_var else self.n
        over = _maximum(env[self.f], 0.0) / eta
        if self.n_var is None:
            return {self.to_var: over ** n}
        return {self.to_var: _safe_pow(over, n)}


class YieldFunction(_NEML2Model):
    """f = stress_measure − σy − k (NEML2 YieldFunction); the isotropic
    hardening is optional."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.sy = params.get_float("yield_stress", required=True)
        self.sm = params.get_str("stress_measure", "state/internal/sm")
        self.k = params.get_str("isotropic_hardening", "")
        self.to_var = params.get_str("yield_function", "state/internal/fp")
        self.from_var = [self.sm] + ([self.k] if self.k else [])

    def forward(self, env):
        f = env[self.sm] - self.sy
        if self.k:
            f = f - env[self.k]
        return {self.to_var: f}


class J2RadialReturn(_NEML2Model):
    """Rate-independent J2 (von Mises) plasticity via the radial-return map
    with isotropic (linear `hardening_modulus` or Voce
    `saturated_hardening` + `saturation_rate`) and optional linear
    kinematic hardening; a field-wide Newton on the plastic multiplier,
    here a host loop (condition first, one fetch a test; ``counts``).

    Inputs: forces/E, old_state/internal/Ep, old_state/internal/ep
    (and old_state/internal/X with kinematic hardening).  Outputs:
    state/S, state/internal/Ep, state/internal/ep (and state/internal/X)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        coeffs = params.get_float_vector("coefficients", required=True)
        types = params.get_str_vector("coefficient_types", required=True)
        self.K, self.G = _elastic_moduli(params, types, coeffs)
        self.sy = params.get_float("yield_stress", required=True)
        self.H = params.get_float("hardening_modulus", 0.0)
        self.R = params.get_float("saturated_hardening", 0.0)
        self.d = params.get_float("saturation_rate", 0.0)
        if self.H and self.R:
            params.error("saturated_hardening",
                         "linear and Voce hardening are exclusive")
        self.abs_tol = params.get_float("absolute_tolerance", 1e-10)
        self.max_its = params.get_int("miter", 50)
        self.strain = params.get_str("strain", "forces/E")
        self.stress = params.get_str("stress", "state/S")
        self.Ep = params.get_str("plastic_strain", "state/internal/Ep")
        self.ep = params.get_str("equivalent_plastic_strain", "state/internal/ep")
        self.Hk = params.get_float("kinematic_hardening_modulus", 0.0)
        self.X = params.get_str("back_stress", "state/internal/X")
        self.old_Ep = "old_" + self.Ep
        self.old_ep = "old_" + self.ep
        self.old_X = "old_" + self.X
        self.from_var = [self.strain, self.old_Ep, self.old_ep]
        self.to_var = [self.stress, self.Ep, self.ep]
        if self.Hk:
            self.from_var.append(self.old_X)
            self.to_var.append(self.X)
        self.counts = NewtonCounts()

    def _k(self, ep):
        if self.H:
            return self.H * ep
        if self.R:
            return self.R * (1.0 - torch.exp(-self.d * ep))
        return torch.zeros_like(ep)

    def _kp(self, ep):
        if self.H:
            return torch.full_like(ep, self.H)
        if self.R:
            return self.R * self.d * torch.exp(-self.d * ep)
        return torch.zeros_like(ep)

    def forward(self, env):
        E = env[self.strain]
        if E.shape[-1] != 6:
            raise NEML2Error(
                f"J2RadialReturn '{self.name}' expects Mandel SR2 strain "
                f"(trailing axis 6), got shape {tuple(E.shape)}")
        Ep_old = torch.broadcast_to(env[self.old_Ep], E.shape)
        ep_old = torch.broadcast_to(env[self.old_ep], E.shape[:-1])
        G, K = self.G, self.K

        Ee = E - Ep_old
        tr = Ee[..., 0] + Ee[..., 1] + Ee[..., 2]
        vol = (tr / 3.0)[..., None] * _vol_mask(E)
        s_dev = 2.0 * G * (Ee - vol)  # trial deviatoric stress
        S_trial = 3.0 * K * vol + s_dev
        # with kinematic hardening the map acts on the shifted stress
        # ξ = dev(S_trial) − X_old (X is deviatoric by construction)
        if self.Hk:
            X_old = torch.broadcast_to(env[self.old_X], E.shape)
            xi = s_dev - X_old
        else:
            xi = s_dev
        svm = torch.sqrt(_maximum(1.5 * torch.sum(xi * xi, -1), 0.0))
        f_trial = svm - self.sy - self._k(ep_old)
        plastic = f_trial > 0.0

        def resid(dep):
            return _where(plastic, svm - (3.0 * G + self.Hk) * dep - self.sy
                          - self._k(ep_old + dep), 0.0)

        dep = torch.zeros_like(svm)
        r = resid(dep)
        it = 0
        while it < self.max_its:
            self.counts.fetches += 1
            perf.count("fetches")
            if not bool(all_reduce(self.mesh, r.abs().max(), "nanmax") > self.abs_tol):
                break
            drdx = -3.0 * G - self.Hk - self._kp(ep_old + dep)
            dep = _maximum(dep - r / drdx, 0.0)
            r = resid(dep)
            it += 1
        self.counts.solves += 1
        self.counts.iterations += it
        self.counts.log.append(it)
        dep = _where(plastic, dep, 0.0)

        # radial-return direction N = 3/2 · ξ/σvm(ξ) (Mandel components)
        N = 1.5 * xi / _where(svm > 0.0, svm, 1.0)[..., None]
        dEp = dep[..., None] * N
        out = {
            self.stress: S_trial - 2.0 * G * dEp,
            self.Ep: Ep_old + dEp,
            self.ep: ep_old + dep,
        }
        if self.Hk:
            out[self.X] = X_old + (2.0 / 3.0) * self.Hk * dEp
        return out


class Normality(_NEML2Model):
    """Associative flow direction of the J2 stress measure, in closed form:
    N = ∂σvm/∂M = (3/2)·dev(M)/σvm (Mandel) — NEML2's Normality."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.function = params.get_str("function", "state/internal/fp")
        self.stress = params.get_str("stress", "state/internal/M")
        self.to_var_stress = params.get_str("flow_direction", "state/internal/NM")
        self.from_var = [self.stress]
        self.to_var = self.to_var_stress

    def forward(self, env):
        vm, dev = _mises(env[self.stress])
        return {self.to_var_stress: 1.5 * dev / _where(vm > 0.0, vm, 1.0)[..., None]}


class AssociativePlasticFlow(_NEML2Model):
    """Ėp = γ̇·N (NEML2 AssociativePlasticFlow)."""

    OUT = ("plastic_strain_rate", "state/internal/Ep_rate")

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.gamma = params.get_str("flow_rate", "state/internal/gamma_rate")
        self.N = params.get_str("flow_direction", "state/internal/NM")
        self.to_var = params.get_str(*self.OUT)
        self.from_var = [self.gamma, self.N]

    def forward(self, env):
        return {self.to_var: env[self.gamma][..., None] * env[self.N]}


class AssociativeKinematicPlasticFlow(AssociativePlasticFlow):
    """K̇p = γ̇·(−∂f/∂X) = γ̇·N (NEML2 AssociativeKinematicPlasticFlow)."""

    OUT = ("kinematic_plastic_strain_rate", "state/internal/Kp_rate")


class AssociativeIsotropicPlasticHardening(_NEML2Model):
    """ėp = γ̇ (NEML2 AssociativeIsotropicPlasticHardening)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.gamma = params.get_str("flow_rate", "state/internal/gamma_rate")
        self.to_var = params.get_str("equivalent_plastic_strain_rate",
                                     "state/internal/ep_rate")
        self.from_var = [self.gamma]

    def forward(self, env):
        return {self.to_var: env[self.gamma]}


class LinearKinematicHardening(_NEML2Model):
    """X = 2/3·C·Kp (NEML2 LinearKinematicHardening)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.C = params.get_float("hardening_modulus", required=True)
        self.Kp = params.get_str("kinematic_plastic_strain", "state/internal/Kp")
        self.to_var = params.get_str("back_stress", "state/internal/X")
        self.from_var = [self.Kp]

    def forward(self, env):
        return {self.to_var: (2.0 / 3.0) * self.C * env[self.Kp]}


class ChabochePlasticHardening(_NEML2Model):
    """One Chaboche back-stress term (NEML2 ChabochePlasticHardening):
    Ẋ = 2/3·C·γ̇·N − g·X·γ̇ − A·‖X‖^(a−1)·X."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.C = params.get_float("C", required=True)
        self.g = params.get_float("g", required=True)
        self.A = params.get_float("A", 0.0)
        self.a = params.get_float("a", 1.0)
        self.X = params.get_str("back_stress", "state/internal/X")
        self.gamma = params.get_str("flow_rate", "state/internal/gamma_rate")
        self.N = params.get_str("flow_direction", "state/internal/NM")
        self.to_var = f"{self.X}_rate"
        self.from_var = [self.X, self.gamma, self.N]

    def forward(self, env):
        X, g_rate, N = env[self.X], env[self.gamma], env[self.N]
        rate = ((2.0 / 3.0) * self.C * g_rate[..., None] * N
                - self.g * X * g_rate[..., None])
        if self.A:
            norm, _ = _mises(X)
            rate = rate - self.A * (norm ** (self.a - 1.0))[..., None] * X
        return {self.to_var: rate}


class RateIndependentPlasticFlowConstraint(_NEML2Model):
    """The Fischer–Burmeister complementarity residual of rate-independent
    plasticity (NEML2 RateIndependentPlasticFlowConstraint):
    residual/internal/gamma_rate = γ̇ − f − √(γ̇² + f²), with a safe sqrt
    (double where) at the corner γ̇ = f = 0."""

    NCOMP = 1
    emits_residual = True

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.f = params.get_str("yield_function", "state/internal/fp")
        self.state_var = params.get_str("flow_rate", "state/internal/gamma_rate")
        self.to_var = self.state_var.replace("state/", "residual/", 1)
        self.from_var = [self.state_var, self.f, "old_" + self.state_var]

    def forward(self, env):
        g, f = env[self.state_var], env[self.f]
        s2 = g * g + f * f
        safe = _where(s2 > 0.0, s2, 1.0)
        norm = _where(s2 > 0.0, torch.sqrt(safe), 0.0)
        return {self.to_var: g - f - norm}


class PowerLawIsotropicHardening(_NEML2Model):
    """k(ep) = K·ep^n (NEML2 PowerLawIsotropicHardening), with the safe pow
    at a virgin ep = 0."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.K = params.get_float("hardening_modulus", required=True)
        self.n = params.get_float("exponent", required=True)
        self.ep = params.get_str("equivalent_plastic_strain", "state/internal/ep")
        self.to_var = params.get_str("isotropic_hardening", "state/internal/k")
        self.from_var = [self.ep]

    def forward(self, env):
        return {self.to_var: self.K * _safe_pow(_maximum(env[self.ep], 0.0), self.n)}


class SlopeSaturationVoceIsotropicHardening(_NEML2Model):
    """Rate-form Voce hardening k̇ = θ·(1 − k/R)·γ̇ (NEML2
    SlopeSaturationVoceIsotropicHardening)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.R = params.get_float("saturated_hardening", required=True)
        self.theta = params.get_float("initial_hardening_rate", required=True)
        self.k = params.get_str("isotropic_hardening", "state/internal/k")
        self.gamma_rate = params.get_str("flow_rate", "state/internal/gamma_rate")
        self.to_var = self.k + "_rate"
        self.from_var = [self.k, self.gamma_rate]

    def forward(self, env):
        return {self.to_var: self.theta * (1.0 - env[self.k] / self.R)
                * env[self.gamma_rate]}


class PowerLawCreep(_NEML2Model):
    """Norton creep γ̇ = A·(⟨sm⟩/σ0)^n, the safe pow at sm = 0."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.A = params.get_float("coefficient", required=True)
        self.n = params.get_float("exponent", required=True)
        self.s0 = params.get_float("reference_stress", 1.0)
        self.sm = params.get_str("stress_measure", "state/internal/sm")
        self.to_var = params.get_str("flow_rate", "state/internal/gamma_rate")
        self.from_var = [self.sm]

    def forward(self, env):
        s = _maximum(env[self.sm], 0.0) / self.s0
        return {self.to_var: self.A * _safe_pow(s, self.n)}


class BlackburnCreep(_NEML2Model):
    """Blackburn-style sinh creep γ̇ = A·sinh(β·⟨sm⟩)^n."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.A = params.get_float("coefficient", required=True)
        self.beta = params.get_float("beta", required=True)
        self.n = params.get_float("exponent", 1.0)
        self.sm = params.get_str("stress_measure", "state/internal/sm")
        self.to_var = params.get_str("flow_rate", "state/internal/gamma_rate")
        self.from_var = [self.sm]

    def forward(self, env):
        sh = torch.sinh(self.beta * _maximum(env[self.sm], 0.0))
        return {self.to_var: self.A * _safe_pow(sh, self.n)}


class IsotropicDamageEffectiveStress(_NEML2Model):
    """Lemaitre effective stress s̃ = sm/(1−d), d clipped to [0, d_max]."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.sm = params.get_str("stress_measure", "state/internal/sm")
        self.d = params.get_str("damage", "state/internal/d")
        self.d_max = params.get_float("maximum_damage", 0.99)
        self.to_var = params.get_str("effective_stress", "state/internal/sm_eff")
        self.from_var = [self.sm, self.d]

    def forward(self, env):
        d = _clip(env[self.d], 0.0, self.d_max)
        return {self.to_var: env[self.sm] / (1.0 - d)}


class PlasticStrainDamageRate(_NEML2Model):
    """Ductile damage ḋ = γ̇/εf."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.ef = params.get_float("failure_strain", required=True)
        self.gamma = params.get_str("flow_rate", "state/internal/gamma_rate")
        self.to_var = params.get_str("damage_rate", "state/internal/d_rate")
        self.from_var = [self.gamma]

    def forward(self, env):
        return {self.to_var: env[self.gamma] / self.ef}


class GTNYieldFunction(_NEML2Model):
    """Gurson-Tvergaard-Needleman yield function (NEML2 GTNYieldFunction):
    f = (se/σf)² + 2·q1·φ·cosh(q2·skk/(2·σf)) − (1 + q3·φ²)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.q1 = params.get_float("q1", 1.0)
        self.q2 = params.get_float("q2", 1.0)
        self.q3 = params.get_float("q3", 1.0)
        self.sy = params.get_float("yield_stress", required=True)
        self.se = params.get_str("stress_measure", "state/internal/se")
        self.skk = params.get_str("stress_trace", "state/internal/skk")
        self.phi = params.get_str("void_fraction", "state/internal/phi")
        self.k = params.get_str("isotropic_hardening", "")
        self.to_var = params.get_str("yield_function", "state/internal/fp")
        self.from_var = [self.se, self.skk, self.phi] + ([self.k] if self.k else [])

    def forward(self, env):
        sf = self.sy + (env[self.k] if self.k else 0.0)
        se, skk, phi = env[self.se], env[self.skk], env[self.phi]
        return {self.to_var:
                (se / sf) ** 2
                + 2.0 * self.q1 * phi * torch.cosh(self.q2 * skk / (2.0 * sf))
                - (1.0 + self.q3 * phi * phi)}


class GursonCavitation(_NEML2Model):
    """Void growth φ̇ = (1 − φ)·tr(Ėp) (NEML2 GursonCavitation)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.phi = params.get_str("void_fraction", "state/internal/phi")
        self.Ep_rate = params.get_str("plastic_strain_rate", "state/internal/Ep_rate")
        self.to_var = self.phi + "_rate"
        self.from_var = [self.phi, self.Ep_rate]

    def forward(self, env):
        Ep_rate = env[self.Ep_rate]
        tr = Ep_rate[..., 0] + Ep_rate[..., 1] + Ep_rate[..., 2]
        return {self.to_var: (1.0 - env[self.phi]) * tr}


# -- (d) crystal plasticity, sintering, fracture, mixed control, Kocks-Mecking ------


def _euler_rotation(phi1, Phi, phi2):
    """Bunge Z-X-Z Euler angles (radians) -> 3x3 rotation matrix (numpy,
    build-time constant)."""
    c1, s1 = np.cos(phi1), np.sin(phi1)
    c, s = np.cos(Phi), np.sin(Phi)
    c2, s2 = np.cos(phi2), np.sin(phi2)
    return np.array([
        [c1 * c2 - s1 * s2 * c, -c1 * s2 - s1 * c2 * c, s1 * s],
        [s1 * c2 + c1 * s2 * c, -s1 * s2 + c1 * c2 * c, -c1 * s],
        [s2 * s, c2 * s, c],
    ])


def _slip_geometry(params):
    """Slip directions and normals (two (ns, 3) numpy arrays, build-time
    constants) for `crystal_class` (FCC: 12 {111}<110> systems, default;
    BCC: 12 {110}<111>) rotated by `euler_angles` (Bunge Z-X-Z, radians)."""
    cls = params.get_str("crystal_class", "FCC").upper()
    if cls == "FCC":
        planes = ([1, 1, 1], [-1, 1, 1], [1, -1, 1], [1, 1, -1])
        directions = ([0, 1, -1], [1, 0, -1], [1, -1, 0],
                      [0, 1, 1], [1, 0, 1], [1, 1, 0])
    elif cls == "BCC":
        planes = ([1, 1, 0], [1, -1, 0], [1, 0, 1],
                  [1, 0, -1], [0, 1, 1], [0, 1, -1])
        directions = ([1, 1, 1], [-1, 1, 1], [1, -1, 1], [1, 1, -1])
    else:
        raise NEML2Error(f"unknown crystal_class '{cls}' (FCC or BCC)")
    normals, dirs = [], []
    for n in planes:
        n = np.asarray(n, float)
        for d in directions:
            d = np.asarray(d, float)
            if abs(np.dot(n, d)) < 1e-12:
                normals.append(n / np.linalg.norm(n))
                dirs.append(d / np.linalg.norm(d))
    normals, dirs = np.asarray(normals), np.asarray(dirs)

    angles = params.get_float_vector("euler_angles", [0.0, 0.0, 0.0])
    if len(angles) != 3:
        params.error("euler_angles", "three Bunge Z-X-Z angles (radians)")
    R = _euler_rotation(*angles)
    return dirs @ R.T, normals @ R.T


def _schmid_mandel(dirs, normals):
    """Mandel 6-vectors of the symmetric Schmid tensors
    P_a = sym(d_a ⊗ n_a) (numpy, (ns, 6))."""
    P = 0.5 * (dirs[:, :, None] * normals[:, None, :]
               + normals[:, :, None] * dirs[:, None, :])
    rt2 = np.sqrt(2.0)
    return np.stack([P[:, 0, 0], P[:, 1, 1], P[:, 2, 2],
                     rt2 * P[:, 1, 2], rt2 * P[:, 0, 2], rt2 * P[:, 0, 1]], axis=-1)


def _mrp_rotation(r):
    """Modified-Rodrigues-parameter rotation matrix (NEML2's Rot
    convention, r = tan(θ/4)·axis): R = I + (4·(1−|r|²)·S + 8·S²)/(1+|r|²)²,
    S = skew(r); r (..., 3) -> (..., 3, 3)."""
    rr = torch.sum(r * r, -1)[..., None, None]
    z = torch.zeros_like(r[..., 0])
    S = torch.stack([
        torch.stack([z, -r[..., 2], r[..., 1]], -1),
        torch.stack([r[..., 2], z, -r[..., 0]], -1),
        torch.stack([-r[..., 1], r[..., 0], z], -1),
    ], -2)
    S2 = torch.einsum("...ij,...jk->...ik", S, S)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye + (4.0 * (1.0 - rr) * S + 8.0 * S2) / (1.0 + rr) ** 2


def _rotated_slips(dirs, normals, R):
    d = torch.einsum("...ij,sj->...si", R, _const(_tuples(dirs), R.dtype, R.device))
    n = torch.einsum("...ij,sj->...si", R, _const(_tuples(normals), R.dtype, R.device))
    return d, n


def _rotated_schmid(dirs, normals, env, orientation):
    """Per-point symmetric Schmid tensors as Mandel 6-vectors for an MRP
    orientation state: d' = R d, n' = R n.  (..., ns, 6)."""
    rt2 = math.sqrt(2.0)
    d, n = _rotated_slips(dirs, normals, _mrp_rotation(env[orientation]))
    P = 0.5 * (d[..., :, None] * n[..., None, :] + n[..., :, None] * d[..., None, :])
    return torch.stack(
        [P[..., 0, 0], P[..., 1, 1], P[..., 2, 2],
         rt2 * P[..., 1, 2], rt2 * P[..., 0, 2], rt2 * P[..., 0, 1]], -1)


class ResolvedShear(_NEML2Model):
    """Resolved shear stresses τ_a = M : P_a on every slip system (NEML2
    ResolvedShear); an optional `orientation` state (MRP, trailing axis 3)
    rotates the slip systems per point."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.dirs, self.normals = _slip_geometry(params)
        self.orientation = params.get_str("orientation", "")
        self.stress = params.get_str("stress", "state/internal/M")
        self.to_var = params.get_str("resolved_shears", "state/internal/resolved_shears")
        self.from_var = [self.stress] + ([self.orientation] if self.orientation else [])
        self.P = _tuples(_schmid_mandel(self.dirs, self.normals))  # (ns, 6)

    def forward(self, env):
        M = env[self.stress]
        if self.orientation:
            P = _rotated_schmid(self.dirs, self.normals, env, self.orientation).to(M.dtype)
            return {self.to_var: torch.einsum("...i,...si->...s", M, P)}
        return {self.to_var: torch.einsum(
            "...i,si->...s", M, _const(self.P, M.dtype, M.device))}


class SingleSlipStrengthMap(_NEML2Model):
    """g_a = τ0 + τ̄ on every slip system (NEML2 SingleSlipStrengthMap)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.tau0 = params.get_float("constant_strength", required=True)
        self.nslip = params.get_int("n_slip", 12)
        self.hard = params.get_str("slip_hardening", "state/internal/slip_hardening")
        self.to_var = params.get_str("slip_strengths", "state/internal/slip_strengths")
        self.from_var = [self.hard]

    def forward(self, env):
        g = self.tau0 + env[self.hard]
        return {self.to_var: torch.broadcast_to(g[..., None], tuple(g.shape) + (self.nslip,))}


class PowerLawSlipRule(_NEML2Model):
    """γ̇_a = γ̇0 · |τ_a/g_a|^(n−1) · (τ_a/g_a) (NEML2 PowerLawSlipRule),
    as sign(x)·|x|^n with the safe pow."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.g0 = params.get_float("gamma0", required=True)
        self.n = params.get_float("n", required=True)
        self.tau = params.get_str("resolved_shears", "state/internal/resolved_shears")
        self.g = params.get_str("slip_strengths", "state/internal/slip_strengths")
        self.to_var = params.get_str("slip_rates", "state/internal/slip_rates")
        self.from_var = [self.tau, self.g]

    def forward(self, env):
        x = env[self.tau] / env[self.g]
        return {self.to_var: self.g0 * torch.sign(x) * _safe_pow(x.abs(), self.n)}


class SumSlipRates(_NEML2Model):
    """Σ_a |γ̇_a| (NEML2 SumSlipRates)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.rates = params.get_str("slip_rates", "state/internal/slip_rates")
        self.to_var = params.get_str("sum_slip_rates", "state/internal/sum_slip_rates")
        self.from_var = [self.rates]

    def forward(self, env):
        return {self.to_var: torch.sum(env[self.rates].abs(), -1)}


class VoceSingleSlipHardening(_NEML2Model):
    """τ̄̇ = θ0·(1 − τ̄/τ_f)·Σ|γ̇_a| (NEML2 VoceSingleSlipHardeningRule)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.theta0 = params.get_float("initial_slope", required=True)
        self.tau_f = params.get_float("saturated_hardening", required=True)
        self.hard = params.get_str("slip_hardening", "state/internal/slip_hardening")
        self.ssr = params.get_str("sum_slip_rates", "state/internal/sum_slip_rates")
        self.to_var = self.hard + "_rate"
        self.from_var = [self.hard, self.ssr]

    def forward(self, env):
        return {self.to_var: self.theta0 * (1.0 - env[self.hard] / self.tau_f)
                * env[self.ssr]}


class PlasticDeformationRate(_NEML2Model):
    """Ėp = Σ_a γ̇_a·P_a (NEML2 PlasticDeformationRate, small deformation)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.dirs, self.normals = _slip_geometry(params)
        self.orientation = params.get_str("orientation", "")
        self.rates = params.get_str("slip_rates", "state/internal/slip_rates")
        self.to_var = params.get_str("plastic_strain_rate", "state/internal/Ep_rate")
        self.from_var = [self.rates] + ([self.orientation] if self.orientation else [])
        self.P = _tuples(_schmid_mandel(self.dirs, self.normals))

    def forward(self, env):
        g = env[self.rates]
        if self.orientation:
            P = _rotated_schmid(self.dirs, self.normals, env, self.orientation).to(g.dtype)
            return {self.to_var: torch.einsum("...s,...si->...i", g, P)}
        return {self.to_var: torch.einsum(
            "...s,si->...i", g, _const(self.P, g.dtype, g.device))}


class PlasticVorticity(_NEML2Model):
    """Plastic vorticity of crystal slip (NEML2 PlasticVorticity), the
    axial vector of W_p = Σ_a γ̇_a·skew(d_a ⊗ n_a): w_p = −½ Σ_a γ̇_a·(d_a × n_a)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.dirs, self.normals = _slip_geometry(params)
        self.orientation = params.get_str("orientation", "")
        self.rates = params.get_str("slip_rates", "state/internal/slip_rates")
        self.to_var = params.get_str("plastic_vorticity", "state/internal/plastic_vorticity")
        self.from_var = [self.rates] + ([self.orientation] if self.orientation else [])
        self.axial = _tuples(-0.5 * np.cross(self.dirs, self.normals))  # (ns, 3)

    def forward(self, env):
        g = env[self.rates]
        if self.orientation:
            d, n = _rotated_slips(self.dirs, self.normals,
                                  _mrp_rotation(env[self.orientation]))
            axial = -0.5 * torch.linalg.cross(d, n, dim=-1)  # (..., ns, 3)
            return {self.to_var: torch.einsum("...s,...si->...i", g, axial.to(g.dtype))}
        return {self.to_var: torch.einsum(
            "...s,si->...i", g, _const(self.axial, g.dtype, g.device))}


class OrientationRate(_NEML2Model):
    """MRP orientation rate under the lattice spin ω = W − w_p (NEML2
    OrientationRate): ṙ = ¼·[(1−|r|²)·ω + 2·r×ω + 2·(r·ω)·r]."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.orientation = params.get_str("orientation", "state/orientation")
        self.wp = params.get_str("plastic_vorticity", "state/internal/plastic_vorticity")
        self.spin = params.get_str("spin", "")  # optional imposed W axial
        self.to_var = self.orientation + "_rate"
        self.from_var = [self.orientation, self.wp] + ([self.spin] if self.spin else [])

    def forward(self, env):
        r = env[self.orientation]
        omega = -env[self.wp]
        if self.spin:
            omega = omega + env[self.spin]
        r, omega = torch.broadcast_tensors(r, omega)
        rr = torch.sum(r * r, -1)[..., None]
        rw = torch.sum(r * omega, -1)[..., None]
        return {self.to_var: 0.25 * (
            (1.0 - rr) * omega + 2.0 * torch.linalg.cross(r, omega, dim=-1) + 2.0 * rw * r)}


class OlevskySinteringStress(_NEML2Model):
    """Olevsky sintering stress σ_s = 3·(γ/r0)·(1 − φ)²."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.gamma = params.get_float("surface_tension", required=True)
        self.r0 = params.get_float("particle_radius", required=True)
        self.phi = params.get_str("void_fraction", "state/internal/phi")
        self.to_var = params.get_str("sintering_stress", "state/internal/ss")
        self.from_var = [self.phi]

    def forward(self, env):
        one_m = 1.0 - env[self.phi]
        return {self.to_var: 3.0 * self.gamma / self.r0 * one_m * one_m}


class PowerDegradationFunction(_NEML2Model):
    """Phase-field fracture degradation g(d) = (1−d)^p·(1−η) + η."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.p = params.get_float("exponent", 2.0)
        self.eta = params.get_float("residual", 1e-3)
        self.d = params.get_str("damage", "state/d")
        self.to_var = params.get_str("degradation", "state/internal/g")
        self.from_var = [self.d]

    def forward(self, env):
        one_m = _clip(1.0 - env[self.d], 0.0, 1.0)
        return {self.to_var: one_m ** self.p * (1.0 - self.eta) + self.eta}


#: matrices a torch.linalg.eigvalsh call: on the card torch takes
#: cuSOLVER's batched syev for a batch of small matrices, which refuses a
#: batch of 32767 or more 3×3 matrices in either precision (24576 ran;
#: CUSOLVER_STATUS_INVALID_VALUE from its workspace query)
EIGVALSH_CHUNK = 2 ** 14


def eigvalsh_3x3(M):
    """torch.linalg.eigvalsh over (..., 3, 3), EIGVALSH_CHUNK matrices a
    call."""
    flat = M.reshape(-1, 3, 3)
    if flat.shape[0] <= EIGVALSH_CHUNK:
        return torch.linalg.eigvalsh(M)
    return torch.cat([torch.linalg.eigvalsh(part) for part in flat.split(EIGVALSH_CHUNK)]
                     ).reshape(M.shape[:-1])


class StrainEnergyDensity(_NEML2Model):
    """Elastic strain-energy density from a Mandel SR2 strain.
    `decomposition = NONE`: ψ = λ/2·tr(E)² + µ·E:E; `SPECTRAL`: the Miehe
    split over the principal strains (``eigvalsh_3x3`` per point),
    emitting `psi` (ψ⁺) and `psi_inactive` (ψ⁻)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.lam = params.get_float("lambda", required=True)
        self.mu = params.get_float("mu", required=True)
        self.decomposition = params.get_str("decomposition", "NONE").upper()
        if self.decomposition not in ("NONE", "SPECTRAL"):
            params.error("decomposition", "NONE or SPECTRAL")
        self.strain = params.get_str("strain", "forces/E")
        self.psi = params.get_str("strain_energy_density", "state/internal/psi")
        self.psi_neg = params.get_str("inactive_strain_energy_density",
                                      "state/internal/psi_inactive")
        self.to_var = [self.psi] + ([self.psi_neg] if self.decomposition == "SPECTRAL" else [])
        self.from_var = [self.strain]

    @staticmethod
    def _unmandel(E):
        """Mandel 6-vector -> symmetric 3x3 (off-diagonals carry 1/sqrt(2))."""
        s = 1.0 / np.sqrt(2.0)
        exx, eyy, ezz = E[..., 0], E[..., 1], E[..., 2]
        eyz, exz, exy = s * E[..., 3], s * E[..., 4], s * E[..., 5]
        return torch.stack([
            torch.stack([exx, exy, exz], -1),
            torch.stack([exy, eyy, eyz], -1),
            torch.stack([exz, eyz, ezz], -1),
        ], -2)

    def forward(self, env):
        E = env[self.strain]
        tr = E[..., 0] + E[..., 1] + E[..., 2]
        if self.decomposition == "NONE":
            return {self.psi: 0.5 * self.lam * tr * tr + self.mu * torch.sum(E * E, -1)}
        eig = eigvalsh_3x3(self._unmandel(E))  # (..., 3) ascending
        tr_p, tr_n = _maximum(tr, 0.0), _minimum(tr, 0.0)
        eig_p, eig_n = _maximum(eig, 0.0), _minimum(eig, 0.0)
        psi_p = 0.5 * self.lam * tr_p * tr_p + self.mu * torch.sum(eig_p * eig_p, -1)
        psi_n = 0.5 * self.lam * tr_n * tr_n + self.mu * torch.sum(eig_n * eig_n, -1)
        return {self.psi: psi_p, self.psi_neg: psi_n}


class MixedControlSetup(_NEML2Model):
    """Mixed stress/strain control, assembly half (NEML2
    MixedControlSetup): E_i = control_i ? mixed_i : fixed_i and
    T_i = control_i ? fixed_i : mixed_i over the six Mandel components."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        ctl = params.get_float_vector("control", required=True)
        if len(ctl) != 6:
            params.error("control", "six Mandel-component flags (0/1)")
        self.control = tuple(map(float, ctl))
        self.fixed = params.get_str("fixed_values", "forces/fixed_values")
        self.state_var = params.get_str("mixed_state", "state/mixed_state")
        self.strain = params.get_str("strain", "forces/E")
        self.target = params.get_str("stress_target", "state/S_target")
        self.to_var = [self.strain, self.target]
        self.from_var = [self.fixed, self.state_var]

    def forward(self, env):
        fixed, mixed = env[self.fixed], env[self.state_var]
        c = _const(self.control, fixed.dtype, fixed.device)
        return {self.strain: c * mixed + (1.0 - c) * fixed,
                self.target: c * fixed + (1.0 - c) * mixed}


class SR2EqualityConstraint(_NEML2Model):
    """residual/<variable> = a − b on Mandel SR2 fields: an equality
    constraint for ImplicitUpdate; `variable` names the unknown it
    determines (a state/ variable)."""

    NCOMP = 6
    emits_residual = True

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.state_var = _state_var(params)
        if not self.state_var.startswith("state/"):
            params.error("variable", "implicit constraints target a state/ variable")
        self.a = params.get_str("a", required=True)
        self.b = params.get_str("b", required=True)
        self.to_var = self.state_var.replace("state/", "residual/", 1)
        self.from_var = [self.a, self.b, self.state_var, "old_" + self.state_var]

    def forward(self, env):
        return {self.to_var: env[self.a] - env[self.b]}


def _mu_input(params):
    """The Kocks-Mecking shear modulus µ: a float literal or a variable."""
    return _float_or_var(params, "shear_modulus")


def _km_slope(params, what):
    """The Kocks-Mecking slope A: nonzero (the JAX package's check) and
    negative, so that the rate sensitivity n = −µb³/(kTA) is positive."""
    A = params.get_float("A", required=True)
    if A == 0.0:
        params.error("A", f"the Kocks-Mecking slope must be nonzero ({what})")
    if A > 0.0:
        params.error("A", f"the Kocks-Mecking slope must be negative (got {A}; "
                          "A > 0 gives a negative rate sensitivity)")
    return A


class KocksMeckingActivationEnergy(_NEML2Model):
    """g = k·T/(µ·b³) · ln(ε̇0/ε̇), |ε̇| floored at `rate_floor` (NEML2
    KocksMeckingActivationEnergy)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.mu_var, self.mu = _mu_input(params)
        self.k = params.get_float("boltzmann_constant", 1.380649e-23)
        self.b = params.get_float("burgers_vector", required=True)
        self.eps0 = params.get_float("reference_strain_rate", required=True)
        self.rate_floor = params.get_float("rate_floor", 1e-20)
        self.T = params.get_str("temperature", "forces/T")
        self.rate = params.get_str("strain_rate", "state/internal/ep_rate")
        self.to_var = params.get_str("activation_energy", "state/internal/g")
        self.from_var = [self.T, self.rate] + ([self.mu_var] if self.mu_var else [])

    def forward(self, env):
        mu = env[self.mu_var] if self.mu_var else self.mu
        rate = _maximum(env[self.rate].abs(), self.rate_floor)
        scale = self.k * env[self.T] / (mu * self.b ** 3)
        return {self.to_var: scale * torch.log(self.eps0 / rate)}


class KocksMeckingRateSensitivity(_NEML2Model):
    """n = −µ·b³/(k·T·A) (NEML2 KocksMeckingRateSensitivity; A < 0)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.mu_var, self.mu = _mu_input(params)
        self.A = _km_slope(params, "it divides the rate sensitivity")
        self.k = params.get_float("boltzmann_constant", 1.380649e-23)
        self.b = params.get_float("burgers_vector", required=True)
        self.T = params.get_str("temperature", "forces/T")
        self.to_var = params.get_str("rate_sensitivity", "state/internal/n")
        self.from_var = [self.T] + ([self.mu_var] if self.mu_var else [])

    def forward(self, env):
        mu = env[self.mu_var] if self.mu_var else self.mu
        return {self.to_var: -mu * self.b ** 3 / (self.k * env[self.T] * self.A)}


class KocksMeckingFlowViscosity(_NEML2Model):
    """η = e^B · µ · ε̇0^(−1/n), n = −µ·b³/(k·T·A) (NEML2
    KocksMeckingFlowViscosity)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.mu_var, self.mu = _mu_input(params)
        self.A = _km_slope(params, "it divides the rate sensitivity")
        self.B = params.get_float("B", required=True)
        self.k = params.get_float("boltzmann_constant", 1.380649e-23)
        self.b = params.get_float("burgers_vector", required=True)
        self.eps0 = params.get_float("reference_strain_rate", required=True)
        self.T = params.get_str("temperature", "forces/T")
        self.to_var = params.get_str("flow_viscosity", "state/internal/eta")
        self.from_var = [self.T] + ([self.mu_var] if self.mu_var else [])

    def forward(self, env):
        mu = env[self.mu_var] if self.mu_var else self.mu
        n = -mu * self.b ** 3 / (self.k * env[self.T] * self.A)
        return {self.to_var: math.exp(self.B) * mu * self.eps0 ** (-1.0 / n)}


class KocksMeckingYieldStress(_NEML2Model):
    """σy = e^C·µ (NEML2 KocksMeckingYieldStress)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.mu_var, self.mu = _mu_input(params)
        self.C = params.get_float("C", required=True)
        self.to_var = params.get_str("yield_stress", "state/internal/sy")
        self.from_var = [self.mu_var] if self.mu_var else []

    def forward(self, env):
        mu = env[self.mu_var] if self.mu_var else self.const(self.mu)
        return {self.to_var: math.exp(self.C) * mu}


class KocksMeckingFlowSwitch(_NEML2Model):
    """γ̇ = γ̇_RI·(1 − s) + γ̇_RD·s, s = (1 + tanh(sharpness·(g − g0)))/2,
    g0 = (C − B)/A (NEML2 KocksMeckingFlowSwitch)."""

    def __init__(self, name, params, device=None):
        super().__init__(name, params, device)
        self.A = _km_slope(params, "it locates the regime boundary g0")
        self.B = params.get_float("B", required=True)
        self.C = params.get_float("C", required=True)
        self.sharpness = params.get_float("sharpness", 1.0)
        self.g = params.get_str("activation_energy", "state/internal/g")
        self.ri = params.get_str("rate_independent_flow_rate", "state/internal/gamma_rate_ri")
        self.rd = params.get_str("rate_dependent_flow_rate", "state/internal/gamma_rate_rd")
        self.to_var = params.get_str("flow_rate", "state/internal/gamma_rate")
        self.from_var = [self.g, self.ri, self.rd]

    def forward(self, env):
        g0 = (self.C - self.B) / self.A
        s = 0.5 * (1.0 + torch.tanh(self.sharpness * (env[self.g] - g0)))
        return {self.to_var: (1.0 - s) * env[self.ri] + s * env[self.rd]}


_MODEL_TYPES = {
    "ScalarMultiplication": ScalarMultiplication,
    "ScalarLinearCombination": ScalarLinearCombination,
    "ScalarParameterToState": ScalarParameterToState,
    "LinearIsotropicElasticity": LinearIsotropicElasticity,
    "SR2Invariant": SR2Invariant,
    "SR2LinearCombination": SR2LinearCombination,
    "ScalarForwardEulerTimeIntegration": ScalarForwardEulerTimeIntegration,
    "VoceIsotropicHardening": VoceIsotropicHardening,
    "LinearIsotropicHardening": LinearIsotropicHardening,
    "PerzynaPlasticFlowRate": PerzynaPlasticFlowRate,
    "YieldFunction": YieldFunction,
    "ComposedModel": ComposedModel,
    "J2RadialReturn": J2RadialReturn,
    "SR2ForwardEulerTimeIntegration": SR2ForwardEulerTimeIntegration,
    "Normality": Normality,
    "AssociativePlasticFlow": AssociativePlasticFlow,
    "AssociativeIsotropicPlasticHardening": AssociativeIsotropicPlasticHardening,
    "AssociativeKinematicPlasticFlow": AssociativeKinematicPlasticFlow,
    "LinearKinematicHardening": LinearKinematicHardening,
    "ChabochePlasticHardening": ChabochePlasticHardening,
    "ArrheniusParameter": ArrheniusParameter,
    "ScalarBackwardEulerTimeIntegration": ScalarBackwardEulerTimeIntegration,
    "SR2BackwardEulerTimeIntegration": SR2BackwardEulerTimeIntegration,
    "ImplicitUpdate": ImplicitUpdate,
    "RateIndependentPlasticFlowConstraint": RateIndependentPlasticFlowConstraint,
    "ThermalEigenstrain": ThermalEigenstrain,
    "PowerLawIsotropicHardening": PowerLawIsotropicHardening,
    "SlopeSaturationVoceIsotropicHardening": SlopeSaturationVoceIsotropicHardening,
    "PowerLawCreep": PowerLawCreep,
    "BlackburnCreep": BlackburnCreep,
    "IsotropicDamageEffectiveStress": IsotropicDamageEffectiveStress,
    "PlasticStrainDamageRate": PlasticStrainDamageRate,
    "GTNYieldFunction": GTNYieldFunction,
    "GursonCavitation": GursonCavitation,
    "ScalarVariableRate": ScalarVariableRate,
    "SR2VariableRate": SR2VariableRate,
    "ResolvedShear": ResolvedShear,
    "SingleSlipStrengthMap": SingleSlipStrengthMap,
    "PowerLawSlipRule": PowerLawSlipRule,
    "SumSlipRates": SumSlipRates,
    "VoceSingleSlipHardening": VoceSingleSlipHardening,
    "PlasticDeformationRate": PlasticDeformationRate,
    "MixedControlSetup": MixedControlSetup,
    "SR2EqualityConstraint": SR2EqualityConstraint,
    "OlevskySinteringStress": OlevskySinteringStress,
    "PlasticVorticity": PlasticVorticity,
    "OrientationRate": OrientationRate,
    "PowerDegradationFunction": PowerDegradationFunction,
    "StrainEnergyDensity": StrainEnergyDensity,
    "VecForwardEulerTimeIntegration": VecForwardEulerTimeIntegration,
    "VecBackwardEulerTimeIntegration": VecBackwardEulerTimeIntegration,
    "KocksMeckingActivationEnergy": KocksMeckingActivationEnergy,
    "KocksMeckingRateSensitivity": KocksMeckingRateSensitivity,
    "KocksMeckingFlowViscosity": KocksMeckingFlowViscosity,
    "KocksMeckingYieldStress": KocksMeckingYieldStress,
    "KocksMeckingFlowSwitch": KocksMeckingFlowSwitch,
}


def walk_models(model):
    """The model and every sub-model it holds (ComposedModel members,
    ImplicitUpdate's inner model), depth first."""
    yield model
    for sub in getattr(model, "models", []):
        yield from walk_models(sub)
    inner = getattr(model, "inner", None)
    if inner is not None:
        yield from walk_models(inner)


def load_neml2_model(path: str, model_name: str, cli_args: List[str] = (), device=None):
    """Parse a NEML2 HIT input file and instantiate the named model, its
    constants on ``device`` (default "cuda").  NEML2's [Settings] block is
    accepted (precision handled by the Domain)."""
    from .. import hit

    dev = _device.resolve(device)
    root = hit.load(path, list(cli_args))
    models = root.children.get("Models")
    if models is None:
        raise NEML2Error(f"No [Models] block in NEML2 input '{path}'")
    node = models.children.get(model_name)
    if node is None:
        raise NEML2Error(
            f"Model '{model_name}' not found in '{path}' "
            f"(available: {sorted(models.children)})"
        )
    p = Params(node)
    mtype = p.get_str("type", required=True)
    if mtype not in _MODEL_TYPES:
        raise NEML2Error(
            f"NEML2 model type '{mtype}' is not in marlin_tpu's supported "
            f"subset {sorted(_MODEL_TYPES)} (reference wraps the full NEML2 "
            "library; see computes/neml2.py)"
        )
    return _MODEL_TYPES[mtype](model_name, p, dev)


@computes.register("NEML2TensorCompute")
class NEML2TensorCompute(TensorCompute):
    """Deck surface of reference NEML2TensorCompute.C: map marlin buffers to
    NEML2 variables, run the model, map outputs back (each broadcast to its
    buffer's declared shape, or over the grid)."""

    def __init__(self, name, params: Params, problem):
        super().__init__(name, params, problem)
        self.marlin_inputs = params.get_str_vector("marlin_inputs", [])
        self.neml2_inputs = params.get_str_vector("neml2_inputs", [])
        self.neml2_outputs = params.get_str_vector("neml2_outputs", [])
        self.marlin_outputs = params.get_str_vector("marlin_outputs", [])
        if len(self.marlin_inputs) != len(self.neml2_inputs):
            params.error("neml2_inputs", "one NEML2 variable per marlin input")
        if len(self.marlin_outputs) != len(self.neml2_outputs):
            params.error("marlin_outputs", "one marlin buffer per NEML2 output")

        from .nn import resolve_data_file

        fname = resolve_data_file(params.get_str("neml2_input_file", required=True),
                                  getattr(problem, "deck_dir", None))
        self.model = load_neml2_model(
            fname,
            params.get_str("neml2_model", required=True),
            params.get_str_vector("cli_args", []),
            device=self.domain.device,
        )
        for m in walk_models(self.model):
            m.mesh = self.domain.mesh
        # every model input must be mapped, or forward() would die with a
        # bare KeyError in the middle of a step
        missing = set(getattr(self.model, "from_var", []) or []) - set(self.neml2_inputs)
        if missing:
            raise ComputeError(
                f"NEML2TensorCompute '{name}': model variables "
                f"{sorted(missing)} are not mapped by neml2_inputs "
                f"(mapped: {self.neml2_inputs})"
            )
        for b in self.marlin_inputs:
            if b not in self.inputs:
                self.inputs.append(b)
        self.outputs = list(self.marlin_outputs)

    def _map_outputs(self, result, grid):
        out = {}
        for nv, mb in zip(self.neml2_outputs, self.marlin_outputs):
            if nv not in result:
                raise ComputeError(f"NEML2 model '{self.model.name}' did not produce '{nv}'")
            arr = result[nv]
            declared = self.problem.declared_buffer_shape(mb)
            if declared is not None:
                # broadcast to the target buffer's declared shape (grid
                # dims + trailing value dims): a spatially constant (6,)
                # Mandel SR2 on a 3-D grid becomes grid + (6,)
                arr = torch.broadcast_to(arr, tuple(declared))
            elif arr.ndim <= self.domain.dim:
                # implicit buffer: scalar results broadcast over the grid;
                # tensor-valued ones keep their trailing axes
                arr = torch.broadcast_to(arr, grid)
            out[mb] = arr.to(self.domain.dtype)
        return out

    def apply(self, state, ctx):
        env = {nv: state[mb] for mb, nv in zip(self.marlin_inputs, self.neml2_inputs)}
        return self._map_outputs(self.model.forward(env), tuple(self.domain.shape))

    def output_specs(self, specs):
        """The shapes the model gives on one-point stand-ins of its inputs
        (each input's grid axes cut to 1, its value axes kept), mapped as
        apply maps them; a stand-in output's grid axes are the grid's."""
        dim = self.domain.dim
        env = {nv: torch.zeros((1,) * min(dim, len(specs[mb].shape))
                               + tuple(specs[mb].shape[dim:]),
                               dtype=specs[mb].dtype, device=self.domain.device)
               for mb, nv in zip(self.marlin_inputs, self.neml2_inputs)}
        saved = [(m, dataclasses.replace(m.counts, log=list(m.counts.log)))
                 for m in walk_models(self.model) if hasattr(m, "counts")]
        out = self._map_outputs(self.model.forward(env), (1,) * dim)
        for m, counts in saved:  # a shape probe is not a solve
            m.counts = counts
        grid = tuple(self.domain.shape)
        return {mb: Spec(tuple(grid[i] if i < dim else s for i, s in enumerate(a.shape))
                         if a.ndim >= dim else grid, a.dtype)
                for mb, a in out.items()}
