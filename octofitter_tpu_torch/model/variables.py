"""Model specification: variables, planets, systems, observation interface.

PyTorch port of `octofitter_tpu/model/variables.py` (the part the
ported fits use, with the `UserLikelihood` and `DirectLL` user terms and
`BlankLikelihood`). A ``variables=dict(...)`` holds

  - a Distribution value: a *prior* (`x ~ Dist`),
  - a number/array: a constant,
  - a callable: a *derived* variable (`y = expr`); its positional
    signature selects scope: system-level ``f(sys)``, planet-level
    ``f(sys, pl)``, observation-level ``f(sys, obs)`` / ``f(sys, pl, obs)``,
  - ``UniformCircular()``: two Normal(0,1) variables, an ``atan2``
    derived angle and a ``UnitLengthPrior`` pseudo-observation,
  - ``IIDVector(dist, n)``: n iid priors ``name_1 .. name_n`` and a
    derived ``name`` stacking them on a last axis.

Derived callables receive tensors whose leading axis is the chain axis,
so they must be elementwise (the functions this package exports are).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import numpy as np
import torch

from ..distributions import Distribution, LogNormal, Normal
from ..orbits import (
    AbsoluteVisualOrbit,
    CartesianOrbit,
    FixedPositionOrbit,
    HyperbolicOrbit,
    KepOrbit,
    RadialVelocityOrbit,
    ThieleInnesOrbit,
    VisualOrbit,
)
from .params import Params


def normalizename(name: str) -> str:
    """Observation name -> valid identifier (reference `normalizename`)."""
    return re.sub(r"\W", "_", name)


# --------------------------------------------------------------------------
# Variable kinds
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Derived:
    """Explicitly-wrapped derived variable (callable or constant)."""

    fn: Any


class UniformCircular:
    """Continuous periodic variable parameterization
    (`variables.jl:242-263`)."""

    def __init__(self, domain: float = 2 * math.pi):
        self.domain = float(domain)


class IIDVector:
    """n iid copies of a scalar prior exposed as ONE stacked variable (the
    reference's `x ~ MvNormal(zeros(n), I)` pattern).

    Expands to scalar priors ``name_1 .. name_n`` (so the grouped prior
    machinery vectorizes them) plus a derived ``name`` of shape (..., n):
    the chain axis first, the n copies last."""

    def __init__(self, dist: "Distribution", n: int):
        self.dist = dist
        self.n = int(n)


@dataclasses.dataclass
class _VarSpec:
    """One entry of a variables block, in declaration order."""

    name: str
    kind: str          # "prior" | "derived" | "constant"
    value: Any         # Distribution | callable | number


def parse_variables(variables: dict | None):
    """Split a variables dict into ordered specs + extra pseudo-likelihoods.

    Returns (specs, extra_obs) where extra_obs holds UnitLengthPrior
    objects generated by UniformCircular expansion.
    """
    specs: list[_VarSpec] = []
    extra_obs: list[AbstractObs] = []
    if variables is None:
        return specs, extra_obs
    for name, v in variables.items():
        if isinstance(v, UniformCircular):
            # expand to (namex, namey) ~ Normal(0,1), derived atan2, and a
            # unit-length pseudo-likelihood (`variables.jl:279-299`)
            nx, ny = f"{name}x", f"{name}y"
            specs.append(_VarSpec(nx, "prior", Normal(0.0, 1.0)))
            specs.append(_VarSpec(ny, "prior", Normal(0.0, 1.0)))
            domain = v.domain

            def _mk(nx=nx, ny=ny, domain=domain):
                def fn(*scopes):
                    ns = scopes[-1]
                    return torch.atan2(ns[ny], ns[nx]) / (2 * math.pi) * domain

                return fn

            specs.append(_VarSpec(name, "derived", _mk()))
            extra_obs.append(UnitLengthPrior(nx, ny))
        elif isinstance(v, IIDVector):
            comp_names = [f"{name}_{i + 1}" for i in range(v.n)]
            for cn in comp_names:
                specs.append(_VarSpec(cn, "prior", v.dist))

            def _mk_stack(comp_names=tuple(comp_names)):
                def fn(*scopes):
                    ns = scopes[-1]
                    return torch.stack(torch.broadcast_tensors(*(ns[cn] for cn in comp_names)),
                                       dim=-1)

                return fn

            specs.append(_VarSpec(name, "derived", _mk_stack()))
        elif isinstance(v, Distribution):
            specs.append(_VarSpec(name, "prior", v))
        elif isinstance(v, Derived):
            kind = "derived" if callable(v.fn) else "constant"
            specs.append(_VarSpec(name, kind, v.fn))
        elif callable(v):
            specs.append(_VarSpec(name, "derived", v))
        else:
            specs.append(_VarSpec(name, "constant", v))
    return specs, extra_obs


# --------------------------------------------------------------------------
# Observation interface
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SystemObservationContext:
    """Context passed to system-attached likelihoods."""

    theta_system: Params
    theta_obs: Params
    orbits: tuple
    solutions: tuple       # per-planet OrbitSolution over ALL epochs
    epoch_start: int       # this obs's start index into the epoch axis
    batch_shape: tuple | None = None  # the rows' shape (`likelihoods.utils.row_shape`)
    # hand-written kernels with first derivatives (`LogDensityModel.ln_post`'s
    # `fused`); False asks a likelihood for composed torch ops
    fused: bool = True


@dataclasses.dataclass
class PlanetObservationContext:
    """Context passed to planet-attached likelihoods."""

    theta_system: Params
    theta_planet: Params
    theta_obs: Params
    orbits: tuple
    solutions: tuple
    i_planet: int
    epoch_start: int
    batch_shape: tuple | None = None
    fused: bool = True


class AbstractObs:
    """Base class for observations/likelihood objects.

    Interface:
      - ``ln_like(ctx)`` -> log-likelihood, one value per chain
      - ``epochs`` property -> np.ndarray of MJD epochs or None
      - ``simulate(ctx)`` -> model-predicted observables (dict)
      - ``generate_from_params(ctx, rng, add_noise)`` -> new obs object
    """

    name: str = ""

    def __init__(self, variables=None, name=""):
        specs, extra = parse_variables(variables)
        if extra:
            raise ValueError(
                "UniformCircular is not supported inside observation "
                "variable blocks"
            )
        self.var_specs = specs
        self.name = name
        self._columns = {}

    @property
    def normalized_name(self) -> str:
        return normalizename(likelihoodname(self))

    @property
    def epochs(self):
        table = getattr(self, "table", None)
        if table is not None and "epoch" in table:
            return np.asarray(table["epoch"])
        return None

    @property
    def is_prior(self) -> bool:
        """True for pseudo-likelihoods that act as priors (no data rows)."""
        return False

    def constant(self, name: str, make, like: torch.Tensor) -> torch.Tensor:
        """`make()` (array data) as a tensor of `like`'s dtype and device,
        converted once per (name, dtype, device) and then reused."""
        key = (name, like.dtype, like.device)
        if key not in self._columns:
            self._columns[key] = torch.as_tensor(make(), dtype=like.dtype, device=like.device)
        return self._columns[key]

    def column(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """Table column `name` as a tensor of `like`'s dtype and device."""
        return self.constant(name, lambda: self.table[name], like)

    def ln_like(self, ctx):
        raise NotImplementedError

    def simulate(self, ctx):
        raise NotImplementedError

    def generate_from_params(self, ctx, rng, add_noise=False):
        return self

    def __repr__(self):
        n = 0 if self.epochs is None else len(self.epochs)
        return f"{type(self).__name__}(name={self.name!r}, epochs={n})"


def likelihoodname(obs: AbstractObs) -> str:
    return obs.name


def prepare_table(observations, required_sets, name) -> dict:
    """Normalize input (dict of arrays / list of dicts / pandas) to a
    dict of float64 numpy arrays, sorted by epoch when present."""
    if hasattr(observations, "to_dict") and hasattr(observations, "columns"):
        observations = {c: np.asarray(observations[c]) for c in observations.columns}
    if isinstance(observations, (list, tuple)):
        keys = observations[0].keys()
        observations = {k: np.asarray([row[k] for row in observations]) for k in keys}
    table = {k: np.atleast_1d(np.asarray(v, dtype=np.float64)) for k, v in observations.items()}
    ok = any(all(c in table for c in req) for req in required_sets)
    if not ok:
        raise ValueError(f"{name}: expected columns from one of {required_sets}, got {list(table)}")
    lens = {len(v) for v in table.values()}
    if len(lens) > 1:
        raise ValueError(f"{name}: columns have unequal lengths")
    if "epoch" in table:
        order = np.argsort(table["epoch"], kind="stable")
        table = {k: v[order] for k, v in table.items()}
    return table


class UnitLengthPrior(AbstractObs):
    """sqrt(x^2+y^2) ~ LogNormal(log 1, 0.1) pseudo-likelihood keeping
    UniformCircular's 2-D representation away from the origin
    (`variables.jl:267-328`)."""

    def __init__(self, varx: str, vary: str):
        super().__init__(variables=None, name=f"unitlengthprior_{varx}_{vary}")
        self.varx = varx
        self.vary = vary
        self._dist = LogNormal(0.0, 0.1)

    @property
    def is_prior(self):
        return True

    def ln_like(self, ctx):
        if isinstance(ctx, PlanetObservationContext):
            theta = ctx.theta_system.merge(ctx.theta_planet)
        else:
            theta = ctx.theta_system
        x = theta[self.varx]
        y = theta[self.vary]
        return self._dist.logpdf(torch.sqrt(x * x + y * y))


class UserLikelihood(AbstractObs):
    """`lhs ~ rhs` user term: adds logpdf(dist, value) where one side
    names a variable holding a Distribution and the other a value
    (`variables.jl:332-385`). The Distribution side is passed directly."""

    def __init__(self, dist: Distribution, var: str, name: str):
        super().__init__(variables=None, name=name)
        self.dist = dist
        self.var = var

    @property
    def is_prior(self):
        return True

    def ln_like(self, ctx):
        if isinstance(ctx, PlanetObservationContext):
            theta = ctx.theta_system.merge(ctx.theta_planet).merge(ctx.theta_obs)
        else:
            theta = ctx.theta_system.merge(ctx.theta_obs)
        return self.dist.logpdf(theta[self.var])


class BlankLikelihood(AbstractObs):
    """Holds variables without contributing likelihood
    (`variables.jl:430-451`), used e.g. by prior-only models."""

    @property
    def is_prior(self):
        return True

    def ln_like(self, ctx):
        return 0.0


class DirectLL(AbstractObs):
    """`LL += expr` escape hatch: adds the value of a named (derived)
    variable directly to the log-likelihood (`variables.jl:397-424`)."""

    def __init__(self, var: str, name: str | None = None):
        super().__init__(variables=None, name=name or f"directll_{var}")
        self.var = var

    @property
    def is_prior(self):
        return True

    def ln_like(self, ctx):
        if isinstance(ctx, PlanetObservationContext):
            theta = ctx.theta_system.merge(ctx.theta_planet).merge(ctx.theta_obs)
        else:
            theta = ctx.theta_system.merge(ctx.theta_obs)
        return theta[self.var]


# --------------------------------------------------------------------------
# Planet & System
# --------------------------------------------------------------------------

_BASIS_MAP = {
    "KepOrbit": KepOrbit,
    "Visual{KepOrbit}": VisualOrbit,
    "VisualOrbit": VisualOrbit,
    "AbsoluteVisual{KepOrbit}": AbsoluteVisualOrbit,
    "AbsoluteVisualOrbit": AbsoluteVisualOrbit,
    "ThieleInnesOrbit": ThieleInnesOrbit,
    "RadialVelocityOrbit": RadialVelocityOrbit,
    "CartesianOrbit": CartesianOrbit,
    "FixedPosition": FixedPositionOrbit,
    "Visual{FixedPosition}": FixedPositionOrbit,
    "HyperbolicOrbit": HyperbolicOrbit,
    "Hyperbolic{KepOrbit}": HyperbolicOrbit,
}


def resolve_basis(basis):
    if isinstance(basis, str):
        if basis not in _BASIS_MAP:
            raise ValueError(
                f"Unknown orbit basis {basis!r}; known: {sorted(_BASIS_MAP)}"
            )
        return _BASIS_MAP[basis]
    return basis


class Planet:
    """A companion model: orbit basis + variables + observations
    (`variables.jl:461-508`)."""

    def __init__(self, *, name: str, basis, variables=None, observations=()):
        self.name = name
        self.basis = resolve_basis(basis)
        specs, extra = parse_variables(variables)
        self.var_specs = specs
        self.observations = list(observations) + list(extra)
        names = [o.normalized_name for o in self.observations]
        if len(set(names)) != len(names):
            raise ValueError(f"Planet {name}: duplicate observation names {names}")

    def __repr__(self):
        return (
            f"Planet({self.name!r}, basis={self.basis.__name__}, "
            f"vars={[s.name for s in self.var_specs]}, "
            f"obs={[o.name for o in self.observations]})"
        )


class System:
    """The root model object (`variables.jl:536-594`)."""

    def __init__(self, *, name: str, variables=None, companions=(), observations=()):
        self.name = name
        specs, extra = parse_variables(variables)
        self.var_specs = specs
        self.planets = list(companions)
        self.observations = list(observations) + list(extra)
        names = [o.normalized_name for o in self.observations]
        if len(set(names)) != len(names):
            raise ValueError(f"System {name}: duplicate observation names {names}")
        pnames = [p.name for p in self.planets]
        if len(set(pnames)) != len(pnames):
            raise ValueError(f"System {name}: duplicate planet names {pnames}")

    def __repr__(self):
        return (
            f"System({self.name!r}, vars={[s.name for s in self.var_specs]}, "
            f"planets={[p.name for p in self.planets]}, "
            f"obs={[o.name for o in self.observations]})"
        )
