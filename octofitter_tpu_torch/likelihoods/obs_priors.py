"""Observable-based and stability pseudo-priors.

PyTorch port of `octofitter_tpu/likelihoods/obs_priors.py` (the
reference's `prior-observable.jl`, `prior-non-crossing.jl` and
`prior-planet-order.jl`). The chain axis is written out: each planet's
orbit quantities are stacked on a last axis, (R..., P), the reference's
data-dependent sorting of orbits by semi-major axis is a stable per-row
`argsort` and `gather`, and the hard cutoffs are branch-free `-inf`
masks whose rows keep a finite gradient.
"""

from __future__ import annotations

import torch

from ..constants import JULIAN_YEAR_DAYS, MJUP2MSOL
from ..model.variables import AbstractObs, PlanetObservationContext, SystemObservationContext
from ..orbits import apoapsis, eccanom, eccentricity, meananom, periapsis, period, semimajoraxis
from .utils import take_epochs


def _per_planet(values):
    """Per-planet values (each of the rows' shape, or 0-d) stacked on a
    last axis: (R..., P)."""
    return torch.stack(torch.broadcast_tensors(*values), dim=-1)


def _sorted_by(key, *values):
    """Each of `values` (R..., P) reordered, per row, by ascending `key`
    (ties in planet order, as the JAX package's stable `argsort`)."""
    order = torch.argsort(key, dim=-1, stable=True)
    return [torch.gather(v.expand_as(key), -1, order) for v in values]


class ObsPriorAstromONeil2019(AbstractObs):
    """O'Neil 2019 observable-based prior wrapping an astrometry likelihood
    (`prior-observable.jl:56-137`).

    Per epoch the Jacobian term is |3M(e+cosE) + 2(-2+e^2+e cosE) sinE|,
    the total is multiplied by P^(1/3)/sqrt(1-e^2), and 2*log(jac) is
    added. As in the reference, `ln_like` returns the *wrapped* likelihood
    plus the prior correction; attach only this wrapper (not the inner
    likelihood as well) unless you intend both terms. The mean anomaly is
    computed from the solution's epochs and elements, the eccentric anomaly
    is the solution's (the fused orbit solve's first field, whose
    cotangent its backward takes)."""

    def __init__(self, wrapped_like: AbstractObs):
        super().__init__(variables=None, name="obspri_" + wrapped_like.name)
        self.wrapped_like = wrapped_like
        self.var_specs = wrapped_like.var_specs
        self.table = wrapped_like.table

    def _jacobian(self, sol, orbit):
        e = eccentricity(orbit)
        M = meananom(sol)
        E = eccanom(sol)
        e_ = e[..., None] if isinstance(e, torch.Tensor) and e.ndim else e
        jac = torch.sum(torch.abs(3 * M * (e_ + torch.cos(E))
                                  + 2 * (-2 + e_**2 + e_ * torch.cos(E)) * torch.sin(E)), dim=-1)
        P_years = period(orbit) / JULIAN_YEAR_DAYS
        jac = jac * P_years ** (1.0 / 3.0) / torch.sqrt(1 - e**2)
        return 2 * torch.log(jac)

    def ln_like(self, ctx):
        ll = self.wrapped_like.ln_like(ctx)
        n = len(self.table["epoch"])
        if isinstance(ctx, PlanetObservationContext):
            orbit = ctx.orbits[ctx.i_planet]
            sol = take_epochs(ctx.solutions[ctx.i_planet], ctx.epoch_start, n)
            ll = ll + self._jacobian(sol, orbit)
        else:
            for i, orbit in enumerate(ctx.orbits):
                sol = take_epochs(ctx.solutions[i], ctx.epoch_start, n)
                ll = ll + self._jacobian(sol, orbit)
        return ll

    def simulate(self, ctx):
        return self.wrapped_like.simulate(ctx)

    def generate_from_params(self, ctx, rng, add_noise=False):
        return ObsPriorAstromONeil2019(
            self.wrapped_like.generate_from_params(ctx, rng, add_noise=add_noise))

    def likeobj_from_epoch_subset(self, idx):
        return ObsPriorAstromONeil2019(self.wrapped_like.likeobj_from_epoch_subset(idx))


class LimitClosestApproachAUPrior(AbstractObs):
    """Hard/soft repulsion between adjacent orbits
    (`prior-non-crossing.jl:1-38`)."""

    def __init__(self, soft_closest_approach_au=0.0, hard_closest_approach_au=None):
        super().__init__(variables=None, name="LimitClosestApproachAUPrior")
        if hard_closest_approach_au is None:
            hard_closest_approach_au = 0.0
        self.hard = float(hard_closest_approach_au)
        self.soft = float(soft_closest_approach_au)

    @property
    def is_prior(self):
        return True

    def ln_like(self, ctx: SystemObservationContext):
        orbits = ctx.orbits
        if len(orbits) <= 1:
            return 0.0
        sma = _per_planet([semimajoraxis(o) for o in orbits])
        apo_s, peri_s = _sorted_by(sma, _per_planet([apoapsis(o) for o in orbits]),
                                   _per_planet([periapsis(o) for o in orbits]))
        closest = peri_s[..., 1:] - apo_s[..., :-1]
        hard_violate = torch.any(closest <= self.hard, dim=-1)
        soft = closest < self.soft
        # the penalty's denominator where it applies, 1 elsewhere: the
        # unselected branch stays finite, and so does its zero gradient
        gap = torch.where(soft, closest - self.soft, 1.0)
        ll = torch.sum(torch.where(soft, -1.0 / gap**2, 0.0), dim=-1)
        return torch.where(hard_violate, -torch.inf, ll)

    def likeobj_from_epoch_subset(self, idx):
        return self


def NonCrossingPrior():
    """Adjacent orbits may not cross (`prior-non-crossing.jl:6`)."""
    return LimitClosestApproachAUPrior(0.0, 0.0)


class HillStabilityPrior(AbstractObs):
    """Mutual Hill-stability hard cutoff (`prior-non-crossing.jl:43-88`):
    adjacent pairs must satisfy delta_a > 2*sqrt(3)*R_Hill."""

    def __init__(self):
        super().__init__(variables=None, name="HillStabilityPrior")

    @property
    def is_prior(self):
        return True

    def ln_like(self, ctx: SystemObservationContext):
        orbits = ctx.orbits
        theta = ctx.theta_system
        if len(orbits) <= 1:
            return 0.0
        pnames = list(theta.planets.keys())
        sma = _per_planet([semimajoraxis(o) for o in orbits])
        masses = _per_planet([theta.planets[p].mass * MJUP2MSOL for p in pnames])
        sma_s, m_s = _sorted_by(sma, sma, masses)
        delta_a = sma_s[..., 1:] - sma_s[..., :-1]
        M_star = torch.clamp(theta.M[..., None] - m_s[..., 1:] - m_s[..., :-1], min=0.0)
        # a cutoff only: no gradient reaches the orbits through it
        R_H = sma_s[..., 1:] * ((m_s[..., 1:] + m_s[..., :-1]) / (3 * M_star)) ** (1.0 / 3.0)
        violate = torch.any(delta_a <= 2 * 3.0**0.5 * R_H, dim=-1)
        return torch.where(violate, -torch.inf, sma.new_zeros(()))

    def likeobj_from_epoch_subset(self, idx):
        return self


class PlanetOrderPrior(AbstractObs):
    """Constrain the listed planets to ascending semi-major axis
    (`prior-planet-order.jl:1-33`)."""

    def __init__(self, *planet_names):
        names = [p.name if hasattr(p, "name") else str(p) for p in planet_names]
        super().__init__(variables=None, name="PlanetOrderPrior_" + "_".join(names))
        self.planet_names = names

    @property
    def is_prior(self):
        return True

    def ln_like(self, ctx: SystemObservationContext):
        pnames = list(ctx.theta_system.planets.keys())
        idxs = [pnames.index(n) for n in self.planet_names]
        sma = _per_planet([semimajoraxis(ctx.orbits[i]) for i in idxs])
        violate = torch.any(sma[..., :-1] >= sma[..., 1:], dim=-1)
        return torch.where(violate, -torch.inf, sma.new_zeros(()))

    def likeobj_from_epoch_subset(self, idx):
        return self
