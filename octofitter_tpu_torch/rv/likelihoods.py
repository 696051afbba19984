"""Radial-velocity likelihoods.

PyTorch port of `octofitter_tpu/rv/likelihoods.py` (the reference's
`OctofitterRadialVelocity`: `rv-absolute.jl`, `rv-absolute-margin.jl`,
`rv-relative.jl`): absolute stellar RV with offset, jitter, trend and an
optional Gaussian process, the analytically zero-point-marginalized
variant (Orvara-paper formula), and companion-relative RV, also with an
optional Gaussian process.

The chain axis is written out: model RVs are (C, n) over the n epochs,
per-chain parameters (offset, jitter, the kernel's hyperparameters)
broadcast against the epoch axis, and every sum is over the epochs
(`dim=-1`), giving one value per chain. A Gaussian process sees the epochs
relative to the table's first, taken in float64 before the cast to the
model's dtype (every kernel depends on differences only; float32 would
otherwise keep MJD epochs to ~4e-3 d).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import MJUP2MSOL
from ..distributions import LogUniform, Uniform
from ..model.params import hasproperty
from ..model.variables import (
    AbstractObs,
    PlanetObservationContext,
    SystemObservationContext,
    prepare_table,
)
from ..likelihoods.utils import gauss_logpdf, per_epoch, take_epochs
from ..orbits import orbitsolve, radvel, semimajoraxis
from .kernels import _gp_predict, gp_loglike

_RV_COLS = ("epoch", "rv", "σ_rv")


def _default_rv_variables():
    # reference defaults (`rv-absolute.jl:73-77`)
    return dict(offset=Uniform(-1000, 1000), jitter=LogUniform(0.001, 100))


def _like(ctx):
    """A tensor of the model's dtype and device."""
    if ctx.solutions:
        return ctx.solutions[0].t
    return next(v for v in ctx.theta_system.values() if isinstance(v, torch.Tensor))


class _BaseRVObs(AbstractObs):
    def __init__(self, observations, variables, name, trend_function, gaussian_process,
                 gp_method="scan"):
        super().__init__(variables=variables, name=name)
        if isinstance(observations, dict):
            observations = {
                k.replace("sigma_", "σ_") if k.startswith("sigma_") else k: v
                for k, v in observations.items()
            }
        self.table = prepare_table(observations, (_RV_COLS,), type(self).__name__)
        self.trend_function = trend_function
        self.gaussian_process = gaussian_process
        self.gp_method = gp_method
        # the rows left out by `likeobj_from_epoch_subset`, for GP cross-validation
        self.held_out_table = None

    def _offset_and_trend(self, ctx, offset=True):
        """The instrument's offset (if the model has one) plus its trend,
        shaped to broadcast against (C, n)."""
        theta_obs = ctx.theta_obs
        rv = per_epoch(theta_obs.get("offset", 0.0), ctx) if offset else 0.0
        if self.trend_function is not None:
            rv = rv + self.trend_function(theta_obs, self.column("epoch", _like(ctx)))
        return rv

    def _star_rv(self, ctx, offset):
        """Offset and trend plus the host star's reflex RV from every
        planet with a mass, (C, n)."""
        n = len(self.table["epoch"])
        rv = self._offset_and_trend(ctx, offset)
        planets = ctx.theta_system.planets
        for j, pname in enumerate(planets.keys()):
            theta_p = planets[pname]
            if not hasproperty(theta_p, "mass"):
                continue
            sol = take_epochs(ctx.solutions[j], ctx.epoch_start, n)
            rv = rv + radvel(sol, theta_p.mass * MJUP2MSOL)
        return rv

    def _residual_and_variance(self, ctx):
        """rv - model and sigma^2 + jitter^2, each broadcast to (C, n)."""
        rv_model = self.simulate(ctx)["rv_model"]
        col = lambda name: self.column(name, _like(ctx))  # noqa: E731
        jitter = per_epoch(ctx.theta_obs.get("jitter", 0.0), ctx)
        resid = col("rv") - rv_model
        return resid, col("σ_rv") ** 2 + jitter**2

    def _gp_epochs(self, name, table, like):
        """`table`'s epochs less this table's first, in float64, then as a
        tensor of `like`'s dtype and device (cached under `name`)."""
        return self.constant(name, lambda: table["epoch"] - self.table["epoch"][0], like)

    def _gp_ln_like(self, ctx):
        """The Gaussian-process log-likelihood of the residuals, (C,)."""
        resid, var = self._residual_and_variance(ctx)
        kernel = self.gaussian_process(ctx.theta_obs)
        t = self._gp_epochs("epoch_rel", self.table, resid)
        return gp_loglike(kernel, t, resid, var, method=self.gp_method, fused=ctx.fused)

    def _pointwise_ln_like(self, ctx):
        """Per-epoch log-likelihood, (C, n); with a Gaussian process the
        per-point marginal N(0, K_ii + var_i)."""
        resid, var = self._residual_and_variance(ctx)
        if self.gaussian_process is not None:
            kernel = self.gaussian_process(ctx.theta_obs)
            t = self._gp_epochs("epoch_rel", self.table, resid)
            var = var + torch.diagonal(kernel.matrix(t, t), dim1=-2, dim2=-1)
        return gauss_logpdf(resid, torch.sqrt(var))

    def _copy_with_table(self, table):
        new = object.__new__(type(self))
        AbstractObs.__init__(new, variables=None, name=self.name)
        new.var_specs = self.var_specs
        new.table = table
        new.trend_function = self.trend_function
        new.gaussian_process = self.gaussian_process
        new.gp_method = self.gp_method
        new.held_out_table = None
        return new

    def likeobj_from_epoch_subset(self, idx):
        """The same likelihood on rows `idx` of the table; the other rows
        are kept as held-out data for GP cross-validation
        (`rv-absolute.jl:115-130`)."""
        mask = np.zeros(len(self.table["epoch"]), bool)
        mask[idx] = True
        new = self._copy_with_table({k: v[mask] for k, v in self.table.items()})
        new.held_out_table = {k: v[~mask] for k, v in self.table.items()}
        return new

    def generate_from_params(self, ctx, rng, add_noise=False):
        """A copy whose RVs are the model's at one parameter set (`ctx` of
        a single chain), with noise of sigma and jitter if asked."""
        n = len(self.table["epoch"])
        rv = self.simulate(ctx)["rv_model"].detach().cpu().numpy().astype(np.float64).reshape(n)
        jitter = float(ctx.theta_obs.get("jitter", 0.0))
        table = {k: np.array(v) for k, v in self.table.items()}
        if add_noise:
            rv = rv + rng.standard_normal(rv.shape) * np.hypot(table["σ_rv"], jitter)
        table["rv"] = rv
        return self._copy_with_table(table)


class StarAbsoluteRVObs(_BaseRVObs):
    """Absolute RV of the host star (`rv-absolute.jl:56-318`).

    Observation variables: `offset` (zero point, m/s), `jitter` (m/s);
    optional trend_function(theta_obs, epochs) and
    gaussian_process(theta_obs) -> a `Kernel` or `CeleriteTerm` whose
    hyperparameters are per-chain tensors. `gp_method` ("scan", the
    default, or "associative") chooses how a celerite term is solved: the
    O(N) recursion (on the GPU the CUDA kernel pair) or the parallel Kalman
    filter for few chains and long series. After `likeobj_from_epoch_subset`
    a GP likelihood conditions on the kept rows and scores the held-out
    ones by the GP's prediction there.
    """

    def __init__(self, observations, variables=None, *, name,
                 trend_function=None, gaussian_process=None,
                 gp_method="scan"):
        if variables is None:
            variables = _default_rv_variables()
        super().__init__(observations, variables, name, trend_function,
                         gaussian_process, gp_method)

    def simulate(self, ctx: SystemObservationContext):
        return {"rv_model": self._star_rv(ctx, offset=True), "epochs": self.table["epoch"]}

    def ln_like(self, ctx: SystemObservationContext):
        if self.gaussian_process is None:
            # without a GP, held-out rows are independent and not scored
            resid, var = self._residual_and_variance(ctx)
            return torch.sum(gauss_logpdf(resid, torch.sqrt(var)), dim=-1)
        if self.held_out_table is None:
            return self._gp_ln_like(ctx)
        return self._held_out_ln_like(ctx)

    def _held_out_ln_like(self, ctx):
        """Cross-validation: the GP conditioned on the table's rows, scored
        at the held-out rows (`rv-absolute.jl:253-304`), whose model RVs come
        from solving each orbit at the held-out epochs."""
        resid, var = self._residual_and_variance(ctx)
        kernel = self.gaussian_process(ctx.theta_obs)
        ho = self.held_out_table
        col = lambda name: self.constant(f"held_out_{name}", lambda: ho[name], resid)  # noqa: E731
        ho_epochs = col("epoch")
        theta_obs = ctx.theta_obs
        rv_ho = per_epoch(theta_obs.get("offset", 0.0), ctx)
        if self.trend_function is not None:
            rv_ho = rv_ho + self.trend_function(theta_obs, ho_epochs)
        planets = ctx.theta_system.planets
        for j, pname in enumerate(planets.keys()):
            theta_p = planets[pname]
            if not hasproperty(theta_p, "mass"):
                continue
            sol = orbitsolve(ctx.orbits[j], ho_epochs, fused=ctx.fused)
            rv_ho = rv_ho + radvel(sol, theta_p.mass * MJUP2MSOL)
        resid_ho = col("rv") - rv_ho
        var_ho = col("σ_rv") ** 2 + per_epoch(theta_obs.get("jitter", 0.0), ctx) ** 2
        t = self._gp_epochs("epoch_rel", self.table, resid)
        t_ho = self._gp_epochs("held_out_epoch_rel", ho, resid)
        pred, pvar, bad = _gp_predict(kernel, t, resid, var, t_ho)
        ll = torch.sum(gauss_logpdf(resid_ho - pred, torch.sqrt(pvar + var_ho)), dim=-1)
        return torch.where(bad, -torch.inf, ll)

    def pointwise_ln_like(self, ctx: SystemObservationContext):
        """Per-epoch log-likelihood, (C, n); the GP case uses the per-point
        marginal N(0, K_ii + var_i)."""
        return self._pointwise_ln_like(ctx)


class MarginalizedStarAbsoluteRVObs(_BaseRVObs):
    """Absolute RV with the zero point marginalized analytically
    (Orvara-paper formula; `rv-absolute-margin.jl:41-216`).

    Accumulate A = sum 1/var, B = -2 sum r/var, C = sum r^2/var over the
    epochs; then ll = sum(-log(2 pi var)) - (-B^2/(4A) + C + log A).
    """

    def __init__(self, observations, variables=None, *, name, trend_function=None):
        if variables is None:
            variables = dict(jitter=LogUniform(0.001, 100))
        super().__init__(observations, variables, name, trend_function, None)

    def simulate(self, ctx: SystemObservationContext):
        return {"rv_model": self._star_rv(ctx, offset=False), "epochs": self.table["epoch"]}

    def ln_like(self, ctx: SystemObservationContext):
        resid, var = self._residual_and_variance(ctx)
        A = torch.sum(1.0 / var, dim=-1)
        B = -2.0 * torch.sum(resid / var, dim=-1)
        C = torch.sum(resid**2 / var, dim=-1)
        ll = -torch.sum(torch.log(2 * math.pi * var), dim=-1)
        # -B^2/(4A) + C is the scatter about the best zero point, and it
        # cancels: where the data sit far from the model, as at an unknown
        # offset of 30 m/s with 5 m/s errors (C ~ 1.4e3, the difference
        # ~ 40), float32 leaves it about 1e-4 absolute of error. Kept as the
        # reference writes it.
        return ll - (-(B**2) / (4 * A) + C + torch.log(A))

    def pointwise_ln_like(self, ctx: SystemObservationContext):
        # single-row marginalized formula: a lone point with a free
        # zero-point carries no information beyond the constant
        resid, _ = self._residual_and_variance(ctx)
        return torch.full_like(resid, -math.log(2 * math.pi))


class PlanetRelativeRVObs(_BaseRVObs):
    """RV of a companion relative to the host (`rv-relative.jl:55-325`),
    with perturbations from interior massive companions, and an optional
    gaussian_process(theta_obs) solved as StarAbsoluteRVObs's default
    ("scan")."""

    def __init__(self, observations, variables=None, *, name,
                 trend_function=None, gaussian_process=None):
        if variables is None:
            variables = dict(jitter=LogUniform(0.001, 100))
        super().__init__(observations, variables, name, trend_function, gaussian_process)

    def simulate(self, ctx: PlanetObservationContext):
        n = len(self.table["epoch"])
        sol = take_epochs(ctx.solutions[ctx.i_planet], ctx.epoch_start, n)
        rv = self._offset_and_trend(ctx) + radvel(sol)
        a_this = semimajoraxis(ctx.orbits[ctx.i_planet])
        planets = ctx.theta_system.planets
        for j, pname in enumerate(planets.keys()):
            theta_p = planets[pname]
            if not hasproperty(theta_p, "mass") or j == ctx.i_planet:
                continue
            sol_o = take_epochs(ctx.solutions[j], ctx.epoch_start, n)
            w = per_epoch((semimajoraxis(ctx.orbits[j]) < a_this).to(rv.dtype), ctx)
            rv = rv + w * radvel(sol_o, theta_p.mass * MJUP2MSOL)
        return {"rv_model": rv, "epochs": self.table["epoch"]}

    def ln_like(self, ctx: PlanetObservationContext):
        if self.gaussian_process is not None:
            return self._gp_ln_like(ctx)
        resid, var = self._residual_and_variance(ctx)
        return torch.sum(gauss_logpdf(resid, torch.sqrt(var)), dim=-1)

    def pointwise_ln_like(self, ctx: PlanetObservationContext):
        """Per-epoch log-likelihood, (C, n); the GP case uses the per-point
        marginal N(0, K_ii + var_i)."""
        return self._pointwise_ln_like(ctx)


StarAbsoluteRVLikelihood = StarAbsoluteRVObs
MarginalizedStarAbsoluteRVLikelihood = MarginalizedStarAbsoluteRVObs
# reference also exports this shorter alias (OctofitterRadialVelocity.jl)
StarAbsoluteRVMarginLikelihood = MarginalizedStarAbsoluteRVObs
PlanetRelativeRVLikelihood = PlanetRelativeRVObs
