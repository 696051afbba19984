"""Relative astrometry likelihood.

PyTorch port of `octofitter_tpu/likelihoods/relastrom.py:38-133`:
positions of a companion relative to its host in either (ra, dec) or
(sep, pa) form, with per-point correlated 2x2 Gaussian errors and
optional `jitter`, `platescale` and `northangle` instrument nuisances,
plus the photocentre perturbation from interior massive companions.
The epoch axis is the last axis of every solution field; per-chain
parameters broadcast against it.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..constants import MJUP2MSOL
from ..model.params import hasproperty
from ..model.variables import AbstractObs, PlanetObservationContext, prepare_table
from ..orbits import decoff, raoff, semimajoraxis
from .utils import gauss2d_logpdf, per_epoch, take_epochs

_COLS_RADEC = ("epoch", "ra", "dec", "σ_ra", "σ_dec")
_COLS_SEPPA = ("epoch", "pa", "sep", "σ_pa", "σ_sep")


class PlanetRelAstromObs(AbstractObs):
    """Relative astrometry observations (mas / radians, epochs in MJD)."""

    def __init__(self, observations, variables=None, name="relastrom"):
        super().__init__(variables=variables, name=name)
        # accept ascii sigma column aliases
        if isinstance(observations, dict):
            observations = {
                k.replace("sigma_", "σ_") if k.startswith("sigma_") else k: v
                for k, v in observations.items()
            }
        self.table = prepare_table(
            observations, (_COLS_RADEC, _COLS_SEPPA), type(self).__name__
        )
        if "cor" not in self.table:
            self.table["cor"] = np.zeros_like(self.table["epoch"])
        self.seppa = "pa" in self.table and "sep" in self.table
        epochs = self.table["epoch"]
        if np.any(epochs >= 69807) or np.any(epochs <= 33282):
            warnings.warn(
                "Epochs fell outside the year 1950-2050 range; expected "
                "format is MJD. Double check your input data."
            )
        if np.any(np.abs(self.table["cor"]) > 1 - 1e-5):
            raise ValueError("Correlation values may not be well-specified")

    # ------------------------------------------------------------------
    def simulate(self, ctx: PlanetObservationContext):
        """Model (ra, dec) offsets at each epoch, including interior-
        companion photocentre perturbation
        (`relative-astrometry.jl:104-142`)."""
        n = len(self.table["epoch"])
        sol = take_epochs(ctx.solutions[ctx.i_planet], ctx.epoch_start, n)
        ra_model = raoff(sol)
        dec_model = decoff(sol)

        a_this = semimajoraxis(ctx.orbits[ctx.i_planet])
        planets = ctx.theta_system.planets
        for j, pname in enumerate(planets.keys()):
            theta_other = planets[pname]
            if not hasproperty(theta_other, "mass"):
                continue
            sol_other = take_epochs(ctx.solutions[j], ctx.epoch_start, n)
            mass_other = theta_other.mass * MJUP2MSOL
            # only interior planets perturb the host photocentre, as a
            # weight mask so shapes stay static
            is_inner = (semimajoraxis(ctx.orbits[j]) < a_this) & (j != ctx.i_planet)
            w = per_epoch(is_inner.to(ra_model.dtype), ctx)
            ra_model = ra_model - w * raoff(sol_other, mass_other)
            dec_model = dec_model - w * decoff(sol_other, mass_other)
        return {"ra_model": ra_model, "dec_model": dec_model, "epochs": self.table["epoch"]}

    # ------------------------------------------------------------------
    def pointwise_ln_like(self, ctx: PlanetObservationContext):
        theta_obs = ctx.theta_obs
        jitter = per_epoch(theta_obs.get("jitter", 0.0), ctx)
        platescale = per_epoch(theta_obs.get("platescale", 1.0), ctx)
        northangle = per_epoch(theta_obs.get("northangle", 0.0), ctx)

        sim = self.simulate(ctx)
        ra_model, dec_model = sim["ra_model"], sim["dec_model"]
        col = lambda name: self.column(name, ra_model)  # noqa: E731

        if self.seppa:
            sigma1 = col("σ_pa")
            sigma2 = col("σ_sep")
            rho = torch.hypot(ra_model, dec_model)
            pa = torch.atan2(ra_model, dec_model)
            # northangle sign convention: corrected PA = data PA + northangle
            # (`relative-astrometry.jl:195-201`, regression test for #141)
            pa_dat = col("pa") + northangle
            pa_diff = torch.remainder(pa_dat - pa + math.pi, 2 * math.pi) - math.pi
            pa_diff = torch.where(pa_diff < -math.pi, pa_diff + 2 * math.pi, pa_diff)
            resid1 = pa_diff
            resid2 = col("sep") * platescale - rho
        else:
            sigma1 = col("σ_ra")
            sigma2 = col("σ_dec")
            # data angle here runs East through North (opposite to PA), so
            # northangle is subtracted (`relative-astrometry.jl:205-215`)
            pa_dat = torch.atan2(col("dec"), col("ra")) - northangle
            sep_dat = torch.hypot(col("dec"), col("ra")) * platescale
            resid1 = sep_dat * torch.cos(pa_dat) - ra_model
            resid2 = sep_dat * torch.sin(pa_dat) - dec_model

        if isinstance(jitter, torch.Tensor):
            sigma1 = torch.hypot(sigma1, jitter)
            sigma2 = torch.hypot(sigma2, jitter)
        elif jitter != 0.0:
            sigma1 = torch.sqrt(sigma1 * sigma1 + jitter * jitter)
            sigma2 = torch.sqrt(sigma2 * sigma2 + jitter * jitter)
        return gauss2d_logpdf(resid1, resid2, sigma1, sigma2, col("cor"))

    def ln_like(self, ctx: PlanetObservationContext):
        return torch.sum(self.pointwise_ln_like(ctx), dim=-1)

    # ------------------------------------------------------------------
    def generate_from_params(self, ctx, rng, add_noise=False):
        """A copy whose positions are the model's at one parameter set
        (`ctx` of a single draw), with noise of sigma (and jitter) if asked
        (`relative-astrometry.jl:256-319`)."""
        sim = self.simulate(ctx)
        ra_model = sim["ra_model"].detach().cpu().numpy().astype(np.float64)
        dec_model = sim["dec_model"].detach().cpu().numpy().astype(np.float64)
        theta_obs = ctx.theta_obs
        platescale = float(theta_obs.get("platescale", 1.0))
        northangle = float(theta_obs.get("northangle", 0.0))
        jitter = float(theta_obs.get("jitter", 0.0))

        table = {k: np.array(v) for k, v in self.table.items()}
        sep = np.hypot(ra_model, dec_model) / platescale
        pa = np.arctan2(ra_model, dec_model) - northangle
        if self.seppa:
            if add_noise:
                sep = sep + rng.standard_normal(sep.shape) * table["σ_sep"]
                pa = pa + rng.standard_normal(pa.shape) * table["σ_pa"]
            table["sep"], table["pa"] = sep, pa
        else:
            ra = sep * np.sin(pa)
            dec = sep * np.cos(pa)
            if add_noise:
                ra = ra + rng.standard_normal(ra.shape) * np.hypot(table["σ_ra"], jitter)
                dec = dec + rng.standard_normal(dec.shape) * np.hypot(table["σ_dec"], jitter)
            table["ra"], table["dec"] = ra, dec
        new = object.__new__(type(self))
        AbstractObs.__init__(new, variables=None, name=self.name)
        new.var_specs = self.var_specs
        new.table = table
        new.seppa = self.seppa
        return new

    def likeobj_from_epoch_subset(self, idx):
        """A copy holding the epochs `idx` only."""
        new = object.__new__(type(self))
        AbstractObs.__init__(new, variables=None, name=self.name)
        new.var_specs = self.var_specs
        new.table = {k: np.asarray(v)[idx] for k, v in self.table.items()}
        new.seppa = self.seppa
        return new


# Backwards-compat alias, as in the reference (`relative-astrometry.jl:98`)
PlanetRelAstromLikelihood = PlanetRelAstromObs
