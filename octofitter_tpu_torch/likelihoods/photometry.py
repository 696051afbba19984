"""Photometry likelihood.

PyTorch port of `octofitter_tpu/likelihoods/photometry.py` (the
reference's `PhotometryObs`, `photometry.jl:30-103`): compares a model
variable (by convention ``flux``) against measured band fluxes or
magnitudes with Gaussian errors. Attachable to a planet or the system.
The model value is one per row (or one per row and band) and broadcasts
against the bands on the last axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.variables import AbstractObs, PlanetObservationContext, prepare_table
from .utils import gauss_logpdf, per_epoch, row_shape


class PhotometryObs(AbstractObs):
    def __init__(self, observations, variables=None, name="photometry"):
        super().__init__(variables=variables, name=name)
        if isinstance(observations, dict):
            observations = {
                k.replace("sigma_", "σ_") if k.startswith("sigma_") else k: v
                for k, v in observations.items()
            }
        self.table = prepare_table(observations, (("phot", "σ_phot"),), type(self).__name__)

    def _theta(self, ctx):
        if isinstance(ctx, PlanetObservationContext):
            return ctx.theta_system.merge(ctx.theta_planet).merge(ctx.theta_obs)
        return ctx.theta_system.merge(ctx.theta_obs)

    def simulate(self, ctx):
        flux = per_epoch(torch.as_tensor(self._theta(ctx)["flux"]), ctx)
        phot = self.column("phot", flux)
        return {"phot_model": torch.broadcast_to(
            flux, torch.broadcast_shapes(flux.shape, row_shape(ctx) + tuple(phot.shape)))}

    def pointwise_ln_like(self, ctx):
        model = self.simulate(ctx)["phot_model"]
        return gauss_logpdf(self.column("phot", model) - model, self.column("σ_phot", model))

    def ln_like(self, ctx):
        return torch.sum(self.pointwise_ln_like(ctx), dim=-1)

    def _copy(self, table):
        new = object.__new__(type(self))
        AbstractObs.__init__(new, variables=None, name=self.name)
        new.var_specs = self.var_specs
        new.table = table
        return new

    def generate_from_params(self, ctx, rng, add_noise=False):
        model = self.simulate(ctx)["phot_model"].detach().cpu().double().numpy()
        table = {k: np.array(v) for k, v in self.table.items()}
        phot = model
        if add_noise:
            phot = phot + rng.standard_normal(phot.shape) * table["σ_phot"]
        table["phot"] = phot
        return self._copy(table)

    def likeobj_from_epoch_subset(self, idx):
        return self._copy({k: np.asarray(v)[idx] for k, v in self.table.items()})


PhotometryLikelihood = PhotometryObs
