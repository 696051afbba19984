"""Gaia DR4 epoch astrometry (IAD) likelihood.

PyTorch port of `octofitter_tpu/astrom/gaia_dr4.py` (the reference's
`GaiaDR4AstromObs`, `gaia-dr4.jl`): along-scan centroid residuals
modelled as the scan-projected (position + proper motion |
AbsoluteVisual-propagated) offsets plus planet perturbations plus the
parallax term, with an `astrometric_jitter` noise variable and
outlier-flag masking. The `primary_star_perturbation` mode analytically
detrends the linear (mean + slope) part of the perturbation with
precomputed O(N) coefficients (`gaia-dr4.jl:58-66,207-235`).

The chain axis is written out: every model column is (..., N) over the N
epochs, and the detrend's means and slopes are sums over the epoch axis
only. The AbsoluteVisual branch subtracts the catalog position in degrees,
so it needs float64.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..constants import JULIAN_YEAR_DAYS, MJUP2MSOL, jd2mjd
from ..likelihoods.utils import gauss_logpdf, per_epoch, take_epochs
from ..model.params import Params, hasproperty
from ..model.variables import AbstractObs, SystemObservationContext
from ..orbits import AbsoluteVisualOrbit, decoff, raoff
from .ephemeris import geocentre_position_query

_REQ = ("centroid_pos_al", "centroid_pos_error_al", "scan_pos_angle", "parallax_factor_al")
_DEG2MAS = 60.0 * 60.0 * 1000.0


class GaiaDR4AstromObs(AbstractObs):
    """Gaia DR4 IAD likelihood.

    Required columns: `centroid_pos_al`, `centroid_pos_error_al` [mas],
    `scan_pos_angle` [rad], `parallax_factor_al`, plus `epoch` (MJD) or
    `obs_time_tcb` (JD). Optional `outlier_flag`.

    Observation variables: `astrometric_jitter` (mas); in non-absolute
    mode also `ra_offset_mas`, `dec_offset_mas`, `pmra`, `pmdec`,
    `ref_epoch`.
    """

    def __init__(
        self,
        observations_table,
        *,
        gaia_id=0,
        gaia_sol=None,
        variables=None,
        name="GaiaDR4",
        primary_star_perturbation=False,
        earth_table=None,
        observer="gaia",
    ):
        super().__init__(variables=variables, name=name)
        table = {k: np.atleast_1d(np.asarray(v, dtype=np.float64))
                 for k, v in dict(observations_table).items()}
        if "epoch" not in table and "obs_time_tcb" in table:
            table["epoch"] = jd2mjd(table["obs_time_tcb"])
        missing = [c for c in _REQ if c not in table]
        if missing:
            raise ValueError(f"GaiaDR4AstromObs missing columns {missing}")
        order = np.argsort(table["epoch"], kind="stable")
        table = {k: v[order] for k, v in table.items()}
        pos = geocentre_position_query(table["epoch"], earth_table,
                                       observer=observer)
        table["x"], table["y"], table["z"] = pos["x"], pos["y"], pos["z"]
        self.table = table
        self.gaia_id = gaia_id
        self.gaia_sol = dict(gaia_sol or {})
        self.primary_star_perturbation = bool(primary_star_perturbation)
        self._set_detrend()

    def _set_detrend(self):
        epochs = self.table["epoch"]
        self.detrend_dt = (epochs - epochs.mean()) / JULIAN_YEAR_DAYS
        self.detrend_inv_N = 1.0 / len(epochs)
        self.detrend_inv_sum_dt2 = 1.0 / np.sum(self.detrend_dt**2)

    # ------------------------------------------------------------------
    def simulate(self, ctx: SystemObservationContext):
        theta = ctx.theta_system
        theta_obs = ctx.theta_obs if isinstance(ctx.theta_obs, Params) else Params()
        n = len(self.table["epoch"])
        pnames = list(theta.planets.keys())
        like = theta.plx
        col = lambda name: self.column(name, like)  # noqa: E731

        absolute = len(ctx.orbits) > 0 and isinstance(ctx.orbits[0], AbsoluteVisualOrbit)
        if absolute:
            comp = take_epochs(ctx.solutions[0], ctx.epoch_start, n).compensated
            ra_ref = self.gaia_sol.get("ra", 0.0)
            dec_ref = self.gaia_sol.get("dec", 0.0)
            ra_off = (comp.ra2 - ra_ref) * _DEG2MAS * torch.cos(torch.deg2rad(comp.dec2))
            dec_off = (comp.dec2 - dec_ref) * _DEG2MAS
        else:
            # linear barycentric model from observation variables
            # (`gaia-dr4.jl:183-187`)
            ep = lambda x: per_epoch(x, ctx)  # noqa: E731
            ra0 = ep(theta_obs.get("ra_offset_mas", 0.0))
            dec0 = ep(theta_obs.get("dec_offset_mas", 0.0))
            pmra = ep(theta_obs.get("pmra", theta.get("pmra", 0.0)))
            pmdec = ep(theta_obs.get("pmdec", theta.get("pmdec", 0.0)))
            ref_epoch = ep(theta_obs.get("ref_epoch", 57388.5))
            dt_yr = (col("epoch") - ref_epoch) / JULIAN_YEAR_DAYS
            ra_off = ra0 + pmra * dt_yr
            dec_off = dec0 + pmdec * dt_yr

        # planet perturbations (host reflex)
        pert_ra = pert_dec = like.new_zeros(n)
        for i, pname in enumerate(pnames):
            theta_p = theta.planets[pname]
            if not hasproperty(theta_p, "mass"):
                continue
            m = theta_p.mass * MJUP2MSOL
            sol = take_epochs(ctx.solutions[i], ctx.epoch_start, n)
            pert_ra = pert_ra + raoff(sol, m)
            pert_dec = pert_dec + decoff(sol, m)

        if self.primary_star_perturbation:
            # remove best-fit mean + slope (`gaia-dr4.jl:207-235`), each a
            # sum over the epochs of one chain
            dt = self.constant("detrend_dt", lambda: self.detrend_dt, like)
            mean_ra = torch.sum(pert_ra, dim=-1, keepdim=True) * self.detrend_inv_N
            slope_ra = torch.sum(dt * pert_ra, dim=-1, keepdim=True) * self.detrend_inv_sum_dt2
            mean_dec = torch.sum(pert_dec, dim=-1, keepdim=True) * self.detrend_inv_N
            slope_dec = torch.sum(dt * pert_dec, dim=-1, keepdim=True) * self.detrend_inv_sum_dt2
            pert_ra = pert_ra - mean_ra - slope_ra * dt
            pert_dec = pert_dec - mean_dec - slope_dec * dt

        ra_off = ra_off + pert_ra
        dec_off = dec_off + pert_dec

        # project onto along-scan + parallax (`gaia-dr4.jl:248-254`)
        psi = col("scan_pos_angle")
        along = (
            ra_off * torch.sin(psi)
            + dec_off * torch.cos(psi)
            + per_epoch(theta.plx, ctx) * col("parallax_factor_al")
        )
        return {
            "along_scan_model": along,
            "ra_offset": ra_off,
            "dec_offset": dec_off,
        }

    def pointwise_ln_like(self, ctx):
        theta_obs = ctx.theta_obs if isinstance(ctx.theta_obs, Params) else Params()
        jit = per_epoch(theta_obs.get("astrometric_jitter", 0.0), ctx)
        sim = self.simulate(ctx)
        like = sim["along_scan_model"]
        col = lambda name: self.column(name, like)  # noqa: E731
        sigma = torch.sqrt(jit**2 + col("centroid_pos_error_al") ** 2)
        lp = gauss_logpdf(like - col("centroid_pos_al"), sigma)
        if "outlier_flag" in self.table:
            keep = self.constant("keep", lambda: self.table["outlier_flag"] <= 0, like) > 0
            lp = torch.where(keep, lp, 0.0)
        return lp

    def ln_like(self, ctx):
        return torch.sum(self.pointwise_ln_like(ctx), dim=-1)

    def generate_from_params(self, ctx, rng, add_noise=False):
        """A copy whose centroids are the model's along-scan positions at one
        parameter set (`ctx` of a single draw), with noise if asked."""
        sim = self.simulate(ctx)
        along = sim["along_scan_model"].detach().cpu().numpy().astype(np.float64)
        table = {k: np.array(v) for k, v in self.table.items()}
        if add_noise:
            along = along + rng.standard_normal(along.shape) * table["centroid_pos_error_al"]
        table["centroid_pos_al"] = along
        new = copy.copy(self)
        new._columns = {}
        new.table = table
        return new

    def likeobj_from_epoch_subset(self, idx):
        new = copy.copy(self)
        new._columns = {}
        new.table = {k: np.asarray(v)[idx] for k, v in self.table.items()}
        new._set_detrend()
        return new


GaiaDR4Astrom = GaiaDR4AstromObs
