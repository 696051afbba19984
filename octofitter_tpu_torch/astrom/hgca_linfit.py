"""HGCA likelihood with the full measurement-process (linear-fit) model.

PyTorch port of `octofitter_tpu/astrom/hgca_linfit.py` (the reference's
`HGCAObs`, `hgca-linfit.jl`): simulate per-scan photocentre perturbations
over the Hipparcos IAD scans and the Gaia scanning law, recover the
catalog-equivalent proper-motion offsets by 5-parameter least-squares
fits *of the perturbations*, add them to the (optionally AbsoluteVisual-
propagated) barycentric proper motion, and compare the three HGCA
channels (Hip PM, Gaia PM, Hip-Gaia positional PM) with their correlated
2x2 uncertainty blocks.

The chain axis is written out: the perturbations are (..., n) over each
mission's scans, the fits solve every chain at once (`fitting.py`), and
every model proper motion is one value per chain. `missed_transits`
marginalization is a weight mask in the Gaia fit (zeroed rows), not a
shape change: a `scatter_add_` of the missed transits' indices over the
scans, (..., n_gaia), whose weights make the design matrix per chain where
the indices are.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from ..constants import JULIAN_YEAR_DAYS, MJUP2MSOL
from ..likelihoods.hgca import _REQUIRED_KEYS, _jyear_to_mjd, load_hgca
from ..likelihoods.utils import gauss2d_logpdf, row_shape, take_epochs
from ..model.params import Params, hasproperty
from ..model.variables import AbstractObs, SystemObservationContext
from ..orbits import AbsoluteVisualOrbit, propagate_astrometry
from .fitting import fit_5param
from .gaia import GaiaCatalogFitObs
from .hipparcos import HipparcosIADObs
from .skypath import skypath_perturbations_linear

_DEG2MAS = 60.0 * 60.0 * 1000.0
# the channels' 2-D Gaussians, in the reference's order of summation
_BLOCKS = (("hip", "ra_hip", "dec_hip"), ("hg", "ra_hg", "dec_hg"),
           ("gaia", "ra_gaia", "dec_gaia"))


class HGCAObs(AbstractObs):
    """Full HGCA measurement-process likelihood.

    Parameters:
      hgca: catalog row dict (or catalog= path + gaia_id=)
      hip_like: a HipparcosIADObs (or iad_file= to construct one)
      gaia_like: a GaiaCatalogFitObs (or gaia_sol= + scanlaw= to construct)
      include_iad: include the published IAD residuals in the Hipparcos
        refit (`hgca-linfit.jl:402-406`)
    Observation variable `fluxratio` (one value, or one per planet on its
    last axis) sets companion flux ratios in the photocentre model.
    """

    def __init__(
        self,
        *,
        hgca=None,
        catalog=None,
        gaia_id=None,
        hip_like: HipparcosIADObs | None = None,
        iad_file=None,
        gaia_like: GaiaCatalogFitObs | None = None,
        gaia_sol=None,
        scanlaw=None,
        include_iad=True,
        variables=None,
        name="HGCA",
    ):
        super().__init__(variables=variables, name=name)
        if hgca is None:
            hgca = load_hgca(catalog, gaia_id=gaia_id)
        missing = [k for k in _REQUIRED_KEYS if k not in hgca]
        if missing:
            raise ValueError(f"HGCA row missing keys: {missing}")
        self.hgca = {k: float(np.asarray(v)) for k, v in hgca.items()
                     if np.ndim(v) == 0 or np.size(v) == 1}
        self.hgca.setdefault("nonlinear_dpmra", 0.0)
        self.hgca.setdefault("nonlinear_dpmdec", 0.0)
        self.include_iad = include_iad

        self.epochs_mjd = {
            "ra_hip": _jyear_to_mjd(self.hgca["epoch_ra_hip"]),
            "dec_hip": _jyear_to_mjd(self.hgca["epoch_dec_hip"]),
            "ra_gaia": _jyear_to_mjd(self.hgca["epoch_ra_gaia"]),
            "dec_gaia": _jyear_to_mjd(self.hgca["epoch_dec_gaia"]),
        }

        if hip_like is None:
            if iad_file is None:
                raise ValueError("provide hip_like or iad_file")
            hip_like = HipparcosIADObs(
                iad_file=iad_file,
                ref_epoch_ra=self.epochs_mjd["ra_hip"],
                ref_epoch_dec=self.epochs_mjd["dec_hip"],
            )
        if gaia_like is None:
            if gaia_sol is None or scanlaw is None:
                raise ValueError("provide gaia_like or gaia_sol + scanlaw")
            gaia_like = GaiaCatalogFitObs(
                gaia_sol=gaia_sol,
                scanlaw=scanlaw,
                ref_epoch_ra=self.epochs_mjd["ra_gaia"],
                ref_epoch_dec=self.epochs_mjd["dec_gaia"],
            )
        self.hip_like = hip_like
        self.gaia_like = gaia_like
        # channels included (subset at whole-channel granularity,
        # `hgca-linfit.jl:198`)
        self.kinds = ["ra_hip", "dec_hip", "ra_gaia", "dec_gaia", "ra_hg", "dec_hg"]

        self.n_hip = len(hip_like.table["epoch"])
        self.n_gaia = len(gaia_like.table["epoch"])
        self.table = {
            "epoch": np.concatenate(
                [hip_like.table["epoch"], gaia_like.table["epoch"]]
            )
        }

    @property
    def epochs(self):
        return self.table["epoch"]

    # ------------------------------------------------------------------
    def _fluxratio(self, ctx, i, like):
        theta_obs = ctx.theta_obs
        if isinstance(theta_obs, Params) and "fluxratio" in theta_obs:
            fr = theta_obs["fluxratio"]
            if fr.ndim == 0 or tuple(fr.shape) == row_shape(ctx):
                return fr
            return fr[..., i]
        return like.new_zeros(())

    def _propagate_astrom(self, orbit, mission, theta, like):
        """(`hgca-linfit.jl:329-347`) propagated (ra, dec, pmra, pmdec) at
        one mission's channel epochs, with the differential light-travel
        apparent acceleration for AbsoluteVisual orbits. The barycentre is
        propagated to the two epochs and to 100 days after the later one
        in one call; the reference solves the whole orbit at each, but
        reads only the propagated astrometry."""
        if isinstance(orbit, AbsoluteVisualOrbit):
            epoch_ra = self.epochs_mjd[f"ra_{mission}"]
            epoch_dec = self.epochs_mjd[f"dec_{mission}"]
            dt = 100.0
            t = self.constant(f"propagate_{mission}", lambda: np.array(
                [epoch_ra, epoch_dec, max(epoch_ra, epoch_dec) + dt]), like)
            comp = propagate_astrometry(orbit, t)
            late = 0 if epoch_ra >= epoch_dec else 1
            lt_fac = (comp.t_em_days[..., 2] - comp.t_em_days[..., late] - dt) / dt
            pmra = comp.pmra2[..., 0] + lt_fac * comp.pmra2[..., late]
            pmdec = comp.pmdec2[..., 1] + lt_fac * comp.pmdec2[..., late]
            return comp.ra2[..., 0], comp.dec2[..., 1], pmra, pmdec
        zero = like.new_zeros(())
        return zero, zero, theta.pmra, theta.pmdec

    def _perturbations(self, ctx, start, n, like):
        """The summed photocentre perturbations of every planet over n
        scans from `start`: (d_alpha, d_delta), (..., n)."""
        theta = ctx.theta_system
        dalpha = ddelta = like.new_zeros(n)
        for i, pname in enumerate(theta.planets.keys()):
            theta_p = theta.planets[pname]
            m = theta_p.mass * MJUP2MSOL if hasproperty(theta_p, "mass") else like.new_zeros(())
            sol = take_epochs(ctx.solutions[i], ctx.epoch_start + start, n)
            da, dd = skypath_perturbations_linear(
                sol, ctx.orbits[i], m, self._fluxratio(ctx, i, like))
            dalpha = dalpha + da
            ddelta = ddelta + dd
        return dalpha, ddelta

    def _missed_transit_weights(self, theta, like):
        """(weights (..., n_gaia), bad_duplicates (...)): weight 0 at the
        scans `missed_transits` names, and True where it names one twice
        (`hgca-linfit.jl:308-322`); indices outside the scans are ignored."""
        n_g = self.n_gaia
        mt = torch.as_tensor(theta.missed_transits, device=like.device).long()
        valid = ((mt >= 0) & (mt < n_g)).to(like.dtype)
        counts = like.new_zeros(mt.shape[:-1] + (n_g,)).scatter_add_(
            -1, mt.clamp(0, n_g - 1), valid)
        return torch.where(counts > 0, 0.0, 1.0).to(like.dtype), (counts > 1).any(dim=-1)

    def simulate(self, ctx: SystemObservationContext):
        theta = ctx.theta_system
        absolute = isinstance(ctx.orbits[0], AbsoluteVisualOrbit)
        like = ctx.solutions[0].raoff_mas
        const = lambda name, make: self.constant(name, make, like)  # noqa: E731

        # ---- Gaia window -------------------------------------------------
        gt = self.gaia_like.table
        dalpha_g, ddelta_g = self._perturbations(ctx, self.n_hip, self.n_gaia, like)
        # missed_transits marginalization as a weight mask
        # (`hgca-linfit.jl:308-322`): zeroed rows drop out of the LSQ.
        weights, bad_duplicates = None, torch.zeros((), dtype=torch.bool, device=like.device)
        if hasproperty(theta, "missed_transits"):
            weights, bad_duplicates = self._missed_transit_weights(theta, like)

        out_g = fit_5param(
            const("A5_gaia", lambda: self.gaia_like.A_prepared_5),
            const("cosphi_gaia", lambda: gt["cosphi"]), const("sinphi_gaia", lambda: gt["sinphi"]),
            dalpha_g, ddelta_g, weights=weights)
        da_g, dd_g, dpmra_g, dpmdec_g, _ = out_g["parameters"]
        ra_g0, dec_g0, pmra_g0, pmdec_g0 = self._propagate_astrom(
            ctx.orbits[0], "gaia", theta, like)
        mu_g = [pmra_g0 + dpmra_g, pmdec_g0 + dpmdec_g]

        # ---- Hipparcos window -------------------------------------------
        ht = self.hip_like.table
        dalpha_h, ddelta_h = self._perturbations(ctx, 0, self.n_hip, like)
        hip_cols = (const("A5_hip", lambda: self.hip_like.A_prepared_5),
                    const("cosphi_hip", lambda: ht["cosphi"]),
                    const("sinphi_hip", lambda: ht["sinphi"]), dalpha_h, ddelta_h)
        if self.include_iad:
            out_h = fit_5param(*hip_cols, residuals=const("res_hip", lambda: ht["res"]),
                               sigma=const("sres_hip", lambda: ht["sres"]))
        else:
            out_h = fit_5param(*hip_cols)
        da_h, dd_h, dpmra_h, dpmdec_h, _ = out_h["parameters"]
        ra_h0, dec_h0, pmra_h0, pmdec_h0 = self._propagate_astrom(
            ctx.orbits[0], "hip", theta, like)
        mu_h = [pmra_h0 + dpmra_h, pmdec_h0 + dpmdec_h]

        # ---- HG positional PM -------------------------------------------
        ep = self.epochs_mjd
        if absolute:
            d_ra_prop = (ra_g0 - ra_h0) * _DEG2MAS * torch.cos(
                torch.deg2rad((dec_g0 + dec_h0) / 2)
            )
            d_dec_prop = (dec_g0 - dec_h0) * _DEG2MAS
            pmra_hg = (da_g - da_h + d_ra_prop) / (
                ep["ra_gaia"] - ep["ra_hip"]
            ) * JULIAN_YEAR_DAYS
            pmdec_hg = (dd_g - dd_h + d_dec_prop) / (
                ep["dec_gaia"] - ep["dec_hip"]
            ) * JULIAN_YEAR_DAYS
        else:
            pmra_hg = (da_g - da_h) / (
                ep["ra_gaia"] - ep["ra_hip"]
            ) * JULIAN_YEAR_DAYS + theta.pmra
            pmdec_hg = (dd_g - dd_h) / (
                ep["dec_gaia"] - ep["dec_hip"]
            ) * JULIAN_YEAR_DAYS + theta.pmdec
        mu_hg = [pmra_hg, pmdec_hg]

        # frame adjustment: pmra/pmdec refer to the primary at the Gaia
        # epoch (`hgca-linfit.jl:434-441`)
        dpm_g = (dpmra_g, dpmdec_g)
        mu_h = [mu - d for mu, d in zip(mu_h, dpm_g)]
        mu_hg = [mu - d for mu, d in zip(mu_hg, dpm_g)]
        mu_g = [mu - d for mu, d in zip(mu_g, dpm_g)]

        return {
            "mu_g": mu_g,
            "mu_h": mu_h,
            "mu_hg": mu_hg,
            "dpmra_g": dpmra_g,
            "dpmdec_g": dpmdec_g,
            "bad_duplicates": bad_duplicates,
            "absolute": absolute,
        }

    # ------------------------------------------------------------------
    def ln_like(self, ctx: SystemObservationContext):
        sim = self.simulate(ctx)
        h = self.hgca
        mu = {"hip": sim["mu_h"], "hg": sim["mu_hg"], "gaia": sim["mu_g"]}
        like = mu["hip"][0]
        const = lambda key: self.constant(key, lambda: h[key], like)  # noqa: E731

        # nonlinear correction only applies when we propagate ourselves
        # (`hgca-linfit.jl:237-255`)
        if sim["absolute"]:
            nonlinear = (h["nonlinear_dpmra"], h["nonlinear_dpmdec"])
            mu["hg"] = [m + c for m, c in zip(mu["hg"], nonlinear)]
            mu["hip"] = [m + 2 * c for m, c in zip(mu["hip"], nonlinear)]

        ll = 0.0
        for block, kind_ra, kind_dec in _BLOCKS:
            if kind_ra in self.kinds and kind_dec in self.kinds:
                ll = ll + gauss2d_logpdf(
                    mu[block][0] - h[f"pmra_{block}"], mu[block][1] - h[f"pmdec_{block}"],
                    const(f"pmra_{block}_error"), const(f"pmdec_{block}_error"),
                    const(f"pmra_pmdec_{block}"),
                )
        return torch.where(sim["bad_duplicates"], -torch.inf, ll)

    def pointwise_ln_like(self, ctx):
        return self.ln_like(ctx).unsqueeze(-1)

    def generate_from_params(self, ctx, rng, add_noise=False):
        """A copy whose catalog values are the model's proper motions at one
        parameter set (`ctx` of a single draw), with catalog noise if asked
        (`hgca-linfit.jl:462-...`)."""
        sim = self.simulate(ctx)
        h = dict(self.hgca)
        vals = {
            "pmra_hip": float(sim["mu_h"][0]),
            "pmdec_hip": float(sim["mu_h"][1]),
            "pmra_gaia": float(sim["mu_g"][0]),
            "pmdec_gaia": float(sim["mu_g"][1]),
            "pmra_hg": float(sim["mu_hg"][0]),
            "pmdec_hg": float(sim["mu_hg"][1]),
        }
        if add_noise:
            for block in ("hip", "gaia", "hg"):
                s1 = h[f"pmra_{block}_error"]
                s2 = h[f"pmdec_{block}_error"]
                rho = h[f"pmra_pmdec_{block}"]
                z1, z2 = rng.standard_normal(2)
                vals[f"pmra_{block}"] += s1 * z1
                vals[f"pmdec_{block}"] += s2 * (
                    rho * z1 + math.sqrt(max(1 - rho**2, 0.0)) * z2
                )
        h.update(vals)
        new = copy.copy(self)
        new._columns = {}
        new.hgca = h
        return new

    def likeobj_from_epoch_subset(self, idx):
        # subsetting at whole-channel granularity
        new = copy.copy(self)
        new._columns = {}
        new.kinds = [self.kinds[i] for i in np.atleast_1d(idx)]
        return new


HGCALikelihood = HGCAObs
