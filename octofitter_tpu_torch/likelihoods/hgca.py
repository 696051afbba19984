"""Hipparcos-Gaia Catalog of Accelerations: instantaneous PM model.

PyTorch port of `octofitter_tpu/likelihoods/hgca.py` (the reference's
`HGCAInstantaneousObs`, `hgca.jl`): model the three HGCA proper-motion
measurements (Hipparcos-epoch PM, Gaia-epoch PM, and the Hipparcos-to-
Gaia positional PM) from the host star's reflex motion, averaged over
`N_ave` epochs around each mission epoch, and compare them with the
catalog's three correlated 2-vector blocks.

The chain axis is written out: a solution field is (C, n) over this
observation's n epochs, and each mission average is a product with a
weight matrix over the last axis, (C, n) @ (n, 2) -> (C, 2) (Hipparcos,
Gaia). The three blocks are evaluated as one (C, 3) 2-D Gaussian.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import J2000_MJD, JULIAN_YEAR_DAYS, MJUP2MSOL
from ..distributions import TruncatedNormal
from ..model.params import hasproperty
from ..model.variables import AbstractObs, SystemObservationContext
from ..orbits import ThieleInnesOrbit, VisualOrbit, decoff, pmdec, pmra, raoff
from .utils import gauss2d_logpdf, take_epochs

# EDR3 Gaia observation window in days (`hgca.jl:92`), 4 yr Hipparcos
DT_GAIA = 1038.0
DT_HIP = 4 * JULIAN_YEAR_DAYS

_REQUIRED_KEYS = [
    "pmra_hip", "pmdec_hip", "pmra_hip_error", "pmdec_hip_error", "pmra_pmdec_hip",
    "pmra_gaia", "pmdec_gaia", "pmra_gaia_error", "pmdec_gaia_error", "pmra_pmdec_gaia",
    "pmra_hg", "pmdec_hg", "pmra_hg_error", "pmdec_hg_error", "pmra_pmdec_hg",
    "epoch_ra_hip", "epoch_dec_hip", "epoch_ra_gaia", "epoch_dec_gaia",
]
# the likelihood's blocks, in the reference's order of summation
_BLOCKS = ("hip", "hg", "gaia")


def _jyear_to_mjd(jy):
    return (jy - 2000.0) * JULIAN_YEAR_DAYS + J2000_MJD


def load_hgca(catalog, gaia_id=None, hip_id=None) -> dict:
    """Load one row of the HGCA FITS catalog (e.g. HGCA_vEDR3.fits) as a
    plain dict, selected by `gaia_id` or `hip_id`."""
    from ..io.fits import read_bintable

    tbl = read_bintable(catalog)
    if gaia_id is not None:
        sel = np.nonzero(tbl["gaia_source_id"] == gaia_id)[0]
    elif hip_id is not None:
        sel = np.nonzero(tbl["hip_id"] == hip_id)[0]
    else:
        raise ValueError("specify gaia_id or hip_id")
    if len(sel) == 0:
        raise KeyError("source not found in HGCA catalog")
    i = int(sel[0])
    return {k: (v[i].item() if np.ndim(v[i]) == 0 else v[i]) for k, v in tbl.items()}


def gaia_plx(*, gaia_id=None, catalog=None, hgca_row: dict | None = None):
    """Truncated-Normal parallax prior from the HGCA catalog entry
    (`hgca.jl:10-24`). Provide either a catalog path + gaia_id, or a
    pre-loaded `hgca_row` dict."""
    if hgca_row is None:
        hgca_row = load_hgca(catalog, gaia_id=gaia_id)
    mu = float(hgca_row["parallax_gaia"])
    sig = float(hgca_row["parallax_gaia_error"])
    return TruncatedNormal(mu, sig, mu - 10 * sig, mu + 10 * sig)


class HGCAInstantaneousObs(AbstractObs):
    """HGCA proper-motion-anomaly likelihood, instantaneous model.

    Provide either `hgca=dict(...)` with catalog values (epochs in
    Julian years), or `catalog=path` + `gaia_id` to load from the HGCA
    FITS file. `N_ave` points are averaged over each mission window
    (`hgca.jl:95-103`); `factor` scales the uncertainties.
    """

    def __init__(self, *, gaia_id=None, catalog=None, hgca=None, N_ave=1,
                 factor=1.0, variables=None, name="HGCA"):
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
        self.factor = float(factor)
        self.N_ave = int(N_ave)

        ep = {
            "ra_hip": _jyear_to_mjd(self.hgca["epoch_ra_hip"]),
            "dec_hip": _jyear_to_mjd(self.hgca["epoch_dec_hip"]),
            "ra_gaia": _jyear_to_mjd(self.hgca["epoch_ra_gaia"]),
            "dec_gaia": _jyear_to_mjd(self.hgca["epoch_dec_gaia"]),
        }
        self.epochs_mjd = ep

        if N_ave == 1:
            dts_hip = np.zeros(1)
            dts_gaia = np.zeros(1)
        else:
            dts_hip = np.linspace(-DT_HIP / 2, DT_HIP / 2, N_ave)
            dts_gaia = np.linspace(-DT_GAIA / 2, DT_GAIA / 2, N_ave)

        rows_epoch, rows_meas, rows_inst = [], [], []
        for dt in dts_hip:
            rows_epoch += [ep["ra_hip"] + dt, ep["dec_hip"] + dt]
            rows_meas += [0, 1]  # 0 = ra, 1 = dec
            rows_inst += [0, 0]  # 0 = hip, 1 = gaia
        for dt in dts_gaia:
            rows_epoch += [ep["ra_gaia"] + dt, ep["dec_gaia"] + dt]
            rows_meas += [0, 1]
            rows_inst += [1, 1]
        self.table = {
            "epoch": np.asarray(rows_epoch, dtype=np.float64),
            "meas": np.asarray(rows_meas),
            "inst": np.asarray(rows_inst),
        }
        # NOTE: do NOT epoch-sort; the masks index this exact order.

        # averaging weights per channel over the epochs
        self._masks = {}
        for name_, meas, inst in (
            ("ra_hip", 0, 0), ("dec_hip", 1, 0), ("ra_gaia", 0, 1), ("dec_gaia", 1, 1),
        ):
            m = (self.table["meas"] == meas) & (self.table["inst"] == inst)
            self._masks[name_] = m.astype(np.float64) / m.sum()

    @property
    def epochs(self):
        return self.table["epoch"]

    def _weights(self, coord, like):
        """(n, 2) averaging weights of `coord` ("ra" or "dec"): columns
        Hipparcos, Gaia."""
        return self.constant(
            f"weights_{coord}",
            lambda: np.stack([self._masks[f"{coord}_hip"], self._masks[f"{coord}_gaia"]], axis=1),
            like)

    # ------------------------------------------------------------------
    def simulate(self, ctx: SystemObservationContext):
        """Model PM at Hip/Gaia epochs + HG positional PM
        (`hgca.jl:219-410`); each model is one value per chain."""
        theta = ctx.theta_system
        n = len(self.table["epoch"])

        # sums over planets, (C, 2): columns Hipparcos, Gaia
        pos_ra = pos_dec = pm_ra = pm_dec = theta.pmra.new_zeros(2)
        for j, pname in enumerate(theta.planets.keys()):
            orbit = ctx.orbits[j]
            if not isinstance(orbit, (VisualOrbit, ThieleInnesOrbit)):
                continue
            theta_p = theta.planets[pname]
            if not hasproperty(theta_p, "mass"):
                continue
            m = theta_p.mass * MJUP2MSOL
            sol = take_epochs(ctx.solutions[j], ctx.epoch_start, n)
            ra = raoff(sol, m)
            w_ra, w_dec = self._weights("ra", ra), self._weights("dec", ra)
            # reduce over the epoch axis only: (C, n) @ (n, 2)
            pos_ra = pos_ra + ra @ w_ra
            pos_dec = pos_dec + decoff(sol, m) @ w_dec
            pm_ra = pm_ra + pmra(sol, m) @ w_ra
            pm_dec = pm_dec + pmdec(sol, m) @ w_dec

        ra_hip, ra_gaia = pos_ra.unbind(-1)
        dec_hip, dec_gaia = pos_dec.unbind(-1)
        pmra_hip, pmra_gaia = pm_ra.unbind(-1)
        pmdec_hip, pmdec_gaia = pm_dec.unbind(-1)

        ep = self.epochs_mjd
        return {
            "pmra_hip_model": pmra_hip + theta.pmra,
            "pmdec_hip_model": pmdec_hip + theta.pmdec,
            "pmra_gaia_model": pmra_gaia + theta.pmra,
            "pmdec_gaia_model": pmdec_gaia + theta.pmdec,
            "pmra_hg_model": (ra_gaia - ra_hip) / (ep["ra_gaia"] - ep["ra_hip"])
            * JULIAN_YEAR_DAYS + theta.pmra,
            "pmdec_hg_model": (dec_gaia - dec_hip) / (ep["dec_gaia"] - ep["dec_hip"])
            * JULIAN_YEAR_DAYS + theta.pmdec,
        }

    # ------------------------------------------------------------------
    def ln_like(self, ctx: SystemObservationContext):
        """Sum of the three blocks' 2-D Gaussian log-densities, (C,)."""
        sim = self.simulate(ctx)
        model_ra = torch.stack(torch.broadcast_tensors(
            *(sim[f"pmra_{b}_model"] for b in _BLOCKS)), dim=-1)
        model_dec = torch.stack(torch.broadcast_tensors(
            *(sim[f"pmdec_{b}_model"] for b in _BLOCKS)), dim=-1)
        h, f = self.hgca, self.factor

        def per_block(fmt, scale=1.0):
            return self.constant(
                fmt, lambda: np.array([h[fmt.format(b)] * scale for b in _BLOCKS]), model_ra)

        ll = gauss2d_logpdf(
            model_ra - per_block("pmra_{}"),
            model_dec - per_block("pmdec_{}"),
            per_block("pmra_{}_error", f),
            per_block("pmdec_{}_error", f),
            per_block("pmra_pmdec_{}"),
        )
        return torch.sum(ll, dim=-1)

    def pointwise_ln_like(self, ctx):
        # three independent 2x2 blocks -> treat as one datum
        return self.ln_like(ctx).unsqueeze(-1)

    # ------------------------------------------------------------------
    def generate_from_params(self, ctx, rng, add_noise=False):
        """A copy whose catalog values are the model's at one parameter
        set (`ctx` of a single chain), with catalog noise if asked."""
        sim = self.simulate(ctx)
        h = dict(self.hgca)
        vals = {k.removesuffix("_model"): float(v) for k, v in sim.items()}
        if add_noise:
            for block in ("hip", "gaia", "hg"):
                s1 = h[f"pmra_{block}_error"] * self.factor
                s2 = h[f"pmdec_{block}_error"] * self.factor
                rho_ = h[f"pmra_pmdec_{block}"]
                z1, z2 = rng.standard_normal(2)
                vals[f"pmra_{block}"] += s1 * z1
                vals[f"pmdec_{block}"] += s2 * (
                    rho_ * z1 + np.sqrt(max(1 - rho_**2, 0.0)) * z2
                )
        h.update(vals)
        new = object.__new__(type(self))
        AbstractObs.__init__(new, variables=None, name=self.name)
        new.var_specs = self.var_specs
        new.hgca = h
        new.factor = self.factor
        new.N_ave = self.N_ave
        new.epochs_mjd = self.epochs_mjd
        new.table = self.table
        new._masks = self._masks
        return new

    def likeobj_from_epoch_subset(self, idx):
        return self


HGCAInstantaneousLikelihood = HGCAInstantaneousObs
