"""Hipparcos Intermediate Astrometric Data (IAD) likelihood.

PyTorch port of `octofitter_tpu/astrom/hipparcos.py` (the reference's
`hipparcos.jl`): parse van Leeuwen Java-Tool IAD files, apply the Nielsen
et al. (2020) uncertainty renormalization and the G. Brandt et al. (2021)
corruption correction (numpy, copied), and model each abscissa as the
point-to-line distance between the propagated model position
(AbsoluteVisual barycentric propagation + BINARYS Hippacentre photocentre
perturbations) and the scan line, with the BINARYS first-harmonic sigma
inflation.

Requires planets on an `AbsoluteVisual{KepOrbit}` basis (the model reads
`sol.compensated`), matching the reference (`hipparcos.jl:610`). The chain
axis is written out: the model abscissae are (..., N) over the N scans and
`ln_like` sums over the scans only. The model subtracts the catalog
position from the propagated one in degrees, so it needs float64 (at
ra = 68 deg one float32 step is 27 mas against ~1.5 mas abscissa errors).
"""

from __future__ import annotations

import copy
import itertools
import math
import os

import numpy as np
import torch

from ..constants import (
    HIPPARCOS_EPOCH_MJD,
    IAU_PC2KM,
    JULIAN_YEAR_DAYS,
    MJUP2MSOL,
)
from ..likelihoods.utils import row_shape, take_epochs
from ..model.params import Params, hasproperty
from ..model.variables import AbstractObs
from ..orbits import AbsoluteVisualOrbit
from .ephemeris import geocentre_position_query
from .fitting import prepare_A_4param, prepare_A_5param
from .skypath import hippacentre_combined

_LOG_2PI = math.log(2 * math.pi)


def parse_iad_file(path_or_lines):
    """Parse a van Leeuwen Java-Tool IAD file (`hipparcos.jl:155-226`).

    Returns (hip_sol dict, table dict with iorb/epoch_yrs/parf/cosphi/
    sinphi/res/sres)."""
    if isinstance(path_or_lines, (str, os.PathLike)):
        with open(path_or_lines) as f:
            lines = f.read().splitlines()
    else:
        lines = list(path_or_lines)

    # Header cards sit on fixed lines in the Java Tool format; locate them
    # robustly by prefix instead of index.
    hip_line = next(l for l in lines if l.startswith("HIP"))
    hp_line = next(l for l in lines if l.startswith("Hp"))
    rad_line = next(l for l in lines if l.startswith("radeg"))

    hipvals = [float(x) for x in hip_line.split()[1:]]
    hip, mce, nres, nc, isol_n, sce, f2, f1 = (hipvals + [0.0] * 8)[:8]
    hpvals = [float(x) for x in hp_line.split()[1:]]
    hp, b_m_v, varann, nob, nr = (hpvals + [0.0] * 5)[:5]
    radvals = []
    for x in rad_line.split()[1:]:
        try:
            radvals.append(float(x))
        except ValueError:
            radvals.append(np.nan)
    radvals = (radvals + [np.nan] * 23)[:23]
    (radeg, dedeg, plx, pm_ra, pm_de, e_ra, e_de, e_plx, e_pmra, e_pmde,
     dpmra, dpmde, e_dpmra, e_dpmde, ddpmra, ddpmde, e_ddpmra, e_ddpmde,
     upsra, upsde, e_upsra, e_upsde, var) = radvals

    hip_sol = dict(
        hip=hip, mce=mce, nres=nres, nc=nc, isol_n=isol_n, sce=sce, f2=f2,
        f1=f1, hp=hp, b_m_v=b_m_v, varann=varann, nob=nob, nr=nr,
        radeg=radeg, dedeg=dedeg, plx=plx, pm_ra=pm_ra, pm_de=pm_de,
        e_ra=e_ra, e_de=e_de, e_plx=e_plx, e_pmra=e_pmra, e_pmde=e_pmde,
        dpmra=dpmra, dpmde=dpmde,
    )

    rows = []
    data_started = False
    for line in lines:
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        if len(parts) != 7:
            continue
        try:
            rows.append(
                (int(parts[0]),) + tuple(float(p) for p in parts[1:])
            )
            data_started = True
        except ValueError:
            if data_started:
                break
            continue
    arr = np.asarray(rows, dtype=np.float64)
    table = dict(
        iorb=arr[:, 0].astype(int),
        epoch_yrs=arr[:, 1],
        parf=arr[:, 2],
        cosphi=arr[:, 3],
        sinphi=arr[:, 4],
        res=arr[:, 5],
        sres=arr[:, 6],
    )
    return hip_sol, table


def detect_corruption(table) -> int:
    """Duplicate-AL-error corruption check (`hipparcos.jl:400-427`)."""
    sres = table["sres_renorm"]
    if len(sres) < 4:
        return 0
    last4 = sres[-4:]
    if not np.all(table["iorb"][-4:] == table["iorb"][-4]):
        return 0
    if abs(last4[0] - last4[3]) < 1e-4 and abs(last4[1] - last4[2]) < 0.1:
        return 3
    return 0


def find_best_correction(table, n_corrupt):
    """G. M. Brandt et al. (2021) appendix-A search
    (`hipparcos.jl:436-481`, after htof.parse.find_epochs_to_reject_java):
    choose which orbits to drop so the chi2 stationarity condition is
    best preserved when the trailing duplicated residuals are removed."""
    n = len(table["epoch_yrs"])
    residuals_keep = np.ones(n, bool)
    residuals_keep[n - n_corrupt:] = False
    residual_factors = (table["res"] / table["sres_renorm"] ** 2)[residuals_keep]
    dt = table["epoch_yrs"]
    orbit_factors = np.stack(
        [
            table["parf"],
            table["cosphi"],
            table["sinphi"],
            dt * table["cosphi"],
            dt * table["sinphi"],
        ],
        axis=-1,
    )
    best = None
    best_val = np.inf
    for reject in itertools.combinations(range(n), n_corrupt):
        keep = np.ones(n, bool)
        keep[list(reject)] = False
        of = orbit_factors[keep, :]
        chi2_vec = 2.0 * residual_factors[:, None] * of
        val = math.sqrt(float(np.sum(np.sum(chi2_vec, axis=0) ** 2)))
        if val < best_val:
            best_val = val
            best = reject
    return list(best), best_val


def correct_iad_corruption(table):
    """Apply the correction (`hipparcos.jl:489-536`): drop the chosen
    orbit rows from the scan columns while trimming the duplicated
    trailing residuals."""
    n_corrupt = detect_corruption(table)
    if n_corrupt == 0:
        return table, False
    reject_idx, chi2 = find_best_correction(table, n_corrupt)
    n = len(table["epoch_yrs"])
    mask = np.ones(n, bool)
    mask[reject_idx] = False
    out = dict(
        iorb=table["iorb"][mask],
        epoch_yrs=table["epoch_yrs"][mask],
        parf=table["parf"][mask],
        cosphi=table["cosphi"][mask],
        sinphi=table["sinphi"][mask],
        res=table["res"][: n - n_corrupt],
        sres=table["sres"][: n - n_corrupt],
        reject=table["reject"][: n - n_corrupt],
        sres_renorm=table["sres_renorm"][: n - n_corrupt],
    )
    return out, True


class HipparcosIADObs(AbstractObs):
    """Hipparcos IAD likelihood (`hipparcos.jl:391-556`).

    Provide `iad_file` (path to a Java-Tool .d file) or `hip_id` +
    `iad_dir` (directory layout ResRec_JavaTool_2014/HNNN/HNNNNNN.d).
    Observation variable `fluxratio_hip` (scalar or per-planet array)
    sets the Hp-band companion flux ratios (default 0 = dark).
    """

    def __init__(
        self,
        *,
        iad_file=None,
        hip_id=None,
        iad_dir=None,
        renormalize=True,
        attempt_correction=True,
        ref_epoch_ra=None,
        ref_epoch_dec=None,
        rv_kms=0.0,
        variables=None,
        name="Hipparcos IAD",
        earth_table=None,
    ):
        super().__init__(variables=variables, name=name)
        if iad_file is None:
            if hip_id is None or iad_dir is None:
                raise ValueError("provide iad_file, or hip_id + iad_dir")
            sub = f"H{int(hip_id) // 1000:03d}"
            iad_file = os.path.join(
                iad_dir, "ResRec_JavaTool_2014", sub, f"H{int(hip_id):06d}.d"
            )
        hip_sol, t = parse_iad_file(iad_file)
        self.hip_sol = hip_sol

        t["reject"] = t["sres"] <= 0
        if renormalize:
            # Nielsen et al. 2020 eq. 10 (`hipparcos.jl:229-236`)
            D = len(t["sres"]) - hip_sol["isol_n"]
            G = hip_sol["f2"]
            f = (G * math.sqrt(2 / (9 * D)) + 1 - 2 / (9 * D)) ** 1.5
            t["sres_renorm"] = t["sres"] * f
        else:
            t["sres_renorm"] = np.array(t["sres"])
        if attempt_correction:
            t, _ = correct_iad_corruption(t)

        t["epoch"] = HIPPARCOS_EPOCH_MJD + t["epoch_yrs"] * JULIAN_YEAR_DAYS
        pos = geocentre_position_query(t["epoch"], earth_table)
        t["x"], t["y"], t["z"] = pos["x"], pos["y"], pos["z"]

        # Catalog linear sky path (tangent plane; `hipparcos.jl:333-356`)
        a0 = math.radians(hip_sol["radeg"])
        d0 = math.radians(hip_sol["dedeg"])
        plx0 = hip_sol["plx"]
        dist0 = 1000.0 / plx0
        ddist_pc_dt_day = rv_kms / IAU_PC2KM * 86400.0
        ddist = ddist_pc_dt_day * (t["epoch"] - HIPPARCOS_EPOCH_MJD)
        t["plx_vs_time"] = 1000.0 / (dist0 + ddist)
        dt_yr = (t["epoch"] - HIPPARCOS_EPOCH_MJD) / JULIAN_YEAR_DAYS
        t["dalpha_cat"] = (
            t["plx_vs_time"] * (t["x"] * math.sin(a0) - t["y"] * math.cos(a0))
            + dt_yr * hip_sol["pm_ra"]
        )
        t["ddelta_cat"] = (
            t["plx_vs_time"]
            * (
                t["x"] * math.cos(a0) * math.sin(d0)
                + t["y"] * math.sin(a0) * math.sin(d0)
                - t["z"] * math.cos(d0)
            )
            + dt_yr * hip_sol["pm_de"]
        )
        # Nielsen eq. 3 abscissa points + scan-line endpoints
        # (`hipparcos.jl:359-366`)
        t["alpha_a"] = t["res"] * t["cosphi"] + t["dalpha_cat"]
        t["delta_a"] = t["res"] * t["sinphi"] + t["ddelta_cat"]
        t["alpha_m1"] = -t["sinphi"] + t["alpha_a"]
        t["alpha_m2"] = t["sinphi"] + t["alpha_a"]
        t["delta_m1"] = t["cosphi"] + t["delta_a"]
        t["delta_m2"] = -t["cosphi"] + t["delta_a"]
        t["parallaxFactorAlongScan"] = (
            (t["x"] * math.sin(a0) - t["y"] * math.cos(a0)) * t["cosphi"]
            + (
                t["x"] * math.cos(a0) * math.sin(d0)
                + t["y"] * math.sin(a0) * math.sin(d0)
                - t["z"] * math.cos(d0)
            )
            * t["sinphi"]
        )
        t["proj_meas_alongscan"] = (
            t["res"] + t["dalpha_cat"] * t["cosphi"] + t["ddelta_cat"] * t["sinphi"]
        )
        self.table = t

        if ref_epoch_ra is None:
            ref_epoch_ra = HIPPARCOS_EPOCH_MJD
        if ref_epoch_dec is None:
            ref_epoch_dec = HIPPARCOS_EPOCH_MJD
        self.A_prepared_4 = prepare_A_4param(
            t["epoch"], t["cosphi"], t["sinphi"], ref_epoch_ra, ref_epoch_dec
        )
        self.A_prepared_5 = prepare_A_5param(
            t["epoch"], t["cosphi"], t["sinphi"], t["parallaxFactorAlongScan"],
            ref_epoch_ra, ref_epoch_dec,
        )

    # ------------------------------------------------------------------
    def _flux_ratios(self, ctx, n_planets, like):
        """One flux ratio per planet: `fluxratio_hip` is one value for all
        (a number, or one per row) or one per planet on its last axis."""
        theta_obs = ctx.theta_obs
        if isinstance(theta_obs, Params) and "fluxratio_hip" in theta_obs:
            fr = theta_obs["fluxratio_hip"]
            if fr.ndim == 0 or tuple(fr.shape) == row_shape(ctx):
                return [fr] * n_planets
            return [fr[..., i] for i in range(n_planets)]
        return [like.new_zeros(())] * n_planets

    def simulate(self, ctx):
        """Model abscissa residuals (`hipparcos.jl:558-708`), (..., N)."""
        theta = ctx.theta_system
        n = len(self.table["epoch"])
        orbits = ctx.orbits
        if not isinstance(orbits[0], AbsoluteVisualOrbit):
            raise TypeError(
                "HipparcosIADObs requires planets on the "
                "AbsoluteVisual{KepOrbit} basis"
            )
        sols = [take_epochs(s, ctx.epoch_start, n) for s in ctx.solutions]
        like = sols[0].compensated.ra2
        col = lambda name: self.column(name, like)  # noqa: E731
        pnames = list(theta.planets.keys())
        masses = [
            theta.planets[p].mass * MJUP2MSOL if hasproperty(theta.planets[p], "mass")
            else like.new_zeros(())
            for p in pnames
        ]
        fluxratios = self._flux_ratios(ctx, len(pnames), like)

        cosphi, sinphi = col("cosphi"), col("sinphi")
        d_alpha_pert, d_delta_pert, sigma_infl = hippacentre_combined(
            cosphi, sinphi, sols, masses, fluxratios
        )

        comp = sols[0].compensated
        a = torch.deg2rad(comp.ra2)
        d = torch.deg2rad(comp.dec2)
        x, y, z = col("x"), col("y"), col("z")
        deg2mas = 60.0 * 60.0 * 1000.0
        alpha_model = (comp.ra2 - self.hip_sol["radeg"]) * deg2mas * torch.cos(d) + comp.parallax2 * (
            x * torch.sin(a) - y * torch.cos(a)
        )
        delta_model = (comp.dec2 - self.hip_sol["dedeg"]) * deg2mas + comp.parallax2 * (
            x * torch.cos(a) * torch.sin(d) + y * torch.sin(a) * torch.sin(d) - z * torch.cos(d)
        )
        alpha_model = alpha_model + d_alpha_pert
        delta_model = delta_model + d_delta_pert

        # point-to-line distance (`hipparcos.jl:716-729`)
        a1, d1 = col("alpha_m1"), col("delta_m1")
        a2, d2 = col("alpha_m2"), col("delta_m2")
        num = torch.abs(
            (a2 - a1) * (d1 - delta_model) - (a1 - alpha_model) * (d2 - d1)
        )
        den = torch.hypot(a2 - a1, d2 - d1)
        resid = num / den
        return {
            "alpha_model": alpha_model,
            "delta_model": delta_model,
            "resid": resid,
            "sigma_inflation": sigma_infl,
        }

    def pointwise_ln_like(self, ctx):
        """Each scan's log-density, (..., N); 0 at rejected scans. A
        rejected scan (sres <= 0) takes sigma 1 before the log, so that
        its masked value leaks no NaN into the gradient."""
        sim = self.simulate(ctx)
        like = sim["resid"]
        keep = self.constant("keep", lambda: ~self.table["reject"], like) > 0
        sres = torch.where(keep, self.column("sres_renorm", like), 1.0)
        sigma = sres * sim["sigma_inflation"]
        lp = -0.5 * (sim["resid"] / sigma) ** 2 - torch.log(sigma) - 0.5 * _LOG_2PI
        return torch.where(keep, lp, 0.0)

    def ln_like(self, ctx):
        return torch.sum(self.pointwise_ln_like(ctx), dim=-1)

    def likeobj_from_epoch_subset(self, idx):
        new = copy.copy(self)
        new._columns = {}
        new.table = {k: np.asarray(v)[idx] for k, v in self.table.items()}
        new.A_prepared_4 = self.A_prepared_4[idx]
        new.A_prepared_5 = self.A_prepared_5[idx]
        return new


HipparcosIADLikelihood = HipparcosIADObs
