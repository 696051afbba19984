"""Gaia catalog-fit data container.

A copy of `octofitter_tpu/astrom/gaia.py` (numpy only; the reference's
`GaiaCatalogFitObs`, `gaia-utils.jl:838-953`): bundles the
Gaia 5-parameter catalog solution (with its full 5x5 covariance), the
scanning-law table, and prepared design matrices. Consumed by the HGCA
linear-fit likelihood (and the G23H composite model); it has no
standalone ln_like in the reference either.

Nothing is fetched: the catalog row is supplied as a dict (`gaia_sol=`)
and the scan law as a GOST CSV path or table (`scanlaw=`).
"""

from __future__ import annotations

import copy

import numpy as np

from ..model.variables import AbstractObs
from .ephemeris import geocentre_position_query
from .fitting import prepare_A_4param, prepare_A_5param
from .scanlaw import META_GAIA_DR2, META_GAIA_DR3, filter_scan_gaps, load_gost_csv

_GAIA_SOL_KEYS = ("ra", "dec", "parallax", "pmra", "pmdec")


class GaiaCatalogFitObs(AbstractObs):
    def __init__(
        self,
        *,
        gaia_sol: dict,
        scanlaw,
        source_id=0,
        release: str = "dr3",
        ref_epoch_ra=None,
        ref_epoch_dec=None,
        gaps=None,
        gap_files=(),
        earth_table=None,
        observer="gaia",
        variables=None,
        name="GaiaCatalogFit",
    ):
        super().__init__(variables=variables, name=name)
        missing = [k for k in _GAIA_SOL_KEYS if k not in gaia_sol]
        if missing:
            raise ValueError(f"gaia_sol missing keys {missing}")
        self.gaia_sol = dict(gaia_sol)
        self.source_id = source_id

        meta = META_GAIA_DR3 if release == "dr3" else META_GAIA_DR2
        if ref_epoch_ra is None:
            ref_epoch_ra = meta["ref_epoch_mjd"]
        if ref_epoch_dec is None:
            ref_epoch_dec = meta["ref_epoch_mjd"]
        self.ref_epoch_ra = ref_epoch_ra
        self.ref_epoch_dec = ref_epoch_dec

        if isinstance(scanlaw, dict) and "cosphi" in scanlaw:
            table = {k: np.asarray(v) for k, v in scanlaw.items()}
        else:
            table = load_gost_csv(scanlaw)
        table = filter_scan_gaps(table, gaps=gaps, gap_files=gap_files)
        pos = geocentre_position_query(table["epoch"], earth_table,
                               observer=observer)
        table["x"], table["y"], table["z"] = pos["x"], pos["y"], pos["z"]
        self.table = table

        # catalog 5-parameter mean/covariance, parameter order
        # [parallax, ra, dec, pmra, pmdec] (`gaia-utils.jl:857-881`)
        g = self.gaia_sol
        mu = np.asarray(
            [g["parallax"], g["ra"], g["dec"], g["pmra"], g["pmdec"]],
            dtype=np.float64,
        )
        sig = np.asarray(
            [
                g.get("parallax_error", 1.0),
                g.get("ra_error", 1.0) / 60 / 60 / 1000 / np.cos(np.deg2rad(g["dec"])),
                g.get("dec_error", 1.0) / 60 / 60 / 1000,
                g.get("pmra_error", 1.0),
                g.get("pmdec_error", 1.0),
            ],
            dtype=np.float64,
        )
        corr_keys = [
            [None, "ra_parallax_corr", "dec_parallax_corr", "parallax_pmra_corr", "parallax_pmdec_corr"],
            ["ra_parallax_corr", None, "ra_dec_corr", "ra_pmra_corr", "ra_pmdec_corr"],
            ["dec_parallax_corr", "ra_dec_corr", None, "dec_pmra_corr", "dec_pmdec_corr"],
            ["parallax_pmra_corr", "ra_pmra_corr", "dec_pmra_corr", None, "pmra_pmdec_corr"],
            ["parallax_pmdec_corr", "ra_pmdec_corr", "dec_pmdec_corr", "pmra_pmdec_corr", None],
        ]
        C = np.eye(5)
        for i in range(5):
            for j in range(5):
                if i != j:
                    C[i, j] = g.get(corr_keys[i][j], 0.0)
        self.catalog_mean = mu
        self.catalog_cov = np.diag(sig) @ C @ np.diag(sig)

        self.A_prepared_4 = prepare_A_4param(
            table["epoch"], table["cosphi"], table["sinphi"],
            ref_epoch_ra, ref_epoch_dec,
        )
        self.A_prepared_5 = prepare_A_5param(
            table["epoch"], table["cosphi"], table["sinphi"],
            table["parallaxFactorAlongScan"], ref_epoch_ra, ref_epoch_dec,
        )

    def likeobj_from_epoch_subset(self, idx):
        new = copy.copy(self)
        new._columns = {}
        new.table = {k: np.asarray(v)[idx] for k, v in self.table.items()}
        new.A_prepared_4 = self.A_prepared_4[idx]
        new.A_prepared_5 = self.A_prepared_5[idx]
        return new


GaiaCatalogFitLikelihood = GaiaCatalogFitObs
