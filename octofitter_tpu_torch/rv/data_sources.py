"""RV archive data loaders.

A copy of `octofitter_tpu/rv/data_sources.py` for the port (numpy, and
pandas imported inside the loaders, so that importing the package never
needs it), with `radvel_posterior` drawing from the port's distributions.
Equivalent of `OctofitterRadialVelocity/src/data-sources/` (HARPS RVBank,
HARPS DR1, HIRES, Lick, CES) and `compat/radvel.jl`. The reference
downloads the archives through DataDeps (`OctofitterRadialVelocity.jl:44-147`);
here each loader takes a local path to the published archive file and
returns an `(epoch, rv, σ_rv)` table ready for `StarAbsoluteRVObs`.
"""

from __future__ import annotations

import numpy as np

from ..constants import jd2mjd, KEPLER_YEAR_DAYS


def _load_csv(path):
    import pandas as pd

    return pd.read_csv(path)


def _match_target(df, target, col="target"):
    sel = df[df[col] == target]
    if len(sel) == 0:
        import difflib

        options = sorted(set(map(str, df[col].dropna())))
        close = difflib.get_close_matches(target, options, n=3)
        raise KeyError(
            f"No results for target {target!r}. Similar available names: {close}"
        )
    return sel


def HARPS_RVBank_rvs(target, catalog):
    """HARPS RVBank ver02 (`harps_rvbank.jl:26-38`): returns mlc_nzp RVs."""
    df = _match_target(_load_csv(catalog), target)
    return dict(
        epoch=jd2mjd(np.asarray(df["BJD"], dtype=float)),
        rv=np.asarray(df["RV_mlc_nzp"], dtype=float),
        σ_rv=np.asarray(df["e_RV_mlc_nzp"], dtype=float),
    )


def HARPS_RVBank_observations(target, catalog):
    return _match_target(_load_csv(catalog), target)


def HARPS_DR1_rvs(target, catalog):
    """HARPS DR1 re-reduction archive."""
    df = _match_target(_load_csv(catalog), target)
    bjd_col = "BJD" if "BJD" in df.columns else "bjd"
    rv_col = "RV" if "RV" in df.columns else "rv"
    err_col = "e_RV" if "e_RV" in df.columns else "σ_rv"
    return dict(
        epoch=jd2mjd(np.asarray(df[bjd_col], dtype=float)),
        rv=np.asarray(df[rv_col], dtype=float),
        σ_rv=np.asarray(df[err_col], dtype=float),
    )


def _generic_rvs(target, catalog, target_col, jd_col, rv_col, err_col):
    df = _match_target(_load_csv(catalog), target, col=target_col)
    return dict(
        epoch=jd2mjd(np.asarray(df[jd_col], dtype=float)),
        rv=np.asarray(df[rv_col], dtype=float),
        σ_rv=np.asarray(df[err_col], dtype=float),
    )


def HIRES_rvs(target, catalog):
    """Keck/HIRES archive (Butler et al. 2017 format)."""
    df = _load_csv(catalog)
    tcol = "Star" if "Star" in df.columns else "target"
    jd = "BJD" if "BJD" in df.columns else "JD"
    rv = "RV" if "RV" in df.columns else "mnvel"
    er = "e_RV" if "e_RV" in df.columns else "errvel"
    return _generic_rvs(target, catalog, tcol, jd, rv, er)


def Lick_rvs(target, catalog):
    """Lick planet-search archive (Fischer et al. 2014 format)."""
    df = _load_csv(catalog)
    tcol = "Star" if "Star" in df.columns else "target"
    jd = "BJD" if "BJD" in df.columns else "JD"
    rv = "RV" if "RV" in df.columns else "mnvel"
    er = "e_RV" if "e_RV" in df.columns else "errvel"
    return _generic_rvs(target, catalog, tcol, jd, rv, er)


def CES_lc_rvs(target, catalog):
    """CES long camera archive."""
    return _generic_rvs(target, catalog, "target", "BJD", "RV", "e_RV")


def CES_vlc_rvs(target, catalog):
    """CES very-long camera archive."""
    return _generic_rvs(target, catalog, "target", "BJD", "RV", "e_RV")


def radvel_posterior(table, M_prior, plx_prior, *, seed=0, tau_ref_epoch=58849.0,
                     device="cuda"):
    """Convert a RadVel posterior table into a Chains object
    (`compat/radvel.jl`): derive msini, a, tp from (per1, k1, e1, w1,
    tc/tp1) with stellar mass and parallax drawn from the supplied priors
    (the port's distributions) by a `torch.Generator` on `device` seeded
    with `seed`: the GPU unless the caller says device="cpu"."""
    import torch

    from ..chains import Chains
    from ..constants import AUDAY_TO_MS, MJUP2MSOL

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("radvel_posterior was asked for a CUDA device, but none is "
                           "available; pass device=\"cpu\"")
    if not isinstance(table, dict):
        table = {c: np.asarray(table[c]) for c in table.columns}
    n = len(table["k1"])
    generator = torch.Generator(device=device).manual_seed(seed)
    M_star = M_prior.sample(generator, (n,), torch.float64).cpu().numpy()
    plx = plx_prior.sample(generator, (n,), torch.float64).cpu().numpy()

    K = np.asarray(table["k1"], dtype=float)          # m/s
    P_days = np.asarray(table["per1"], dtype=float)
    e = np.asarray(table["e1"], dtype=float) if "e1" in table else np.zeros(n)
    w = np.asarray(table["w1"], dtype=float) if "w1" in table else np.zeros(n)
    # msini from the RV mass function (planet mass << M_star)
    P_kepler_yr = P_days / KEPLER_YEAR_DAYS
    a = np.cbrt(M_star * P_kepler_yr**2)
    K_auday = K / AUDAY_TO_MS
    msini_msol = K_auday * np.sqrt(1 - e**2) * M_star * P_days / (2 * np.pi * a)
    msini_mjup = msini_msol / MJUP2MSOL

    data = {
        "M": M_star,
        "plx": plx,
        "b_P": P_days,
        "b_a": a,
        "b_e": e,
        "b_omega": w,
        "b_msini": msini_mjup,
    }
    if "tp1" in table:
        data["b_tp"] = jd2mjd(np.asarray(table["tp1"], dtype=float))
    return Chains({k: v[None, :] for k, v in data.items()}, {}, {"sampler": "radvel"})
