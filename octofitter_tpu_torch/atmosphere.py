"""Atmosphere / evolution model grids.

PyTorch port of `octofitter_tpu/atmosphere.py` (the reference's
`src/sonora.jl` and `src/BHAC.jl`): differentiable interpolators over the
Sonora Bobcat photometry and cooling grids and the BHAC15 isochrones. The
reference's workflow (RBF fit of the sparse model grid -> dense regular
grid -> fast linear interpolation, autodiff-safe) is kept: the RBF
gridding runs once on the host through scipy, the file parsers are numpy
copies, and the bilinear lookup is torch, differentiable in both
coordinates and batched over any shape of points (one per chain).

Data files are the standard published model grids (the reference
downloads them via DataDeps); pass local paths here.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .constants import MJUP2MSOL


def interp2d_bilinear(xgrid, ygrid, values):
    """Return a differentiable f(x, y) bilinear interpolator over a regular
    grid (`values[i, j]` at `xgrid[i]`, `ygrid[j]`); out-of-domain -> NaN
    (matching the reference's extrapolation_bc=NaN). x and y are tensors of
    one broadcast shape (numbers become float64 on the CPU); the grid is
    moved to their dtype and device once per pair."""
    xgrid = np.asarray(xgrid, dtype=np.float64)
    ygrid = np.asarray(ygrid, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    nx, ny = values.shape
    x0, x1, y0, y1 = float(xgrid[0]), float(xgrid[-1]), float(ygrid[0]), float(ygrid[-1])
    grids = {}

    def f(x, y):
        x = torch.as_tensor(x, dtype=torch.float64) if not isinstance(x, torch.Tensor) else x
        y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
        key = (x.dtype, x.device)
        if key not in grids:
            grids[key] = torch.as_tensor(values, dtype=x.dtype, device=x.device)
        v_grid = grids[key]
        x, y = torch.broadcast_tensors(x, y)
        fx = (x - x0) / (x1 - x0) * (nx - 1)
        fy = (y - y0) / (y1 - y0) * (ny - 1)
        i = torch.clamp(torch.floor(fx).long(), 0, nx - 2)
        j = torch.clamp(torch.floor(fy).long(), 0, ny - 2)
        tx = torch.clamp(fx - i, 0.0, 1.0)
        ty = torch.clamp(fy - j, 0.0, 1.0)
        v = (
            v_grid[i, j] * (1 - tx) * (1 - ty)
            + v_grid[i + 1, j] * tx * (1 - ty)
            + v_grid[i, j + 1] * (1 - tx) * ty
            + v_grid[i + 1, j + 1] * tx * ty
        )
        inside = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
        return torch.where(inside, v, torch.nan)

    return f


def _rbf_to_grid(points, samples, xg, yg, epsilon=2.0):
    from scipy.interpolate import RBFInterpolator

    rbf = RBFInterpolator(points, samples, kernel="multiquadric", epsilon=epsilon)
    XX, YY = np.meshgrid(xg, yg, indexing="ij")
    flat = np.stack([XX.reshape(-1), YY.reshape(-1)], axis=-1)
    return rbf(flat).reshape(XX.shape)


# ---------------------------------------------------------------------------
_SONORA_MAG_COLS = [
    "Teff", "logg", "mass", "R_Rsun", "Y", "logKzz",
    "MKO_Y", "MKO_Z", "MKO_J", "MKO_H", "MKO_K", "MKO_Lp", "MKO_Mp",
    "TwoMASS_J", "TwoMASS_H", "TwoMASS_Ks",
    "Keck_Ks", "Keck_Lp", "Keck_Ms",
    "SDSS_gp", "SDSS_rp", "SDSS_ip", "SDSS_zp",
    "IRAC_36", "IRAC_45", "IRAC_57", "IRAC_79",
    "WISE_W1", "WISE_W2", "WISE_W3", "WISE_W4",
]


def _normalize_band(band: str) -> str:
    return band.replace("′", "p").replace("'", "p").replace(":", "")


def load_sonora_mag_table(path) -> dict:
    """Parse a Sonora Bobcat `mag_table±x.x` photometry file."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < len(_SONORA_MAG_COLS):
                continue
            try:
                rows.append([float(p) for p in parts[: len(_SONORA_MAG_COLS)]])
            except ValueError:
                continue
    arr = np.asarray(rows)
    if arr.size == 0:
        raise ValueError(f"No data rows parsed from {path}")
    return {c: arr[:, i] for i, c in enumerate(_SONORA_MAG_COLS)}


def sonora_photometry_interpolator(band, catalog, metalicity="+0.0"):
    """(temperature_K, mass_Mjup) -> absolute magnitude in `band`
    (`sonora.jl:22-62`). `catalog` is the path to the photometry table
    file (e.g. `.../photometry_tables/mag_table+0.0`)."""
    band = _normalize_band(str(band))
    table = load_sonora_mag_table(catalog)
    if band not in table:
        raise KeyError(f"not a valid band: {band}; have {list(table)[6:]}")
    pts = np.stack([table["Teff"] / 10.0, table["mass"]], axis=-1)
    samples = table[band]
    tg = np.linspace(table["Teff"].min(), table["Teff"].max(), 200)
    mg = np.linspace(table["mass"].min(), table["mass"].max(), 200)
    grid = _rbf_to_grid(pts, samples, tg / 10.0, mg, epsilon=2.0)
    f = interp2d_bilinear(tg, mg, grid)
    return lambda teff_k, mass_mjup: f(teff_k, mass_mjup)


def sonora_cooling_interpolator(catalog, metalicity="+0.0"):
    """(age_Myr, mass_Mjup) -> Teff_K (`sonora.jl:66-130`). `catalog`
    is the path to an evolution `nc+0.0_co1.0_age` style table."""
    rows = []
    with open(catalog) as f:
        lines = [l for l in f if len(l.strip()) > 10]
    header = re.split(r"  +", lines[0].strip())
    header = [re.sub(r"\W", "", h).lower() for h in header][:6]
    for line in lines[1:]:
        parts = re.split(r"  +", line.strip())
        try:
            rows.append([float(p) for p in parts[:6]])
        except ValueError:
            continue
    arr = np.asarray(rows)
    cols = {h: arr[:, i] for i, h in enumerate(header)}
    age_myr = cols["agegyr"] * 1e3
    m_mjup = cols["mmsun"] / MJUP2MSOL
    teff = cols["teffk"]
    pts = np.stack([np.log(age_myr), m_mjup], axis=-1)
    ag = np.linspace(age_myr.min(), age_myr.max(), 2000)
    mg = np.linspace(m_mjup.min(), m_mjup.max(), 500)
    grid = _rbf_to_grid(pts, teff, np.log(ag), mg, epsilon=0.5)
    f = interp2d_bilinear(ag, mg, grid)
    return lambda age_myr_, mass_mjup: f(age_myr_, mass_mjup)


# ---------------------------------------------------------------------------
def load_bhac15(path) -> list[dict]:
    """Parse a BHAC15 track file into per-age record dicts
    (`BHAC.jl:4-105`)."""
    with open(path) as f:
        lines = f.read().splitlines()
    records = []
    age_gyr = None
    colnames = None
    block = []

    def flush():
        nonlocal block
        if age_gyr is not None and colnames and block:
            arr = np.asarray(block)
            rec = {c: arr[:, i] for i, c in enumerate(colnames[: arr.shape[1]])}
            rec["age_Gyr"] = np.full(arr.shape[0], age_gyr)
            records.append(rec)
        block = []

    for i, line in enumerate(lines):
        if "t (Gyr)" in line:
            flush()
            age_gyr = float(line.split("=")[-1])
            colnames = None
            continue
        if age_gyr is not None and colnames is None and re.search(r"M/Ms", line):
            colnames = [re.sub(r"\W", "_", c) for c in re.findall(r"[\w\./]+", line)]
            continue
        if age_gyr is not None and colnames:
            parts = line.split()
            try:
                block.append([float(p) for p in parts])
            except ValueError:
                continue
    flush()
    return records


def bhac15_mass_age_interpolator(path, column="Teff"):
    """(age_Myr, mass_Msun) -> `column` from the BHAC15 isochrones."""
    records = load_bhac15(path)
    ages, masses, vals = [], [], []
    for rec in records:
        key = column if column in rec else [k for k in rec if column in k][0]
        mcol = "M_Ms" if "M_Ms" in rec else list(rec.keys())[0]
        ages.append(rec["age_Gyr"] * 1e3)
        masses.append(rec[mcol])
        vals.append(rec[key])
    age = np.concatenate(ages)
    mass = np.concatenate(masses)
    val = np.concatenate(vals)
    pts = np.stack([np.log(age), mass], axis=-1)
    ag = np.linspace(age.min(), age.max(), 500)
    mg = np.linspace(mass.min(), mass.max(), 300)
    grid = _rbf_to_grid(pts, val, np.log(ag), mg, epsilon=0.5)
    f = interp2d_bilinear(ag, mg, grid)
    return lambda age_myr, mass_msun: f(age_myr, mass_msun)
