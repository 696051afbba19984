"""Observer ephemerides for parallax factors and sky-path modeling.

Precise offline replacement for the reference's SPICE/DE440 geocentre
queries (`gaia-utils.jl:101-181`), copied from
`octofitter_tpu/astrom/ephemeris.py` (numpy only): the
default path evaluates the truncated-VSOP87 barycentric Earth from
`vsop87.py` (~1e-5 AU vs DE440, validated in tests/test_ephemeris.py
against the Romer delays and parallax factors in the reference's
shipped ESA GOST / Gaia DR4 files). An explicit `(epoch, x, y, z)`
table still overrides everything, and `observer="gaia"` models the
spacecraft at Sun-Earth L2 — closer to the ESA-published Gaia scan
geometry than the geocentre the reference uses.

Convention matches the reference IAD usage: (x, y, z) is the observer
position relative to the solar-system barycentre in *equatorial J2000*
coordinates, in AU, so the parallax deflections are
  d(alpha*) = plx * (x sin(a) - y cos(a))
  d(delta)  = plx * (x cos(a) sin(d) + y sin(a) sin(d) - z cos(d)).
"""

from __future__ import annotations

import numpy as np

from ..constants import J2000_MJD
from . import vsop87


def earth_position_au_almanac(mjd):
    """Legacy low-precision analytic series (Astronomical Almanac solar
    series, Earth = -Sun geocentric; ~5e-3 AU worst case — no Sun
    barycentric offset). Kept for comparison tests only."""
    mjd = np.asarray(mjd, dtype=np.float64)
    n = mjd - J2000_MJD
    L = np.deg2rad(np.mod(280.460 + 0.9856474 * n, 360.0))
    g = np.deg2rad(np.mod(357.528 + 0.9856003 * n, 360.0))
    lam = L + np.deg2rad(1.915) * np.sin(g) + np.deg2rad(0.020) * np.sin(2 * g)
    R = 1.00014 - 0.01671 * np.cos(g) - 0.00014 * np.cos(2 * g)
    eps = np.deg2rad(23.439 - 4.0e-7 * n)
    xs = R * np.cos(lam)
    ys = R * np.cos(eps) * np.sin(lam)
    zs = R * np.sin(eps) * np.sin(lam)
    return {"x": -xs, "y": -ys, "z": -zs}


def earth_position_au(mjd):
    """Earth geocentre relative to the solar-system barycentre
    (equatorial J2000, AU) — truncated-VSOP87 path, ~1e-5 AU."""
    x, y, z = vsop87.earth_barycentric_xyz(mjd)
    return {"x": x, "y": y, "z": z}


def gaia_position_au(mjd):
    """Gaia spacecraft (Sun-Earth L2 model) relative to the barycentre
    (equatorial J2000, AU); residual is the ~2e-3 AU Lissajous orbit."""
    x, y, z = vsop87.gaia_barycentric_xyz(mjd)
    return {"x": x, "y": y, "z": z}


def earth_position_from_table(mjd, earth_table):
    """Interpolate a user-supplied ephemeris table
    {'epoch','x','y','z'} at the requested epochs."""
    mjd = np.asarray(mjd, dtype=np.float64)
    ep = np.asarray(earth_table["epoch"], dtype=np.float64)
    return {
        k: np.interp(mjd, ep, np.asarray(earth_table[k], dtype=np.float64))
        for k in ("x", "y", "z")
    }


def geocentre_position_query(mjd, earth_table=None, observer="earth",
                             with_velocity=False):
    """Observer (x, y, z) in AU at the given MJD (TDB~TT) epochs.

    observer: "earth" (geocentre; reference behavior, `gaia-utils.jl:
    146-181` spkez(399)) or "gaia" (Sun-Earth L2 spacecraft model —
    more accurate for Gaia scan tables). A user-supplied `earth_table`
    overrides both. with_velocity adds vx/vy/vz in AU/day (reference
    API parity).
    """
    if earth_table is not None:
        pos = earth_position_from_table(mjd, earth_table)
        if with_velocity:
            if all(k in earth_table for k in ("vx", "vy", "vz")):
                mjd_arr = np.asarray(mjd, dtype=np.float64)
                ep = np.asarray(earth_table["epoch"], dtype=np.float64)
                for k in ("vx", "vy", "vz"):
                    pos[k] = np.interp(
                        mjd_arr, ep, np.asarray(earth_table[k], dtype=np.float64)
                    )
            else:
                # Finite difference of the interpolated table. np.interp
                # clamps outside [ep[0], ep[-1]], so shift the stencil to
                # stay inside the table (one-sided at the boundaries)
                # rather than silently halving/zeroing edge velocities.
                h = 0.5  # days
                ep = np.asarray(earth_table["epoch"], dtype=np.float64)
                mjd_arr = np.asarray(mjd, dtype=np.float64)
                t_lo = np.clip(mjd_arr - h, ep[0], max(ep[-1] - 2 * h, ep[0]))
                t_hi = np.minimum(t_lo + 2 * h, ep[-1])
                dt = np.maximum(t_hi - t_lo, 1e-12)
                lo = earth_position_from_table(t_lo, earth_table)
                hi = earth_position_from_table(t_hi, earth_table)
                for k in ("x", "y", "z"):
                    pos["v" + k] = (hi[k] - lo[k]) / dt
        return pos
    if observer == "gaia":
        pos = gaia_position_au(mjd)
    else:
        pos = earth_position_au(mjd)
    if with_velocity:
        if observer == "gaia":
            vx, vy, vz = vsop87.gaia_velocity_au_day(mjd)
        else:
            vx, vy, vz = vsop87.earth_velocity_au_day(mjd)
        pos = dict(pos, vx=vx, vy=vy, vz=vz)
    return pos
