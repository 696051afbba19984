"""Precision offline Earth/Sun-system ephemeris (truncated VSOP87).

A copy of `octofitter_tpu/astrom/vsop87.py` (numpy only), the offline
replacement for the reference's SPICE/DE440 geocentre queries
(`gaia-utils.jl:101-181`, `spkez(399,...)`)
with no kernel downloads: everything below is an analytic series
evaluated host-side with numpy (the ephemeris feeds *data tables*, never
the jitted likelihood hot path).

Composition of the barycentric Earth geocentre position:

  r_earth(bary, eq J2000) = r_sun(bary) + r_earth(helio)

1. ``r_earth(helio)`` — truncated VSOP87D series for the Earth
   (Bretagnon & Francou 1988, in the widely reprinted truncation of
   Meeus, *Astronomical Algorithms* ch. 32), heliocentric ecliptic of
   date, rotated to the equatorial J2000 frame via the mean obliquity
   and the IAU-1976 precession angles. The series is for the Earth
   *proper* — the lunar-inequality terms (e.g. the L0/R0 terms at
   77713.77 rad/millennium, the synodic beat of the Earth's motion
   about the Earth-Moon barycentre) are included — so no separate Moon
   correction is applied. Truncation error ~5e-6 AU.
2. ``r_sun(bary)`` — the Sun's offset from the solar-system barycentre,
   from the mass-weighted heliocentric positions of the eight planets
   propagated with the standard mean Keplerian elements (Standish,
   "Keplerian elements for approximate positions of the major planets",
   valid 1800-2050 AD). Dominated by Jupiter/Saturn (the offset itself
   reaches ~0.01 AU); element errors contribute <2e-6 AU.

Total error budget vs DE440: ~1e-5 AU, validated externally in
the JAX package's `tests/test_ephemeris.py` against (a) the Romer delays implied by the
reference's shipped ESA GOST forecast CSVs (ObservationTimeAtGaia vs
ObservationTimeAtBarycentre) and (b) the parallax factors in those CSVs
and in the ESA Gaia DR4 epoch-astrometry file.

``gaia_position_au`` additionally models the Gaia spacecraft at the
Sun-Earth L2 point (radial scaling of the heliocentric Earth vector by
1 + (m/(3 M))^(1/3)); the remaining error is Gaia's Lissajous orbit
about L2, amplitude ~2e-3 AU — still ~5x closer to the ESA-published
scan geometry than the Earth geocentre the reference uses.

All epochs are MJD on the TDB (~TT) scale unless noted; the ~70 s
UTC/TCB offsets move the Earth by <2e-5 AU and helpers are provided.
"""

from __future__ import annotations

import numpy as np

MJD2000 = 51544.5  # J2000.0 = JD 2451545.0 = MJD 51544.5 (TDB)

# ----------------------------------------------------------------------
# Truncated VSOP87D series for the Earth (heliocentric, ecliptic of
# date). Units: amplitude 1e-8 rad (L, B) / 1e-8 AU (R); phase rad;
# frequency rad per Julian millennium from J2000.0 TDB.
# ----------------------------------------------------------------------

_L0 = np.array([
    [175347046.0, 0.0, 0.0],
    [3341656.0, 4.6692568, 6283.0758500],
    [34894.0, 4.62610, 12566.15170],
    [3497.0, 2.7441, 5753.3849],
    [3418.0, 2.8289, 3.5231],
    [3136.0, 3.6277, 77713.7715],
    [2676.0, 4.4181, 7860.4194],
    [2343.0, 6.1352, 3930.2097],
    [1324.0, 0.7425, 11506.7698],
    [1273.0, 2.0371, 529.6910],
    [1199.0, 1.1096, 1577.3435],
    [990.0, 5.233, 5884.927],
    [902.0, 2.045, 26.298],
    [857.0, 3.508, 398.149],
    [780.0, 1.179, 5223.694],
    [753.0, 2.533, 5507.553],
    [505.0, 4.583, 18849.228],
    [492.0, 4.205, 775.523],
    [357.0, 2.920, 0.067],
    [317.0, 5.849, 11790.629],
    [284.0, 1.899, 796.298],
    [271.0, 0.315, 10977.079],
    [243.0, 0.345, 5486.778],
    [206.0, 4.806, 2544.314],
    [205.0, 1.869, 5573.143],
    [202.0, 2.458, 6069.777],
    [156.0, 0.833, 213.299],
    [132.0, 3.411, 2942.463],
    [126.0, 1.083, 20.775],
    [115.0, 0.645, 0.980],
    [103.0, 0.636, 4694.003],
    [102.0, 0.976, 15720.839],
    [102.0, 4.267, 7.114],
    [99.0, 6.21, 2146.17],
    [98.0, 0.68, 155.42],
    [86.0, 5.98, 161000.69],
    [85.0, 1.30, 6275.96],
    [85.0, 3.67, 71430.70],
    [80.0, 1.81, 17260.15],
    [79.0, 3.04, 12036.46],
    [75.0, 1.76, 5088.63],
    [74.0, 3.50, 3154.69],
    [74.0, 4.68, 801.82],
    [70.0, 0.83, 9437.76],
    [62.0, 3.98, 8827.39],
    [61.0, 1.82, 7084.90],
    [57.0, 2.78, 6286.60],
    [56.0, 4.39, 14143.50],
    [56.0, 3.47, 6279.55],
    [52.0, 0.19, 12139.55],
    [52.0, 1.33, 1748.02],
    [51.0, 0.28, 5856.48],
    [49.0, 0.49, 1194.45],
    [41.0, 5.37, 8429.24],
    [41.0, 2.40, 19651.05],
    [39.0, 6.17, 10447.39],
    [37.0, 6.04, 10213.29],
    [37.0, 2.57, 1059.38],
    [36.0, 1.71, 2352.87],
    [36.0, 1.78, 6812.77],
    [33.0, 0.59, 17789.85],
    [30.0, 0.44, 83996.85],
    [30.0, 2.74, 1349.87],
    [25.0, 3.16, 4690.48],
])

_L1 = np.array([
    [628331966747.0, 0.0, 0.0],
    [206059.0, 2.678235, 6283.075850],
    [4303.0, 2.6351, 12566.1517],
    [425.0, 1.590, 3.523],
    [119.0, 5.796, 26.298],
    [109.0, 2.966, 1577.344],
    [93.0, 2.59, 18849.23],
    [72.0, 1.14, 529.69],
    [68.0, 1.87, 398.15],
    [67.0, 4.41, 5507.55],
    [59.0, 2.89, 5223.69],
    [56.0, 2.17, 155.42],
    [45.0, 0.40, 796.30],
    [36.0, 0.47, 775.52],
    [29.0, 2.65, 7.11],
    [21.0, 5.34, 0.98],
    [19.0, 1.85, 5486.78],
    [19.0, 4.97, 213.30],
    [17.0, 2.99, 6275.96],
    [16.0, 0.03, 2544.31],
    [16.0, 1.43, 2146.17],
    [15.0, 1.21, 10977.08],
    [12.0, 2.83, 1748.02],
    [12.0, 3.26, 5088.63],
    [12.0, 5.27, 1194.45],
    [12.0, 2.08, 4694.00],
    [11.0, 0.77, 553.57],
    [10.0, 1.30, 6286.60],
    [10.0, 4.24, 1349.87],
    [9.0, 2.70, 242.73],
    [9.0, 5.64, 951.72],
    [8.0, 5.30, 2352.87],
    [6.0, 2.65, 9437.76],
    [6.0, 4.67, 4690.48],
])

_L2 = np.array([
    [52919.0, 0.0, 0.0],
    [8720.0, 1.0721, 6283.0758],
    [309.0, 0.867, 12566.152],
    [27.0, 0.05, 3.52],
    [16.0, 5.19, 26.30],
    [16.0, 3.68, 155.42],
    [10.0, 0.76, 18849.23],
    [9.0, 2.06, 77713.77],
    [7.0, 0.83, 775.52],
    [5.0, 4.66, 1577.34],
    [4.0, 1.03, 7.11],
    [4.0, 3.44, 5573.14],
    [3.0, 5.14, 796.30],
    [3.0, 6.05, 5507.55],
    [3.0, 1.19, 242.73],
    [3.0, 6.12, 529.69],
    [3.0, 0.31, 398.15],
    [3.0, 2.28, 553.57],
    [2.0, 4.38, 5223.69],
    [2.0, 3.75, 0.98],
])

_L3 = np.array([
    [289.0, 5.844, 6283.076],
    [35.0, 0.0, 0.0],
    [17.0, 5.49, 12566.15],
    [3.0, 5.20, 155.42],
    [1.0, 4.72, 3.52],
    [1.0, 5.30, 18849.23],
    [1.0, 5.97, 242.73],
])

_L4 = np.array([
    [114.0, 3.142, 0.0],
    [8.0, 4.13, 6283.08],
    [1.0, 3.84, 12566.15],
])

_L5 = np.array([[1.0, 3.14, 0.0]])

_B0 = np.array([
    [280.0, 3.199, 84334.662],
    [102.0, 5.422, 5507.553],
    [80.0, 3.88, 5223.69],
    [44.0, 3.70, 2352.87],
    [32.0, 4.00, 1577.34],
])

_B1 = np.array([
    [9.0, 3.90, 5507.55],
    [6.0, 1.73, 5223.69],
])

_R0 = np.array([
    [100013989.0, 0.0, 0.0],
    [1670700.0, 3.0984635, 6283.0758500],
    [13956.0, 3.05525, 12566.15170],
    [3084.0, 5.1985, 77713.7715],
    [1628.0, 1.1739, 5753.3849],
    [1576.0, 2.8469, 7860.4194],
    [925.0, 5.453, 11506.770],
    [542.0, 4.564, 3930.210],
    [472.0, 3.661, 5884.927],
    [346.0, 0.964, 5507.553],
    [329.0, 5.900, 5223.694],
    [307.0, 0.299, 5573.143],
    [243.0, 4.273, 11790.629],
    [212.0, 5.847, 1577.344],
    [186.0, 5.022, 10977.079],
    [175.0, 3.012, 18849.228],
    [110.0, 5.055, 5486.778],
    [98.0, 0.89, 6069.78],
    [86.0, 5.69, 15720.84],
    [86.0, 1.27, 161000.69],
    [65.0, 0.27, 17260.15],
    [63.0, 0.92, 529.69],
    [57.0, 2.01, 83996.85],
    [56.0, 5.24, 71430.70],
    [49.0, 3.25, 2544.31],
    [47.0, 2.58, 775.52],
    [45.0, 5.54, 9437.76],
    [43.0, 6.01, 6275.96],
    [39.0, 5.36, 4694.00],
    [38.0, 2.39, 8827.39],
    [37.0, 0.83, 19651.05],
    [37.0, 4.90, 12139.55],
    [36.0, 1.67, 12036.46],
    [35.0, 1.84, 2942.46],
    [33.0, 0.24, 7084.90],
    [32.0, 0.18, 5088.63],
    [32.0, 1.78, 398.15],
    [28.0, 1.21, 6286.60],
    [28.0, 1.90, 6279.55],
    [26.0, 4.59, 10447.39],
])

_R1 = np.array([
    [103019.0, 1.107490, 6283.075850],
    [1721.0, 1.0644, 12566.1517],
    [702.0, 3.142, 0.0],
    [32.0, 1.02, 18849.23],
    [31.0, 2.84, 5507.55],
    [25.0, 1.32, 5223.69],
    [18.0, 1.42, 1577.34],
    [10.0, 5.91, 10977.08],
    [9.0, 1.42, 6275.96],
    [9.0, 0.27, 5486.78],
])

_R2 = np.array([
    [4359.0, 5.7846, 6283.0758],
    [124.0, 5.579, 12566.152],
    [12.0, 3.14, 0.0],
    [9.0, 3.63, 77713.77],
    [6.0, 1.87, 5573.14],
    [3.0, 5.47, 18849.23],
])

_R3 = np.array([
    [145.0, 4.273, 6283.076],
    [7.0, 3.92, 12566.15],
])

_R4 = np.array([[4.0, 2.56, 6283.08]])


def _series(tables, tau):
    """Sum a VSOP87 polynomial-of-series: Σ_k τ^k Σ_i A cos(B + C τ)."""
    out = np.zeros_like(tau)
    for k, tab in enumerate(tables):
        a, b, c = tab[:, 0], tab[:, 1], tab[:, 2]
        out += tau**k * np.sum(
            a[:, None] * np.cos(b[:, None] + c[:, None] * tau[None, :]), axis=0
        )
    return out * 1e-8


def earth_heliocentric_ecliptic(mjd_tdb):
    """Heliocentric (L, B, R) of the Earth, VSOP87D ecliptic of date.

    Returns (longitude rad, latitude rad, radius AU) arrays.
    """
    mjd_tdb = np.atleast_1d(np.asarray(mjd_tdb, dtype=np.float64))
    tau = (mjd_tdb - MJD2000) / 365250.0  # Julian millennia TDB
    L = _series([_L0, _L1, _L2, _L3, _L4, _L5], tau) % (2 * np.pi)
    B = _series([_B0, _B1], tau)
    R = _series([_R0, _R1, _R2, _R3, _R4], tau)
    # VSOP87 dynamical ecliptic -> FK5 frame correction (Meeus 32.3);
    # < 0.1 arcsec, kept for completeness
    T = tau * 10.0
    lam_p = L - np.deg2rad(1.397) * T - np.deg2rad(0.00031) * T**2
    dL = np.deg2rad(
        (-0.09033 + 0.03916 * (np.cos(lam_p) + np.sin(lam_p)) * np.tan(B)) / 3600.0
    )
    dB = np.deg2rad(0.03916 * (np.cos(lam_p) - np.sin(lam_p)) / 3600.0)
    return L + dL, B + dB, R


def _ecl_of_date_to_eq_j2000(L, B, R, mjd_tdb):
    """Spherical ecliptic-of-date -> rectangular equatorial J2000 (AU)."""
    mjd_tdb = np.atleast_1d(np.asarray(mjd_tdb, dtype=np.float64))
    T = (mjd_tdb - MJD2000) / 36525.0  # Julian centuries
    x = R * np.cos(B) * np.cos(L)
    y = R * np.cos(B) * np.sin(L)
    z = R * np.sin(B)
    # mean obliquity of date (IAU 1976, arcsec)
    eps = np.deg2rad(
        (84381.448 - 46.8150 * T - 0.00059 * T**2 + 0.001813 * T**3) / 3600.0
    )
    xe = x
    ye = y * np.cos(eps) - z * np.sin(eps)
    ze = y * np.sin(eps) + z * np.cos(eps)
    # precess mean-of-date -> J2000 (IAU 1976 angles, arcsec)
    zeta = np.deg2rad((2306.2181 * T + 0.30188 * T**2 + 0.017998 * T**3) / 3600.0)
    zz = np.deg2rad((2306.2181 * T + 1.09468 * T**2 + 0.018203 * T**3) / 3600.0)
    th = np.deg2rad((2004.3109 * T - 0.42665 * T**2 - 0.041833 * T**3) / 3600.0)
    # r_date = Rz(-zz) Ry(th) Rz(-zeta) r_J2000  =>  invert (transpose)
    cz, sz = np.cos(zz), np.sin(zz)
    ct, st = np.cos(th), np.sin(th)
    cZ, sZ = np.cos(zeta), np.sin(zeta)
    # forward matrix elements (J2000 -> date)
    p11 = cZ * ct * cz - sZ * sz
    p12 = -sZ * ct * cz - cZ * sz
    p13 = -st * cz
    p21 = cZ * ct * sz + sZ * cz
    p22 = -sZ * ct * sz + cZ * cz
    p23 = -st * sz
    p31 = cZ * st
    p32 = -sZ * st
    p33 = ct
    # transpose applied to (xe, ye, ze)
    X = p11 * xe + p21 * ye + p31 * ze
    Y = p12 * xe + p22 * ye + p32 * ze
    Z = p13 * xe + p23 * ye + p33 * ze
    return X, Y, Z


def earth_heliocentric_xyz(mjd_tdb):
    """Heliocentric Earth position, equatorial J2000 rectangular (AU)."""
    L, B, R = earth_heliocentric_ecliptic(mjd_tdb)
    return _ecl_of_date_to_eq_j2000(L, B, R, mjd_tdb)


# ----------------------------------------------------------------------
# Sun barycentric offset from planetary mean Keplerian elements
# (Standish 1800-2050 AD table; J2000 ecliptic frame, T in centuries).
# Columns: a [AU], e, I [deg], L [deg], long.peri [deg], long.node [deg]
# and their per-century rates; final column 1/(mass ratio Sun/planet).
# ----------------------------------------------------------------------

_PLANETS = [
    # name, elements,                                rates,                                      m/Msun
    ("mercury",
     (0.38709927, 0.20563593, 7.00497902, 252.25032350, 77.45779628, 48.33076593),
     (0.00000037, 0.00001906, -0.00594749, 149472.67411175, 0.16047689, -0.12534081),
     1.0 / 6023600.0),
    ("venus",
     (0.72333566, 0.00677672, 3.39467605, 181.97909950, 131.60246718, 76.67984255),
     (0.00000390, -0.00004107, -0.00078890, 58517.81538729, 0.00268329, -0.27769418),
     1.0 / 408523.71),
    ("emb",
     (1.00000261, 0.01671123, -0.00001531, 100.46457166, 102.93768193, 0.0),
     (0.00000562, -0.00004392, -0.01294668, 35999.37244981, 0.32327364, 0.0),
     1.0 / 328900.56),
    ("mars",
     (1.52371034, 0.09339410, 1.84969142, -4.55343205, -23.94362959, 49.55953891),
     (0.00001847, 0.00007882, -0.00813131, 19140.30268499, 0.44441088, -0.29257343),
     1.0 / 3098708.0),
    ("jupiter",
     (5.20288700, 0.04838624, 1.30439695, 34.39644051, 14.72847983, 100.47390909),
     (-0.00011607, -0.00013253, -0.00183714, 3034.74612775, 0.21252668, 0.20469106),
     1.0 / 1047.3486),
    ("saturn",
     (9.53667594, 0.05386179, 2.48599187, 49.95424423, 92.59887831, 113.66242448),
     (-0.00125060, -0.00050991, 0.00193609, 1222.49362201, -0.41897216, -0.28867794),
     1.0 / 3497.898),
    ("uranus",
     (19.18916464, 0.04725744, 0.77263783, 313.23810451, 170.95427630, 74.01692503),
     (-0.00196176, -0.00004397, -0.00242939, 428.48202785, 0.40805281, 0.04240589),
     1.0 / 22902.98),
    ("neptune",
     (30.06992276, 0.00859048, 1.77004347, -55.12002969, 44.96476227, 131.78422574),
     (0.00026291, 0.00005105, 0.00035372, 218.45945325, -0.32241464, -0.00508664),
     1.0 / 19412.24),
]

_EPS_J2000 = np.deg2rad(23.43929111)  # mean obliquity at J2000


def _kepler_E(M, e, n_iter=8):
    """Solve Kepler's equation by Newton iteration (host-side numpy)."""
    E = M + e * np.sin(M)
    for _ in range(n_iter):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


def planet_heliocentric_xyz(name, mjd_tdb):
    """Heliocentric planet position, equatorial J2000 (AU), from the
    Standish mean elements (valid 1800-2050; errors <~1 arcmin)."""
    for nm, el, rate, _ in _PLANETS:
        if nm == name:
            break
    else:
        raise KeyError(name)
    mjd_tdb = np.atleast_1d(np.asarray(mjd_tdb, dtype=np.float64))
    T = (mjd_tdb - MJD2000) / 36525.0
    a = el[0] + rate[0] * T
    e = el[1] + rate[1] * T
    inc = np.deg2rad(el[2] + rate[2] * T)
    Lm = np.deg2rad(el[3] + rate[3] * T)
    ph = np.deg2rad(el[4] + rate[4] * T)
    Om = np.deg2rad(el[5] + rate[5] * T)
    w = ph - Om  # argument of perihelion
    M = np.mod(Lm - ph + np.pi, 2 * np.pi) - np.pi
    E = _kepler_E(M, e)
    xp = a * (np.cos(E) - e)
    yp = a * np.sqrt(1 - e**2) * np.sin(E)
    # orbital plane -> J2000 ecliptic
    cw, sw = np.cos(w), np.sin(w)
    cO, sO = np.cos(Om), np.sin(Om)
    ci, si = np.cos(inc), np.sin(inc)
    xe = (cw * cO - sw * sO * ci) * xp + (-sw * cO - cw * sO * ci) * yp
    ye = (cw * sO + sw * cO * ci) * xp + (-sw * sO + cw * cO * ci) * yp
    ze = (sw * si) * xp + (cw * si) * yp
    # ecliptic J2000 -> equatorial J2000
    x = xe
    y = ye * np.cos(_EPS_J2000) - ze * np.sin(_EPS_J2000)
    z = ye * np.sin(_EPS_J2000) + ze * np.cos(_EPS_J2000)
    return x, y, z


def sun_barycentric_xyz(mjd_tdb):
    """Sun position relative to the solar-system barycentre, equatorial
    J2000 (AU): r_sun = -Σ m_i r_i(helio) / (M_sun + Σ m_i)."""
    mjd_tdb = np.atleast_1d(np.asarray(mjd_tdb, dtype=np.float64))
    sx = np.zeros_like(mjd_tdb)
    sy = np.zeros_like(mjd_tdb)
    sz = np.zeros_like(mjd_tdb)
    mtot = 1.0
    for nm, _, _, m in _PLANETS:
        x, y, z = planet_heliocentric_xyz(nm, mjd_tdb)
        sx += m * x
        sy += m * y
        sz += m * z
        mtot += m
    return -sx / mtot, -sy / mtot, -sz / mtot


# ----------------------------------------------------------------------
# public observers
# ----------------------------------------------------------------------

# Sun-Earth L2 distance ratio: 1 + (m/(3 M))^(1/3) with
# m/(M+m) for the Earth-Moon system; the standard SEL2 ~ 1.5e6 km.
_L2_SCALE = 1.0 + (3.0403e-6 / 3.0) ** (1.0 / 3.0)


def _match_shape(parts, mjd):
    shape = np.shape(mjd)
    return tuple(np.asarray(p).reshape(shape) for p in parts)


def earth_barycentric_xyz(mjd_tdb):
    """Earth geocentre relative to the solar-system barycentre,
    equatorial J2000 (AU). The precise counterpart of the reference's
    `geocentre_position_query` (`gaia-utils.jl:146-181`)."""
    hx, hy, hz = earth_heliocentric_xyz(mjd_tdb)
    bx, by, bz = sun_barycentric_xyz(mjd_tdb)
    return _match_shape((hx + bx, hy + by, hz + bz), mjd_tdb)


def gaia_barycentric_xyz(mjd_tdb):
    """Approximate Gaia spacecraft position (barycentric, eq J2000, AU):
    the Sun-Earth L2 point, i.e. the heliocentric Earth vector scaled by
    1+(m/3M)^(1/3). Residual vs the true spacecraft is the Lissajous
    orbit, ~2e-3 AU — ~5x closer to ESA's published Gaia scan geometry
    (GOST forecasts, DR4 parallax_factor_al) than the Earth geocentre."""
    hx, hy, hz = earth_heliocentric_xyz(mjd_tdb)
    bx, by, bz = sun_barycentric_xyz(mjd_tdb)
    return _match_shape(
        (hx * _L2_SCALE + bx, hy * _L2_SCALE + by, hz * _L2_SCALE + bz),
        mjd_tdb,
    )


def earth_velocity_au_day(mjd_tdb, dt=0.05):
    """Earth barycentric velocity (AU/day, eq J2000) by central
    difference of the series (truncation error ~2e-9 AU/day)."""
    mjd_tdb = np.atleast_1d(np.asarray(mjd_tdb, dtype=np.float64))
    xp, yp, zp = earth_barycentric_xyz(mjd_tdb + dt)
    xm, ym, zm = earth_barycentric_xyz(mjd_tdb - dt)
    return (
        (xp - xm) / (2 * dt),
        (yp - ym) / (2 * dt),
        (zp - zm) / (2 * dt),
    )


def gaia_velocity_au_day(mjd_tdb, dt=0.05):
    """Gaia (Sun-Earth L2 model) barycentric velocity (AU/day, eq
    J2000) by central difference, consistent with
    `gaia_barycentric_xyz` so an observer state vector never mixes the
    L2 position with the geocentre velocity."""
    mjd_tdb = np.atleast_1d(np.asarray(mjd_tdb, dtype=np.float64))
    xp, yp, zp = gaia_barycentric_xyz(mjd_tdb + dt)
    xm, ym, zm = gaia_barycentric_xyz(mjd_tdb - dt)
    return (
        (xp - xm) / (2 * dt),
        (yp - ym) / (2 * dt),
        (zp - zm) / (2 * dt),
    )


# ----------------------------------------------------------------------
# time-scale helpers (for validation against UTC/TCB-stamped data)
# ----------------------------------------------------------------------

# TAI-UTC leap seconds (start MJD of each value), 1972+
_LEAP = [
    (41317.0, 10), (41499.0, 11), (41683.0, 12), (42048.0, 13),
    (42413.0, 14), (42778.0, 15), (43144.0, 16), (43509.0, 17),
    (43874.0, 18), (44239.0, 19), (44786.0, 20), (45151.0, 21),
    (45516.0, 22), (46247.0, 23), (47161.0, 24), (47892.0, 25),
    (48257.0, 26), (48804.0, 27), (49169.0, 28), (49534.0, 29),
    (50083.0, 30), (50630.0, 31), (51179.0, 32), (53736.0, 33),
    (54832.0, 34), (56109.0, 35), (57204.0, 36), (57754.0, 37),
]

_LB = 1.550519768e-8  # TCB drift rate vs TT
_T0_MJD_TT = 43144.0003725  # 1977-01-01.0003725 TT


def tai_minus_utc(mjd_utc):
    mjd_utc = np.atleast_1d(np.asarray(mjd_utc, dtype=np.float64))
    out = np.zeros_like(mjd_utc)
    for start, sec in _LEAP:
        out = np.where(mjd_utc >= start, float(sec), out)
    return out


def utc_to_tt_mjd(mjd_utc):
    return np.asarray(mjd_utc) + (tai_minus_utc(mjd_utc) + 32.184) / 86400.0


def tcb_to_tt_mjd(mjd_tcb):
    """TCB -> TT (TDB ~ TT to 2 ms): TCB-TT = L_B * (t - t0)."""
    mjd_tcb = np.asarray(mjd_tcb, dtype=np.float64)
    return mjd_tcb - _LB * (mjd_tcb - _T0_MJD_TT)


def tt_to_tcb_mjd(mjd_tt):
    mjd_tt = np.asarray(mjd_tt, dtype=np.float64)
    return mjd_tt + _LB * (mjd_tt - _T0_MJD_TT) / (1.0 - _LB)
