"""AbsoluteVisual orbits: rigorous on-sky barycentric propagation.

PyTorch port of `octofitter_tpu/orbits/absolute_visual.py` (PlanetOrbits'
`AbsoluteVisual{KepOrbit}`): the system barycentre moves through space,
so the apparent ra/dec/parallax/proper motion all change with time, and
the changing distance modulates the light-travel time (shifting the
observed orbital phase, an apparent acceleration).

Exact epoch propagation in Cartesian coordinates. Units: ra/dec in
degrees, plx in mas, pmra/pmdec in mas/yr (pmra includes cos(dec)), rv in
m/s, ref_epoch in MJD. Solutions carry a `compensated` block with
ra2/dec2/parallax2/pmra2/pmdec2/rv2/t_em_days.

The chain axis is written out: the elements broadcast to one batch shape
B, the epochs t are shared by every chain, and every `Compensated` field
has shape B + t.shape. The Kepler solve then runs at each chain's own
emission epochs, (B + t.shape), through `kepler_solver` (the standalone
CUDA kernel on a card); the fused orbit-solve pair takes one epoch vector
for all chains and does not apply. Absolute positions need float64: at
ra = 68 deg one float32 step is 27 mas.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..constants import AUDAY_TO_MS, IAU_AU_M, IAU_PC2AU, JULIAN_YEAR_DAYS, RAD2AS
from .elements import (
    OrbitSolution,
    _per_epoch,
    _pick,
    _resolve_aliases,
    _solve_common,
    _thiele_innes_unit,
)

# light travel time across one parsec, in days
C_M_S = 299792458.0
PC_LT_DAYS = IAU_PC2AU * IAU_AU_M / C_M_S / 86400.0
MASYR_TO_RADYR = 1.0 / (1000.0 * RAD2AS)


@dataclasses.dataclass(frozen=True)
class Compensated:
    """Propagated barycentric astrometry at the solution epochs."""

    ra2: torch.Tensor         # deg
    dec2: torch.Tensor        # deg
    parallax2: torch.Tensor   # mas
    pmra2: torch.Tensor       # mas/yr
    pmdec2: torch.Tensor      # mas/yr
    rv2: torch.Tensor         # m/s
    distance2_pc: torch.Tensor
    t_em_days: torch.Tensor   # emission epoch (MJD days)


@dataclasses.dataclass(frozen=True)
class AbsoluteVisualOrbit:
    """AbsoluteVisual{KepOrbit}."""

    a: torch.Tensor
    e: torch.Tensor
    i: torch.Tensor
    omega: torch.Tensor
    Omega: torch.Tensor
    tp: torch.Tensor
    M: torch.Tensor
    plx: torch.Tensor
    ra: torch.Tensor          # deg, at ref_epoch
    dec: torch.Tensor         # deg, at ref_epoch
    rv: torch.Tensor          # m/s
    pmra: torch.Tensor        # mas/yr
    pmdec: torch.Tensor       # mas/yr
    ref_epoch: torch.Tensor   # MJD

    @classmethod
    def from_params(cls, *, device="cuda", **kw):
        kw = _resolve_aliases(kw, device)
        if "rv" not in kw:
            kw["rv"] = 0.0
        return cls(**_pick(kw, device, "a", "e", "i", "omega", "Omega", "tp", "M", "plx",
                           "ra", "dec", "rv", "pmra", "pmdec", "ref_epoch"))


def _unit_vectors(ra_rad, dec_rad):
    cr, sr = torch.cos(ra_rad), torch.sin(ra_rad)
    cd, sd = torch.cos(dec_rad), torch.sin(dec_rad)
    rhat = torch.stack([cr * cd, sr * cd, sd], dim=-1)
    phat = torch.stack([-sr, cr, torch.zeros_like(sr)], dim=-1)      # East
    qhat = torch.stack([-cr * sd, -sr * sd, cd], dim=-1)             # North
    return rhat, phat, qhat


def _deg(rad):
    """Radians to degrees for the propagated ra2 and dec2, the one place
    where the absolute position is rounded to degrees; a check of two
    evaluations' agreement replaces it to move every result by an ulp."""
    return torch.rad2deg(rad)


def propagate_astrometry(elem: AbsoluteVisualOrbit, t) -> Compensated:
    """Epoch-propagate the barycentre to MJD t (shared by every chain);
    returns Compensated with fields of shape B + t.shape."""
    ra, dec, plx, pmra, pmdec, rv, ref_epoch = torch.broadcast_tensors(
        elem.ra, elem.dec, elem.plx, elem.pmra, elem.pmdec, elem.rv, elem.ref_epoch)
    t = torch.as_tensor(t, dtype=plx.dtype, device=plx.device)
    n = t.ndim

    def per_epoch3(x):
        # B + (3,) -> B + (1,) * n + (3,)
        return x.reshape(x.shape[:-1] + (1,) * n + (3,))

    ra0 = torch.deg2rad(ra)
    dec0 = torch.deg2rad(dec)
    d0 = 1000.0 / plx * 1.0  # pc

    rhat, phat, qhat = _unit_vectors(ra0, dec0)

    # velocity in pc/julian-year
    mu_a = (pmra * MASYR_TO_RADYR)[..., None]    # rad/yr
    mu_d = (pmdec * MASYR_TO_RADYR)[..., None]
    v_r = (rv / IAU_AU_M * 86400.0 * JULIAN_YEAR_DAYS / IAU_PC2AU)[..., None]  # pc/yr
    v = d0[..., None] * (mu_a * phat + mu_d * qhat) + v_r * rhat  # pc/yr, B + (3,)

    dt_yr = (t - _per_epoch(ref_epoch, t)) / JULIAN_YEAR_DAYS     # B + t.shape
    b = per_epoch3(d0[..., None] * rhat) + per_epoch3(v) * dt_yr[..., None]
    d_t = torch.linalg.vector_norm(b, dim=-1)
    rhat_t = b / d_t[..., None]

    ra_t = torch.atan2(rhat_t[..., 1], rhat_t[..., 0])
    ra_t = torch.remainder(ra_t, 2 * math.pi)
    dec_t = torch.arcsin(torch.clamp(rhat_t[..., 2], -1.0, 1.0))

    _, phat_t, qhat_t = _unit_vectors(ra_t, dec_t)
    v_t = per_epoch3(v)
    pmra_t = torch.sum(v_t * phat_t, dim=-1) / d_t / MASYR_TO_RADYR
    pmdec_t = torch.sum(v_t * qhat_t, dim=-1) / d_t / MASYR_TO_RADYR
    rv_t = (torch.sum(v_t * rhat_t, dim=-1) / (86400.0 * JULIAN_YEAR_DAYS)
            * IAU_PC2AU * IAU_AU_M)

    t_em = t - (d_t - _per_epoch(d0, t)) * PC_LT_DAYS

    return Compensated(
        ra2=_deg(ra_t),
        dec2=_deg(dec_t),
        parallax2=1000.0 / d_t,
        pmra2=pmra_t,
        pmdec2=pmdec_t,
        rv2=rv_t,
        distance2_pc=d_t,
        t_em_days=t_em,
    )


def orbitsolve_absolute(elem: AbsoluteVisualOrbit, t) -> OrbitSolution:
    """Solve the orbit at observation epoch(s) t (MJD), with the Kepler
    phase evaluated at each chain's light-travel-compensated emission
    epoch."""
    t = torch.as_tensor(t, dtype=elem.plx.dtype, device=elem.plx.device)
    comp = propagate_astrometry(elem, t)
    n = t.ndim

    EA, nu, r, X, Y, VX, VY = _solve_common(elem, comp.t_em_days, elem.a, elem.e,
                                            epoch_ndim=n)
    A, B, F, G = (_per_epoch(x, t) for x in _thiele_innes_unit(elem))
    sw = _per_epoch(torch.sin(elem.omega), t)
    cw = _per_epoch(torch.cos(elem.omega), t)
    si = _per_epoch(torch.sin(elem.i), t)
    posx = B * X + G * Y
    posy = A * X + F * Y
    posz = si * (sw * X + cw * Y)
    vx = B * VX + G * VY
    vy = A * VX + F * VY
    vz = si * (sw * VX + cw * VY)
    plx_t = comp.parallax2
    return OrbitSolution(
        elem=elem,
        t=t,
        EA=EA,
        nu=nu,
        r=r,
        posx=posx,
        posy=posy,
        posz=posz,
        vx=vx,
        vy=vy,
        vz=vz,
        raoff_mas=posx * plx_t,
        decoff_mas=posy * plx_t,
        pmra_masyr=vx * plx_t * JULIAN_YEAR_DAYS,
        pmdec_masyr=vy * plx_t * JULIAN_YEAR_DAYS,
        radvel_ms=vz * AUDAY_TO_MS,
        compensated=comp,
    )
