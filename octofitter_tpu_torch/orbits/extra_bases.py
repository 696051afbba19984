"""Additional orbit bases: FixedPosition, CartesianOrbit and HyperbolicOrbit.

PyTorch port of `octofitter_tpu/orbits/extra_bases.py` (the reference's
single-epoch fixed-position shim and PlanetOrbits' Cartesian state-vector
and hyperbolic bases). The chain axis is written out as in `elements.py`:
fields of shape B + t.shape. Each basis has only the composed path: the
Cartesian basis converts its state vector to Campbell elements and solves
a `VisualOrbit` through `kepler_solver` (the standalone CUDA kernel on a
card), the hyperbolic basis runs `kepler_solver_hyperbolic`'s guarded
Newton in torch ops.
"""

from __future__ import annotations

import dataclasses

import torch

from ..constants import AUDAY_TO_MS, GAUSSIAN_GRAV_CONST, JULIAN_YEAR_DAYS
from .elements import (
    OrbitSolution,
    VisualOrbit,
    _elements_device,
    _per_epoch,
    _pick,
    _resolve_aliases,
    _tensor,
    _thiele_innes_unit,
    orbitsolve,
)
from .kepler import kepler_solver_hyperbolic


@dataclasses.dataclass(frozen=True)
class FixedPositionOrbit:
    """Visual{FixedPosition}: a single fixed sky offset, useful when only
    one epoch of data exists.

    Constructed from (x, y[, z]) in AU, (ra, dec) in mas, or (sep, pa)
    (mas, rad), always with plx.
    """

    x: torch.Tensor     # AU, RA direction
    y: torch.Tensor     # AU, Dec direction
    z: torch.Tensor     # AU, line of sight
    plx: torch.Tensor   # mas

    @classmethod
    def from_params(cls, *, device="cuda", **kw):
        kw = _resolve_aliases(kw, device)
        device = _elements_device(kw, device)
        val = lambda name, default=None: _tensor(kw.get(name, default), device)  # noqa: E731
        plx = val("plx")
        z = val("z", 0.0)
        if "x" in kw and "y" in kw:
            x, y = val("x"), val("y")
        elif "ra" in kw and "dec" in kw:
            x, y = val("ra") / plx, val("dec") / plx
        elif "sep" in kw and "pa" in kw:
            sep, pa = val("sep"), val("pa")
            x = sep * torch.sin(pa) / plx
            y = sep * torch.cos(pa) / plx
        else:
            raise ValueError("pass x & y, ra & dec, or sep & pa (with plx)")
        return cls(x=x, y=y, z=z, plx=plx)


def orbitsolve_fixed(elem: FixedPositionOrbit, t) -> OrbitSolution:
    x, y, z, plx = torch.broadcast_tensors(elem.x, elem.y, elem.z, elem.plx)
    x, y, z, plx = (_per_epoch(v, t) for v in (x, y, z, plx))
    shape = torch.broadcast_shapes(x.shape, t.shape)
    one = torch.ones(shape, dtype=t.dtype, device=t.device)
    zero = torch.zeros_like(one)
    return OrbitSolution(
        elem=elem, t=t, EA=zero, nu=zero,
        r=torch.hypot(x * one, y * one),
        posx=x * one, posy=y * one, posz=z * one,
        vx=zero, vy=zero, vz=zero,
        raoff_mas=x * plx * one,
        decoff_mas=y * plx * one,
        pmra_masyr=zero, pmdec_masyr=zero, radvel_ms=zero,
    )


@dataclasses.dataclass(frozen=True)
class CartesianOrbit:
    """Orbit from a Cartesian state vector at a reference epoch.

    x, y, z [AU] in the sky frame (+x East, +y North, +z away from the
    observer), vx, vy, vz [AU/day], M [Msun], tref [MJD], plx [mas].
    Converted to Campbell elements at solve time (standard rv2el).
    """

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    M: torch.Tensor
    tref: torch.Tensor
    plx: torch.Tensor

    @classmethod
    def from_params(cls, *, device="cuda", **kw):
        kw = _resolve_aliases(kw, device)
        if "tref" not in kw:
            kw["tref"] = kw.get("ref_epoch", 57388.5)
        return cls(**_pick(kw, device, "x", "y", "z", "vx", "vy", "vz", "M", "tref", "plx"))


def _dot(u, v):
    return torch.sum(u * v, dim=-1)


def cartesian_to_campbell(elem: CartesianOrbit):
    """State vector -> (a, e, i, omega, Omega, tp), each of the elements'
    batch shape, in this framework's conventions (z away from the
    observer)."""
    mu = GAUSSIAN_GRAV_CONST**2 * elem.M  # AU^3 / day^2
    rvec = torch.stack(torch.broadcast_tensors(elem.x, elem.y, elem.z), dim=-1)
    vvec = torch.stack(torch.broadcast_tensors(elem.vx, elem.vy, elem.vz), dim=-1)
    rvec, vvec = torch.broadcast_tensors(rvec, vvec)
    r = torch.linalg.vector_norm(rvec, dim=-1)
    v2 = _dot(vvec, vvec)

    hvec = torch.linalg.cross(rvec, vvec, dim=-1)
    h = torch.linalg.vector_norm(hvec, dim=-1)
    # eccentricity vector
    evec = torch.linalg.cross(vvec, hvec, dim=-1) / mu[..., None] - rvec / r[..., None]
    e = torch.linalg.vector_norm(evec, dim=-1)
    # semi-major axis from vis-viva
    a = 1.0 / (2.0 / r - v2 / mu)

    # The sky frame (x=East, y=North, z=away) is LEFT-handed, so the
    # right-handed cross product yields h with an inverted z
    # interpretation: i = arccos(-h_z/h).
    i = torch.arccos(torch.clamp(-hvec[..., 2] / h, -1.0, 1.0))
    # ascending node vector n = z_hat x h
    nvec = torch.stack([-hvec[..., 1], hvec[..., 0], torch.zeros_like(h)], dim=-1)
    n = torch.linalg.vector_norm(nvec, dim=-1)
    # Omega measured in the sky plane from North (y) toward East (x):
    Omega = torch.atan2(nvec[..., 0], nvec[..., 1])
    # argument of periastron
    cos_w = _dot(nvec, evec) / torch.clamp(n * e, min=1e-300)
    omega = torch.arccos(torch.clamp(cos_w, -1.0, 1.0))
    omega = torch.where(evec[..., 2] < 0, 2 * torch.pi - omega, omega)
    # true anomaly at tref
    cos_nu = _dot(evec, rvec) / torch.clamp(e * r, min=1e-300)
    nu = torch.arccos(torch.clamp(cos_nu, -1.0, 1.0))
    nu = torch.where(_dot(rvec, vvec) < 0, 2 * torch.pi - nu, nu)
    # eccentric & mean anomaly -> tp
    E = 2 * torch.atan2(torch.sqrt(1 - e) * torch.sin(nu / 2),
                        torch.sqrt(1 + e) * torch.cos(nu / 2))
    Mano = E - e * torch.sin(E)
    n_mot = torch.sqrt(mu / a**3)  # rad/day
    tp = elem.tref - Mano / n_mot
    return a, e, i, omega, Omega, tp


def orbitsolve_cartesian(elem: CartesianOrbit, t) -> OrbitSolution:
    a, e, i, omega, Omega, tp = cartesian_to_campbell(elem)
    vis = VisualOrbit(a=a, e=e, i=i, omega=omega, Omega=Omega, tp=tp, M=elem.M, plx=elem.plx)
    sol = orbitsolve(vis, t, fused=False)
    # keep a reference to the original element
    return dataclasses.replace(sol, elem=elem)


# --------------------------------------------------------------------------
# Hyperbolic orbits (e > 1, a < 0)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HyperbolicOrbit:
    """Visual hyperbolic orbit, Campbell elements with e > 1 and a < 0
    (AU, standard convention; a > 0 input is negated), with the accessor
    surface of VisualOrbit. The solver is the guarded Newton on
    e sinh(H) - H = M with an implicit-derivative backward
    (`kepler.py:kepler_solver_hyperbolic`)."""

    a: torch.Tensor       # semi-major axis [AU], negative
    e: torch.Tensor       # eccentricity > 1
    i: torch.Tensor       # inclination [rad]
    omega: torch.Tensor   # argument of periastron [rad]
    Omega: torch.Tensor   # longitude of ascending node [rad]
    tp: torch.Tensor      # periastron passage epoch [MJD]
    M: torch.Tensor       # total mass [Msun]
    plx: torch.Tensor     # parallax [mas]

    @classmethod
    def from_params(cls, *, device="cuda", **kw):
        kw = _resolve_aliases(kw, device)
        return cls(**_pick(kw, device, "a", "e", "i", "omega", "Omega", "tp", "M", "plx"))


def orbitsolve_hyperbolic(elem: HyperbolicOrbit, t) -> OrbitSolution:
    """Solve a hyperbolic orbit at epoch(s) t [MJD]."""
    ep = lambda x: _per_epoch(x, t)  # noqa: E731
    a = ep(-torch.abs(elem.a))                 # enforce a < 0
    e = ep(elem.e)
    mu = GAUSSIAN_GRAV_CONST**2 * ep(elem.M)   # AU^3/day^2
    n = torch.sqrt(mu / (-a) ** 3)             # rad/day
    MA = n * (t - ep(elem.tp))
    H = kepler_solver_hyperbolic(MA, e)
    ch, sh = torch.cosh(H), torch.sinh(H)
    sq = torch.sqrt(e**2 - 1.0)
    X = a * (ch - e)                           # r cos(nu)
    Y = -a * sq * sh                           # r sin(nu)
    r = a * (1.0 - e * ch)                     # = |a|(e cosh H - 1) > 0
    Hdot = n / (e * ch - 1.0)
    VX = a * sh * Hdot
    VY = -a * sq * ch * Hdot
    nu = torch.atan2(Y, X)

    A, B, F, G = (ep(x) for x in _thiele_innes_unit(elem))
    sw, cw = ep(torch.sin(elem.omega)), ep(torch.cos(elem.omega))
    si = ep(torch.sin(elem.i))
    posx = B * X + G * Y
    posy = A * X + F * Y
    posz = si * (sw * X + cw * Y)
    vx = B * VX + G * VY
    vy = A * VX + F * VY
    vz = si * (sw * VX + cw * VY)
    plx = ep(elem.plx)
    return OrbitSolution(
        elem=elem, t=t, EA=H, nu=nu, r=r,
        posx=posx, posy=posy, posz=posz, vx=vx, vy=vy, vz=vz,
        raoff_mas=posx * plx, decoff_mas=posy * plx,
        pmra_masyr=vx * plx * JULIAN_YEAR_DAYS,
        pmdec_masyr=vy * plx * JULIAN_YEAR_DAYS,
        radvel_ms=vz * AUDAY_TO_MS,
    )
