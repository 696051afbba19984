"""Orbit element types, solver, and solution accessors.

PyTorch port of `octofitter_tpu/orbits/elements.py`; the conventions
are the same (see that module's docstring):

  - Elements: a [AU], e, i [rad], omega (argument of periastron of the
    *companion*, rad), Omega (longitude of ascending node, rad),
    tp [MJD], M (total mass, Msun), plx [mas].
  - Sky frame: +RA offset East, +Dec offset North, +z *away* from the
    observer, so ``radvel`` > 0 means receding.
  - Mass-weighted accessors (e.g. ``raoff(sol, m)``) return the *host
    star's reflex*: -(m/Mtot) x companion quantity.

The chain axis is written out: every element field is a tensor of one
batch shape B (``()`` for one orbit, ``(C,)`` for C chains), and
``orbitsolve(elem, t)`` returns fields of shape ``B + t.shape``. The other
bases (`absolute_visual.py`, `extra_bases.py`) keep that contract; an
AbsoluteVisual orbit solves Kepler's equation at each chain's own emission
epochs, of shape ``B + t.shape``, which `_solve_common` takes with
``epoch_ndim=t.ndim``.

``orbitsolve`` has two paths for a `KepOrbit` or `VisualOrbit`, chosen by
its ``fused`` argument. The fused path, the default, is the `_OrbitSolve`
Function: one kernel forward and one backward on a CUDA tensor
(`kernels/csrc/orbit_solve.cu`), their plain versions on a CPU tensor,
first derivatives only. The composed path (``fused=False``) is plain torch
ops around `kepler_solver` (the standalone Kepler kernel on a CUDA tensor)
and can be differentiated to any order and under `torch.func`; the Laplace
step's Hessian asks for it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from torch.autograd.function import once_differentiable

from ..constants import AUDAY_TO_MS, JULIAN_YEAR_DAYS, KEPLER_YEAR_DAYS
from .kepler import kepler_solver
from .kernels.orbit_solve import orbit_solve_backward_cuda, orbit_solve_forward_cuda


def _tensor(x, device=None):
    # numbers (and numpy values) become float64 on `device`, tensors keep
    # their type and device
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _elements_device(kw, device):
    """Where `from_params` puts elements given as numbers: the device of
    the first value that is a tensor, or else `device`, which must then
    exist (the GPU by default: a caller who wants the CPU says so)."""
    for v in kw.values():
        if isinstance(v, torch.Tensor):
            return v.device
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"orbit elements were asked for device {device!s}, but no CUDA device is "
            "available; pass device=\"cpu\""
        )
    return device


def _pick(kw, device, *names):
    device = _elements_device(kw, device)
    return {k: _tensor(kw[k], device) for k in names}


# --------------------------------------------------------------------------
# Element types
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KepOrbit:
    """Campbell elements, no parallax (physical units only)."""

    a: torch.Tensor      # semi-major axis [AU]
    e: torch.Tensor      # eccentricity
    i: torch.Tensor      # inclination [rad]
    omega: torch.Tensor  # argument of periastron [rad]
    Omega: torch.Tensor  # longitude of ascending node [rad]
    tp: torch.Tensor     # epoch of periastron [MJD]
    M: torch.Tensor      # total mass [Msun]

    @classmethod
    def from_params(cls, *, device="cuda", **kw):
        kw = _resolve_aliases(kw, device)
        return cls(**_pick(kw, device, "a", "e", "i", "omega", "Omega", "tp", "M"))


@dataclasses.dataclass(frozen=True)
class VisualOrbit:
    """Visual{KepOrbit}: Campbell elements + parallax for on-sky angles."""

    a: torch.Tensor
    e: torch.Tensor
    i: torch.Tensor
    omega: torch.Tensor
    Omega: torch.Tensor
    tp: torch.Tensor
    M: torch.Tensor
    plx: torch.Tensor    # parallax [mas]

    @classmethod
    def from_params(cls, *, device="cuda", **kw):
        kw = _resolve_aliases(kw, device)
        return cls(**_pick(kw, device, "a", "e", "i", "omega", "Omega", "tp", "M", "plx"))


@dataclasses.dataclass(frozen=True)
class ThieleInnesOrbit:
    """Thiele-Innes linear elements A,B,F,G [mas] (+ e, tp, M, plx)."""

    e: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    F: torch.Tensor
    G: torch.Tensor
    tp: torch.Tensor
    M: torch.Tensor
    plx: torch.Tensor

    @classmethod
    def from_params(cls, *, device="cuda", **kw):
        kw = _resolve_aliases(kw, device)
        return cls(**_pick(kw, device, "e", "A", "B", "F", "G", "tp", "M", "plx"))


@dataclasses.dataclass(frozen=True)
class RadialVelocityOrbit:
    """RV-only orbit: no inclination/node (sin(i)=1 convention)."""

    a: torch.Tensor
    e: torch.Tensor
    omega: torch.Tensor
    tp: torch.Tensor
    M: torch.Tensor

    @classmethod
    def from_params(cls, *, device="cuda", **kw):
        kw = _resolve_aliases(kw, device)
        return cls(**_pick(kw, device, "a", "e", "omega", "tp", "M"))


def _resolve_aliases(kw, device):
    """Accept unicode names (as used in reference docs) and P->a."""
    kw = dict(kw)
    alias = {"ω": "omega", "Ω": "Omega", "ϖ": "plx", "τ": "tau"}
    for old, new in alias.items():
        if old in kw and new not in kw:
            kw[new] = kw.pop(old)
    if "a" not in kw and "P" in kw and "M" in kw:
        # P in days -> a via Kepler's third law
        device = _elements_device(kw, device)
        P_kepler_years = _tensor(kw["P"], device) / KEPLER_YEAR_DAYS
        kw["a"] = (_tensor(kw["M"], device) * P_kepler_years**2) ** (1.0 / 3.0)
    return kw


# --------------------------------------------------------------------------
# Derived element quantities
# --------------------------------------------------------------------------

def semimajoraxis(elem):
    """Semi-major axis in AU (for TI orbits, derived from A,B,F,G & plx;
    0 for the bases without one, as FixedPosition)."""
    if isinstance(elem, ThieleInnesOrbit):
        u = (elem.A**2 + elem.B**2 + elem.F**2 + elem.G**2) / 2
        v = elem.A * elem.G - elem.B * elem.F
        alpha = torch.sqrt(u + torch.sqrt((u + v) * (u - v)))  # [mas]
        return alpha / elem.plx
    if not hasattr(elem, "a"):
        return torch.zeros((), dtype=elem.plx.dtype, device=elem.plx.device)
    return elem.a


def eccentricity(elem):
    return elem.e


def totalmass(elem):
    return elem.M


def periastron(elem):
    return elem.tp


def period(elem):
    """Orbital period in days."""
    a = semimajoraxis(elem)
    return torch.sqrt(a**3 / elem.M) * KEPLER_YEAR_DAYS


def meanmotion(elem):
    """Mean motion in rad/day."""
    return 2 * math.pi / period(elem)


def periapsis(elem):
    """Periapsis distance [AU]."""
    return semimajoraxis(elem) * (1 - elem.e)


def apoapsis(elem):
    """Apoapsis distance [AU]."""
    return semimajoraxis(elem) * (1 + elem.e)


def distance_pc(elem):
    """Distance in parsecs from parallax."""
    return 1000.0 / elem.plx


def _thiele_innes_unit(elem):
    """Unitless Thiele-Innes constants from Campbell elements."""
    cw, sw = torch.cos(elem.omega), torch.sin(elem.omega)
    cO, sO = torch.cos(elem.Omega), torch.sin(elem.Omega)
    ci = torch.cos(elem.i)
    A = cO * cw - sO * sw * ci
    B = sO * cw + cO * sw * ci
    F = -cO * sw - sO * cw * ci
    G = -sO * sw + cO * cw * ci
    return A, B, F, G


def thiele_innes_to_campbell(A, B, F, G):
    """(A,B,F,G) -> (alpha, i, omega, Omega). alpha in input units.

    Returns the branch with omega+Omega and omega-Omega each in
    (-pi, pi]; see the JAX package for the node degeneracy."""
    wpO = torch.atan2(B - F, A + G)
    wmO = torch.atan2(-(B + F), A - G)
    q1 = torch.hypot(A + G, B - F)   # alpha (1 + cos i)
    q2 = torch.hypot(A - G, B + F)   # alpha (1 - cos i)
    alpha = (q1 + q2) / 2
    cosi = (q1 - q2) / (q1 + q2)
    i = torch.arccos(torch.clamp(cosi, -1.0, 1.0))
    omega = (wpO + wmO) / 2
    Omega = (wpO - wmO) / 2
    return alpha, i, omega, Omega


# --------------------------------------------------------------------------
# Solutions
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OrbitSolution:
    """Orbit solved at epoch(s) t, with all on-sky observables cached.

    Fields have shape ``B + t.shape`` (B: the elements' batch shape).
    Angles in mas, velocities: pm* in mas/yr, radvel in m/s, positions
    pos* in AU."""

    elem: object
    t: torch.Tensor
    EA: torch.Tensor        # eccentric anomaly [rad]
    nu: torch.Tensor        # true anomaly [rad]
    r: torch.Tensor         # physical separation [AU]
    posx: torch.Tensor      # RA-direction offset [AU] (East +)
    posy: torch.Tensor      # Dec-direction offset [AU] (North +)
    posz: torch.Tensor      # line-of-sight offset [AU] (+ away from observer)
    vx: torch.Tensor        # d(posx)/dt [AU/day]
    vy: torch.Tensor        # d(posy)/dt [AU/day]
    vz: torch.Tensor        # d(posz)/dt [AU/day]
    raoff_mas: torch.Tensor
    decoff_mas: torch.Tensor
    pmra_masyr: torch.Tensor
    pmdec_masyr: torch.Tensor
    radvel_ms: torch.Tensor
    # AbsoluteVisual orbits attach the propagated barycentric astrometry
    # here (an `absolute_visual.Compensated`, fields of shape B + t.shape);
    # None for the other bases
    compensated: object = None


def _per_epoch(x, t, epoch_ndim=None):
    """Give a batch-shaped element field trailing unit axes for the epoch
    axes: all of t's by default, or its last `epoch_ndim` where t carries
    the batch axes too (an AbsoluteVisual orbit's per-chain epochs)."""
    n = t.ndim if epoch_ndim is None else epoch_ndim
    return x.reshape(x.shape + (1,) * n)


def _solve_common(elem, t, a, e, epoch_ndim=None):
    """Kepler solve + in-plane coords shared by all element types. The
    epochs t are shared by every orbit of the batch, or with `epoch_ndim`
    (the number of epoch axes) one set per orbit, of shape B + T."""
    a, e = _per_epoch(a, t, epoch_ndim), _per_epoch(e, t, epoch_ndim)
    P = torch.sqrt(a**3 / _per_epoch(elem.M, t, epoch_ndim)) * KEPLER_YEAR_DAYS
    n = 2 * math.pi / P                         # rad/day
    MA = n * (t - _per_epoch(elem.tp, t, epoch_ndim))
    EA = kepler_solver(MA, e)
    sE, cE = torch.sin(EA), torch.cos(EA)
    sq = torch.sqrt(1 - e**2)
    X = a * (cE - e)
    Y = a * sq * sE
    Edot = n / (1 - e * cE)                     # rad/day
    VX = -a * sE * Edot
    VY = a * sq * cE * Edot
    nu = torch.atan2(Y, X)
    r = a * (1 - e * cE)
    return EA, nu, r, X, Y, VX, VY


def _kep_visual_fields(elem, t, epoch_ndim=None):
    """The 14 solution fields of a KepOrbit or VisualOrbit, composed of
    plain torch ops around `kepler_solver`. A KepOrbit has no parallax:
    its four sky fields are NaN. With `epoch_ndim` the epochs t carry the
    batch axes too, one set per orbit (`_solve_common`)."""
    EA, nu, r, X, Y, VX, VY = _solve_common(elem, t, elem.a, elem.e, epoch_ndim)
    A, B, F, G = (_per_epoch(x, t, epoch_ndim) for x in _thiele_innes_unit(elem))
    sw = _per_epoch(torch.sin(elem.omega), t, epoch_ndim)
    cw = _per_epoch(torch.cos(elem.omega), t, epoch_ndim)
    si = _per_epoch(torch.sin(elem.i), t, epoch_ndim)
    posx = B * X + G * Y
    posy = A * X + F * Y
    posz = si * (sw * X + cw * Y)
    vx = B * VX + G * VY
    vy = A * VX + F * VY
    vz = si * (sw * VX + cw * VY)
    if isinstance(elem, VisualOrbit):
        plx = _per_epoch(elem.plx, t, epoch_ndim)
    else:
        plx = torch.full_like(X, math.nan)
    raoff = posx * plx
    decoff = posy * plx
    pmra = vx * plx * JULIAN_YEAR_DAYS
    pmdec = vy * plx * JULIAN_YEAR_DAYS
    radvel = vz * AUDAY_TO_MS
    return EA, nu, r, posx, posy, posz, vx, vy, vz, raoff, decoff, pmra, pmdec, radvel


# rows of the fused path's (8, B) element tensor (a KepOrbit's plx row is
# NaN) and of its (14, B, T) solution tensor, the order `_kep_visual_fields`
# returns
_ELEMENT_ROWS = ("a", "e", "i", "omega", "Omega", "tp", "M", "plx")
FIELD_ROWS = ("EA", "nu", "r", "posx", "posy", "posz", "vx", "vy", "vz", "raoff_mas",
              "decoff_mas", "pmra_masyr", "pmdec_masyr", "radvel_ms")


def _orbit_solve_backward_plain(elems, t, EA, g, has_plx):
    """Plain PyTorch version of the backward kernel, line by line: the
    gradient with respect to `elems` (8, B) of sum(g * fields), for the
    cotangent g (14, B, T) of the fields at the eccentric anomaly EA
    (B, T). With `has_plx` false the four sky fields do not contribute."""
    a, e, inc, omega, Omega, tp, mass, plx = (x[:, None] for x in elems)
    n = 2 * math.pi / (torch.sqrt(a**3 / mass) * KEPLER_YEAR_DAYS)
    sq = torch.sqrt(1 - e * e)
    si, ci = torch.sin(inc), torch.cos(inc)
    sw, cw = torch.sin(omega), torch.cos(omega)
    sO, cO = torch.sin(Omega), torch.cos(Omega)
    A = cO * cw - sO * sw * ci
    B = sO * cw + cO * sw * ci
    F = -cO * sw - sO * cw * ci
    G = -sO * sw + cO * cw * ci
    # the orbit-plane state at EA
    dt = t - tp
    sE, cE = torch.sin(EA), torch.cos(EA)
    f1 = 1 - e * cE
    X = a * (cE - e)
    Y = a * sq * sE
    Edot = n / f1
    VX = -a * sE * Edot
    VY = a * sq * cE * Edot

    g_EA, g_nu, g_r, g_px, g_py, g_pz, g_vx, g_vy = g[:8]
    g_vz = g[8] + g[13] * AUDAY_TO_MS
    s_plx = torch.zeros_like(EA)
    if has_plx:
        # raoff = posx plx, decoff = posy plx, pmra = vx plx yr, pmdec too
        g_ra, g_dec = g[9], g[10]
        g_pmra, g_pmdec = g[11] * JULIAN_YEAR_DAYS, g[12] * JULIAN_YEAR_DAYS
        posx = B * X + G * Y
        posy = A * X + F * Y
        vx = B * VX + G * VY
        vy = A * VX + F * VY
        s_plx = g_ra * posx + g_dec * posy + g_pmra * vx + g_pmdec * vy
        g_px = g_px + g_ra * plx
        g_py = g_py + g_dec * plx
        g_vx = g_vx + g_pmra * plx
        g_vy = g_vy + g_pmdec * plx
    # projections: pos = (B X + G Y, A X + F Y, si (sw X + cw Y)), v alike
    zs, zc = si * sw, si * cw
    g_X = B * g_px + A * g_py + zs * g_pz
    g_Y = G * g_px + F * g_py + zc * g_pz
    g_VX = B * g_vx + A * g_vy + zs * g_vz
    g_VY = G * g_vx + F * g_vy + zc * g_vz
    s_A = X * g_py + VX * g_vy
    s_B = X * g_px + VX * g_vx
    s_F = Y * g_py + VY * g_vy
    s_G = Y * g_px + VY * g_vx
    s_si = g_pz * (sw * X + cw * Y) + g_vz * (sw * VX + cw * VY)
    s_sw = si * (g_pz * X + g_vz * VX)
    s_cw = si * (g_pz * Y + g_vz * VY)
    # nu = atan2(Y, X), written as autograd writes it
    inv_r2 = 1 / (X * X + Y * Y)
    g_X = g_X + g_nu * -Y * inv_r2
    g_Y = g_Y + g_nu * X * inv_r2
    # r = a f1
    s_a = g_r * f1
    g_f1 = g_r * a
    # X = a (cE - e)
    s_a = s_a + g_X * (cE - e)
    g_cE = a * g_X
    s_e = -a * g_X
    # Y = a sq sE
    s_a = s_a + g_Y * sq * sE
    s_sq = g_Y * a * sE
    g_sE = g_Y * a * sq
    # VX = -a sE Edot
    s_a = s_a - g_VX * sE * Edot
    g_sE = g_sE - g_VX * a * Edot
    g_Edot = -g_VX * a * sE
    # VY = a sq cE Edot
    s_a = s_a + g_VY * sq * cE * Edot
    s_sq = s_sq + g_VY * a * cE * Edot
    g_cE = g_cE + g_VY * a * sq * Edot
    g_Edot = g_Edot + g_VY * a * sq * cE
    # Edot = n / f1
    inv_f1 = 1 / f1
    s_n = g_Edot * inv_f1
    g_f1 = g_f1 - g_Edot * Edot * inv_f1
    # f1 = 1 - e cE
    s_e = s_e - cE * g_f1
    g_cE = g_cE - e * g_f1
    # sE = sin E, cE = cos E
    g_E = g_EA + g_sE * cE - g_cE * sE
    # E - e sin E = MA, implicitly: dE = (dMA + sin E de) / f1
    g_MA = g_E * inv_f1
    s_e = s_e + g_MA * sE
    # MA = n (t - tp)
    s_n = s_n + g_MA * dt
    s_MA = g_MA

    # sum over epochs, then the chain's constants back to its elements
    (s_a, s_e, s_sq, s_n, s_MA, s_plx, s_A, s_B, s_F, s_G, s_si, s_sw, s_cw) = (
        x.sum(dim=-1) for x in
        (s_a, s_e, s_sq, s_n, s_MA, s_plx, s_A, s_B, s_F, s_G, s_si, s_sw, s_cw))
    a, e, mass, n, sq, si, ci, sw, cw, sO, cO = (
        x[:, 0] for x in (a, e, mass, n, sq, si, ci, sw, cw, sO, cO))
    # sq = sqrt(1 - e^2); n = 2 pi / (year sqrt(a^3 / mass))
    g_e = s_e - s_sq * e / sq
    g_a = s_a - 1.5 * s_n * n / a
    g_mass = 0.5 * s_n * n / mass
    g_tp = -n * s_MA
    # A = cO cw - sO sw ci, B = sO cw + cO sw ci,
    # F = -cO sw - sO cw ci, G = -sO sw + cO cw ci
    g_cw = s_cw + s_A * cO + s_B * sO - s_F * sO * ci + s_G * cO * ci
    g_sw = s_sw - s_A * sO * ci + s_B * cO * ci - s_F * cO - s_G * sO
    g_cO = s_A * cw + s_B * sw * ci - s_F * sw + s_G * cw * ci
    g_sO = -s_A * sw * ci + s_B * cw - s_F * cw * ci - s_G * sw
    g_ci = -s_A * sO * sw + s_B * cO * sw - s_F * sO * cw + s_G * cO * cw
    g_i = s_si * ci - g_ci * si
    g_omega = g_sw * cw - g_cw * sw
    g_Omega = g_sO * cO - g_cO * sO
    return torch.stack([g_a, g_e, g_i, g_omega, g_Omega, g_tp, g_mass, s_plx])


class _OrbitSolve(torch.autograd.Function):
    """fields (14, B, T) of elems (8, B) and epochs t (T,), in one kernel
    forward and one backward for CUDA tensors and by the plain versions
    for CPU tensors. First derivatives with respect to `elems` only: a
    second derivative, or a `torch.func` transform, raises."""

    @staticmethod
    def forward(ctx, elems, t, has_plx):
        if elems.device.type == "cuda":
            out = orbit_solve_forward_cuda(elems, t)
        elif elems.device.type == "cpu":
            elem = VisualOrbit(*elems) if has_plx else KepOrbit(*elems[:7])
            out = torch.stack(_kep_visual_fields(elem, t))
        else:
            raise ValueError(f"orbitsolve has no fused kernel for device {elems.device}")
        ctx.save_for_backward(elems, t, out)
        ctx.has_plx = has_plx
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        elems, t, out = ctx.saved_tensors
        if elems.device.type == "cuda":
            gelems = orbit_solve_backward_cuda(elems, t, out[0], g.contiguous(), ctx.has_plx)
        else:
            gelems = _orbit_solve_backward_plain(elems, t, out[0], g, ctx.has_plx)
        return gelems, None, None


def _kep_visual_fields_fused(elem, t):
    """The 14 solution fields through `_OrbitSolve`: the element fields
    are broadcast to one batch shape and stacked into (8, B), the epochs
    flattened to (T,)."""
    if t.requires_grad:
        raise ValueError("the fused orbit solve has no gradient with respect to the "
                         "epochs; use orbitsolve(..., fused=False)")
    has_plx = isinstance(elem, VisualOrbit)
    rows = list(torch.broadcast_tensors(
        *(getattr(elem, name) for name in _ELEMENT_ROWS[: 8 if has_plx else 7])))
    if not has_plx:
        rows.append(torch.full_like(rows[0], math.nan))
    batch = rows[0].shape
    elems = torch.stack([x.reshape(-1) for x in rows])
    out = _OrbitSolve.apply(elems, t.reshape(-1).contiguous(), has_plx)
    out = out.reshape((out.shape[0],) + batch + t.shape)
    # indexed one by one, not unbound: autograd then fills the cotangent
    # from the fields in use alone, where unbind's backward stacks all 14
    return tuple(out[k] for k in range(out.shape[0]))


def orbitsolve(elem, t, *, fused=True):
    """Solve the orbit at epoch(s) t [MJD] -> OrbitSolution.

    t may be the full packed epoch array, giving one vectorized solution
    for every chain and epoch at once.

    fused: solve a KepOrbit or VisualOrbit with the fused Function (one
    kernel forward, one backward on a CUDA tensor). It gives first
    derivatives with respect to the elements only and raises on a second
    derivative, under `torch.func`, or for epochs that require a gradient:
    `fused=False` asks for the composed torch ops, which have all of these.
    The other element types have only the composed path, which they take
    whatever `fused` says."""
    other = _other_solvers().get(type(elem))
    ref = elem.e if other is None else elem.plx
    t = torch.as_tensor(t, dtype=ref.dtype, device=ref.device)

    if isinstance(elem, (KepOrbit, VisualOrbit)):
        solve = _kep_visual_fields_fused if fused else _kep_visual_fields
        (EA, nu, r, posx, posy, posz, vx, vy, vz,
         raoff, decoff, pmra, pmdec, radvel) = solve(elem, t)

    elif isinstance(elem, ThieleInnesOrbit):
        a = semimajoraxis(elem)
        EA, nu, r, X, Y, VX, VY = _solve_common(elem, t, a, elem.e)
        a = _per_epoch(a, t)
        # X, Y are in AU; the TI constants carry the mas scale, so the
        # on-sky projection uses the unit (a=1) in-plane coordinates.
        Xu, Yu, VXu, VYu = X / a, Y / a, VX / a, VY / a
        A, B, F, G = (_per_epoch(x, t) for x in (elem.A, elem.B, elem.F, elem.G))
        raoff = B * Xu + G * Yu
        decoff = A * Xu + F * Yu
        pmra = (B * VXu + G * VYu) * JULIAN_YEAR_DAYS
        pmdec = (A * VXu + F * VYu) * JULIAN_YEAR_DAYS
        # physical quantities via TI -> Campbell inversion
        _, inc, omega, _ = thiele_innes_to_campbell(A, B, F, G)
        si = torch.sin(inc)
        sw, cw = torch.sin(omega), torch.cos(omega)
        vz = si * (sw * VX + cw * VY)              # AU/day
        plx = _per_epoch(elem.plx, t)
        posx = raoff / plx
        posy = decoff / plx
        posz = si * (sw * X + cw * Y)
        vx = VX
        vy = VY
        radvel = vz * AUDAY_TO_MS

    elif isinstance(elem, RadialVelocityOrbit):
        EA, nu, r, X, Y, VX, VY = _solve_common(elem, t, elem.a, elem.e)
        sw = _per_epoch(torch.sin(elem.omega), t)
        cw = _per_epoch(torch.cos(elem.omega), t)
        posz = sw * X + cw * Y      # sin(i) = 1
        vz = sw * VX + cw * VY
        nanlike = torch.full_like(X, math.nan)
        posx = posy = vx = vy = nanlike
        raoff = decoff = pmra = pmdec = nanlike
        radvel = vz * AUDAY_TO_MS

    elif other is not None:
        return other(elem, t)

    else:
        raise TypeError(f"Unsupported orbit element type {type(elem).__name__}")

    return OrbitSolution(
        elem=elem, t=t, EA=EA, nu=nu, r=r,
        posx=posx, posy=posy, posz=posz, vx=vx, vy=vy, vz=vz,
        raoff_mas=raoff, decoff_mas=decoff,
        pmra_masyr=pmra, pmdec_masyr=pmdec, radvel_ms=radvel,
    )


def _other_solvers() -> dict:
    """{element type: its solve} for the bases of `absolute_visual.py` and
    `extra_bases.py`, which import this module."""
    from .absolute_visual import AbsoluteVisualOrbit, orbitsolve_absolute
    from .extra_bases import (
        CartesianOrbit, FixedPositionOrbit, HyperbolicOrbit, orbitsolve_cartesian,
        orbitsolve_fixed, orbitsolve_hyperbolic,
    )

    return {AbsoluteVisualOrbit: orbitsolve_absolute, CartesianOrbit: orbitsolve_cartesian,
            FixedPositionOrbit: orbitsolve_fixed, HyperbolicOrbit: orbitsolve_hyperbolic}


# --------------------------------------------------------------------------
# Solution accessors (PlanetOrbits API surface)
# --------------------------------------------------------------------------

def _reflex_factor(sol, mass):
    """-(m_companion / M_total): host-reflex weighting, per epoch."""
    M = totalmass(sol.elem)
    return _per_epoch(-_tensor(mass, M.device) / M, sol.t)


def raoff(sol, mass=None):
    if mass is None:
        return sol.raoff_mas
    return _reflex_factor(sol, mass) * sol.raoff_mas


def decoff(sol, mass=None):
    if mass is None:
        return sol.decoff_mas
    return _reflex_factor(sol, mass) * sol.decoff_mas


def pmra(sol, mass=None):
    if mass is None:
        return sol.pmra_masyr
    return _reflex_factor(sol, mass) * sol.pmra_masyr


def pmdec(sol, mass=None):
    if mass is None:
        return sol.pmdec_masyr
    return _reflex_factor(sol, mass) * sol.pmdec_masyr


def radvel(sol, mass=None):
    if mass is None:
        return sol.radvel_ms
    return _reflex_factor(sol, mass) * sol.radvel_ms


def posx(sol, mass=None):
    if mass is None:
        return sol.posx
    return _reflex_factor(sol, mass) * sol.posx


def posy(sol, mass=None):
    if mass is None:
        return sol.posy
    return _reflex_factor(sol, mass) * sol.posy


def posz(sol, mass=None):
    if mass is None:
        return sol.posz
    return _reflex_factor(sol, mass) * sol.posz


def projectedseparation(sol):
    """Projected separation in mas."""
    return torch.hypot(sol.raoff_mas, sol.decoff_mas)


def posangle(sol):
    """Position angle, North through East [rad]."""
    return torch.atan2(sol.raoff_mas, sol.decoff_mas)


def meananom(sol):
    elem = sol.elem
    return _per_epoch(meanmotion(elem), sol.t) * (sol.t - _per_epoch(elem.tp, sol.t))


def eccanom(sol):
    return sol.EA


def trueanom(sol):
    return sol.nu


def soltime(sol):
    return sol.t
