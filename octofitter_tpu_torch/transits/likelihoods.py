"""Limb-darkened transit light-curve likelihood.

PyTorch port of `octofitter_tpu/transits/likelihoods.py` (the reference's
`OctofitterTransits`, `OctofitterTransits.jl:14-108`): a photometric light
curve against the limb-darkened occultation depth of the orbit solution.
The occulted flux is a fixed-order (64-point) Gauss-Legendre quadrature of
the limb-darkening profile against the two-circle overlap arc: branch-free
and differentiable, over tensors of shape (rows, epochs, 64).

System variables: `R` (stellar radius in meters), limb-darkening
coefficients u1..u4; planet variables: `r` (radius ratio). The occultation
is gated on the companion being in front of the star (line-of-sight
z < 0).

The arc angle's arccos is taken only inside (-1 + tol, 1 - tol), with the
argument replaced by 0 elsewhere (a double `where`), so that its infinite
edge derivative never meets the masked branch's zero cotangent. tol is
the JAX package's 1e-12 in float64; 1e-12 rounds away against 1 in
float32, so there tol is float32's epsilon (2^-23). The JAX package clips
the argument instead, which gives the same values and gradients in
float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import IAU_AU_M
from ..likelihoods.utils import gauss_logpdf, per_epoch, row_shape, take_epochs
from ..model.variables import AbstractObs, SystemObservationContext, prepare_table
from ..orbits import posx, posy, posz

_QUAD_N = 64
_GL_X, _GL_W = np.polynomial.legendre.leggauss(_QUAD_N)
_NODES = {}


def _nodes(like):
    """The Gauss-Legendre nodes and weights as tensors of `like`'s dtype
    and device, converted once."""
    key = (like.dtype, like.device)
    if key not in _NODES:
        _NODES[key] = (torch.as_tensor(_GL_X, dtype=like.dtype, device=like.device),
                       torch.as_tensor(_GL_W, dtype=like.dtype, device=like.device))
    return _NODES[key]


def _edge_tol(dtype) -> float:
    return 1e-12 if dtype == torch.float64 else float(torch.finfo(dtype).eps)


def _safe_mu(rho):
    """sqrt(1 - rho^2) with a finite gradient at rho = 1."""
    x = 1 - rho * rho
    inside = x > 1e-12
    return torch.where(inside, torch.sqrt(torch.where(inside, x, 1.0)), 0.0)


class QuadLimbDark:
    """I(mu) = 1 - u1(1-mu) - u2(1-mu)^2."""

    def __init__(self, u1=0.0, u2=0.0):
        self.u = (u1, u2)

    def intensity(self, rho):
        mu = _safe_mu(rho)
        u1, u2 = self.u
        return 1 - u1 * (1 - mu) - u2 * (1 - mu) ** 2


class NonlinearLimbDark:
    """Claret 4-parameter law: I = 1 - sum_k u_k (1 - mu^(k/2))."""

    def __init__(self, u1=0.0, u2=0.0, u3=0.0, u4=0.0):
        self.u = (u1, u2, u3, u4)

    def intensity(self, rho):
        mu = _safe_mu(rho)
        out = torch.ones_like(mu)
        for k, uk in enumerate(self.u, start=1):
            out = out - uk * (1 - mu ** (k / 2.0))
        return out


def _with_node_axis(ld):
    """`ld` with each tensor coefficient given a trailing axis, so that it
    broadcasts against the quadrature nodes."""
    new = object.__new__(type(ld))
    new.u = tuple(u[..., None] if isinstance(u, torch.Tensor) else u for u in ld.u)
    return new


def _occulted_fraction(ld, b, r):
    """Fraction of stellar flux occulted by a disk of radius ratio r at
    projected separation b (stellar radii): b (...), r and the
    coefficients of `ld` broadcasting against it."""
    ld = _with_node_axis(ld)
    # |b| with the slope +1 at 0, as `jnp.abs`'s
    b = torch.where(b >= 0, b, -b)
    r = torch.as_tensor(r, dtype=b.dtype, device=b.device)
    x, w = _nodes(b)
    # integration range over stellar radius rho where partial overlap occurs
    lo = torch.clamp(b - r, 0.0, 1.0)
    hi = torch.clamp(b + r, 0.0, 1.0)
    mid = (hi + lo) / 2
    half = (hi - lo) / 2
    rho = mid[..., None] + half[..., None] * x  # (..., N)
    # arc angle of the overlap at radius rho: cos(kappa) = (rho^2+b^2-r^2)/(2 rho b)
    bb = b[..., None]
    rr = r[..., None]
    denom = 2 * rho * bb
    pos = denom > 0
    cosk = torch.where(
        pos, (rho**2 + bb**2 - rr**2) / torch.where(pos, torch.clamp(denom, min=1e-30), 1.0), 1.0)
    tol = _edge_tol(b.dtype)
    interior = torch.abs(cosk) < 1.0 - tol
    kappa = torch.where(
        interior,
        torch.arccos(torch.where(interior, cosk, 0.0)),
        # (a tensor for pi: a `where` of two numbers would be float32)
        torch.where(cosk >= 1.0 - tol, 0.0, torch.full_like(cosk, math.pi)),
    )
    integrand = ld.intensity(rho) * kappa * rho
    partial = 2 * torch.sum(integrand * w, dim=-1) * half

    # fully-covered inner disk (rho < r - b): full annulus 2*pi
    hi_full = torch.clamp(r - b, 0.0, 1.0)
    mid_f = (hi_full + 0.0) / 2
    half_f = (hi_full - 0.0) / 2
    rho_f = mid_f[..., None] + half_f[..., None] * x
    full = 2 * math.pi * torch.sum(ld.intensity(rho_f) * rho_f * w, dim=-1) * half_f

    # total stellar flux normalization
    rho_n = 0.5 + 0.5 * x
    total = 2 * math.pi * torch.sum(ld.intensity(rho_n) * rho_n * w, dim=-1) * 0.5
    return (partial + full) / total


def transit_depth(ld, b, r, in_front):
    """Relative flux (1 = unocculted). Numbers become float64 tensors on
    the CPU."""
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, dtype=torch.float64)
    depth = _occulted_fraction(ld, b, r)
    in_front = torch.as_tensor(in_front, device=b.device)
    return torch.where(in_front, 1.0 - depth, 1.0)


class LightCurveObs(AbstractObs):
    """Photometric transit light curve (`OctofitterTransits.jl:14-108`).

    Columns: epoch (MJD), phot (relative flux), σ_phot.
    """

    def __init__(self, observations, variables=None, name="lightcurve",
                 limbdark="quad"):
        super().__init__(variables=variables, name=name)
        if isinstance(observations, dict):
            observations = {
                k.replace("sigma_", "σ_") if k.startswith("sigma_") else k: v
                for k, v in observations.items()
            }
        self.table = prepare_table(
            observations, (("epoch", "phot", "σ_phot"),), type(self).__name__
        )
        self.limbdark = limbdark

    def _ld(self, theta, ctx):
        us = [theta.get(f"u{k}") for k in (1, 2, 3, 4)]
        us = [per_epoch(u, ctx) for u in us if u is not None]
        if self.limbdark == "quad" or len(us) <= 2:
            return QuadLimbDark(*us[:2])
        return NonlinearLimbDark(*us)

    def simulate(self, ctx: SystemObservationContext):
        """The model light curve, (rows, epochs): the product of every
        planet's transit depth (the planets with a radius ratio `r`)."""
        theta = ctx.theta_system
        ld = self._ld(theta, ctx)
        R_star_au = per_epoch(theta["R"], ctx) / IAU_AU_M
        n = len(self.table["epoch"])
        phot = None
        for j, pname in enumerate(theta.planets.keys()):
            theta_p = theta.planets[pname]
            if "r" not in theta_p:
                continue
            sol = take_epochs(ctx.solutions[j], ctx.epoch_start, n)
            b = torch.hypot(posx(sol), posy(sol)) / R_star_au
            in_front = posz(sol) < 0
            depth = transit_depth(ld, b, per_epoch(theta_p.r, ctx), in_front)
            phot = depth if phot is None else phot * depth
        if phot is None:
            phot = torch.ones(row_shape(ctx) + (n,), dtype=R_star_au.dtype,
                              device=R_star_au.device)
        return {"phot_model": phot, "epochs": self.table["epoch"]}

    def pointwise_ln_like(self, ctx):
        model = self.simulate(ctx)["phot_model"]
        resid = model - self.column("phot", model)
        return gauss_logpdf(resid, self.column("σ_phot", model))

    def ln_like(self, ctx):
        return torch.sum(self.pointwise_ln_like(ctx), dim=-1)

    def _copy(self, table):
        new = object.__new__(type(self))
        AbstractObs.__init__(new, variables=None, name=self.name)
        new.var_specs = self.var_specs
        new.table = table
        new.limbdark = self.limbdark
        return new

    def generate_from_params(self, ctx, rng, add_noise=False):
        model = self.simulate(ctx)["phot_model"].detach().cpu().double().numpy()
        table = {k: np.array(v) for k, v in self.table.items()}
        phot = model
        if add_noise:
            phot = phot + rng.standard_normal(phot.shape) * table["σ_phot"]
        table["phot"] = phot
        return self._copy(table)

    def likeobj_from_epoch_subset(self, idx):
        return self._copy({k: np.asarray(v)[idx] for k, v in self.table.items()})


LightCurveLikelihood = LightCurveObs
