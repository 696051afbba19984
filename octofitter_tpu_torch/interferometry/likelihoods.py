"""Closure-phase + squared-visibility likelihood.

PyTorch port of `octofitter_tpu/interferometry/likelihoods.py` (the
reference's `InterferometryObs`, `OctofitterInterferometry.jl:13-300`):
model complex visibilities of the host + point-source companions, form
closure phases over the supplied baseline triangles, and compare with
measured closure phases (deg) and optionally squared visibilities.

The visibilities are carried as their real and imaginary parts, each a
real tensor of shape (rows, baselines, wavelengths): the phases are
atan2(im, re) and V^2 is |re + i im|^2, so autograd and the card see real
arithmetic only. `cvis_point_sources` still returns a complex tensor for
callers who want one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import MJUP2MSOL, RAD2AS
from ..likelihoods.utils import row_shape, take_epochs
from ..model.params import hasproperty
from ..model.variables import AbstractObs, SystemObservationContext
from ..orbits import decoff, raoff, semimajoraxis

MAS_TO_RAD = 1.0 / (RAD2AS * 1000.0)


def _cvis_sum(u, v, dra_mas, ddec_mas, contrasts):
    """(re, im) of host (flux 1) + point companions' visibility, not yet
    normalized: u, v (n_baseline, n_wave) tensors; offsets and contrasts
    sequences of tensors that broadcast against them (one per companion)."""
    re = torch.ones_like(u)
    im = torch.zeros_like(u)
    for dra, ddec, f in zip(dra_mas, ddec_mas, contrasts):
        arg = -2 * math.pi * (u * dra + v * ddec) * MAS_TO_RAD
        re = re + f * torch.cos(arg)
        im = im + f * torch.sin(arg)
    return re, im


def _cvis_parts(u, v, dra_mas, ddec_mas, contrasts):
    """(re, im) of the complex visibility normalized by the total flux."""
    re, im = _cvis_sum(u, v, dra_mas, ddec_mas, contrasts)
    norm = 1.0 + sum(contrasts)
    return re / norm, im / norm


def cvis_point_sources(u, v, dra_mas, ddec_mas, contrasts):
    """Complex visibility of host (flux 1) + point companions.

    u, v: (n_baseline, n_wave) in inverse wavelengths; dra/ddec lists of
    offsets (mas); contrasts list of contrasts. Normalized by total flux.
    (`cvis_bin!`, reference `:255-277`.) Numbers become float64 tensors."""
    u = torch.as_tensor(u, dtype=torch.float64) if not isinstance(u, torch.Tensor) else u
    v = torch.as_tensor(v, dtype=u.dtype, device=u.device)
    t = lambda x: torch.as_tensor(x, dtype=u.dtype, device=u.device)  # noqa: E731
    re, im = _cvis_parts(u, v, [t(x) for x in dra_mas], [t(x) for x in ddec_mas],
                         [t(x) for x in contrasts])
    return torch.complex(re, im)


def _closure_phases(re, im, i1, i2, i3):
    """Closure phases [deg] of the visibility (re, im) over triangles:
    phi(i1) + phi(i2) - phi(i3) on the baseline axis (the second to last),
    each phase in (-180, 180] and the sum not wrapped again."""
    phi = torch.rad2deg(torch.atan2(im, re))
    return phi[..., i1, :] + phi[..., i2, :] - phi[..., i3, :]


def closure_phases_deg(cvis, i1, i2, i3):
    """Closure phases [deg] over triangles (`closurephase!`,
    reference `:280-300`): phi(i1) + phi(i2) - phi(i3), each phase
    wrapped to (-180, 180]."""
    return _closure_phases(cvis.real, cvis.imag, i1, i2, i3)


def per_planet(flux, ctx, n_planets):
    """Each planet's contrast from a `flux` variable: one value per row for
    all planets (the rows' shape, or 0-d), or one per planet on a last
    axis (the rows' shape plus that axis, or a constant vector). The JAX
    package tells the two apart by `jnp.ndim` under its per-chain vmap;
    here the rows' shape (`row_shape`) does."""
    rows = row_shape(ctx)
    if not isinstance(flux, torch.Tensor):
        flux = torch.as_tensor(np.asarray(flux, dtype=np.float64))
    if flux.ndim == 0 or (tuple(flux.shape) == rows and flux.ndim == len(rows)):
        return [flux] * n_planets
    return [flux[..., i] for i in range(n_planets)]


def _trailing(x, k):
    """A per-row tensor with k trailing unit axes (numbers unchanged)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(x.shape + (1,) * k)
    return x


class AbstractInterferometryObs(AbstractObs):
    """Supertype of interferometric observation objects (reference
    `OctofitterInterferometry.jl:10` AbstractInterferometryLikelihood)."""

    def _row(self, i, key, like):
        """Epoch row i's array `key` as a tensor of `like`'s dtype and
        device, converted once."""
        return self.constant((key, i), lambda: np.asarray(self.rows[i][key], dtype=np.float64),
                             like)


class InterferometryObs(AbstractInterferometryObs):
    """Closure phases + V^2 from interferometric observations.

    observations: list of per-epoch dicts with keys
      epoch (MJD), u, v ((n_baseline, n_wave), inverse wavelengths),
      cps_data, dcps ((n_triangle, n_wave), degrees),
      vis2_data, dvis2 ((n_baseline, n_wave)),
      index_cps1/2/3 (triangle index arrays into the baseline axis),
      use_vis2 (bool); or a `filename` of an OIFITS file (`load_oifits`)
      with the other keys (epoch, wavelength window, use_vis2) passed on.
    Observation variables: `flux` (companion flux contrasts: one for all,
    or one per planet on a last axis), optional `σ_cp_jitter` (deg),
    `platescale`, `northangle`.
    """

    def __init__(self, observations, variables=None, name="interferometry"):
        super().__init__(variables=variables, name=name)
        from .oifits import load_oifits

        rows = [dict(r) for r in observations]
        rows = [load_oifits(**r) if "filename" in r else r for r in rows]
        for r in rows:
            dcps = np.asarray(r["dcps"], dtype=np.float64)
            if np.any(dcps == 0):
                # clamp CP errors to >= 2 degrees (reference `:89-93`)
                dcps = np.maximum(2.0, dcps)
            r["dcps"] = dcps
        rows.sort(key=lambda r: float(r["epoch"]))
        self.rows = rows
        self.table = {"epoch": np.asarray([float(r["epoch"]) for r in rows])}

    # ------------------------------------------------------------------
    def _positions(self, ctx, i_epoch):
        """Model (dra, ddec) [mas] of each companion at epoch i, each of
        the rows' shape, including inner-companion photocentre shifts."""
        theta = ctx.theta_system
        theta_obs = ctx.theta_obs
        platescale = theta_obs.get("platescale", 1.0)
        northangle = theta_obs.get("northangle", 0.0)
        pnames = list(theta.planets.keys())
        n_p = len(pnames)
        sols = [take_epochs(ctx.solutions[j], ctx.epoch_start + i_epoch, 1) for j in range(n_p)]
        dras, ddecs = [], []
        for i in range(n_p):
            ra = raoff(sols[i])[..., 0]
            dec = decoff(sols[i])[..., 0]
            a_this = semimajoraxis(ctx.orbits[i])
            for j in range(n_p):
                if j == i:
                    continue
                theta_o = theta.planets[pnames[j]]
                if not hasproperty(theta_o, "mass"):
                    continue
                w = (semimajoraxis(ctx.orbits[j]) < a_this).to(ra.dtype)
                m = theta_o.mass * MJUP2MSOL
                ra = ra - w * raoff(sols[j], m)[..., 0]
                dec = dec - w * decoff(sols[j], m)[..., 0]
            angle = torch.as_tensor(northangle, dtype=ra.dtype, device=ra.device)
            c, s = torch.cos(angle), torch.sin(angle)
            ra_r = ra * c - dec * s
            dec_r = ra * s + dec * c
            dras.append(ra_r * platescale)
            ddecs.append(dec_r * platescale)
        return dras, ddecs

    def ln_like(self, ctx: SystemObservationContext):
        theta_obs = ctx.theta_obs
        sig_jit = _trailing(theta_obs.get("σ_cp_jitter", 0.0), 2)
        n_p = len(ctx.theta_system.planets)
        contrasts = [_trailing(f, 2) for f in per_planet(theta_obs["flux"], ctx, n_p)]

        ll = 0.0
        for i_epoch, r in enumerate(self.rows):
            dras, ddecs = self._positions(ctx, i_epoch)
            like = dras[0]
            u, v = self._row(i_epoch, "u", like), self._row(i_epoch, "v", like)
            re, im = _cvis_parts(u, v, [_trailing(d, 2) for d in dras],
                                 [_trailing(d, 2) for d in ddecs], contrasts)
            i1 = np.asarray(r["index_cps1"], dtype=int)
            i2 = np.asarray(r["index_cps2"], dtype=int)
            i3 = np.asarray(r["index_cps3"], dtype=int)
            cps_model = _closure_phases(re, im, i1, i2, i3)
            cps_data = self._row(i_epoch, "cps_data", like)
            dcps = self._row(i_epoch, "dcps", like)
            var = dcps**2 + sig_jit**2
            ll = ll + torch.sum(
                -0.5 * (cps_data - cps_model) ** 2 / var - 0.5 * torch.log(2 * math.pi * var),
                dim=(-2, -1))
            if r.get("use_vis2", False):
                vis2 = torch.hypot(re, im) ** 2
                v2d = self._row(i_epoch, "vis2_data", like)
                dv2 = self._row(i_epoch, "dvis2", like)
                ll = ll + torch.sum(
                    -0.5 * (v2d - vis2) ** 2 / dv2**2 - 0.5 * torch.log(2 * math.pi * dv2**2),
                    dim=(-2, -1))
        return ll

    def likeobj_from_epoch_subset(self, idx):
        idx = np.atleast_1d(idx)
        new = object.__new__(type(self))
        AbstractObs.__init__(new, variables=None, name=self.name)
        new.var_specs = self.var_specs
        new.rows = [self.rows[i] for i in idx]
        new.table = {"epoch": self.table["epoch"][idx]}
        return new


InterferometryLikelihood = InterferometryObs
AbstractInterferometryLikelihood = AbstractInterferometryObs
