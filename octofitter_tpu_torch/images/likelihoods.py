"""Direct-image likelihoods.

PyTorch port of `octofitter_tpu/images/likelihoods.py` (the reference's
`OctofitterImages`, `images.jl`, `likelihood-maps.jl`): each image (and
its contrast curve or map) is read at the model position of the
companion, and the Ruffio 2017 (eq 31) / Mawet 2019 (eq 8) likelihood
    ll_i = -(flux^2 - 2 flux f_x) / (2 sigma_x^2)
is applied. Image grids are centered: (0, 0) is the star, +x is -RA,
+y is +Dec, in units of `platescale` mas/px.

The chain axis is written out: positions are (rows, epochs). The epochs
whose images share a shape (and whose contrasts are alike: maps of one
shape, or curves) are read as one stack in one gather, so a group costs
the same launches however many epochs it holds. Images, maps and curves
are converted to the model's dtype and device once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import MJUP2MSOL
from ..likelihoods.utils import per_epoch, take_epochs
from ..model.params import hasproperty
from ..model.variables import AbstractObs, PlanetObservationContext
from ..orbits import decoff, raoff, semimajoraxis
from .utils_interp import interp_image_centered


def contrast_curve(image: np.ndarray, step_px: float = 2.0) -> tuple:
    """Azimuthal-std contrast curve of a centered image
    (`images.jl:93-139`). Returns (radii_px, sigma)."""
    ny, nx = image.shape
    y, x = np.mgrid[0:ny, 0:nx]
    cx, cy = (nx - 1) / 2, (ny - 1) / 2
    dr = np.hypot(x - cx, y - cy)
    rmax = dr.max()
    bins = np.arange(0, rmax, step_px)
    radii, sigmas = [], []
    for lo in bins:
        mask = (dr >= lo) & (dr < lo + step_px) & np.isfinite(image)
        if mask.sum() > 5:
            radii.append(lo + step_px / 2)
            sigmas.append(np.std(image[mask]))
    return np.asarray(radii), np.asarray(sigmas)


def _sky_to_image(ra, dec):
    """Image-frame (x, y) of a sky offset: x is -RA (`images.jl:210-212`),
    y is +Dec."""
    return -ra, dec


def _groups(keys):
    """Epoch indices grouped by key, in order of first appearance."""
    out = {}
    for i, k in enumerate(keys):
        out.setdefault(k, []).append(i)
    return list(out.items())


def _take(x, idx, n):
    """x[..., idx]: a slice where idx is a run of epochs, else a gather."""
    if idx == list(range(idx[0], idx[0] + len(idx))):
        return x if len(idx) == n else x[..., idx[0]: idx[0] + len(idx)]
    return x[..., idx]


def _join(parts, groups, n):
    """The groups' (rows, group epochs) results back in epoch order."""
    if len(parts) == 1:
        return parts[0]
    order = np.concatenate([idx for _, idx in groups])
    inverse = torch.as_tensor(np.argsort(order), device=parts[0].device)
    return torch.cat(parts, dim=-1)[..., inverse]


def _interp_curves(r, radii, sigmas):
    """`jnp.interp(r, radii, sigmas)` for each epoch's curve at once: r is
    (..., G), radii and sigmas (G, L), each row increasing. Outside a
    curve its end values hold. Curves shorter than L were padded past
    their last radius with their last sigma, which reads the same there."""
    lead = r.shape[:-1]
    rt = r.reshape(-1, r.shape[-1]).T.contiguous()  # (G, rows)
    n = radii.shape[-1]
    i = torch.clamp(torch.searchsorted(radii, rt, right=True), 1, n - 1)
    x0, x1 = torch.gather(radii, 1, i - 1), torch.gather(radii, 1, i)
    f0, f1 = torch.gather(sigmas, 1, i - 1), torch.gather(sigmas, 1, i)
    df = f1 - f0
    dx = x1 - x0
    delta = rt - x0
    eps = float(np.spacing(np.finfo(str(r.dtype).removeprefix("torch.")).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f0, f0 + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(rt < radii[:, :1], sigmas[:, :1], f)
    f = torch.where(rt > radii[:, -1:], sigmas[:, -1:], f)
    return f.T.reshape(lead + (r.shape[-1],))


class ImageObs(AbstractObs):
    """Direct-image likelihood.

    observations: list of dicts with keys `image` (2D array, centered),
    `epoch` (MJD), `platescale` (mas/px); optional `contrast` as
    (radii_px, sigma) tuple or `contrastmap` 2D array. The observation
    variables must include `flux` (band flux of the companion);
    optional `platescale` (multiplier) and `northangle` nuisances.
    """

    def __init__(self, observations, variables=None, name="images"):
        super().__init__(variables=variables, name=name)
        rows = list(observations)
        epochs = np.asarray([float(r["epoch"]) for r in rows])
        order = np.argsort(epochs, kind="stable")
        rows = [rows[i] for i in order]
        self._epochs = epochs[order]
        self.images = [np.asarray(r["image"], dtype=np.float64) for r in rows]
        self.platescales = np.asarray([float(r["platescale"]) for r in rows])
        self.contrastmaps = []
        self.contrasts = []
        for r in rows:
            if "contrastmap" in r:
                self.contrastmaps.append(np.asarray(r["contrastmap"], dtype=np.float64))
                self.contrasts.append(None)
            else:
                if "contrast" in r:
                    radii, sig = r["contrast"]
                else:
                    radii, sig = contrast_curve(np.asarray(r["image"], dtype=np.float64))
                self.contrastmaps.append(None)
                self.contrasts.append((np.asarray(radii, dtype=np.float64),
                                       np.asarray(sig, dtype=np.float64)))
        self.table = {"epoch": self._epochs}
        self._set_groups()

    def _set_groups(self):
        keys = [(im.shape, "map", cm.shape) if cm is not None else (im.shape, "curve")
                for im, cm in zip(self.images, self.contrastmaps)]
        self._groups = _groups(keys)

    def _stack(self, g, like):
        """Group g's images, contrast maps or padded curves, and
        platescales, as tensors of `like`'s dtype and device."""
        key, idx = self._groups[g]

        def curves(part):
            n = max(len(self.contrasts[i][0]) for i in idx)
            out = []
            for i in idx:
                radii, sig = self.contrasts[i]
                pad = n - len(radii)
                out.append(np.concatenate([radii, radii[-1] + np.arange(1, pad + 1)]) if part == 0
                           else np.concatenate([sig, np.full(pad, sig[-1])]))
            return np.stack(out)

        c = lambda name, make: self.constant((name, g), make, like)  # noqa: E731
        out = {"images": c("images", lambda: np.stack([self.images[i] for i in idx])),
               "platescale": c("platescale", lambda: self.platescales[idx])}
        if key[1] == "map":
            out["contrastmap"] = c("contrastmap",
                                   lambda: np.stack([self.contrastmaps[i] for i in idx]))
        else:
            out["radii"] = c("radii", lambda: curves(0))
            out["sigmas"] = c("sigmas", lambda: curves(1))
        return out

    # ------------------------------------------------------------------
    def _model_xy(self, ctx: PlanetObservationContext):
        """Image-frame (x, y) [mas] of the companion at every epoch, with
        the photocentre shift of interior massive companions and the
        `northangle` rotation: (rows, epochs) each."""
        n = len(self._epochs)
        sol = take_epochs(ctx.solutions[ctx.i_planet], ctx.epoch_start, n)
        ra = raoff(sol)
        dec = decoff(sol)
        a_this = semimajoraxis(ctx.orbits[ctx.i_planet])
        planets = ctx.theta_system.planets
        for j, pname in enumerate(planets.keys()):
            theta_p = planets[pname]
            if not hasproperty(theta_p, "mass") or j == ctx.i_planet:
                continue
            w = per_epoch((semimajoraxis(ctx.orbits[j]) < a_this).to(ra.dtype), ctx)
            sol_o = take_epochs(ctx.solutions[j], ctx.epoch_start, n)
            m = theta_p.mass * MJUP2MSOL
            ra = ra - w * raoff(sol_o, m)
            dec = dec - w * decoff(sol_o, m)

        northangle = per_epoch(torch.as_tensor(ctx.theta_obs.get("northangle", 0.0),
                                               dtype=ra.dtype, device=ra.device), ctx)
        c, s = torch.cos(northangle), torch.sin(northangle)
        ra_r = ra * c - dec * s
        dec_r = ra * s + dec * c
        return _sky_to_image(ra_r, dec_r)

    def ln_like(self, ctx: PlanetObservationContext):
        return torch.sum(self.pointwise_ln_like(ctx), dim=-1)

    def pointwise_ln_like(self, ctx: PlanetObservationContext):
        theta = ctx.theta_system.merge(ctx.theta_planet).merge(ctx.theta_obs)
        flux = per_epoch(theta["flux"], ctx)
        ps_mult = per_epoch(ctx.theta_obs.get("platescale", 1.0), ctx)
        x, y = self._model_xy(ctx)
        n = len(self._epochs)

        parts = []
        for g, (key, idx) in enumerate(self._groups):
            d = self._stack(g, x)
            ps = d["platescale"] * ps_mult
            xi, yi = _take(x, idx, n) / ps, _take(y, idx, n) / ps
            f = interp_image_centered(d["images"], xi, yi)
            f = torch.where(torch.isfinite(f), f, 0.0)
            if key[1] == "map":
                sig = interp_image_centered(d["contrastmap"], xi, yi)
            else:
                sig = _interp_curves(torch.hypot(xi, yi), d["radii"], d["sigmas"])
            bad = (~torch.isfinite(sig)) | (sig == 0)
            sig = torch.where(bad, 1.0, sig)
            ll = -(flux**2 - 2 * flux * f) / (2 * sig**2)
            parts.append(torch.where(bad, -torch.inf, ll))
        return _join(parts, self._groups, n)

    def likeobj_from_epoch_subset(self, idx):
        idx = np.atleast_1d(idx)
        new = object.__new__(type(self))
        AbstractObs.__init__(new, variables=None, name=self.name)
        new.var_specs = self.var_specs
        new._epochs = self._epochs[idx]
        new.images = [self.images[i] for i in idx]
        new.platescales = self.platescales[idx]
        new.contrastmaps = [self.contrastmaps[i] for i in idx]
        new.contrasts = [self.contrasts[i] for i in idx]
        new.table = {"epoch": new._epochs}
        new._set_groups()
        return new


class LogLikelihoodMapObs(AbstractObs):
    """External per-epoch log-likelihood maps over (Delta-RA, Delta-Dec)
    (`OctofitterImages/src/likelihood-maps.jl:37-201`).

    observations: dicts with `map` (2D ll values, centered), `epoch`,
    `platescale` (mas/px); optional `fillvalue` for out-of-map positions.
    """

    def __init__(self, observations, variables=None, name="llmaps", fillvalue=-1e4):
        super().__init__(variables=variables, name=name)
        rows = list(observations)
        epochs = np.asarray([float(r["epoch"]) for r in rows])
        order = np.argsort(epochs, kind="stable")
        rows = [rows[i] for i in order]
        self._epochs = epochs[order]
        self.maps = [np.asarray(r["map"], dtype=np.float64) for r in rows]
        self.platescales = np.asarray([float(r["platescale"]) for r in rows])
        self.fillvalues = np.asarray([float(r.get("fillvalue", fillvalue)) for r in rows])
        self.table = {"epoch": self._epochs}
        self._groups = _groups([m.shape for m in self.maps])

    def ln_like(self, ctx: PlanetObservationContext):
        return torch.sum(self.pointwise_ln_like(ctx), dim=-1)

    def pointwise_ln_like(self, ctx: PlanetObservationContext):
        n = len(self._epochs)
        sol = take_epochs(ctx.solutions[ctx.i_planet], ctx.epoch_start, n)
        x, y = _sky_to_image(raoff(sol), decoff(sol))
        parts = []
        for g, (_, idx) in enumerate(self._groups):
            c = lambda name, make: self.constant((name, g), make, x)  # noqa: E731
            maps = c("maps", lambda: np.stack([self.maps[i] for i in idx]))
            ps = c("platescale", lambda: self.platescales[idx])
            fill = c("fillvalue", lambda: self.fillvalues[idx])
            v = interp_image_centered(maps, _take(x, idx, n) / ps, _take(y, idx, n) / ps)
            parts.append(torch.where(torch.isfinite(v), v, fill))
        return _join(parts, self._groups, n)

    def likeobj_from_epoch_subset(self, idx):
        idx = np.atleast_1d(idx)
        new = object.__new__(type(self))
        AbstractObs.__init__(new, variables=None, name=self.name)
        new.var_specs = self.var_specs
        new._epochs = self._epochs[idx]
        new.maps = [self.maps[i] for i in idx]
        new.platescales = self.platescales[idx]
        new.fillvalues = self.fillvalues[idx]
        new.table = {"epoch": new._epochs}
        new._groups = _groups([m.shape for m in new.maps])
        return new


ImageLikelihood = ImageObs
# reference alias (OctofitterImages/src/likelihood-maps.jl:76)
LogLikelihoodMap = LogLikelihoodMapObs
