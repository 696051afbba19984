"""GRAVITY-Wide kernel-phase likelihood.

PyTorch port of `octofitter_tpu/interferometry/gravity.py` (the
reference's `GRAVITY.jl` + `GRAVITY-correlation.jl`, `GRAVITYWideKPObs`):
closure phases projected into a kernel-phase basis (Cholesky of the
closure design matrix), fiber-coupling throughput loss for off-centre
companions, and Jens' semi-analytic block-diagonal kernel-phase
correlation matrix with spectral correlation parameter `kp_Cy` and
additive `kp_jitter`.

The fiber-coupling table and the kernel-phase basis are built once on the
host (numpy and scipy) when the observation is made. Per evaluation, the
coupling is one bilinear lookup over (rows, wavelengths); the covariance
is factored block by block, every (n_wave, n_wave) block of every row in
one batched Cholesky (`rv/kernels.py:_gated_cholesky`): a row whose
covariance is not positive definite gives -inf with a zero gradient row,
where the JAX package's Cholesky returns NaN and its gate gives -inf.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..atmosphere import interp2d_bilinear
from ..likelihoods.utils import take_epochs
from ..model.variables import AbstractObs, SystemObservationContext
from ..orbits import decoff, projectedseparation, raoff
from ..rv.kernels import _gated_cholesky
from .likelihoods import (AbstractInterferometryObs, _closure_phases, _cvis_sum, _trailing,
                          per_planet)

# GRAVITY/VLTI closure design matrix: 4 triangles from 6 baselines
# (`GRAVITY.jl:48-53`)
_T_GRAVITY = np.array(
    [
        [1, -1, 0, 1, 0, 0],
        [1, 0, -1, 0, 1, 0],
        [0, 1, -1, 0, 0, 1],
        [0, 0, 0, 1, -1, 1],
    ],
    dtype=np.int8,
)
_LOG_2PI = math.log(2 * math.pi)


def fiber_coupling_fraction(theta_mas, lambda_m=2.2e-6, n_grid=500):
    """Fiber coupling efficiency vs offset (mas) at one wavelength.

    Fraunhofer overlap integral of a tilted pupil field with a Gaussian
    fiber mode (`fiber_coupling_fraction`, `GRAVITY.jl:115-129`; credit
    W. Balmer, D. Bakely et al. in the reference). The tilt's phase runs
    along the first pupil axis only, so the overlap sums the fiber mode
    over the second axis once and then one phase per row: the same sums
    as the JAX package's full grid per offset, in another order.
    """
    theta_mas = np.atleast_1d(np.asarray(theta_mas, dtype=np.float64))
    D = 8.0
    x = np.linspace(-2 * D, 2 * D, n_grid)
    r = np.hypot(x[:, None], x[None, :])
    m = r < D / 2
    w0 = 0.32 * D
    field_fiber = np.exp(-(r**2) / (2 * w0**2))
    mas2rad = 1e-3 / (180 / np.pi * 3600)
    masked = m * field_fiber
    denom = abs(masked.sum()) ** 2
    row_sums = masked.sum(axis=1)
    phase = x[None, :] / lambda_m * theta_mas[:, None] * mas2rad * 2 * np.pi
    return np.abs(np.exp(1j * phase) @ row_sums) ** 2 / denom


def _kernel_phase_basis(n_wave: int, T=_T_GRAVITY):
    """Kernel-phase projection P1 ((3*n_wave) x (4*n_wave)) from the
    wavelength-replicated design matrix (`GRAVITY.jl:55-79`)."""
    import scipy.linalg as sla

    nT, nB = T.shape
    TL = np.zeros((n_wave * nT, n_wave * nB))
    for bi in range(nT):
        for bj in range(nB):
            for wi in range(n_wave):
                TL[wi + bi * n_wave, wi + bj * n_wave] = T[bi, bj]
    M = TL @ TL.T
    L = sla.cholesky(M + 1e-10 * np.eye(M.shape[0]), lower=True)
    P1 = L / np.sqrt(np.diag(L @ L.T))[:, None]
    d = np.diag(P1)
    i_max = int(np.argmax(d <= 1e-5)) if np.any(d <= 1e-5) else len(d)
    return P1[:, :i_max].T  # (i_max, 4*n_wave) -> rows are KP combinations


def _blocks(n_kp: int, n_wave: int) -> tuple[int, int]:
    """(number, size) of the covariance's diagonal blocks: the JAX
    package's kron(eye(n_kp // n_wave), block)[:n_kp, :n_kp]."""
    n_blocks = max(n_kp // n_wave, 1)
    if n_blocks * n_wave == n_kp:
        return n_blocks, n_wave
    if n_kp < n_wave:
        return 1, n_kp
    raise ValueError(f"{n_kp} kernel phases do not fill blocks of {n_wave} wavelengths")


class GRAVITYWideKPObs(AbstractInterferometryObs):
    """GRAVITY wide-field kernel phases.

    observations: per-epoch dicts with keys epoch, u, v
    ((n_baseline, n_wave), inverse wavelengths), cps_data/dcps
    ((4, n_wave), deg), index_cps1/2/3, eff_wave (m).
    Observation variables: `flux` (per-planet contrast), optional
    `kp_jitter` (deg), `kp_Cy` (spectral correlation in [0,1)).
    """

    def __init__(self, observations, variables=None, name="GRAVITY-WIDE"):
        super().__init__(variables=variables, name=name)
        rows = [dict(r) for r in observations]
        rows.sort(key=lambda r: float(r["epoch"]))
        for r in rows:
            r["dcps"] = np.maximum(np.asarray(r["dcps"], dtype=np.float64), 1e-3)
            n_wave = len(np.asarray(r["eff_wave"]))
            P1 = _kernel_phase_basis(n_wave)
            r["P1"] = P1
            # CP vector layout: triangle-major, wavelengths contiguous
            r["sigma_kp"] = P1 @ np.asarray(r["dcps"], dtype=np.float64).reshape(-1)
        self.rows = rows
        self.table = {"epoch": np.asarray([float(r["epoch"]) for r in rows])}

        # fiber coupling interpolation grid (`GRAVITY.jl:84-92`)
        sep_grid = np.arange(0.0, 102.0, 2.0)
        waves = np.concatenate([np.asarray(r["eff_wave"], dtype=np.float64) for r in rows])
        lam_grid = np.linspace(waves.min() * 0.99, waves.max() * 1.01, 15)
        coupling = np.stack(
            [fiber_coupling_fraction(sep_grid, lam) for lam in lam_grid], axis=1
        )
        self._coupling = interp2d_bilinear(sep_grid, lam_grid, coupling)

    # ------------------------------------------------------------------
    def ln_like(self, ctx: SystemObservationContext):
        theta_obs = ctx.theta_obs
        n_p = len(ctx.theta_system.planets)
        contrasts = per_planet(theta_obs["flux"], ctx, n_p)
        kp_jitter = theta_obs.get("kp_jitter", 0.0)
        kp_cy = torch.as_tensor(theta_obs.get("kp_Cy", 0.0))

        ll = 0.0
        for i_epoch, r in enumerate(self.rows):
            # positions + throughput-scaled contrasts per wavelength
            dras, ddecs, eff_contrasts = [], [], []
            for i in range(n_p):
                sol = take_epochs(ctx.solutions[i], ctx.epoch_start + i_epoch, 1)
                ra = raoff(sol)[..., 0]
                dec = decoff(sol)[..., 0]
                sep = projectedseparation(sol)[..., 0]
                f = contrasts[i]
                fiber_offset = f * sep / (1.0 + f)
                eff_wave = self._row(i_epoch, "eff_wave", ra)
                coup = self._coupling(fiber_offset[..., None], eff_wave)
                coup = torch.where(torch.isfinite(coup), coup, 0.0)
                dras.append(ra[..., None, None])
                ddecs.append(dec[..., None, None])
                eff_contrasts.append(f[..., None, None] * coup[..., None, :])

            like = dras[0]
            u, v = self._row(i_epoch, "u", like), self._row(i_epoch, "v", like)
            re, im = _cvis_sum(u, v, dras, ddecs, eff_contrasts)
            # normalization uses the raw contrast (`GRAVITY.jl:223-226`)
            norm = (1.0 + sum(contrasts))[..., None, None] if n_p else 1.0
            re, im = re / norm, im / norm

            i1 = np.asarray(r["index_cps1"], dtype=int)
            i2 = np.asarray(r["index_cps2"], dtype=int)
            i3 = np.asarray(r["index_cps3"], dtype=int)
            cps_model = _closure_phases(re, im, i1, i2, i3)
            cps_data = self._row(i_epoch, "cps_data", like)
            resids = (cps_data - cps_model).flatten(-2)  # triangle-major
            P1 = self._row(i_epoch, "P1", like)
            kp_resids = resids @ P1.T
            sigma_kp = self._row(i_epoch, "sigma_kp", like)

            # block-diagonal KP correlation: (n_wave x n_wave) blocks of
            # (1 diag, kp_Cy off-diag) (`CKP`, `GRAVITY-correlation.jl:123-160`),
            # each factored on its own
            n_kp = P1.shape[0]
            n_blocks, size = _blocks(n_kp, len(r["eff_wave"]))
            cy = kp_cy.to(like.device, like.dtype)[..., None, None, None]
            eye = torch.eye(size, dtype=like.dtype, device=like.device)
            block = cy * torch.ones_like(eye) + (1 - cy) * eye
            s = sigma_kp.reshape(n_blocks, size)
            Sigma = s[:, :, None] * block * s[:, None, :]
            Sigma = Sigma + (_trailing(kp_jitter, 3) ** 2 + 1e-12) * eye
            L, bad = _gated_cholesky(Sigma)
            res_b = kp_resids.reshape(kp_resids.shape[:-1] + (n_blocks, size, 1))
            alpha = torch.linalg.solve_triangular(L, res_b, upper=False)
            ll_e = (
                -0.5 * torch.sum(alpha**2, dim=(-3, -2, -1))
                - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=(-2, -1))
                - 0.5 * n_kp * _LOG_2PI
            )
            ok = torch.isfinite(ll_e) & ~bad.any(dim=-1)
            ll = ll + torch.where(ok, ll_e, -torch.inf)
        return ll

    def likeobj_from_epoch_subset(self, idx):
        idx = np.atleast_1d(idx)
        new = object.__new__(type(self))
        AbstractObs.__init__(new, variables=None, name=self.name)
        new.var_specs = self.var_specs
        new.rows = [self.rows[i] for i in idx]
        new.table = {"epoch": self.table["epoch"][idx]}
        new._coupling = self._coupling
        return new


GRAVITYWideKPLikelihood = GRAVITYWideKPObs
