"""Differentiable astrometric least-squares fits.

PyTorch port of `octofitter_tpu/astrom/fitting.py` (the reference's design
matrices and 4/5-parameter solves, `gaia-utils.jl:295-459`). The chain
axis is written out: a right-hand side is (..., N) over N scans, one row
per chain, and each returned parameter has the leading shape (...).
Where the design matrix is the same for every chain (no weights, or
weights and a sigma per scan only), it is factored once by
`torch.linalg.qr` and every chain is solved by one product and one
`torch.linalg.solve_triangular`; per-chain weights (..., N) solve each
chain's weighted normal equations by one batched Cholesky factorization.
These are library calls: the JAX package computes them outside any
Pallas kernel too.

Design matrix columns (`gaia-utils.jl:317-339`):
    [cos(phi), sin(phi), -parallaxFactorAL, cos(phi) dt_ra, sin(phi) dt_dec]
with dt in Julian years from per-axis reference epochs. RHS:
    b = d(alpha*) cos(phi) + d(delta) sin(phi) + residuals.
Returned parameter order: (d_alpha, d_delta, d_pmra, d_pmdec, d_plx)
(the reference returns x[[1,2,4,5,3]], `gaia-utils.jl:405`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import JULIAN_YEAR_DAYS


def prepare_A_4param(epoch, cosphi, sinphi, ref_epoch_ra, ref_epoch_dec):
    dt_ra = (np.asarray(epoch) - ref_epoch_ra) / JULIAN_YEAR_DAYS
    dt_dec = (np.asarray(epoch) - ref_epoch_dec) / JULIAN_YEAR_DAYS
    return np.stack(
        [cosphi, sinphi, cosphi * dt_ra, sinphi * dt_dec], axis=-1
    )


def prepare_A_5param(epoch, cosphi, sinphi, parallax_factor_al,
                     ref_epoch_ra, ref_epoch_dec):
    dt_ra = (np.asarray(epoch) - ref_epoch_ra) / JULIAN_YEAR_DAYS
    dt_dec = (np.asarray(epoch) - ref_epoch_dec) / JULIAN_YEAR_DAYS
    return np.stack(
        [
            cosphi,
            sinphi,
            -np.asarray(parallax_factor_al),
            cosphi * dt_ra,
            sinphi * dt_dec,
        ],
        axis=-1,
    )


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _lstsq_qr(A, b):
    """Least squares of A x = b: A (N, k) shared by every row of b (..., N),
    factored once by QR; or A (..., N, k) one per row, solved by the normal
    equations A^T A x = A^T b with one batched Cholesky factorization.
    Returns x (..., k).

    A batched QR factors each row's matrix in a launch of its own on a CUDA
    device (tens of thousands of launches at 4096 rows); the normal
    equations take a handful for every row at once. They square the
    condition number of A, which for the scan-law design matrices (unit
    columns cos(phi), sin(phi), parallax factors below 1 and the same times
    a few years) stays near 1e2: ~1e-14 of the QR solution in float64."""
    if A.ndim == 2:
        Q, R = torch.linalg.qr(A)
        # one factorization: Q^T b for every chain as one product, then one
        # triangular solve with the chains as right-hand sides
        y = b @ Q                                           # (..., k)
        lead = y.shape[:-1]
        x = torch.linalg.solve_triangular(R, y.reshape(-1, y.shape[-1]).T, upper=True)
        return x.T.reshape(lead + (R.shape[-1],))
    At = A.transpose(-1, -2)
    L = torch.linalg.cholesky_ex(At @ A).L
    return torch.cholesky_solve(At @ b[..., None], L)[..., 0]


def ordered_parameters(x):
    """The solution x (..., 5) in the returned order: (d_alpha, d_delta,
    d_pmra, d_pmdec, d_plx)."""
    return (x[..., 0], x[..., 1], x[..., 3], x[..., 4], x[..., 2])


def _rhs(dalpha, ddelta, cosphi, sinphi, residuals):
    """b = dalpha cos(phi) + ddelta sin(phi) + residuals, as a tensor."""
    ref = next(x for x in (dalpha, ddelta, residuals) if isinstance(x, torch.Tensor))
    return _as(dalpha, ref) * _as(cosphi, ref) + _as(ddelta, ref) * _as(sinphi, ref) + residuals


def fit_5param(A, cosphi, sinphi, dalpha, ddelta, residuals=0.0, sigma=None,
               include_chi2=False, weights=None, n_rows=None):
    """Weighted 5-parameter fit (`fit_5param_prepared`,
    `gaia-utils.jl:371-439`) of every chain's scans at once.

    dalpha, ddelta (and residuals): (..., N) or (N,). sigma: None or a
    number (cancels in the solve, folded into chi2 only) or a per-scan
    vector (N,) (weights the solve). weights: optional per-scan
    multiplicities/masks, (N,) for every chain or (..., N) per chain: the
    tensor form of the reference's per-sample epoch re-selection (weight 0
    drops a scan, 2 enters it twice). n_rows: the row count for the chi2
    dof (defaults to N).

    Returns dict with 'parameters' (d_alpha, d_delta, d_pmra, d_pmdec,
    d_plx), each of the chains' shape, and optionally chi2 values.
    """
    b = _rhs(dalpha, ddelta, cosphi, sinphi, residuals)
    A = _as(A, b)
    scalar_sigma = sigma is None or np.ndim(sigma) == 0
    if not scalar_sigma:
        sigma = _as(sigma, b)
        Aw = A / sigma[:, None]
        bw = b / sigma
    else:
        Aw, bw = A, b
    if weights is not None:
        sw = torch.sqrt(_as(weights, b))
        Aw = Aw * sw[..., None]
        bw = bw * sw
    x = _lstsq_qr(Aw, bw)
    out = {"parameters": ordered_parameters(x)}
    if include_chi2:
        resid = bw - (Aw @ x[..., None])[..., 0]
        chi2 = torch.sum(resid * resid, dim=-1)
        if scalar_sigma:
            s = 1.0 if sigma is None else sigma
            chi2 = chi2 / (s * s)
        dof = (A.shape[-2] if n_rows is None else n_rows) - 5
        out["chi_squared_astro"] = chi2
        out["chi2_reduced"] = chi2 / dof
        out["dof"] = dof
    return out


def fit_4param(A, cosphi, sinphi, dalpha, ddelta, sigma=None):
    """4-parameter (no parallax) fit (`fit_4param_prepared`,
    `gaia-utils.jl:342-369`). Returns (d_alpha, d_delta, d_pmra, d_pmdec)."""
    b = _rhs(dalpha, ddelta, cosphi, sinphi, 0.0)
    A = _as(A, b)
    if sigma is not None and np.ndim(sigma) > 0:
        sigma = _as(sigma, b)
        A = A / sigma[:, None]
        b = b / sigma
    x = _lstsq_qr(A, b)
    return {"parameters": (x[..., 0], x[..., 1], x[..., 2], x[..., 3])}


def fit_5param_pinv(pinv_A, cosphi, sinphi, dalpha, ddelta, residuals=0.0):
    """5-param solve with a precomputed pseudo-inverse (5 x N), the
    cached-weighted-pinv fast path of `gaia-utils.jl:441-459`."""
    b = _rhs(dalpha, ddelta, cosphi, sinphi, residuals)
    x = b @ _as(pinv_A, b).T
    return {"parameters": ordered_parameters(x)}
