"""Parameterization helpers.

PyTorch port of `octofitter_tpu/model/parameterizations.py`: torch
functions usable as derived-variable callables. Parameters may carry a
leading batch shape (one entry per chain or per prior draw); they
broadcast elementwise.
"""

from __future__ import annotations

import math

import torch

from ..constants import IAU_PC2AU, KEPLER_YEAR_DAYS, RAD2AS


def _nu_to_tp(nu, e, a, M, theta_epoch):
    """True anomaly at theta_epoch -> epoch of periastron [MJD].

    Mean anomaly from true anomaly via the atan2 form used by the
    reference (`parameterizations.jl:60`), then tp = epoch - MA/n.
    """
    sq = torch.sqrt(1 - e * e)
    MA = (
        torch.atan2(-sq * torch.sin(nu), -e - torch.cos(nu))
        + math.pi
        - e * sq * torch.sin(nu) / (1 + e * torch.cos(nu))
    )
    period_days = torch.sqrt(a**3 / M) * KEPLER_YEAR_DAYS
    return theta_epoch - MA / (2 * math.pi) * period_days


def _campbell_abfg(i, omega, Omega):
    """Unit Thiele-Innes constants (A, B, F, G) of the angles."""
    cw, sw = torch.cos(omega), torch.sin(omega)
    cO, sO = torch.cos(Omega), torch.sin(Omega)
    ci = torch.cos(i)
    return (cO * cw - sO * sw * ci, sO * cw + cO * sw * ci,
            -cO * sw - sO * cw * ci, -sO * sw + cO * cw * ci)


def _true_anomaly_at_pa(theta, A, B, F, G):
    """True anomaly at position angle theta: solve [A F; B G] [x; y] =
    [cos theta; sin theta] in the deprojected plane."""
    det = A * G - F * B
    ct, st = torch.cos(theta), torch.sin(theta)
    x = (G * ct - F * st) / det
    y = (-B * ct + A * st) / det
    return torch.atan2(y, x)


def theta_at_epoch_to_tperi(
    theta,
    theta_epoch,
    *,
    M,
    e,
    a=None,
    P=None,
    i=None,
    omega=None,
    Omega=None,
    A=None,
    B=None,
    F=None,
    G=None,
    plx=None,
    **_ignored,
):
    """Position angle `theta` at `theta_epoch` -> epoch of periastron.

    Supports both Campbell (i, omega, Omega + a or P) and Thiele-Innes
    (A, B, F, G + plx) parameterizations, mirroring the reference
    `θ_at_epoch_to_tperi` (`parameterizations.jl:6-69`).
    """
    if A is not None and B is not None and F is not None and G is not None:
        if plx is None:
            raise ValueError("Thiele-Innes branch requires plx")
        u = (A**2 + B**2 + F**2 + G**2) / 2
        v = A * G - B * F
        alpha = torch.sqrt(u + torch.sqrt((u + v) * (u - v)))
        a_eff = alpha / plx
    elif i is not None and omega is not None and Omega is not None:
        if a is None:
            if P is None:
                raise ValueError("specify a or P with the Campbell branch")
            a = (M * (P / KEPLER_YEAR_DAYS) ** 2) ** (1.0 / 3.0)
        a_eff = a
        A, B, F, G = _campbell_abfg(i, omega, Omega)
    else:
        raise ValueError(
            "Specify either (i, omega, Omega, a|P) or (A, B, F, G, plx)"
        )

    # the direction in the deprojected plane (`parameterizations.jl:43-55`)
    nu = _true_anomaly_at_pa(theta, A, B, F, G)
    return _nu_to_tp(nu, e, a_eff, M, theta_epoch)


def _as_tensors(*values, device=None):
    """`values` as tensors of the first tensor's dtype and device, or on
    `device` when one is given. With no tensor among them they are float64
    on `device`, the GPU unless the caller says `device="cpu"`; with no
    CUDA device that raises instead of running on the CPU."""
    ref = next((v for v in values if isinstance(v, torch.Tensor)), None)
    dtype = torch.float64 if ref is None else ref.dtype
    dev = torch.device(device if device is not None
                       else "cuda" if ref is None else ref.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"ofti_linear_solve was asked for device {dev!s}, but no CUDA "
            "device is available; pass device=\"cpu\" for the CPU"
        )
    return tuple(torch.as_tensor(v, dtype=dtype, device=dev) for v in values)


def ofti_linear_solve(
    epochs,
    ra_data,
    dec_data,
    sigma_ra,
    sigma_dec,
    cor,
    sigma_ABFG,
    e,
    a,
    tp,
    M,
    plx,
    *,
    device=None,
):
    """Analytic marginalization over Thiele-Innes constants.

    Given nonlinear parameters (e, a, tp, M, plx) of any common batch
    shape B, sky positions are linear in (A, B, F, G); solve the weighted
    linear system with an isotropic Gaussian prior N(0, sigma_ABFG^2 I)
    and return the posterior means (each of shape B) and the marginal
    log-likelihood (B), as the reference's `ofti_linear_solve` does
    (`parameterizations.jl:318-405`). The data are (N,) arrays over the
    epochs; the normal equations are (B, 4, 4), solved in one batched
    call. The eccentric anomalies come from `kepler_solver`, at (B, N) in
    one call, and differentiate through its implicit backward.

    device: where the solve runs. By default that is the device of the
    first tensor among the inputs, and the GPU when none is a tensor (as
    with Python floats); with no CUDA device that raises, and a caller who
    wants the CPU says `device="cpu"`.
    """
    from ..orbits.kepler import kepler_solver

    e, a, tp, M, plx, epochs, ra_data, dec_data, sigma_ra, sigma_dec, cor = _as_tensors(
        e, a, tp, M, plx, epochs, ra_data, dec_data, sigma_ra, sigma_dec, cor, device=device)
    e, a, tp, M = (v[..., None] for v in torch.broadcast_tensors(e, a, tp, M))

    period_days = torch.sqrt(a**3 / M) * KEPLER_YEAR_DAYS
    n = 2 * math.pi / period_days  # rad/day
    MA = n * (epochs - tp)                   # (B, N)
    EA = kepler_solver(MA, e.expand(MA.shape))
    x = torch.cos(EA) - e                    # multiplies B (ra), A (dec)
    y = torch.sin(EA) * torch.sqrt(1 - e * e)  # multiplies G (ra), F (dec)

    # per-epoch inverse covariance of (ra, dec)
    det_S = sigma_ra**2 * sigma_dec**2 * (1 - cor**2)
    w_rr = sigma_dec**2 / det_S
    w_dd = sigma_ra**2 / det_S
    w_rd = -cor * sigma_ra * sigma_dec / det_S

    # parameter order (A, B, F, G): the ra row of an epoch is
    # r = (0, x, 0, y), its dec row s = (x, 0, y, 0); the normal equations
    # are Sigma_inv = sum_j [w_rr r r^T + w_rd (r s^T + s r^T) + w_dd s s^T]
    # + prior and b = sum_j [(w_rr ra + w_rd dec) r + (w_dd dec + w_rd ra) s]
    zero = torch.zeros_like(x)
    r = torch.stack([zero, x, zero, y], dim=-1)  # (B, N, 4)
    s = torch.stack([x, zero, y, zero], dim=-1)
    Sigma_inv = (
        torch.einsum("j,...ji,...jk->...ik", w_rr, r, r)
        + torch.einsum("j,...ji,...jk->...ik", w_rd, r, s)
        + torch.einsum("j,...ji,...jk->...ik", w_rd, s, r)
        + torch.einsum("j,...ji,...jk->...ik", w_dd, s, s)
    )
    prior_prec = 1.0 / sigma_ABFG**2
    Sigma_inv = Sigma_inv + prior_prec * torch.eye(4, dtype=x.dtype, device=x.device)
    b = (torch.einsum("j,...ji->...i", w_rr * ra_data + w_rd * dec_data, r)
         + torch.einsum("j,...ji->...i", w_dd * dec_data + w_rd * ra_data, s))

    mu = torch.linalg.solve(Sigma_inv, b)
    data_quad = torch.sum(w_rr * ra_data**2 + 2 * w_rd * ra_data * dec_data + w_dd * dec_data**2)
    post_quad = torch.einsum("...i,...ij,...j->...", mu, Sigma_inv, mu)
    _, logdet_post_inv = torch.linalg.slogdet(Sigma_inv)
    logdet_prior_inv = 4 * math.log(prior_prec)
    logdet_data_cov = torch.sum(torch.log(det_S))
    N = epochs.shape[0]
    log_marginal = (
        -0.5 * (data_quad - post_quad + logdet_post_inv - logdet_prior_inv + logdet_data_cov)
        - N * math.log(2 * math.pi)
    )
    return {
        "A": mu[..., 0],
        "B": mu[..., 1],
        "F": mu[..., 2],
        "G": mu[..., 3],
        "log_marginal_likelihood": log_marginal,
    }


def theta_omegatheta_at_epoch_to_omega_tperi(
    theta, omega_theta, theta_epoch, *, M, e, i, Omega, a=None, P=None, **_ignored
):
    """(theta, omega_theta) -> (tp, omega): position angle plus the
    angle omega_theta = atan2(B, A) parameterization
    (`θ_ωθ_at_epoch_to_ω_tperi`, reference `parameterizations.jl:71-160`).

    Returns (tp, omega).
    """
    if a is None:
        if P is None:
            raise ValueError("specify a or P")
        a = (M * (P / KEPLER_YEAR_DAYS) ** 2) ** (1.0 / 3.0)
    omega = torch.atan(-torch.tan(Omega - omega_theta) / torch.cos(i))
    nu = _true_anomaly_at_pa(theta, *_campbell_abfg(i, omega, Omega))
    return _nu_to_tp(nu, e, a, M, theta_epoch), omega


def theta_sep_at_epoch_to_tperi_sma(
    theta, sep, theta_epoch, *, M, plx, e, i, omega, Omega, **_ignored
):
    """(theta, sep) -> (tp, a): position angle + projected separation
    parameterization (`θ_sep_at_epoch_to_tperi_sma`, reference
    `parameterizations.jl:162-284`). sep in mas. Returns (tp, a[AU])."""
    e = torch.where(e == 0.0, 1e-12, e)
    nu = _true_anomaly_at_pa(theta, *_campbell_abfg(i, omega, Omega))

    # scale a so the projected separation matches (reference :237-270)
    dist_au = 1000.0 / plx * IAU_PC2AU
    cart2angle = RAD2AS * 1e3 / dist_au
    sep_au = sep / cart2angle
    cO, sO, ci = torch.cos(Omega), torch.sin(Omega), torch.cos(i)
    snw, cnw = torch.sin(omega + nu), torch.cos(omega + nu)
    r = sep_au / torch.sqrt((cnw * sO + snw * ci * cO) ** 2 + (cnw * cO - snw * ci * sO) ** 2)
    p = r * (1 + e * torch.cos(nu))
    a = p / (1 - e * e)
    return _nu_to_tp(nu, e, a, M, theta_epoch), a
