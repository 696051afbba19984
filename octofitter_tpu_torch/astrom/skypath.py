"""Sky-path perturbation accumulators.

PyTorch port of `octofitter_tpu/astrom/skypath.py` (the reference's
per-scan perturbation loops, `gaia-utils.jl:460-699`): the linear
photocentre form (Gaia / small separation) and the BINARYS atan2
Hippacentre with resolution taper and sigma inflation (Hipparcos
abscissae). The chain axis is written out: solution fields are
(..., T) over the scans, per-chain masses and flux ratios (...) or
numbers, scan angles (T,).
"""

from __future__ import annotations

import math

import torch

from ..orbits import decoff, raoff, totalmass

# Hipparcos main grid step & resolution scale (Lindegren 1997, ESA
# SP-1200; `gaia-utils.jl:468-482`)
HIPPARCOS_GRID_STEP_ARCSEC = 1.2074
HIPPARCOS_RESOLUTION_ARCSEC = 1.207


def _per_scan(x):
    """A per-chain value (masses, flux ratios and coefficients are one per
    row, or numbers) with a trailing axis for the scans."""
    return x.unsqueeze(-1) if isinstance(x, torch.Tensor) else x


def photocentre_coeff(orbit, planet_mass_msol, flux_ratio):
    """Linear photocentre coefficient (`gaia-utils.jl:505-510`):
    offset = raoff(sol) * coeff with
    coeff = (-m_p + f*m_host) / (M_tot * (1 + f))."""
    M_tot = totalmass(orbit)
    m_host_eff = M_tot - planet_mass_msol
    return (-planet_mass_msol + flux_ratio * m_host_eff) / (M_tot * (1 + flux_ratio))


def skypath_perturbations_linear(sol, orbit, planet_mass_msol, flux_ratio):
    """Photocentre (d_alpha*, d_delta) [mas] per epoch for one companion
    (`_simulate_skypath_perturbations!`, `gaia-utils.jl:494-525`)."""
    ra = raoff(sol)
    coeff = _per_scan(photocentre_coeff(orbit, planet_mass_msol, flux_ratio))
    return ra * coeff, decoff(sol) * coeff


def hippacentre_combined(
    cosphi,
    sinphi,
    sols,                 # list of per-planet OrbitSolution over the scans
    planet_masses_msol,   # list of per-chain masses
    flux_ratios,          # list of per-chain Hp-band flux ratios
    s_arcsec: float = HIPPARCOS_GRID_STEP_ARCSEC,
):
    """Combined BINARYS Hippacentre along-scan offset + sigma inflation
    (`_simulate_skypath_hippacentre_combined!`, `gaia-utils.jl:577-699`;
    Leclerc et al. 2023 Eq. 13 & 15, multi-companion generalization).

    Returns (d_alpha [mas], d_delta [mas], sigma_inflation) over chains
    and scans. The per-companion modulated signal is gated by the
    Gaussian resolution taper in full projected separation; the
    host-reflex sum is not gated. Zero-mass companions contribute exactly
    zero through a weight mask (branch-free), and a non-finite phase
    enters as NaN without reaching the gradient of the finite ones.
    """
    s_mas = s_arcsec * 1000.0
    two_pi_over_s = 2 * math.pi / s_mas
    inv_res_mas2 = 1.0 / (1000.0 * HIPPARCOS_RESOLUTION_ARCSEC) ** 2

    Re = torch.ones_like(cosphi)
    Im = torch.zeros_like(cosphi)
    f_total = torch.zeros_like(cosphi)
    host_along = torch.zeros_like(cosphi)

    for sol, m, f in zip(sols, planet_masses_msol, flux_ratios):
        ra_p = raoff(sol)
        active = _per_scan(torch.where(torch.as_tensor(m) != 0, 1.0, 0.0).to(ra_p))
        f = _per_scan(f)
        ra_h = raoff(sol, m)
        dec_h = decoff(sol, m)
        host_along = host_along + active * (ra_h * cosphi + dec_h * sinphi)

        dec_p = decoff(sol)
        rho_pk = ra_p * cosphi + dec_p * sinphi
        rho_full_sq = ra_p * ra_p + dec_p * dec_p
        alpha_k = torch.exp(-rho_full_sq * inv_res_mas2)
        zeta = two_pi_over_s * rho_pk
        zeta_ok = torch.isfinite(zeta)
        zeta_safe = torch.where(zeta_ok, zeta, 0.0)
        f_k = f * alpha_k * active
        sz = torch.where(zeta_ok, torch.sin(zeta_safe), math.nan)
        cz = torch.where(zeta_ok, torch.cos(zeta_safe), math.nan)
        Re = Re + f_k * cz
        Im = Im + f_k * sz
        f_total = f_total + f_k

    phi = torch.atan2(Im, Re)
    dnu = s_mas / (2 * math.pi) * phi + host_along
    d_alpha = dnu * cosphi
    d_delta = dnu * sinphi
    amp = torch.sqrt(Re * Re + Im * Im)
    sigma_inflation = (1 + f_total) / amp
    return d_alpha, d_delta, sigma_inflation
