"""Per-datatype posterior plot panels.

Port of `octofitter_tpu/plots/panels.py`, the matplotlib equivalents of
the reference's per-datatype Makie plots
(`ext/OctofitterMakieExt/`): astromtimeplot,
physorbitplot, masspostplot, hgcaplot (pmaplot with data overlay),
hipparcosplot, gaiatimeplot, skytrackplot, dotplot, completenessplot,
absastromplot, gaiastarplot. Every orbit-drawing panel computes its arrays
in a private `_*_arrays` function (no matplotlib; all draws in one batch,
see `octoplot.py`) and draws them as the JAX package does;
`masspostplot`, `dotplot` and `completenessplot` draw a chain's columns or
a completeness map and are copies of the JAX functions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.params import Params
from ..model.variables import SystemObservationContext
from ..orbits import decoff, orbitsolve, pmdec, pmra, posx, posy, raoff
from ._util import (
    flat_draws,
    map_row,
    mass_or_zero,
    orbits_of,
    pick_planet,
    pyplot,
    savable as _savable,
    to_host,
)
from .octoplot import _pm_arrays, _sample_orbits, period_tracks, solve_tracks


def _sys_ctx(model, obs, rows):
    """A SystemObservationContext for the (n, D) rows of the draws."""
    nt, orbits = orbits_of(model, rows)
    epochs = model.tensor(model._all_epochs)
    sols = tuple(orbitsolve(o, epochs) for o in orbits)
    theta_obs = nt.observations.get(obs.normalized_name, Params())
    return SystemObservationContext(
        theta_system=nt,
        theta_obs=theta_obs,
        orbits=orbits,
        solutions=sols,
        epoch_start=model._epoch_start.get(id(obs), 0),
        batch_shape=(len(rows),),
    )


def _data_timespan(model, pad_frac=0.1, fallback=(56000.0, 59000.0)):
    tmin, tmax = np.inf, -np.inf
    for obs in model.system.observations + [
        o for p in model.system.planets for o in p.observations
    ]:
        ep = getattr(obs, "epochs", None)
        if ep is not None and len(ep):
            tmin = min(tmin, float(np.min(ep)))
            tmax = max(tmax, float(np.max(ep)))
    if not np.isfinite(tmin):
        return fallback
    pad = (tmax - tmin) * pad_frac
    return tmin - pad, tmax + pad


# --------------------------------------------------------------------------
def _astromtimeplot_arrays(model, chain, n_draws=50, planet_name=None):
    """astromtimeplot's arrays: 400 epochs over the data's span `ts`, and
    each draw's separation [mas] and position angle [deg] there, `sep` and
    `pa` (n, 400)."""
    planet = pick_planet(model, planet_name)
    tmin, tmax = _data_timespan(model)
    ts = np.linspace(tmin, tmax, 400)
    with torch.no_grad():
        orbit, _ = _sample_orbits(model, chain, planet.name, n_draws)
        sol = orbitsolve(orbit, model.tensor(ts))
        ra, dec = raoff(sol), decoff(sol)
        pa = torch.rad2deg(torch.remainder(torch.atan2(ra, dec), 2 * np.pi))
        return dict(to_host({"sep": torch.hypot(ra, dec), "pa": pa}), ts=ts)


@_savable
def astromtimeplot(model, chain, axs=None, n_draws=50, planet_name=None):
    """Separation and position angle vs time (`astromtimeplot.jl`)."""
    from ..likelihoods.relastrom import PlanetRelAstromObs

    plt = pyplot("astromtimeplot")
    if axs is None:
        _, axs = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    planet = pick_planet(model, planet_name)
    arrays = _astromtimeplot_arrays(model, chain, n_draws, planet.name)
    for sep, pa in zip(arrays["sep"], arrays["pa"]):
        axs[0].plot(arrays["ts"], sep, color="C0", alpha=0.08, lw=0.8)
        axs[1].plot(arrays["ts"], pa, color="C0", alpha=0.08, lw=0.8)
    for obs in planet.observations:
        if isinstance(obs, PlanetRelAstromObs):
            t = obs.table
            if obs.seppa:
                sep, pa = t["sep"], np.degrees(t["pa"])
                dsep, dpa = t["σ_sep"], np.degrees(t["σ_pa"])
            else:
                sep = np.hypot(t["ra"], t["dec"])
                pa = np.degrees(np.mod(np.arctan2(t["ra"], t["dec"]), 2 * np.pi))
                dsep = np.hypot(t["σ_ra"], t["σ_dec"])
                dpa = np.degrees(dsep / np.maximum(sep, 1e-9))
            axs[0].errorbar(t["epoch"], sep, yerr=dsep, fmt="o", ms=3,
                            color="k", zorder=5)
            axs[1].errorbar(t["epoch"], pa, yerr=dpa, fmt="o", ms=3,
                            color="k", zorder=5)
    axs[0].set_ylabel("separation [mas]")
    axs[1].set_ylabel("PA [deg]")
    axs[1].set_xlabel("epoch [MJD]")
    return axs


def _physorbitplot_arrays(model, chain, n_draws=50, planet_name=None):
    """physorbitplot's arrays: each draw's track over one period in AU,
    `x` and `y` (n, 200)."""
    planet = pick_planet(model, planet_name)
    with torch.no_grad():
        orbit, _ = _sample_orbits(model, chain, planet.name, n_draws)
        sol = solve_tracks(orbit, period_tracks(orbit, 200, model.dtype, model.device))
        return to_host({"x": posx(sol), "y": posy(sol)})


@_savable
def physorbitplot(model, chain, ax=None, n_draws=50, planet_name=None):
    """Physical orbit in AU (`show_physical_orbit`, octoplot.jl)."""
    plt = pyplot("physorbitplot")
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    arrays = _physorbitplot_arrays(model, chain, n_draws, planet_name)
    for x, y in zip(arrays["x"], arrays["y"]):
        ax.plot(x, y, color="C0", alpha=0.08, lw=0.8)
    ax.plot(0, 0, marker="*", ms=14, color="goldenrod", zorder=6)
    ax.set_xlabel("x [AU]")
    ax.set_ylabel("y [AU]")
    ax.set_aspect("equal")
    return ax


@_savable
def masspostplot(model, chain, axs=None, n_draws=2000):
    """Mass posterior histogram + mass vs semi-major axis
    (`masspostplot.jl`)."""
    plt = pyplot("masspostplot")
    planets = [
        p.name for p in model.system.planets
        if f"{p.name}_mass" in chain.data
    ]
    if axs is None:
        _, axs = plt.subplots(1, 2, figsize=(9, 4))
    for i, name in enumerate(planets):
        m = chain[f"{name}_mass"].reshape(-1)
        axs[0].hist(m, bins=50, histtype="step", density=True,
                    label=name, color=f"C{i}")
        a_col = f"{name}_a"
        if a_col in chain.data:
            a = chain[a_col].reshape(-1)
            k = min(n_draws, len(m))
            axs[1].scatter(a[:k], m[:k], s=2, alpha=0.2, color=f"C{i}")
    axs[0].set_xlabel(r"mass [M$_{\rm jup}$]")
    axs[0].set_ylabel("posterior density")
    if planets:
        axs[0].legend()
    axs[1].set_xlabel("semi-major axis [AU]")
    axs[1].set_ylabel(r"mass [M$_{\rm jup}$]")
    return axs


@_savable
def dotplot(model, chain, ax=None, n_draws=4000, planet_name=None,
            mode="separation", epoch=None):
    """Mass vs separation/period scatter with marginal histograms
    (`dotplot.jl`)."""
    plt = pyplot("dotplot")
    planet = pick_planet(model, planet_name)
    name = planet.name
    m = chain[f"{name}_mass"].reshape(-1) if f"{name}_mass" in chain.data else None
    a = chain[f"{name}_a"].reshape(-1)
    if mode == "period":
        M = chain["M"].reshape(-1) if "M" in chain.data else np.ones_like(a)
        x = np.sqrt(a**3 / M) * 365.25
        xlabel = "period [days]"
    else:
        x = a
        xlabel = "semi-major axis [AU]"
    y = m if m is not None else chain[f"{name}_e"].reshape(-1)
    ylabel = r"mass [M$_{\rm jup}$]" if m is not None else "eccentricity"
    k = min(n_draws, len(x))

    if ax is None:
        fig = plt.figure(figsize=(6, 6))
        gs = fig.add_gridspec(2, 2, width_ratios=[4, 1], height_ratios=[1, 4],
                              hspace=0.05, wspace=0.05)
        ax = fig.add_subplot(gs[1, 0])
        ax_hx = fig.add_subplot(gs[0, 0], sharex=ax)
        ax_hy = fig.add_subplot(gs[1, 1], sharey=ax)
        ax_hx.hist(x[:k], bins=50, color="C0")
        ax_hy.hist(y[:k], bins=50, orientation="horizontal", color="C0")
        ax_hx.axis("off")
        ax_hy.axis("off")
    ax.scatter(x[:k], y[:k], s=2, alpha=0.2, color="C0")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return ax


def _hgcaplot_arrays(model, chain, n_draws=50):
    """hgcaplot's arrays: 400 epochs `ts` from the Hipparcos epoch (or the
    data's start) to the data's end, and each planet's draws' proper
    motion there, offset by the chain's median `pmra`/`pmdec`: `pmra` and
    `pmdec` (planets, n, 400) [mas/yr]."""
    tmin, tmax = _data_timespan(model, fallback=(47500.0, 58500.0))
    tmin = min(tmin, 47500.0)
    arrays = _pm_arrays(model, chain, n_draws, np.linspace(tmin, tmax, 400))
    pmra0 = np.median(chain["pmra"].reshape(-1)) if "pmra" in chain.data else 0.0
    pmdec0 = np.median(chain["pmdec"].reshape(-1)) if "pmdec" in chain.data else 0.0
    return dict(arrays, pmra=pmra0 + arrays["pmra"], pmdec=pmdec0 + arrays["pmdec"])


@_savable
def hgcaplot(model, chain, axs=None, n_draws=50):
    """Proper-motion vs time with the HGCA measurements overlaid
    (`hgcaplot.jl` / `pmaplot.jl`)."""
    from ..constants import J2000_MJD, JULIAN_YEAR_DAYS

    plt = pyplot("hgcaplot")
    if axs is None:
        _, axs = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    arrays = _hgcaplot_arrays(model, chain, n_draws)
    for ras, decs in zip(arrays["pmra"], arrays["pmdec"]):
        for ra, dec in zip(ras, decs):
            axs[0].plot(arrays["ts"], ra, color="C0", alpha=0.08, lw=0.8)
            axs[1].plot(arrays["ts"], dec, color="C0", alpha=0.08, lw=0.8)

    def _jy2mjd(jy):
        return (jy - 2000.0) * JULIAN_YEAR_DAYS + J2000_MJD

    for obs in model.system.observations:
        cat = getattr(obs, "catalog", None) or getattr(obs, "hgca", None)
        if not isinstance(cat, dict) or "pmra_hip" not in cat:
            continue
        for pfx, ep_key in (
            ("hip", "epoch_ra_hip"), ("hg", None), ("dr3", "epoch_ra_dr3_mjd"),
            ("gaia", "epoch_ra_gaia"),
        ):
            if f"pmra_{pfx}" not in cat:
                continue
            if ep_key is None:
                e_h = cat.get("epoch_ra_hip")
                e_g = cat.get("epoch_ra_gaia", cat.get("epoch_ra_dr3_mjd"))
                if e_h is None or e_g is None:
                    continue
                e_h = _jy2mjd(e_h) if e_h < 3000 else e_h
                e_g = _jy2mjd(e_g) if e_g < 3000 else e_g
                ep = 0.5 * (e_h + e_g)
            else:
                ep = cat.get(ep_key)
                if ep is None:
                    continue
                ep = _jy2mjd(ep) if ep < 3000 else ep
            for ax_i, comp in ((0, "pmra"), (1, "pmdec")):
                axs[ax_i].errorbar(
                    [ep], [cat[f"{comp}_{pfx}"]],
                    yerr=[cat.get(f"{comp}_{pfx}_error", 0.0)],
                    fmt="s", ms=5, color="crimson", zorder=6,
                )
    axs[0].set_ylabel(r"$\mu_{\alpha*}$ [mas/yr]")
    axs[1].set_ylabel(r"$\mu_{\delta}$ [mas/yr]")
    axs[1].set_xlabel("epoch [MJD]")
    return axs


def _hipparcos_obs(model):
    from ..astrom.hipparcos import HipparcosIADObs

    hips = [o for o in model.system.observations if isinstance(o, HipparcosIADObs)]
    hips += [
        o.hip_like
        for o in model.system.observations
        if getattr(o, "hip_like", None) is not None
    ]
    if not hips:
        raise ValueError("model has no Hipparcos IAD observation")
    return hips[0]


def _hipparcosplot_arrays(model, chain, n_draws=30):
    """hipparcosplot's arrays: each draw's along-scan Hippacentre
    perturbation at the IAD epochs in time order, `epoch` (T,) and
    `proj` (n, T) [mas]."""
    from ..astrom.skypath import hippacentre_combined

    t = _hipparcos_obs(model).table
    rows = flat_draws(model, chain, n_draws)
    n = len(rows)
    with torch.no_grad():
        nt, orbits = orbits_of(model, rows)
        epochs = model.tensor(t["epoch"])
        cphi = model.tensor(t["cosphi"])
        sphi = model.tensor(t["sinphi"])
        sols_h = [orbitsolve(o, epochs) for o in orbits]
        masses = [mass_or_zero(model, nt, p.name, n) for p in model.system.planets]
        frh = [torch.zeros(n, dtype=model.dtype, device=model.device) for _ in orbits]
        d_a, d_d, _ = hippacentre_combined(cphi, sphi, sols_h, masses, frh)
        proj = to_host({"proj": d_a * cphi + d_d * sphi})["proj"]
    order = np.argsort(t["epoch"])
    return {"epoch": t["epoch"][order], "proj": proj[:, order]}


@_savable
def hipparcosplot(model, chain, ax=None, n_draws=30):
    """Hipparcos IAD abscissa residuals vs time with posterior model
    along-scan perturbations (`hipparcosplot.jl`)."""
    plt = pyplot("hipparcosplot")
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    t = _hipparcos_obs(model).table
    keep = ~t["reject"]
    ax.errorbar(t["epoch"][keep], t["res"][keep], yerr=t["sres"][keep],
                fmt="o", ms=3, color="k", zorder=5, label="IAD abscissae")
    arrays = _hipparcosplot_arrays(model, chain, n_draws)
    for proj in arrays["proj"]:
        ax.plot(arrays["epoch"], proj, color="C0", alpha=0.15, lw=0.8)
    ax.set_xlabel("epoch [MJD]")
    ax.set_ylabel("along-scan abscissa [mas]")
    return ax


def _gaia_dr4_obs(model):
    from ..astrom.gaia_dr4 import GaiaDR4AstromObs

    obs_list = [o for o in model.system.observations if isinstance(o, GaiaDR4AstromObs)]
    if not obs_list:
        raise ValueError("model has no GaiaDR4AstromObs")
    return obs_list[0]


def _gaiatimeplot_arrays(model, chain, n_draws=30):
    """gaiatimeplot's arrays: each draw's along-scan photocentre
    perturbation at the DR4 epochs in time order, `epoch` (T,) and `proj`
    (n, T) [mas]."""
    from ..astrom.skypath import skypath_perturbations_linear

    t = _gaia_dr4_obs(model).table
    rows = flat_draws(model, chain, n_draws)
    n = len(rows)
    with torch.no_grad():
        nt, orbits = orbits_of(model, rows)
        epochs = model.tensor(t["epoch"])
        cphi = model.tensor(np.cos(t["scan_pos_angle"]))
        sphi = model.tensor(np.sin(t["scan_pos_angle"]))
        d_a = torch.zeros((n, len(t["epoch"])), dtype=model.dtype, device=model.device)
        d_d = torch.zeros_like(d_a)
        for p, orbit in zip(model.system.planets, orbits):
            sol = orbitsolve(orbit, epochs)
            da, dd = skypath_perturbations_linear(
                sol, orbit, mass_or_zero(model, nt, p.name, n), 0.0)
            d_a = d_a + da
            d_d = d_d + dd
        proj = to_host({"proj": d_a * cphi + d_d * sphi})["proj"]
    order = np.argsort(t["epoch"])
    return {"epoch": t["epoch"][order], "proj": proj[:, order]}


@_savable
def gaiatimeplot(model, chain, ax=None, n_draws=30):
    """Gaia DR4 along-scan residuals vs time with posterior model curves
    (`gaiatimeplot.jl`)."""
    plt = pyplot("gaiatimeplot")
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    t = _gaia_dr4_obs(model).table
    ax.errorbar(
        t["epoch"], t["centroid_pos_al"], yerr=t["centroid_pos_error_al"],
        fmt="o", ms=3, color="k", zorder=5,
    )
    arrays = _gaiatimeplot_arrays(model, chain, n_draws)
    for proj in arrays["proj"]:
        ax.plot(arrays["epoch"], proj, color="C0", alpha=0.15, lw=0.8)
    ax.set_xlabel("epoch [MJD]")
    ax.set_ylabel("along-scan position [mas]")
    return ax


def _skytrackplot_arrays(model, chain, sample_idx=None, t_range=None, keplerian_mult=1.0):
    """skytrackplot's arrays: the photocentre track (proper motion,
    parallax and each massive companion's reflex) of one posterior sample
    (the MAP draw by default) at 600 epochs, `dra` and `ddec` (600,)
    [mas]."""
    from ..astrom.ephemeris import earth_position_au

    tmin, tmax = t_range if t_range is not None else _data_timespan(model)
    ts = np.linspace(tmin, tmax, 600)
    dt_yr = (ts - ts[0]) / 365.25
    with torch.no_grad():
        nt, orbits = orbits_of(model, map_row(model, chain, sample_idx))
        pmra0 = float(nt["pmra"]) if "pmra" in nt else 0.0
        pmdec0 = float(nt["pmdec"]) if "pmdec" in nt else 0.0
        plx = float(nt["plx"]) if "plx" in nt else 0.0
        reflex = []
        ts_t = model.tensor(ts)
        for p, orbit in zip(model.system.planets, orbits):
            m = mass_or_zero(model, nt, p.name, 1)
            if float(m[0]) == 0.0:
                continue
            sol = orbitsolve(orbit, ts_t)
            reflex.append(torch.stack([raoff(sol, m)[0], decoff(sol, m)[0]]))
        host = to_host({f"reflex_{k}": r for k, r in enumerate(reflex)})

    # parallax factors from the analytic Earth ephemeris
    ra = np.deg2rad(float(getattr(model.system, "ra_deg", 0.0) or 0.0))
    dec = np.deg2rad(float(getattr(model.system, "dec_deg", 0.0) or 0.0))
    epos = earth_position_au(ts)
    ex, ey, ez = epos["x"], epos["y"], epos["z"]
    f_ra = (ex * np.sin(ra) - ey * np.cos(ra))
    f_dec = (
        ex * np.cos(ra) * np.sin(dec)
        + ey * np.sin(ra) * np.sin(dec)
        - ez * np.cos(dec)
    )
    dra = pmra0 * dt_yr + plx * f_ra
    ddec = pmdec0 * dt_yr + plx * f_dec
    for k in range(len(reflex)):
        dra = dra + keplerian_mult * host[f"reflex_{k}"][0]
        ddec = ddec + keplerian_mult * host[f"reflex_{k}"][1]
    return {"dra": dra, "ddec": ddec}


@_savable
def skytrackplot(model, chain, ax=None, sample_idx=None, t_range=None,
                 keplerian_mult=1.0):
    """On-sky photocentre track (pm + parallax + Keplerian reflex) for
    one posterior sample (`skytrackplot.jl`)."""
    plt = pyplot("skytrackplot")
    if ax is None:
        _, ax = plt.subplots(figsize=(7, 5))
    arrays = _skytrackplot_arrays(model, chain, sample_idx, t_range, keplerian_mult)
    dra, ddec = arrays["dra"], arrays["ddec"]
    ax.plot(dra, ddec, lw=1.0, color="C0")
    ax.scatter(dra[0], ddec[0], marker="^", color="C2", zorder=5, label="start")
    ax.set_xlabel(r"$\Delta\alpha^*$ [mas]")
    ax.set_ylabel(r"$\Delta\delta$ [mas]")
    ax.invert_xaxis()
    ax.set_aspect("equal")
    return ax


def _g23h_obs(model):
    from ..astrom.g23h import G23HObs

    g23hs = [o for o in model.system.observations if isinstance(o, G23HObs)]
    if not g23hs:
        raise ValueError("model has no G23HObs")
    return g23hs[0]


def _absastromplot_arrays(model, chain, n_draws=30):
    """absastromplot's arrays: each draw's pull (catalog - model)/sigma
    per G23H channel, `pull` (n, channels), and the channels, `kinds`."""
    obs = _g23h_obs(model)
    rows = flat_draws(model, chain, n_draws)
    with torch.no_grad():
        pulls = obs.debug_pulls(_sys_ctx(model, obs, rows))["pull"]
        return dict(to_host({"pull": pulls}), kinds=list(obs.kinds))


@_savable
def absastromplot(model, chain, ax=None, n_draws=30):
    """G23H absolute-astrometry channel pulls: posterior distribution of
    (catalog - model)/sigma per channel (`absastromplot.jl` intent,
    rendered as a pull box plot via the debug_pulls hook)."""
    plt = pyplot("absastromplot")
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    arrays = _absastromplot_arrays(model, chain, n_draws)
    pulls = arrays["pull"]
    ax.axhline(0.0, color="0.6", lw=0.8)
    ax.boxplot(
        [pulls[:, i] for i in range(pulls.shape[1])],
        tick_labels=arrays["kinds"],
    )
    ax.set_ylabel(r"pull (catalog $-$ model)/$\sigma$")
    ax.tick_params(axis="x", rotation=45)
    return ax


def _gaiastarplot_arrays(model, chain, sample_idx=None):
    """gaiastarplot's arrays: for one posterior sample (the MAP draw by
    default) the star's reflex over one period of each massive companion,
    `reflex` [(planet name, ra (200,), dec (200,))] [mas]."""
    with torch.no_grad():
        nt, orbits = orbits_of(model, map_row(model, chain, sample_idx))
        names, tracks = [], {}
        for p, orbit in zip(model.system.planets, orbits):
            m = mass_or_zero(model, nt, p.name, 1)
            if float(m[0]) == 0.0:
                continue
            # one draw: its track is a grid that all (one) draws share
            sol = orbitsolve(orbit, period_tracks(orbit, 200, model.dtype, model.device)[0])
            tracks[f"ra_{p.name}"] = raoff(sol, m)[0]
            tracks[f"dec_{p.name}"] = decoff(sol, m)[0]
            names.append(p.name)
        host = to_host(tracks)
    return {"reflex": [(n, host[f"ra_{n}"], host[f"dec_{n}"]) for n in names]}


@_savable
def gaiastarplot(model, chain, ax=None, sample_idx=None):
    """Sky-plane star reflex orbit with the Gaia along-scan measurements
    drawn as scan-direction segments, for one posterior sample
    (`gaiastarplot.jl`). Scan data constrain only the along-scan
    coordinate, so each epoch is a line perpendicular to nothing —
    a segment along the scan direction through the measured offset."""
    plt = pyplot("gaiastarplot")
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    t = _gaia_dr4_obs(model).table

    # star reflex orbit over one period of each massive companion
    for name, ra, dec in _gaiastarplot_arrays(model, chain, sample_idx)["reflex"]:
        ax.plot(ra, dec, color="C0", lw=1.2, label=f"{name} reflex")

    # along-scan measurements as scan-direction segments centered on the
    # measured along-scan offset projected onto the sky
    psi = np.asarray(t["scan_pos_angle"])
    al = np.asarray(t["centroid_pos_al"])
    err = np.asarray(t["centroid_pos_error_al"])
    cpsi, spsi = np.cos(psi), np.sin(psi)
    # along-scan unit vector (ra, dec) = (cos psi, sin psi) in our
    # convention; the across-scan coordinate is unconstrained
    x0 = al * cpsi
    y0 = al * spsi
    half = 3 * np.median(err) + 0.5 * np.abs(al).max()
    for k in range(len(al)):
        # the constraint line runs ACROSS scan through the AL offset
        ax.plot(
            [x0[k] - half * -spsi[k], x0[k] + half * -spsi[k]],
            [y0[k] - half * cpsi[k], y0[k] + half * cpsi[k]],
            color="0.7", lw=0.5, zorder=1,
        )
        ax.plot([x0[k]], [y0[k]], marker=".", ms=3, color="k", zorder=5)
    ax.axhline(0, color="grey", ls="--", lw=0.6)
    ax.axvline(0, color="grey", ls="--", lw=0.6)
    ax.set_xlabel(r"$\Delta\alpha^*$ [mas]")
    ax.set_ylabel(r"$\Delta\delta$ [mas]")
    ax.invert_xaxis()
    ax.set_aspect("equal")
    return ax


@_savable
def completenessplot(cmap, ax=None, levels=(0.5, 0.9)):
    """Completeness map heat map + contours (`completenessplot.jl`).

    cmap: analysis.completeness.CompletenessMap.
    """
    plt = pyplot("completenessplot")
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4.5))
    X, Y = np.meshgrid(cmap.separations, cmap.masses)
    pc = ax.pcolormesh(X, Y, cmap.completeness, vmin=0, vmax=1,
                       shading="auto", cmap="viridis")
    try:
        cs = ax.contour(X, Y, cmap.completeness, levels=levels,
                        colors="w", linewidths=1.0)
        ax.clabel(cs, fmt=lambda v: f"{v:.0%}")
    except Exception:
        pass  # degenerate grids (constant map) have no contours
    plt.colorbar(pc, ax=ax, label="completeness")
    ax.set_xlabel("separation [AU]")
    ax.set_ylabel(r"mass [M$_{\rm jup}$]")
    return ax
