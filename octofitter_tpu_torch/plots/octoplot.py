"""Orbit plots.

Port of `octofitter_tpu/plots/octoplot.py` (the reference's Makie plotting
extension, `ext/OctofitterMakieExt/octoplot.jl` and the per-datatype
panels): a matplotlib multi-panel figure of posterior orbit draws over the
data, drawn from a fitted Chains and the model.

Each orbit-drawing panel has a private `_*_arrays` function, free of
matplotlib, that computes what the panel draws and returns it as numpy;
the public function draws those arrays with the artists, colours, order
and labels of the JAX package. The draws are solved together, not one by
one: one `arr2nt` and one `construct_orbits` on the (n_draws, D) rows of
the draws (the JAX package's choice of draws), one `orbitsolve` at
(n_draws, T) for each grid of epochs that the draws share (on a CUDA model
the fused forward kernel for a Visual or Kep orbit, the composed path with
the Kepler kernel for the other bases), all under `torch.no_grad()`, and
one copy to the host per panel (`_util.to_host`). A grid that differs per
draw (a track over one period from each draw's tp) goes through
`solve_tracks`: the composed path with per-orbit epochs, one Kepler launch,
for a Visual or Kep orbit; one solve per draw for the other bases.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..likelihoods.relastrom import PlanetRelAstromObs
from ..orbits import decoff, orbitsolve, period, pmdec, pmra, radvel, raoff
from ..orbits.elements import KepOrbit, OrbitSolution, VisualOrbit, _kep_visual_fields
from ._util import (
    flat_draws,
    map_row,
    mass_or_zero,
    orbits_of,
    pick_planet,
    planet_mass,
    pyplot,
    savable as _savable,
    to_host,
)


def _sample_orbits(model, chain, planet_name, n_draws=100, rng=None):
    """One planet's orbit elements at the posterior draws, as one batch
    (fields of shape (n,)), and its mass in Msun at each draw, (n,), or
    None for a planet without a mass."""
    rows = flat_draws(model, chain, n_draws, rng)
    nt, orbits = orbits_of(model, rows)
    i = [p.name for p in model.system.planets].index(planet_name)
    return orbits[i], planet_mass(model, nt, planet_name, len(rows))


def _reflex_or_own(fn, sol, m):
    """The JAX package's `fn(sol, m) if m else fn(sol)` at each draw: the
    host's reflex where the draw's mass is nonzero, else the companion's
    own quantity."""
    if m is None:
        return fn(sol)
    return torch.where((m != 0)[:, None], fn(sol, m), fn(sol))


def _row_orbit(orbit, i, n):
    """The i-th orbit of a batch of n."""
    return dataclasses.replace(orbit, **{
        f.name: torch.broadcast_to(getattr(orbit, f.name), (n,))[i]
        for f in dataclasses.fields(orbit)
        if isinstance(getattr(orbit, f.name), torch.Tensor)})


def solve_tracks(orbit, ts):
    """Each orbit of the batch (n,) solved at its own epochs ts (n, T):
    one composed solve with per-orbit epochs (one Kepler launch on a CUDA
    model) for a Visual or Kep orbit; one `orbitsolve` per orbit for the
    other bases."""
    if type(orbit) in (KepOrbit, VisualOrbit):
        return OrbitSolution(orbit, ts, *_kep_visual_fields(orbit, ts, epoch_ndim=1))
    n = ts.shape[0]
    sols = [orbitsolve(_row_orbit(orbit, i, n), ts[i]) for i in range(n)]
    fields = {f.name: torch.stack([getattr(s, f.name) for s in sols])
              for f in dataclasses.fields(OrbitSolution)
              if f.name not in ("elem", "t", "compensated")}
    return OrbitSolution(elem=orbit, t=ts, **fields)


def period_tracks(orbit, n_points, dtype, device):
    """(n, n_points) epochs from each orbit's tp over one period."""
    tp = orbit.tp.reshape(-1, 1)
    P = period(orbit).reshape(-1, 1)
    u = torch.linspace(0.0, 1.0, n_points, dtype=torch.float64, device=device).to(dtype)
    return tp + P * u


def mark_summary(ras, decs):
    """(sep mean, sep std [mas], PA mean, PA std [deg]) of the draws'
    positions at one epoch, with circular PA statistics: a linear mean/std
    on an angle wrapped to [0, 360) is wrong near the north-crossing."""
    sep = np.hypot(ras, decs)
    pa = np.arctan2(ras, decs)
    pa_mean = np.degrees(np.arctan2(np.mean(np.sin(pa)), np.mean(np.cos(pa)))) % 360.0
    dev = np.degrees(np.angle(np.exp(1j * (pa - np.radians(pa_mean)))))
    return sep.mean(), sep.std(), pa_mean, dev.std()


def _astromplot_arrays(model, chain, planet_name=None, n_draws=50, mark_epochs_mjd=None):
    """astromplot's arrays: each draw's track over one period, `ra` and
    `dec` (n, 200) [mas], and with marks each draw's position at each
    marked epoch, `mark_ra` and `mark_dec` (n, K)."""
    planet = pick_planet(model, planet_name)
    with torch.no_grad():
        orbit, _ = _sample_orbits(model, chain, planet.name, n_draws)
        sol = solve_tracks(orbit, period_tracks(orbit, 200, model.dtype, model.device))
        out = {"ra": raoff(sol), "dec": decoff(sol)}
        if mark_epochs_mjd is not None:
            marks = np.atleast_1d(np.asarray(mark_epochs_mjd, dtype=np.float64))
            sol_m = orbitsolve(orbit, model.tensor(marks))
            out.update(mark_ra=raoff(sol_m), mark_dec=decoff(sol_m), marks=marks)
    return to_host(out)


@_savable
def astromplot(model, chain, ax=None, planet_name=None, n_draws=50,
               mark_epochs_mjd=None, verbosity=1):
    """Sky-plane orbit plot with astrometry data
    (`astromplot.jl`). `mark_epochs_mjd` scatters the posterior's
    predicted companion position at each given epoch and prints a
    sep/PA summary, like the reference's octoplot kwarg
    (`octoplot.jl:35`, used in `docs/src/faq.md`)."""
    plt = pyplot("astromplot")
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    planet = pick_planet(model, planet_name)
    arrays = _astromplot_arrays(model, chain, planet.name, n_draws, mark_epochs_mjd)
    for ra, dec in zip(arrays["ra"], arrays["dec"]):
        ax.plot(ra, dec, color="C0", alpha=0.08, lw=0.8)
    if mark_epochs_mjd is not None:
        for k, t_mark in enumerate(arrays["marks"]):
            ras, decs = arrays["mark_ra"][:, k], arrays["mark_dec"][:, k]
            color = f"C{(k % 8) + 1}"
            ax.scatter(ras, decs, s=10, color=color, zorder=7,
                       label=f"MJD {t_mark:.1f}")
            if verbosity >= 1:
                sep_mean, sep_std, pa_mean, pa_std = mark_summary(ras, decs)
                print(
                    f"epoch MJD {t_mark:.1f}: "
                    f"sep = {sep_mean:.1f} ± {sep_std:.1f} mas, "
                    f"PA = {pa_mean:.1f} ± {pa_std:.1f} deg"
                )
        ax.legend(loc="best", fontsize=8)
    for obs in planet.observations:
        if isinstance(obs, PlanetRelAstromObs):
            t = obs.table
            if obs.seppa:
                ra = t["sep"] * np.sin(t["pa"])
                dec = t["sep"] * np.cos(t["pa"])
                ax.scatter(ra, dec, s=14, color="k", zorder=5)
            else:
                ax.errorbar(t["ra"], t["dec"], xerr=t["σ_ra"], yerr=t["σ_dec"],
                            fmt="o", ms=3, color="k", zorder=5)
    ax.plot(0, 0, marker="*", ms=14, color="goldenrod", zorder=6)
    ax.set_xlabel(r"$\Delta \alpha^*$ [mas]")
    ax.set_ylabel(r"$\Delta \delta$ [mas]")
    ax.invert_xaxis()
    ax.set_aspect("equal")
    return ax


def _rv_observations(model):
    from ..rv.likelihoods import _BaseRVObs

    return [o for o in model.system.observations if isinstance(o, _BaseRVObs)]


def _rvtimeplot_arrays(model, chain, n_draws=50, t_range=None):
    """rvtimeplot's arrays: the 500 epochs `ts` and, per planet, each
    draw's RV there, `rv` (planets, n, 500) [m/s]."""
    tmin, tmax = np.inf, -np.inf
    for obs in _rv_observations(model):
        tmin = min(tmin, obs.table["epoch"].min())
        tmax = max(tmax, obs.table["epoch"].max())
    if t_range is not None:
        tmin, tmax = t_range
    if not np.isfinite(tmin):
        tmin, tmax = 56000.0, 58000.0
    ts = np.linspace(tmin, tmax, 500)
    rows = flat_draws(model, chain, n_draws)
    with torch.no_grad():
        nt, orbits = orbits_of(model, rows)
        rv = [_reflex_or_own(radvel, orbitsolve(orbit, model.tensor(ts)),
                             planet_mass(model, nt, p.name, len(rows)))
              for p, orbit in zip(model.system.planets, orbits)]
        out = {"rv": torch.stack(rv)} if rv else {"rv": np.zeros((0, len(rows), len(ts)))}
    return dict(to_host(out), ts=ts)


@_savable
def rvtimeplot(model, chain, ax=None, n_draws=50, t_range=None):
    """RV time-series plot (`rvtimeplot.jl`)."""
    plt = pyplot("rvtimeplot")
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    for obs in _rv_observations(model):
        t = obs.table
        ax.errorbar(t["epoch"], t["rv"], yerr=t["σ_rv"], fmt="o", ms=3, zorder=5,
                    label=obs.name)
    arrays = _rvtimeplot_arrays(model, chain, n_draws, t_range)
    for planet_rv in arrays["rv"]:
        for rv in planet_rv:
            ax.plot(arrays["ts"], rv, color="C0", alpha=0.08, lw=0.8)
    ax.set_xlabel("epoch [MJD]")
    ax.set_ylabel("RV [m/s]")
    return ax


def _pm_arrays(model, chain, n_draws, ts):
    """Each planet's reflex proper motion at the epochs `ts` for each draw:
    `pmra` and `pmdec` (planets, n, T) [mas/yr] (mass 0 for a planet
    without one, as the JAX package plots)."""
    rows = flat_draws(model, chain, n_draws)
    ts_t = model.tensor(ts)
    with torch.no_grad():
        nt, orbits = orbits_of(model, rows)
        ra, dec = [], []
        for p, orbit in zip(model.system.planets, orbits):
            sol = orbitsolve(orbit, ts_t)
            m = mass_or_zero(model, nt, p.name, len(rows))
            ra.append(pmra(sol, m))
            dec.append(pmdec(sol, m))
        out = {"pmra": torch.stack(ra), "pmdec": torch.stack(dec)}
    return dict(to_host(out), ts=ts)


def _pmaplot_arrays(model, chain, n_draws=50):
    return _pm_arrays(model, chain, n_draws, np.linspace(47500.0, 58500.0, 400))


@_savable
def pmaplot(model, chain, ax=None, n_draws=50):
    """Proper-motion-anomaly plot (`pmaplot.jl`): reflex pm vs time with
    HGCA measurement windows."""
    plt = pyplot("pmaplot")
    if ax is None:
        _, ax = plt.subplots(2, 1, figsize=(8, 5), sharex=True)
    arrays = _pmaplot_arrays(model, chain, n_draws)
    for ras, decs in zip(arrays["pmra"], arrays["pmdec"]):
        for ra, dec in zip(ras, decs):
            ax[0].plot(arrays["ts"], ra, color="C0", alpha=0.08, lw=0.8)
            ax[1].plot(arrays["ts"], dec, color="C0", alpha=0.08, lw=0.8)
    ax[0].set_ylabel(r"$\Delta\mu_{\alpha*}$ [mas/yr]")
    ax[1].set_ylabel(r"$\Delta\mu_{\delta}$ [mas/yr]")
    ax[1].set_xlabel("epoch [MJD]")
    return ax


def _panel_jobs(model, chain, n_draws=50, show_astrom=None, show_physical_orbit=None,
                show_astrom_time=None, show_rv=None, show_relative_rv=None, show_pma=None,
                show_absastrom=None, show_mass=False, show_hipparcos=None, show_gaia=None,
                mark_epochs_mjd=None):
    """octoplot's panels, chosen from the data types present in the model
    (None = auto) as the JAX package chooses them: [(rows, name, kwargs)],
    where `name` is the panel's function in this package and kwargs its
    arguments besides the model, the chain and the axes."""
    from ..astrom.g23h import G23HObs
    from ..astrom.gaia_dr4 import GaiaDR4AstromObs
    from ..astrom.hipparcos import HipparcosIADObs
    from ..likelihoods.hgca import HGCAInstantaneousObs
    from ..rv.likelihoods import PlanetRelativeRVObs, _BaseRVObs

    sysobs = model.system.observations
    plobs = [o for p in model.system.planets for o in p.observations]

    def _auto(flag, cond):
        return cond if flag is None else flag

    has_astrom = any(isinstance(o, PlanetRelAstromObs) for o in plobs)
    show_astrom = _auto(show_astrom, has_astrom or len(model.system.planets) > 0)
    show_astrom_time = _auto(show_astrom_time, has_astrom)
    show_physical_orbit = _auto(show_physical_orbit, False)
    show_rv = _auto(show_rv, any(isinstance(o, _BaseRVObs) for o in sysobs))
    show_relative_rv = _auto(
        show_relative_rv, any(isinstance(o, PlanetRelativeRVObs) for o in plobs)
    )
    show_pma = _auto(
        show_pma,
        any(isinstance(o, HGCAInstantaneousObs) for o in sysobs)
        or any(type(o).__name__ == "HGCAObs" for o in sysobs),
    )
    show_absastrom = _auto(show_absastrom, any(isinstance(o, G23HObs) for o in sysobs))
    show_hipparcos = _auto(
        show_hipparcos, any(isinstance(o, HipparcosIADObs) for o in sysobs)
    )
    show_gaia = _auto(show_gaia, any(isinstance(o, GaiaDR4AstromObs) for o in sysobs))
    show_mass = _auto(
        show_mass,
        any(f"{p.name}_mass" in chain.data for p in model.system.planets),
    )

    few = min(n_draws, 20)
    jobs = []
    if show_astrom:
        jobs.append((2, "astromplot", dict(n_draws=n_draws, mark_epochs_mjd=mark_epochs_mjd)))
    if show_physical_orbit:
        jobs.append((2, "physorbitplot", dict(n_draws=n_draws)))
    if show_astrom_time:
        jobs.append((2, "astromtimeplot", dict(n_draws=n_draws)))
    if show_rv:
        jobs.append((1, "rvtimeplot", dict(n_draws=n_draws)))
    if show_relative_rv:
        jobs.append((1, "rvtimeplot", dict(n_draws=n_draws)))
    if show_pma:
        jobs.append((2, "hgcaplot", dict(n_draws=n_draws)))
    if show_absastrom:
        jobs.append((1, "absastromplot", dict(n_draws=few)))
    if show_hipparcos:
        jobs.append((1, "hipparcosplot", dict(n_draws=few)))
    if show_gaia:
        jobs.append((1, "gaiatimeplot", dict(n_draws=few)))
    if show_mass:
        jobs.append((1, "masspostplot", {}))
    if not jobs:
        raise ValueError("octoplot: no panels enabled / no plottable data")
    return jobs


def octoplot(
    model,
    chain,
    fname=None,
    n_draws=50,
    show_astrom=None,
    show_physical_orbit=None,
    show_astrom_time=None,
    show_rv=None,
    show_relative_rv=None,
    show_pma=None,
    show_absastrom=None,
    show_mass=False,
    show_hipparcos=None,
    show_gaia=None,
    mark_epochs_mjd=None,
):
    """Multi-panel summary figure (`octoplot.jl:35-110`): the panel set
    adapts to the data types present in the model (None = auto), like
    the reference's 9-panel composite. Flags force panels on/off.
    `mark_epochs_mjd` marks predicted positions at the given epochs on
    the sky-plane panel and prints a sep/PA summary (`octoplot.jl:35`,
    `docs/src/faq.md` workflow)."""
    from . import panels

    plt = pyplot("octoplot")
    jobs = _panel_jobs(
        model, chain, n_draws, show_astrom=show_astrom,
        show_physical_orbit=show_physical_orbit, show_astrom_time=show_astrom_time,
        show_rv=show_rv, show_relative_rv=show_relative_rv, show_pma=show_pma,
        show_absastrom=show_absastrom, show_mass=show_mass, show_hipparcos=show_hipparcos,
        show_gaia=show_gaia, mark_epochs_mjd=mark_epochs_mjd)
    # each panel's axes, as the JAX package lays them out
    layout = {"astromtimeplot": ("axs", (2, 1), dict(sharex=True)),
              "hgcaplot": ("axs", (2, 1), dict(sharex=True)),
              "masspostplot": ("axs", (1, 2), {})}

    heights = [r for r, _, _ in jobs]
    fig = plt.figure(figsize=(7, 2.6 * sum(heights)))
    subfigs = fig.subfigures(len(jobs), 1, height_ratios=heights)
    if len(jobs) == 1:
        subfigs = [subfigs]
    for sub, (_, name, kwargs) in zip(subfigs, jobs):
        fn = getattr(panels, name, None) or globals()[name]
        key, grid, sub_kw = layout.get(name, ("ax", (), {}))
        fn(model, chain, **{key: sub.subplots(*grid, **sub_kw)}, **kwargs)
    fig.suptitle(model.system.name)
    if fname is None:
        fname = f"{model.system.name}-plot-grid.png"
    if fname:
        fig.savefig(fname, dpi=150)
    return fig


def _rvpostplot_arrays(model, chain, n_draws=50, planet_name=None, sample_idx=None):
    """rvpostplot's arrays: for each RV observation the data's phase on the
    MAP ephemeris, the data less the MAP draw's non-Keplerian part
    (offset, trend and, with a GP, its prediction conditioned on the MAP
    residuals; `gp_predict`) and the residuals (`obs`: a list of dicts);
    300 epochs over the MAP period from its tp (`ts`) and each draw's
    Keplerian RV there (`rv` (n, 300)), which rvpostplot folds and sorts
    by phase."""
    from ..model.params import Params
    from ..model.variables import SystemObservationContext
    from ..rv.kernels import gp_predict

    planet = pick_planet(model, planet_name)
    i_planet = [p.name for p in model.system.planets].index(planet.name)
    with torch.no_grad():
        nt, orbits_map = orbits_of(model, map_row(model, chain, sample_idx))
        epochs_all = model.tensor(model._all_epochs)
        sols_map = tuple(orbitsolve(o, epochs_all) for o in orbits_map)
        orbit_map = orbits_map[i_planet]
        m_map = planet_mass(model, nt, planet.name, 1)
        P_map = float(period(orbit_map)[0])
        tp_map = float(orbit_map.tp.reshape(-1)[0])
        data = []
        for obs in _rv_observations(model):
            t = obs.table
            theta_obs = nt.observations.get(obs.normalized_name, Params())
            ctx = SystemObservationContext(
                theta_system=nt, theta_obs=theta_obs, orbits=orbits_map,
                solutions=sols_map, epoch_start=model._epoch_start.get(id(obs), 0),
                batch_shape=(1,),
            )
            rv_full = obs.simulate(ctx)["rv_model"].reshape(-1)
            epochs = model.tensor(t["epoch"])
            # the chosen planet's Keplerian part at the data epochs
            sol_p = orbitsolve(orbit_map, epochs)
            nonkep = rv_full
            if m_map is not None and float(m_map[0]) != 0.0:
                nonkep = rv_full - radvel(sol_p, m_map).reshape(-1)
            resid_map = model.tensor(t["rv"]) - rv_full
            # GP conditioning on the MAP residuals (`rv-gp.md` workflow)
            if getattr(obs, "gaussian_process", None) is not None:
                jitter = theta_obs.get("jitter", model.tensor(0.0))
                var = model.tensor(t["σ_rv"]) ** 2 + jitter.reshape(-1)[0] ** 2
                kernel = obs.gaussian_process(theta_obs)
                gp_mean, _ = gp_predict(kernel, epochs, resid_map[None], var[None], epochs)
                nonkep = nonkep + gp_mean.reshape(-1)
                resid_map = resid_map - gp_mean.reshape(-1)
            data.append({"nonkep": nonkep, "resid": resid_map})

        orbit, m = _sample_orbits(model, chain, planet.name, n_draws)
        ts = np.linspace(tp_map, tp_map + P_map, 300)
        rv = _reflex_or_own(radvel, orbitsolve(orbit, model.tensor(ts)), m)
        host = to_host({"rv": rv, **{f"{k}_{i}": v for i, d in enumerate(data)
                                     for k, v in d.items()}})
    obs_arrays = []
    for i, obs in enumerate(_rv_observations(model)):
        t = obs.table
        obs_arrays.append({
            "phase": np.mod((t["epoch"] - tp_map) / P_map, 1.0),
            "rv_detrended": t["rv"] - host[f"nonkep_{i}"],
            "resid": host[f"resid_{i}"],
        })
    return {"obs": obs_arrays, "ts": ts, "rv": host["rv"], "P_map": P_map, "tp_map": tp_map}


@_savable
def rvpostplot(model, chain, axs=None, n_draws=50, planet_name=None,
               sample_idx=None):
    """Phase-folded RV plot with a residual panel and GP conditioning
    (`OctofitterRadialVelocity/ext/...MakieExt.jl` rvpostplot).

    The data are detrended with the MAP draw's non-Keplerian components
    (per-instrument offset, trend function, and — when the observation
    carries a celerite GP — the GP prediction conditioned on the MAP
    residuals), folded on the MAP period of the chosen planet, and
    overlaid with posterior Keplerian draws. The bottom panel shows the
    residuals after also removing the MAP Keplerian signal.
    """
    plt = pyplot("rvpostplot")
    if axs is None:
        fig, axs = plt.subplots(
            2, 1, figsize=(7, 5.5), sharex=True,
            height_ratios=[3, 1], constrained_layout=True,
        )
    ax, ax_res = axs
    arrays = _rvpostplot_arrays(model, chain, n_draws, planet_name, sample_idx)
    rv_obs = _rv_observations(model)
    for k, (obs, a) in enumerate(zip(rv_obs, arrays["obs"])):
        t = obs.table
        ax.errorbar(a["phase"], a["rv_detrended"], yerr=t["σ_rv"], fmt="o", ms=3,
                    zorder=5, label=obs.name, color=f"C{k + 1}")
        ax_res.errorbar(a["phase"], a["resid"], yerr=t["σ_rv"], fmt="o", ms=3,
                        zorder=5, color=f"C{k + 1}")
    phase = np.mod((arrays["ts"] - arrays["tp_map"]) / arrays["P_map"], 1.0)
    order = np.argsort(phase)
    for rv in arrays["rv"]:
        ax.plot(phase[order], rv[order], color="C0", alpha=0.08, lw=0.8)
    ax_res.axhline(0.0, color="0.6", lw=0.8)
    ax.set_ylabel("RV [m/s]")
    ax_res.set_ylabel("residual [m/s]")
    ax_res.set_xlabel("orbital phase")
    if rv_obs:
        ax.legend(fontsize=8)
    return axs
