"""Cross-validation utilities.

PyTorch port of `octofitter_tpu/analysis/crossvalidation.py` (the
reference's `cross-validation.jl`): `pointwise_like`, the per-datum
log-likelihood matrix over a chain, `prior_only_model`, the k-fold and
per-epoch system generators, and PSIS-LOO scoring. The pointwise matrix is
one batched computation per chunk of draws: the orbits of every draw in
the chunk are solved at all of the model's epochs in one call, and every
data-bearing observation's `pointwise_ln_like` gives its columns.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.generate import _clone_planet, _clone_system
from ..model.params import Params
from ..model.variables import (
    BlankLikelihood,
    PlanetObservationContext,
    SystemObservationContext,
)
from ..orbits import orbitsolve

# draws per batched evaluation in `pointwise_like`
POINTWISE_CHUNK = 65_536


def prior_only_model(model_or_system, exclude_all=False):
    """Strip data-bearing observations, keeping their variables via
    BlankLikelihood (`cross-validation.jl:60-100`); with `exclude_all`
    the prior-like terms go too. Returns a System."""
    from ..model.logdensity import LogDensityModel

    system = (
        model_or_system.system
        if isinstance(model_or_system, LogDensityModel)
        else model_or_system
    )

    def strip(obs_list):
        out = []
        for obs in obs_list:
            if exclude_all or not obs.is_prior:
                blank = BlankLikelihood(name=obs.name)
                blank.var_specs = obs.var_specs
                out.append(blank)
            else:
                out.append(obs)
        return out

    new_planets = [_clone_planet(p, strip(p.observations)) for p in system.planets]
    return _clone_system(system, strip(system.observations), new_planets)


def _data_observations(system):
    """(kind, planet name, observation) of every data-bearing observation:
    the system's first, then each planet's."""
    out = [("sys", None, obs) for obs in system.observations if not obs.is_prior]
    for p in system.planets:
        out.extend(("planet", p.name, obs) for obs in p.observations if not obs.is_prior)
    return out


def generate_kfold_systems(system):
    """N system copies, each dropping one likelihood object
    (`cross-validation.jl:107-...`)."""
    out = []
    for _, _, obs_drop in _data_observations(system):
        sys_obs = [o for o in system.observations if o is not obs_drop]
        planets = [_clone_planet(p, [o for o in p.observations if o is not obs_drop])
                   for p in system.planets]
        out.append(_clone_system(system, sys_obs, planets))
    return out


def generate_system_per_epoch(system):
    """One system per data row; returns (systems, epochs)
    (`cross-validation.jl:234-...`)."""
    systems, epochs = [], []
    for kind, pname, obs in _data_observations(system):
        if obs.epochs is None:
            continue
        for i in range(len(obs.epochs)):
            sub = obs.likeobj_from_epoch_subset(np.asarray([i]))
            sys_obs = [o for o in system.observations if o.is_prior]
            if kind == "sys":
                sys_obs = sys_obs + [sub]
            planets = []
            for p in system.planets:
                pobs = [o for o in p.observations if o.is_prior]
                if kind == "planet" and p.name == pname:
                    pobs = pobs + [sub]
                planets.append(_clone_planet(p, pobs))
            systems.append(_clone_system(system, sys_obs, planets))
            epochs.append(float(obs.epochs[i]))
    return systems, np.asarray(epochs)


def _pointwise_rows(model, theta):
    """The per-datum log-likelihoods of natural-space rows theta (n, D):
    (n, n_data), the system's observations first, then each planet's."""
    system = model.system
    theta_nt = model.arr2nt(theta)
    rows = (theta.shape[0],)
    orbits = model.construct_orbits(theta_nt)
    sols = tuple(orbitsolve(o, model._epochs_t) for o in orbits)
    pieces = []
    for kind, pname, obs in _data_observations(system):
        if obs.epochs is None:
            continue
        start = model._epoch_start.get(id(obs), 0)
        if kind == "sys":
            ctx = SystemObservationContext(
                theta_system=theta_nt,
                theta_obs=theta_nt.observations.get(obs.normalized_name, Params()),
                orbits=orbits, solutions=sols, epoch_start=start, batch_shape=rows)
        else:
            i_planet = [p.name for p in system.planets].index(pname)
            theta_planet = theta_nt.planets[pname]
            ctx = PlanetObservationContext(
                theta_system=theta_nt, theta_planet=theta_planet,
                theta_obs=theta_planet.observations.get(obs.normalized_name, Params()),
                orbits=orbits, solutions=sols, i_planet=i_planet, epoch_start=start,
                batch_shape=rows)
        pieces.append(torch.broadcast_to(obs.pointwise_ln_like(ctx), rows + (len(obs.epochs),)))
    return torch.cat(pieces, dim=-1)


def pointwise_like(model, chain, *, chunk_size: int = POINTWISE_CHUNK):
    """Per-datum log-likelihood matrix over the chain.

    Returns (LL [n_samples, n_data] float64 numpy, epochs [n_data]). Each
    datum is one row of one data-bearing observation. The draws go through
    the model in chunks of `chunk_size` (POINTWISE_CHUNK, 65,536, by
    default): one batched orbit solve and one evaluation of every
    observation's `pointwise_ln_like` per chunk, under `no_grad`, so that a
    4096-chain x 100-draw chain never holds all of its draws' solution
    fields (14 per draw and epoch) at once.
    """
    names = model.parameter_names
    flat = np.stack([np.asarray(chain[n]).reshape(-1) for n in names], axis=-1)
    epochs = np.concatenate([obs.epochs for _, _, obs in _data_observations(model.system)
                             if obs.epochs is not None])
    out = []
    with torch.no_grad():
        for lo in range(0, len(flat), chunk_size):
            out.append(_pointwise_rows(model, model.tensor(flat[lo: lo + chunk_size])).cpu())
    LL = torch.cat(out).numpy().astype(np.float64)
    return LL, epochs


def psis_loo(LL):
    """Pareto-smoothed importance-sampling LOO (Vehtari et al. 2017).

    LL: (n_samples, n_data) pointwise log-likelihood matrix.
    Returns dict with elpd_loo, p_loo, pointwise elpd and Pareto k-hats.
    """
    S, N = LL.shape
    elpd = np.zeros(N)
    khat = np.zeros(N)
    for i in range(N):
        logr = -LL[:, i]
        logr = logr - logr.max()
        r = np.exp(logr)
        # fit generalized Pareto to the top 20% of the raw ratios
        M = max(int(0.2 * S), 10)
        tail = np.sort(r)[-M:]
        mu = np.sort(r)[-M - 1] if S > M else tail[0]
        k, sigma = _gpd_fit(tail - mu)
        khat[i] = k
        if np.isfinite(k) and k < 0.7 and sigma > 0:
            # smooth the tail with GPD quantiles
            q = (np.arange(1, M + 1) - 0.5) / M
            smoothed = mu + _gpd_quantile(q, k, sigma)
            order = np.argsort(r)
            r_s = r.copy()
            r_s[order[-M:]] = smoothed
            w = r_s
        else:
            w = r
        w = np.minimum(w, w.max())
        w = w / w.sum()
        elpd[i] = np.log(np.sum(w * np.exp(LL[:, i] - LL[:, i].max()))) + LL[:, i].max()
    lpd = np.array(
        [np.log(np.mean(np.exp(LL[:, i] - LL[:, i].max()))) + LL[:, i].max() for i in range(N)]
    )
    return {
        "elpd_loo": float(elpd.sum()),
        "p_loo": float((lpd - elpd).sum()),
        "elpd_pointwise": elpd,
        "pareto_k": khat,
    }


def _gpd_fit(x):
    """Zhang & Stephens (2009) generalized-Pareto fit."""
    x = np.sort(np.asarray(x))
    n = len(x)
    if n < 5 or x[-1] <= 0:
        return np.inf, 0.0
    prior = 3.0
    m = 30 + int(np.sqrt(n))
    bs = 1 - np.sqrt(m / (np.arange(1, m + 1) - 0.5))
    bs = bs / (prior * x[int(n / 4 + 0.5) - 1]) + 1 / x[-1]
    ks = np.array([-np.mean(np.log1p(-b * x)) for b in bs])
    L = n * (np.log(bs / ks) + ks - 1)
    w = 1 / np.array([np.sum(np.exp(L - L[i])) for i in range(m)])
    b = np.sum(bs * w)
    k = -np.mean(np.log1p(-b * x))
    sigma = k / b
    return k, sigma


def _gpd_quantile(q, k, sigma):
    return sigma * (np.power(1 - q, -k) - 1) / k
