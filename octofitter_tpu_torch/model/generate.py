"""Generative path: synthesize observations from model parameters.

PyTorch port of `octofitter_tpu/model/generate.py` (the reference's
`generate_from_params(system, theta; add_noise)`,
`likelihoods/system.jl:278-398`): the orbits of one parameter set are
solved at the model's epochs, in the likelihood's order, and every
observation makes a synthetic copy of itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ..orbits import orbitsolve
from .params import Params
from .variables import Planet, PlanetObservationContext, System, SystemObservationContext


def _clone_planet(planet: Planet, new_obs) -> Planet:
    new = object.__new__(Planet)
    new.name = planet.name
    new.basis = planet.basis
    new.var_specs = planet.var_specs
    new.observations = list(new_obs)
    return new


def _clone_system(system: System, new_obs, new_planets) -> System:
    new = object.__new__(System)
    new.name = system.name
    new.var_specs = system.var_specs
    new.planets = list(new_planets)
    new.observations = list(new_obs)
    return new


def generate_from_params(model, theta_nt=None, *, rng=None, add_noise=False):
    """A new System whose observations are the model's at the structured
    parameters `theta_nt` (one draw, as `arr2nt` of a (D,) point gives;
    default: a prior draw), with noise if `add_noise`. rng: a numpy
    Generator (default seeded 0) for the noise and the prior draw."""
    if rng is None:
        rng = np.random.default_rng(0)
    system = model.system
    if theta_nt is None:
        gen = torch.Generator(device=model.device).manual_seed(int(rng.integers(2**31)))
        theta_nt = model.drawfrompriors(gen)

    with torch.no_grad():
        orbits = model.construct_orbits(theta_nt)
        if len(model._epochs_t) and len(orbits):
            sols = tuple(orbitsolve(o, model._epochs_t) for o in orbits)
        else:
            sols = tuple(None for _ in orbits)
        start_map = model._epoch_start

        new_planets = []
        for i_planet, planet in enumerate(system.planets):
            theta_planet = theta_nt.planets[planet.name]
            new_obs = []
            for obs in planet.observations:
                theta_obs = theta_planet.observations.get(obs.normalized_name, Params())
                ctx = PlanetObservationContext(
                    theta_system=theta_nt,
                    theta_planet=theta_planet,
                    theta_obs=theta_obs,
                    orbits=orbits,
                    solutions=sols,
                    i_planet=i_planet,
                    epoch_start=start_map.get(id(obs), 0),
                    batch_shape=(),
                )
                new_obs.append(obs.generate_from_params(ctx, rng, add_noise=add_noise))
            new_planets.append(_clone_planet(planet, new_obs))

        new_sys_obs = []
        for obs in system.observations:
            theta_obs = theta_nt.observations.get(obs.normalized_name, Params())
            ctx = SystemObservationContext(
                theta_system=theta_nt,
                theta_obs=theta_obs,
                orbits=orbits,
                solutions=sols,
                epoch_start=start_map.get(id(obs), 0),
                batch_shape=(),
            )
            new_sys_obs.append(obs.generate_from_params(ctx, rng, add_noise=add_noise))

    return _clone_system(system, new_sys_obs, new_planets)
