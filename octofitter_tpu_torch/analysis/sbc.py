"""Simulation-based calibration.

PyTorch port of `octofitter_tpu/analysis/sbc.py` (the reference's
`sbc.jl`): draw parameters from the priors, generate synthetic
observations with `generate_from_params`, refit, and compute the rank of
each true parameter within its marginal posterior (`calibrationhmc`,
`sbc.jl:35-117`). Under a well-calibrated pipeline the ranks are uniform.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.generate import generate_from_params
from ..model.logdensity import LogDensityModel


def sbc_trial(
    model: LogDensityModel,
    key,
    *,
    sampler_kwargs: dict | None = None,
    init_at_truth: bool = False,
    verbosity: int = 0,
):
    """One SBC trial: prior draw -> synthetic data -> refit -> ranks.

    key: an int seed or a `torch.Generator` on the model's device; it draws
    the truth, the seed of the numpy rng that makes the data's noise, and
    then the fit's random numbers. `init_at_truth=True` starts the chains
    at the generating parameters, like the reference completeness workflow
    (`completeness.jl:457`). Returns dict with 'theta_true' (flat natural,
    numpy), 'ranks' {name: rank in [0, 1]}, and the fitted chain.
    """
    from ..samplers import octofit

    if isinstance(key, (int, np.integer)):
        generator = torch.Generator(device=model.device).manual_seed(int(key))
    else:
        generator = key
    theta = model.sample_priors(generator)
    theta_true = theta.cpu().numpy().astype(np.float64)
    seed = int(torch.randint(0, 2**31, (), generator=generator, device=generator.device))
    new_system = generate_from_params(model, model.arr2nt(theta),
                                      rng=np.random.default_rng(seed), add_noise=True)
    new_model = LogDensityModel(new_system, verbosity=0, device=model.device, dtype=model.dtype)

    kwargs = dict(chains=4, adaptation=500, iterations=500, verbosity=verbosity)
    kwargs.update(sampler_kwargs or {})
    if init_at_truth and "starting_points" not in kwargs:
        kwargs["starting_points"] = new_model.link(new_model.tensor(theta_true))
    chain = octofit(new_model, generator=generator, **kwargs)

    ranks = {}
    for i, name in enumerate(model.parameter_names):
        if name in chain.data:
            draws = chain.flat(name)
            ranks[name] = float(np.mean(draws < theta_true[i]))
    return {"theta_true": theta_true, "ranks": ranks, "chain": chain}


def calibrate(
    model: LogDensityModel,
    n_trials: int = 20,
    *,
    seed: int = 0,
    sampler_kwargs: dict | None = None,
    init_at_truth: bool = False,
    verbosity: int = 1,
):
    """Run n_trials SBC trials; returns, per parameter, the trials' ranks
    and a uniformity check (KS distance), as the JAX package does, with
    each trial's true value (`truths`) and whether all of its draws were
    finite (`finite`). Trial i is `sbc_trial` with the i-th of n_trials
    seeds drawn by numpy's default_rng(seed)."""
    seeds = np.random.default_rng(seed).integers(0, 2**62, n_trials)
    all_ranks: dict[str, list] = {}
    truths: dict[str, list] = {}
    finite: dict[str, list] = {}
    for i in range(n_trials):
        out = sbc_trial(
            model, int(seeds[i]), sampler_kwargs=sampler_kwargs,
            init_at_truth=init_at_truth,
        )
        for k, v in out["ranks"].items():
            all_ranks.setdefault(k, []).append(v)
            truths.setdefault(k, []).append(out["theta_true"][model.parameter_names.index(k)])
            finite.setdefault(k, []).append(bool(np.isfinite(out["chain"].flat(k)).all()))
        if verbosity >= 1:
            print(f"sbc trial {i + 1}/{n_trials} done")
    result = {}
    for k, v in all_ranks.items():
        r = np.asarray(v)
        # KS distance from uniform
        rs = np.sort(r)
        grid = (np.arange(1, len(rs) + 1)) / len(rs)
        ks = float(np.max(np.abs(rs - grid)))
        result[k] = {"ranks": r, "ks_distance": ks, "truths": np.asarray(truths[k]),
                     "finite": np.asarray(finite[k])}
    return result
