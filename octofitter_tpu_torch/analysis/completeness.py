"""Completeness (injection-recovery sensitivity) mapping.

PyTorch port of `octofitter_tpu/analysis/completeness.py` (the reference's
`completeness.jl`): a 3-phase workflow — generate a grid of jobs, run
injection-recovery trials (draw priors, override (mass, separation),
simulate, refit starting at truth), then apply a detection criterion post
hoc and assemble the completeness map. Trials store full chains so
criteria can be re-applied without re-sampling (`completeness.jl:12-16`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..model.generate import generate_from_params
from ..model.logdensity import LogDensityModel

# starting points the trial's fit gets, all at the truth (`completeness.jl:457`)
_TRUTH_STARTS = 8


@dataclasses.dataclass
class CompletenessJob:
    i_mass: int
    i_sep: int
    i_trial: int
    mass: float
    separation: float
    seed: int


@dataclasses.dataclass
class CompletenessResult:
    job: CompletenessJob
    chain: object
    theta_true: object


@dataclasses.dataclass
class CompletenessMap:
    masses: np.ndarray
    separations: np.ndarray
    completeness: np.ndarray
    n_detected: np.ndarray
    n_total: np.ndarray


def completeness_jobs(*, masses, separations, n_trials: int = 5, seed: int = 0):
    """Phase 1 (`completeness.jl:125-...`): one job per
    (mass, separation, trial), each with a seed from numpy's
    default_rng(seed)."""
    rng = np.random.default_rng(seed)
    jobs = []
    for i_m, m in enumerate(masses):
        for i_s, s in enumerate(separations):
            for i_t in range(n_trials):
                jobs.append(
                    CompletenessJob(
                        i_m, i_s, i_t, float(m), float(s),
                        int(rng.integers(2**31)),
                    )
                )
    return jobs


def _apply_overrides(model, theta_flat, overrides: dict):
    """Override free parameters by flat name (`b_mass`, `b_a`, ...)."""
    theta = np.array(theta_flat, dtype=np.float64)
    names = model.parameter_names
    for k, v in overrides.items():
        if k not in names:
            raise KeyError(
                f"Cannot override {k!r}: not a free (prior) parameter. "
                f"Available: {names}"
            )
        theta[names.index(k)] = float(v)
    return theta


def _simulated_model(model, theta_flat, seed: int, add_noise: bool):
    """The trial's model: its data generated at the flat natural-space
    parameters `theta_flat` with noise from numpy's default_rng(seed), on
    the model's device and dtype. Returns (model, structured truth)."""
    theta_nt = model.arr2nt(model.tensor(theta_flat))
    sim_system = generate_from_params(model, theta_nt, rng=np.random.default_rng(seed),
                                      add_noise=add_noise)
    return LogDensityModel(sim_system, verbosity=0, device=model.device,
                           dtype=model.dtype), theta_nt


def run_completeness_trial(
    job: CompletenessJob,
    model: LogDensityModel,
    sampler,
    *,
    inject,
    add_noise: bool = True,
    verbosity: int = 0,
):
    """Phase 2 (`completeness.jl:199-238`): one injection-recovery trial.

    The truth is a prior draw by a generator seeded `job.seed` on the
    model's device, with `inject(mass, sep)`'s flat-name overrides, e.g.
    `lambda m, s: {"b_mass": m, "b_a": s}`; the data's noise comes from
    numpy's default_rng(job.seed). `sampler(model)` runs the fit (the
    model arrives with 8 starting points, all at the truth,
    `completeness.jl:457`).
    """
    generator = torch.Generator(device=model.device).manual_seed(job.seed)
    theta_flat = model.sample_priors(generator).cpu().numpy().astype(np.float64)
    theta_flat = _apply_overrides(model, theta_flat, inject(job.mass, job.separation))
    sim_model, theta_nt = _simulated_model(model, theta_flat, job.seed, add_noise)

    # initialize at truth ("the cheat", `completeness.jl:455-466`)
    theta_t = sim_model.link(sim_model.tensor(theta_flat))
    sim_model.starting_points = theta_t.expand(_TRUTH_STARTS, -1).clone()

    chain = sampler(sim_model)
    return CompletenessResult(job, chain, theta_nt)


def assemble_completeness(results, detection_criterion, *, masses, separations):
    """Phase 3 (`completeness.jl:286-...`): apply
    `detection_criterion(chain, theta_true) -> bool` and tabulate."""
    masses = np.asarray(list(masses), dtype=float)
    seps = np.asarray(list(separations), dtype=float)
    n_det = np.zeros((len(masses), len(seps)), int)
    n_tot = np.zeros((len(masses), len(seps)), int)
    for r in results:
        det = bool(detection_criterion(r.chain, r.theta_true))
        n_tot[r.job.i_mass, r.job.i_sep] += 1
        n_det[r.job.i_mass, r.job.i_sep] += det
    with np.errstate(invalid="ignore"):
        comp = np.where(n_tot > 0, n_det / np.maximum(n_tot, 1), np.nan)
    return CompletenessMap(masses, seps, comp, n_det, n_tot)


def completeness_map(
    model: LogDensityModel,
    sampler,
    detection_criterion,
    *,
    inject,
    masses,
    separations,
    n_trials: int = 5,
    add_noise: bool = True,
    seed: int = 0,
    verbosity: int = 1,
):
    """The whole workflow (`completeness.jl:374-...`): jobs, trials, map.
    Returns (CompletenessMap, results list)."""
    jobs = completeness_jobs(
        masses=masses, separations=separations, n_trials=n_trials, seed=seed
    )
    results = []
    for i, job in enumerate(jobs):
        if verbosity >= 1:
            print(f"completeness trial {i + 1}/{len(jobs)}", end="\r")
        results.append(
            run_completeness_trial(
                job, model, sampler, inject=inject, add_noise=add_noise,
                verbosity=max(0, verbosity - 1),
            )
        )
    if verbosity >= 1:
        print()
    cmap = assemble_completeness(
        results, detection_criterion, masses=masses, separations=separations
    )
    return cmap, results
