"""High-level sampling entry points.

PyTorch port of `octofitter_tpu/samplers/driver.py`: `octofit`
initializes the model (prior search -> multistart Adam -> L-BFGS ->
Laplace) unless it has starting points, runs cross-chain ChEES-HMC, NUTS,
jittered HMC or, on a model with a large discrete domain, Gibbs-within-HMC
over all chains at once, prints a sampling report, and repackages the
draws (with all derived quantities and the discrete variables) into a
named `Chains`.

`octofit_rejection` mirrors `sampling.jl:168-279`: IID prior batches drawn
and scored on the model's device, each draw accepted with probability
exp(ll - max_ll) against the global maximum likelihood.
"""

from __future__ import annotations

import datetime
import time

import numpy as np
import torch

from ..chains import Chains, flatten_params_batch
from ..distributions import categorical
from ..model.logdensity import LogDensityModel
from .chees import run_chees
from .nuts import run_nuts
from .shard import Shard


def _repackage(model: LogDensityModel, samples_t, lps, stats, info, t_sampling,
               sampler="chees"):
    """Transformed draws -> named Chains with derived quantities (the
    reference's invlink -> arr2nt -> result2mcmcchain, `sampling.jl:465-527`).
    The discrete variables come from the sampler (Gibbs mode), or are
    recovered per draw from their conditional given the continuous state,
    drawn with a generator seeded 0 (marginalized)."""
    n_chains, n_draws, D = samples_t.shape
    flat_t = samples_t.reshape(-1, D)
    disc = None
    with torch.no_grad():
        if model.discrete_names and model.discrete_mode == "gibbs":
            disc = info["disc_samples"].reshape(flat_t.shape[0], -1)
        elif model.discrete_names:
            gen = torch.Generator(device=model.device).manual_seed(0)
            disc = model._disc_combos[categorical(model.discrete_conditional_logits(flat_t), gen)]
        nts = model.arr2nt(model.invlink(flat_t), disc)
        lprior = model.ln_prior_transformed(flat_t)
    data = {}
    n = flat_t.shape[0]
    for k, v in flatten_params_batch(nts).items():
        if v.ndim == 0 or v.shape[0] != n:  # a constant: the same for every draw
            v = np.broadcast_to(v, (n,) + v.shape)
        if v.ndim == 1:
            data[k] = v.reshape(n_chains, n_draws)
        else:
            # vector variables expand to _1, _2, ... columns per the
            # reference naming contract (`sampling.jl:908-981`)
            flat2 = v.reshape(n_chains, n_draws, -1)
            for j in range(flat2.shape[-1]):
                data[f"{k}_{j + 1}"] = flat2[..., j]
    lps_np = lps.cpu().numpy()
    lprior_np = lprior.cpu().numpy().reshape(n_chains, n_draws)
    internals = {
        "logpost": lps_np,
        "logprior": lprior_np,
        "loglike": lps_np - lprior_np,
    }
    internals.update({k: v.cpu().numpy() for k, v in stats._asdict().items()})
    chain_info = {
        "sampler": f"{sampler}_vectorized",
        "model_name": model.system.name,
        "stop_time": datetime.datetime.now().isoformat(timespec="seconds"),
        "step_size": np.asarray(info["step_size"]),
        "sigma": info["sigma"].cpu().numpy(),
        "sampling_time_s": t_sampling,
        "n_grad_evals": info["n_grad_evals"],
        "transition_evals": info.get("transition_evals"),  # NUTS, HMC and Gibbs
        "n_sweep_evals": info.get("n_sweep_evals"),  # Gibbs
        "parameter_names": model.parameter_names,
        "device": str(model.device),
    }
    return Chains(data, internals, chain_info)


def _gather_chains(shard, samples, lps, stats, info, t_sampling, per_chain_tuning):
    """Every rank's chains, in rank order, on every rank: the draws, the
    statistics and, where each chain adapts its own (NUTS, HMC), the step
    sizes, metrics and warmup divergences all-gathered along the chain
    axis; the sampling time is the slowest rank's."""
    info = dict(info)
    if per_chain_tuning:
        info["sigma"] = shard.gather(info["sigma"], 0)
        for key in ("step_size", "warmup_divergences"):
            t = torch.as_tensor(info[key], device=samples.device)
            info[key] = shard.gather(t, 0).cpu().numpy()
    samples, lps = shard.gather(samples, 0), shard.gather(lps, 0)
    stats = type(stats)(*(shard.gather(leaf, 0) for leaf in stats))
    t = shard.max(torch.tensor(t_sampling, dtype=torch.float64, device=samples.device))
    return samples, lps, stats, info, float(t)


def _initial_sigma_from_points(points, metric):
    """Dense metric seeded from the starting-point covariance, with the
    reference's diagonal-jitter retry ladder (`sampling.jl:336-363`)."""
    pts = np.asarray(points)
    if metric == "diag":
        v = pts.var(axis=0)
        return np.where(v > 1e-12, v, 1.0)
    if len(pts) < pts.shape[1] + 2:
        return np.eye(pts.shape[1])
    cov = np.cov(pts.T)
    d = pts.shape[1]
    for jitter in [0.0, 1e-8, 1e-6, 1e-4, 1e-2, 1.0]:
        trial = cov + jitter * np.eye(d)
        try:
            np.linalg.cholesky(trial)
            return trial
        except np.linalg.LinAlgError:
            continue
    return np.eye(d)


def octofit(
    model: LogDensityModel,
    target_accept: float | None = None,
    *,
    generator: torch.Generator | None = None,
    chains: int | None = None,
    adaptation: int | None = None,
    iterations: int | None = None,
    max_depth: int | None = None,
    verbosity: int | None = None,
    starting_points=None,
    metric: str = "dense",
    sampler: str | None = None,
    profile_dir: str | None = None,
    step_size: float | None = None,
    drop_warmup: bool = True,
    mesh=None,
):
    """Sample the posterior with a vectorized transition (ChEES default).

    sampler: "chees" (cross-chain ChEES-HMC), "nuts" (per-chain
    window-adapted multinomial NUTS, the reference's transition), "hmc"
    (jittered-trajectory HMC with NUTS's adaptation) or "gibbs"
    (Gibbs-within-HMC over discrete priors, `samplers/gibbs.py`), which a
    model in the Gibbs mode (a discrete domain too large to marginalize)
    always takes.
    Defaults mirror the reference (`sampling.jl:317-325`) and resolve
    from the typed config (OCTOFITTER_* env overrides; config.py).
    generator: a `torch.Generator` on the model's device (default: seed 0).
    starting_points: optional unconstrained (D,) or (chains, D) points;
    otherwise the model's own (running `initialize` first if it has none).
    profile_dir: write a `torch.profiler` trace of the run there
    (`utils.profile_trace`; default: the config's `profile_dir`, set by
    OCTOFITTER_PROFILE_DIR, and none when that is empty).
    step_size: manual initial step size (adaptation still refines it).
    drop_warmup: when False, adaptation draws are kept at the start of
    the chain (reference `sampling.jl:129`).
    mesh: a one-dimensional `DeviceMesh` (`parallel.chain_mesh` or
    `parallel.global_mesh`) over which the chains are sharded:
    `parallel.octofit_sharded` sets it. Every rank calls `octofit` with the
    same arguments and a generator in the same state; each runs its block
    of the chains, draws the whole batch's random numbers, and all-reduces
    what crosses chains (ChEES's acceptance, criterion and metric, the
    NUTS and step-size loop exits). The returned `Chains` holds every
    chain, gathered, on every rank. Not for sampler="gibbs".
    """
    from ..config import get_config

    cfg = get_config()
    target_accept = cfg.target_accept if target_accept is None else target_accept
    chains = cfg.chains if chains is None else chains
    adaptation = cfg.adaptation if adaptation is None else adaptation
    iterations = cfg.iterations if iterations is None else iterations
    max_depth = cfg.max_depth if max_depth is None else max_depth
    verbosity = cfg.verbosity if verbosity is None else verbosity
    sampler = cfg.sampler if sampler is None else sampler
    profile_dir = (cfg.profile_dir or None) if profile_dir is None else profile_dir
    if profile_dir:
        from ..utils import profile_trace

        with profile_trace(profile_dir):
            return octofit(
                model, target_accept, generator=generator, chains=chains,
                adaptation=adaptation, iterations=iterations, max_depth=max_depth,
                verbosity=verbosity, starting_points=starting_points, metric=metric,
                sampler=sampler, profile_dir="", step_size=step_size,
                drop_warmup=drop_warmup, mesh=mesh,
            )
    if model.discrete_mode == "gibbs" and sampler != "gibbs":
        sampler = "gibbs"
        if verbosity >= 1:
            print("octofit: large discrete domain detected -> Gibbs-within-HMC sampler")
    if sampler not in ("chees", "nuts", "hmc", "gibbs"):
        raise ValueError(f"unknown sampler {sampler!r}; use 'chees', 'nuts', 'hmc' or 'gibbs'")
    if sampler == "gibbs" and not model.discrete_names:
        raise ValueError("sampler='gibbs' samples discrete priors; this model has no discrete "
                         "priors")
    if sampler == "gibbs" and (not drop_warmup or step_size is not None):
        raise ValueError(
            "drop_warmup=False / step_size= are not supported by the "
            "Gibbs-within-HMC sampler (used for large discrete "
            "domains); use the default adaptation instead"
        )
    if sampler == "gibbs" and mesh is not None:
        raise ValueError("mesh= shards ChEES, NUTS and HMC; the Gibbs-within-HMC sampler runs "
                         "in one process")
    shard = None if mesh is None else Shard.from_mesh(mesh, (chains,), ("chains",), model.device)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)

    if starting_points is not None:
        theta0 = model.tensor(starting_points)
        if theta0.ndim == 1:
            theta0 = theta0[None, :].expand(chains, -1).clone()
        initial_sigma = _initial_sigma_from_points(theta0.cpu().numpy(), metric)
    else:
        if model.starting_points is None:
            # full initialization pipeline (`initialization.jl:184`)
            model.initialize(generator, verbosity=verbosity)
        pts = model.starting_points
        idx = torch.randint(len(pts), (chains,), generator=generator,
                            device=generator.device)
        theta0 = pts[idx.to(pts.device)]
        if model.laplace_sigma is not None and metric == "dense":
            initial_sigma = model.laplace_sigma
        else:
            initial_sigma = _initial_sigma_from_points(pts.cpu().numpy(), metric)
    # every rank holds every starting point (and so the same initial
    # metric); each samples its own block of the chains
    if shard is not None:
        theta0 = theta0[shard.blocks[0]]

    t0 = time.perf_counter()
    if sampler == "gibbs":
        from .gibbs import run_gibbs

        samples, lps, stats, info = run_gibbs(
            model,
            theta0,
            generator,
            n_warmup=adaptation,
            n_samples=iterations,
            target_accept=target_accept,
            metric=metric,
            initial_sigma=initial_sigma,
        )
    elif sampler == "chees":
        samples, lps, stats, info = run_chees(
            model.ln_post_and_grad,
            theta0,
            generator,
            n_warmup=adaptation,
            n_samples=iterations,
            target_accept=target_accept,
            metric=metric,
            initial_sigma=initial_sigma,
            # ChEES trajectories are capped harder than a NUTS tree: on
            # plateau posteriors the adapted length can otherwise run to
            # 2**max_depth leapfrogs per step
            max_leapfrog=min(2**max_depth, 1024),
            drop_warmup=drop_warmup,
            shard=shard,
            **({} if step_size is None else {"initial_step_size": step_size}),
        )
    else:
        samples, lps, stats, info = run_nuts(
            model.ln_post_and_grad,
            theta0,
            generator,
            n_warmup=adaptation,
            n_samples=iterations,
            max_depth=max_depth,
            target_accept=target_accept,
            metric=metric,
            initial_sigma=initial_sigma,
            sampler=sampler,
            initial_step_size=step_size,
            drop_warmup=drop_warmup,
            shard=shard,
        )
    if samples.is_cuda:
        torch.cuda.synchronize(samples.device)
    t_sampling = time.perf_counter() - t0
    if shard is not None:
        samples, lps, stats, info, t_sampling = _gather_chains(
            shard, samples, lps, stats, info, t_sampling, sampler != "chees")

    if verbosity >= 1:
        n_evals = info["n_grad_evals"]
        n_div = int(stats.is_divergent.sum())
        n_draws_total = chains * iterations
        mean_accept = float(stats.acceptance_rate.mean())
        mean_depth = float(stats.tree_depth.double().mean())
        print(
            f"octofit sampling report: {chains} chains x {iterations} draws "
            f"in {t_sampling:.2f}s on {model.device}\n"
            f"  mean acceptance          {mean_accept:.3f}\n"
            f"  divergences              {n_div} "
            f"({100 * n_div / n_draws_total:.2f}%)\n"
            f"  mean tree depth          {mean_depth:.2f}\n"
            f"  batched gradient evals   {n_evals}\n"
            f"  time per batched eval    {t_sampling / max(n_evals, 1) * 1e6:.2f} us"
        )

    return _repackage(model, samples, lps, stats, info, t_sampling, sampler)


def octofit_rejection(
    model: LogDensityModel,
    *,
    generator: torch.Generator | None = None,
    num_samples: int = 10_000,
    batch_size: int = 100_000,
    max_batches: int = 100,
    verbosity: int = 1,
):
    """Rejection sampling from the prior (`sampling.jl:168-279`).

    Draws IID prior batches on the model's device; each draw is accepted
    with probability exp(ll - max_ll) against the GLOBAL maximum
    likelihood, as the reference does with its single pre-evaluated batch:
    every batch keeps, on the device, the superset accepted under the
    running maximum (which only grows, so acceptance probabilities only
    shrink) with each draw's uniform variate, and the final accept
    re-filters all retained candidates under the final max_ll, so the
    result is distributionally identical to one giant batch. The host
    reads the batch's maximum and the accepted count, once per batch.
    generator: a `torch.Generator` on the model's device (default: seed 0).
    Pairs with `ofti_linear_solve` for OFTI-style workflows.
    """
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)

    cand_draws, cand_ll, cand_u = [], [], []
    max_ll = -np.inf
    total_drawn = 0
    n_acc = 0
    for i in range(max_batches):
        with torch.no_grad():
            draws = model.sample_priors(generator, batch_size)
            lls = model.ln_like_nt(model.arr2nt(draws))
        lls = torch.where(torch.isnan(lls), -torch.inf, lls)
        u = torch.rand((batch_size,), generator=generator, dtype=model.dtype,
                       device=generator.device)
        prev_max_ll = max_ll
        # the maximum over finite values: one +inf must not reject the rest
        max_ll = max(max_ll, float(torch.where(torch.isfinite(lls), lls, -torch.inf).max()))
        keep = u < torch.exp(lls - max_ll)
        cand_draws.append(draws[keep])
        cand_ll.append(lls[keep])
        cand_u.append(u[keep])
        total_drawn += batch_size
        # exact acceptance count under the current global max. A higher
        # max only shrinks earlier candidates' acceptance, so the full
        # recount is needed ONLY when max_ll moved; otherwise count just
        # this batch's kept candidates (already filtered under max_ll).
        if max_ll > prev_max_ll:
            n_acc = int(sum((uc < torch.exp(lc - max_ll)).sum() for uc, lc in zip(cand_u, cand_ll)))
        else:
            n_acc += int(keep.sum())
        if verbosity >= 2:
            print(f"octofit_rejection: batch {i + 1}, accepted {n_acc}/{total_drawn}")
        if n_acc >= num_samples:
            break

    if not np.isfinite(max_ll):
        raise RuntimeError("all prior samples produced non-finite log-likelihoods")
    draws_all = torch.cat(cand_draws)
    ll_all = torch.cat(cand_ll)
    final = torch.cat(cand_u) < torch.exp(ll_all - max_ll)
    n_accepted = int(final.sum())
    draws_nat = draws_all[final][:num_samples]
    ll_acc = ll_all[final][:num_samples]
    n_kept = len(draws_nat)
    if n_kept == 0:
        raise RuntimeError("rejection sampling accepted zero draws")
    if n_kept / total_drawn < 1e-3 and verbosity >= 1:
        print(
            "octofit_rejection: very low acceptance rate "
            f"({100 * n_kept / total_drawn:.3g}%); consider octofit (HMC) instead"
        )

    with torch.no_grad():
        nts = model.arr2nt(draws_nat)
        lp = model.ln_prior_transformed(model.link(draws_nat)).cpu().numpy()
    data = {}
    for k, v in flatten_params_batch(nts).items():
        if v.ndim == 0 or v.shape[0] != n_kept:  # a constant: the same for every draw
            v = np.broadcast_to(v, (n_kept,) + v.shape)
        if v.ndim == 1:
            data[k] = v[None, :]
        else:
            flat2 = v.reshape(n_kept, -1)
            for j in range(flat2.shape[-1]):
                data[f"{k}_{j + 1}"] = flat2[None, :, j]
    ll_np = ll_acc.cpu().numpy()
    internals = {
        "loglike": ll_np[None, :],
        "logpost": (ll_np + lp)[None, :],
    }
    info = {
        "sampler": "rejection",
        "model_name": model.system.name,
        "acceptance_fraction": n_kept / total_drawn,
        # every draw accepted under the final maximum, before the cut to
        # num_samples: n_accepted / n_drawn is the acceptance rate itself,
        # where acceptance_fraction (the reference's) is at most
        # num_samples / n_drawn
        "n_accepted": n_accepted,
        "n_drawn": total_drawn,
        "n_batches": i + 1,
        "device": str(model.device),
    }
    return Chains(data, internals, info)
