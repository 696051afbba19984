"""Batched nested sampling.

PyTorch port of `octofitter_tpu/samplers/nested.py` (the reference's
Dynesty integration, `ext/OctofitterDynestyHypercubeTransformExt.jl`):
static nested sampling in which the K = batch_frac * n_live worst live
points are replaced at once. Each replacement is a walker started from a
random survivor that takes `n_mcmc_steps` Metropolis steps leaving the
prior invariant (proposals in unconstrained space, accepted by the ratio
of the transformed prior density) under the hard constraint ll > L*, the
K-th worst log-likelihood.

The live points stay on the model's device. The K walkers advance
together: each step is one batched proposal and one batched likelihood
over (K, D), so on the card every walker step is one launch of the fused
orbit-solve forward at (K, epochs). The sampler runs under `no_grad`: no
backward is launched and no graph is kept. The host reads one packed
tensor per iteration (the dead rows, their log-likelihoods, the live
maximum and the acceptance) and accumulates the evidence from it in
float64 with the shrinkage estimate, as the JAX package does.
"""

from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..chains import Chains, flatten_params_batch

# rounds of redrawing the initial live points whose log-likelihood is not
# finite (`nested.py:65`)
_REDRAW_ROUNDS = 20


class NestedDraws(NamedTuple):
    """The random numbers of one iteration with K walkers: `seeds` (K,)
    integers in [0, n_live - K), indices into the survivors sorted by
    log-likelihood; the proposals' standard normals `normals`
    (n_mcmc_steps, K, D); the acceptance uniforms `uniforms`
    (n_mcmc_steps, K)."""

    seeds: torch.Tensor
    normals: torch.Tensor
    uniforms: torch.Tensor


def _loglike(model, theta):
    """ln_like at natural-space rows theta (n, D) -> (n,), NaN as -inf."""
    ll = torch.broadcast_to(model.tensor(model.ln_like_nt(model.arr2nt(theta))),
                            theta.shape[:-1])
    return torch.where(torch.isnan(ll), -torch.inf, ll)


def _replace_batch(model, live, live_ll, K, n_mcmc_steps, draws: NestedDraws):
    """Remove the K worst live points and put in their place K walkers
    evolved from random survivors above the K-th threshold. Returns
    (live, live_ll, dead, dead_ll, mean acceptance), all on the device."""
    order = torch.argsort(live_ll, stable=True)
    worst_idx = order[:K]
    thresh = live_ll[order[K - 1]]
    dead = live[worst_idx]
    dead_ll = live_ll[worst_idx]

    seeds = order[K:][draws.seeds]
    theta = live[seeds]
    ll = live_ll[seeds]
    # proposal scale from the live points' spread in unconstrained space
    scale = torch.std(model.link(live), dim=0, correction=0) * 0.3 + 1e-8

    theta_t = model.link(theta)
    lp_t = model.ln_prior_transformed(theta_t)
    n_acc = torch.zeros_like(ll)
    for s in range(n_mcmc_steps):
        prop_t = theta_t + scale * draws.normals[s]
        prop = model.invlink(prop_t)
        prop_ll = _loglike(model, prop)
        # the transformed prior: logpdf(x) + log|dx/dy|
        prop_lp_t = model.ln_prior(prop) + model._ln_abs_det_jacobian(prop_t)
        ok = ((torch.log(draws.uniforms[s]) < prop_lp_t - lp_t)
              & (prop_ll > thresh) & torch.isfinite(prop_ll))
        theta_t = torch.where(ok[:, None], prop_t, theta_t)
        theta = torch.where(ok[:, None], prop, theta)
        ll = torch.where(ok, prop_ll, ll)
        lp_t = torch.where(ok, prop_lp_t, lp_t)
        n_acc = n_acc + ok
    live = live.index_copy_(0, worst_idx, theta)
    live_ll = live_ll.index_copy_(0, worst_idx, ll)
    return live, live_ll, dead, dead_ll, torch.mean(n_acc / n_mcmc_steps)


def octofit_nested(
    model,
    *,
    generator: torch.Generator | None = None,
    n_live: int = 1000,
    batch_frac: float = 0.25,
    n_mcmc_steps: int = 20,
    dlogz_tol: float = 0.05,
    max_iterations: int = 100_000,
    verbosity: int = 1,
    prior_draws: Callable[[int], torch.Tensor] | None = None,
    draws: Callable[[int], NestedDraws] | None = None,
):
    """Nested sampling; returns (Chains, info) with info['logz'].

    Parameters follow Dynesty-ish conventions: `n_live` live points,
    replacement in batches of `batch_frac * n_live`, `n_mcmc_steps`
    constrained-prior Metropolis steps per replacement. The run stops
    when the live points could add less than `dlogz_tol` to log Z.
    generator: a `torch.Generator` on the model's device (default: seed 0)
    that draws every random number not passed in.
    prior_draws: optional callable of the round r giving (n_live, D)
    natural-space prior draws: r = 0 the initial live points, r >= 1 the
    fresh draws that replace live points whose log-likelihood is not
    finite. draws: optional callable of the iteration giving its
    `NestedDraws`. The two let a caller replay another implementation's
    random numbers.

    info holds the JAX package's keys (sampler, model_name, logz,
    n_iterations, n_dead) and the run's `information` H (nats) from the
    final weights, each iteration's mean acceptance (`acceptance`) and
    `sampling_time_s`. The chain's draws are the dead and final live
    points resampled to equal weights with numpy's default_rng(0).
    """
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    dev, dtype, D = model.device, model.dtype, model.D
    K = max(1, int(batch_frac * n_live))

    def prior(r):
        if prior_draws is not None:
            return model.tensor(prior_draws(r)).clone()
        return model.sample_priors(generator, n_live)

    def iteration_draws(it):
        if draws is not None:
            d = draws(it)
            return NestedDraws(torch.as_tensor(d.seeds, device=dev),
                               model.tensor(d.normals), model.tensor(d.uniforms))
        return NestedDraws(
            torch.randint(0, n_live - K, (K,), generator=generator, device=dev),
            torch.randn((n_mcmc_steps, K, D), generator=generator, dtype=dtype, device=dev),
            torch.rand((n_mcmc_steps, K), generator=generator, dtype=dtype, device=dev))

    t0 = time.perf_counter()
    with torch.no_grad():
        live = prior(0)
        live_ll = _loglike(model, live)
        for r in range(1, _REDRAW_ROUNDS + 1):
            bad = ~torch.isfinite(live_ll)
            if not bool(bad.any()):
                break
            fresh = prior(r)
            live = torch.where(bad[:, None], fresh, live)
            live_ll = torch.where(bad, _loglike(model, fresh), live_ll)

        dead_points, dead_lls, dead_log_w, acceptance = [], [], [], []
        log_x_prev = 0.0
        logz = -np.inf
        it = 0
        while it < max_iterations:
            live, live_ll, dead, dead_ll, acc = _replace_batch(
                model, live, live_ll, K, n_mcmc_steps, iteration_draws(it))
            # one host read: dead rows, their log-likelihoods, live max, acceptance
            packed = torch.cat([dead.reshape(-1), dead_ll, live_ll.max().reshape(1),
                                acc.reshape(1)]).cpu().numpy().astype(np.float64)
            dead_np = packed[: K * D].reshape(K, D)
            dead_ll_np = packed[K * D: K * D + K]
            ll_max, acc = float(packed[-2]), float(packed[-1])
            # batch shrinkage: removing the j-th worst of n live points (not
            # yet replaced) shrinks the enclosed mass by E[dlogX] =
            # -1/(n - j + 1); summed over the batch this is ln(n/(n-K)),
            # NOT K/n, which biases logZ high
            for j in range(1, K + 1):
                log_x = log_x_prev - 1.0 / (n_live - j + 1)
                log_w = np.log(max(np.exp(log_x_prev) - np.exp(log_x), 1e-320))
                logz = np.logaddexp(logz, log_w + dead_ll_np[j - 1])
                dead_log_w.append(log_w)
                log_x_prev = log_x
            dead_points.append(dead_np)
            dead_lls.append(dead_ll_np)
            acceptance.append(acc)
            it += 1
            # termination: the evidence the live points could still add
            dlogz = np.logaddexp(logz, log_x_prev + ll_max) - logz
            if verbosity >= 2 and it % 20 == 0:
                print(f"nested it {it}: logz={logz:.3f} dlogz={dlogz:.3f} accept={acc:.2f}")
            if dlogz < dlogz_tol:
                break

        # the remaining live points, each with an equal width X_final / n_live
        # of the remaining prior mass
        live_np = live.cpu().numpy().astype(np.float64)
        live_ll_np = live_ll.cpu().numpy().astype(np.float64)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_sampling = time.perf_counter() - t0
    order = np.argsort(live_ll_np)
    log_w_live = log_x_prev - math.log(n_live)
    for j in order:
        logz = np.logaddexp(logz, log_w_live + live_ll_np[j])
        dead_points.append(live_np[j: j + 1])
        dead_lls.append(live_ll_np[j: j + 1])
        dead_log_w.append(log_w_live)

    dead_all = np.concatenate(dead_points)
    dead_ll_all = np.concatenate(dead_lls)
    n_dead = len(dead_all)
    log_wt = np.asarray(dead_log_w) + dead_ll_all
    log_wt -= log_wt.max()
    w = np.exp(log_wt)
    w /= w.sum()
    finite = w > 0
    information = float(np.sum(w[finite] * dead_ll_all[finite]) - logz)

    # resample to equal weights
    rng = np.random.default_rng(0)
    idx = rng.choice(n_dead, size=n_dead, p=w)
    samples = dead_all[idx]

    with torch.no_grad():
        nts = model.arr2nt(model.tensor(samples))
    data = {}
    for k, v in flatten_params_batch(nts).items():
        if v.ndim == 0:  # a constant: the same for every draw
            v = np.broadcast_to(v, (n_dead,))
        if v.ndim == 1:
            data[k] = v[None, :]
    internals = {"loglike": dead_ll_all[idx][None, :]}
    info = {
        "sampler": "nested_batched",
        "model_name": model.system.name,
        "logz": float(logz),
        "n_iterations": it,
        "n_dead": n_dead,
        "information": information,
        "acceptance": np.asarray(acceptance),
        "sampling_time_s": t_sampling,
    }
    if verbosity >= 1:
        print(f"octofit_nested: logz = {logz:.3f} after {it} iterations")
    return Chains(data, internals, info), info


# Dynesty-compatible alias (`ext/OctofitterDynestyHypercubeTransformExt.jl:11`)
dysample = octofit_nested
