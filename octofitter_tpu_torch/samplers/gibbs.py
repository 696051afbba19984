"""Gibbs-within-HMC for models with large discrete domains.

PyTorch port of `octofitter_tpu/samplers/gibbs.py`. When the product of
the discrete domains exceeds the marginalization cap, `LogDensityModel`
is in the Gibbs mode (`discrete_mode == "gibbs"`) and each transition of
every chain is
  1. a jittered-HMC transition (`hmc.py:hmc_step`) of the continuous
     parameters, conditional on the chain's discrete values;
  2. a systematic-scan Gibbs sweep redrawing every discrete variable from
     its full conditional (`LogDensityModel.gibbs_update_disc`: one
     likelihood evaluation without gradient per variable);
  3. one value-and-gradient evaluation at the new state.
The chain axis is written out; the warmup is NUTS's (Stan's windows, a
step size per chain by dual averaging, a metric per chain from Welford
covariances), with the JAX package's starting step size of 0.05.
"""

from __future__ import annotations

import numpy as np
import torch

from .hmc import hmc_step
from .nuts import (
    _stack_draws,
    build_warmup_schedule,
    chain_metric,
    da_init,
    da_update,
    initial_chain_metric,
    welford_init,
    welford_sigma,
    welford_update,
)


def run_gibbs(
    model,
    theta0_batch: torch.Tensor,
    generator: torch.Generator,
    n_warmup: int = 1000,
    n_samples: int = 1000,
    n_leapfrog: int = 32,
    target_accept: float = 0.8,
    metric: str = "diag",
    initial_sigma=None,
    disc0_batch=None,
):
    """Warmup + sample a batch of chains with Gibbs-within-HMC.

    theta0_batch: (C, D) unconstrained starting points. disc0_batch:
    (C, n_disc) starting discrete values (default: prior draws from a
    generator seeded 0). metric: "diag" or "dense"; initial_sigma: an
    optional (D,) or (D, D) starting metric shared by the chains.

    Returns (samples [C, S, D], lps [C, S], NutsStats with [C, S] leaves,
    info) with info["disc_samples"] [C, S, n_disc] the discrete draws,
    "step_size" (C,), "sigma", "warmup_divergences" (C,), "n_grad_evals"
    (batched value-and-gradient evaluations) and "n_sweep_evals" (batched
    likelihood evaluations of the Gibbs sweeps, one per discrete variable
    per transition)."""
    Theta = model.tensor(theta0_batch)
    C, D = Theta.shape
    dtype, device = Theta.dtype, Theta.device
    dense = metric == "dense"
    if disc0_batch is None:
        disc0_batch = model.sample_disc_priors(
            torch.Generator(device=model.device).manual_seed(0), C)
    disc = model.tensor(disc0_batch)
    n_disc = disc.shape[-1]
    is_slow, window_end = build_warmup_schedule(n_warmup)
    metric_c = initial_chain_metric(initial_sigma, C, D, dense, dtype, device)

    def vg_given(d):
        return lambda th: model.ln_post_given_disc_and_grad(th, d)

    def transition(Theta, disc, lp, Grad, eps, metric_c):
        Theta, lp, Grad, stats = hmc_step(vg_given(disc), Theta, lp, Grad, generator, eps,
                                          metric_c, n_leapfrog)
        disc = model.gibbs_update_disc(Theta, disc, generator)
        lp, Grad = model.ln_post_given_disc_and_grad(Theta, disc)
        return Theta, disc, lp, Grad, stats

    def host_tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    lp, Grad = model.ln_post_given_disc_and_grad(Theta, disc)
    da = da_init(np.full(C, 0.05))
    welford = welford_init(D, dtype, dense, device=device, n_chains=C)
    wdivs = torch.zeros((C,), dtype=torch.int64, device=device)
    for s in range(n_warmup):
        Theta, disc, lp, Grad, stats = transition(Theta, disc, lp, Grad,
                                                  host_tensor(np.exp(da.log_eps)), metric_c)
        da = da_update(da, stats.acceptance_rate.cpu().double().numpy(), target_accept)
        if is_slow[s]:
            welford = welford_update(welford, Theta)
        if window_end[s]:
            metric_c = chain_metric(welford_sigma(welford))
            welford = welford_init(D, dtype, dense, device=device, n_chains=C)
            da = da_init(np.exp(da.log_eps))
        wdivs += stats.is_divergent

    eps_f = np.exp(da.log_eps_avg)
    eps_t = host_tensor(eps_f)
    Thetas, discs, lps, stats_list = [], [], [], []
    for _ in range(n_samples):
        Theta, disc, lp, Grad, stats = transition(Theta, disc, lp, Grad, eps_t, metric_c)
        Thetas.append(Theta)
        discs.append(disc)
        lps.append(lp)
        stats_list.append(stats)

    samples, lps_out, stats_out = _stack_draws(Thetas, lps, stats_list)
    n_transitions = n_warmup + n_samples
    info = {
        "step_size": eps_f,
        "sigma": metric_c.sigma,
        "disc_samples": torch.stack(discs, dim=1),
        "warmup_divergences": wdivs.cpu().numpy(),
        "n_grad_evals": 1 + n_transitions * (n_leapfrog + 1),
        "n_sweep_evals": n_transitions * n_disc,
        "transition_evals": np.full(n_transitions, n_leapfrog + 1),
    }
    return samples, lps_out, stats_out, info
