"""ChEES-HMC: cross-chain adaptive-trajectory HMC.

PyTorch port of `octofitter_tpu/samplers/chees.py` (Hoffman, Radul &
Sountsov, AISTATS 2021). All chains share one Halton-jittered trajectory
time t = u * T per step; the maximum T is tuned by Adam ascent on the
ChEES criterion, whose gradient is estimated from the chain batch.

- step size: shared dual averaging on the mean Metropolis acceptance
  across chains (Stan parameters);
- trajectory length: Adam on log T, with the per-chain gradient
  estimate weighted by acceptance probability;
- metric: shared Welford covariance accumulated over (steps x chains)
  during Stan-style slow windows.

The JAX package's `lax.scan` over a `lax.while_loop` becomes eager
Python loops: each transition reads one pair of scalars from the device
(the mean acceptance and the ChEES gradient) to drive the host-side
adaptation, and the leapfrog count is a host integer.

`value_and_grad(Theta) -> (lp, Grad)` works on the whole (C, D) chain
batch at once.

`_chees_transition_rungs` is the parallel-tempering explorer's form: the
JAX package vmaps `_chees_transition` over the rungs of a ladder
(`tempering.py:395-421`), and here all rungs' chains are one batch, each
rung with its own step size, diagonal metric and leapfrog count.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .nuts import (
    MAX_DELTA_ENERGY,
    NutsStats,
    WelfordState,
    _kinetic,
    _leapfrog,
    _sample_momentum,
    _stack_draws,
    _velocity,
    build_warmup_schedule,
    chain_metric,
    da_init,
    da_update,
    leapfrogs_masked,
    metric_from_sigma,
    welford_init,
    welford_sigma,
)
from .shard import as_shard


# --------------------------------------------------------------------------
# Welford accumulator over the chains of a batch
# --------------------------------------------------------------------------

def welford_update_batch(w: WelfordState, X, shard=None):
    """Merge a (C, D) batch into a Welford accumulator (Chan et al.); under
    a `shard`, X is this rank's block and the whole batch is merged."""
    shard = as_shard(shard, X.shape[0])
    n_b = float(shard.axes[0].n)
    mean_b = shard.sum(X.sum(dim=0)) / n_b
    delta = X - mean_b[None, :]
    if w.m2.ndim == 2:
        m2_b = shard.sum(delta.T @ delta)
    else:
        m2_b = shard.sum(torch.sum(delta * delta, dim=0))
    n = w.n + n_b
    d = mean_b - w.mean
    mean = w.mean + d * (n_b / max(n, 1))
    if w.m2.ndim == 2:
        corr = torch.outer(d, d) * (w.n * n_b / max(n, 1))
    else:
        corr = d * d * (w.n * n_b / max(n, 1))
    return WelfordState(n, mean, w.m2 + m2_b + corr)


# --------------------------------------------------------------------------
# Halton sequence (host-side)
# --------------------------------------------------------------------------

def halton_sequence(n: int, base: int = 2) -> np.ndarray:
    """First n points of the van der Corput / Halton sequence in (0, 1)."""
    out = np.zeros(n)
    for i in range(n):
        f, r = 1.0, 0.0
        k = i + 1
        while k > 0:
            f /= base
            r += f * (k % base)
            k //= base
        out[i] = r
    return out


# --------------------------------------------------------------------------
# Adam on log trajectory length (host floats, or one per rung)
# --------------------------------------------------------------------------

class AdamState(NamedTuple):
    """Leaves are floats, or (NT,) numpy arrays with one entry per rung;
    `_adam_step` is elementwise."""

    m: float | np.ndarray
    v: float | np.ndarray
    t: float | np.ndarray


def _adam_step(state: AdamState, g, lr=0.025, b1=0.9, b2=0.95, eps=1e-8):
    t = state.t + 1
    m = b1 * state.m + (1 - b1) * g
    v = b2 * state.v + (1 - b2) * g * g
    mh = m / (1 - b1**t)
    vh = v / (1 - b2**t)
    sqrt_vh = math.sqrt(vh) if isinstance(vh, float) else np.sqrt(vh)
    return AdamState(m, v, t), lr * mh / (sqrt_vh + eps)


# --------------------------------------------------------------------------
# One ChEES transition over the whole chain batch
# --------------------------------------------------------------------------

def _chees_transition(vg_batch, Theta, lp, Grad, generator, eps, traj_len, u,
                      metric, max_leapfrog, shard=None):
    """Shared-trajectory HMC step for all chains at once.

    Returns new (Theta, lp, Grad), per-chain stats, the ChEES
    trajectory-length gradient estimate (a 0-d tensor) and the number of
    leapfrog steps taken. Under a `shard` (`samplers/shard.py`) Theta is
    this rank's block: the draws are the whole batch's and the criterion's
    cross-chain sums are all-reduced."""
    C, D = Theta.shape
    shard = as_shard(shard, C)
    Z = shard.randn(generator, (D,), Theta.dtype)
    R0 = _sample_momentum(metric, Z)
    H0 = -lp + _kinetic(metric, R0)

    L = int(min(max(math.ceil(u * traj_len / eps), 1), max_leapfrog))
    Theta1, R1, lp1, Grad1 = Theta, R0, lp, Grad
    for _ in range(L):
        Theta1, R1, lp1, Grad1 = _leapfrog(vg_batch, Theta1, R1, Grad1, eps, metric)

    H1 = -lp1 + _kinetic(metric, R1)
    delta = H1 - H0
    delta = torch.where(torch.isnan(delta), torch.inf, delta)
    alpha = torch.clamp(torch.exp(-delta), max=1.0)
    divergent = delta > MAX_DELTA_ENERGY

    accept = shard.rand(generator, (), Theta.dtype) < alpha
    acc = accept[:, None]
    Theta_new = torch.where(acc, Theta1, Theta)
    lp_new = torch.where(accept, lp1, lp)
    Grad_new = torch.where(acc, Grad1, Grad)

    # --- ChEES gradient estimate (Hoffman et al. 2021, eq. 8) ---------
    # Use only non-divergent proposals; weight by acceptance prob.
    w = torch.where(divergent, 0.0, alpha)
    sums = shard.sum(torch.cat([Theta.sum(dim=0), (w[:, None] * Theta1).sum(dim=0), w.sum()[None]]))
    mean_cur = sums[:D] / shard.axes[0].n
    wsum = torch.clamp(sums[2 * D], min=1e-12)
    mean_prop = sums[D:2 * D] / wsum
    dsq_prop = torch.sum((Theta1 - mean_prop[None, :]) ** 2, dim=1)
    dsq_cur = torch.sum((Theta - mean_cur[None, :]) ** 2, dim=1)
    V1 = _velocity(metric, R1)  # dtheta/dt at trajectory end
    proj = torch.sum((Theta1 - mean_prop[None, :]) * V1, dim=1)
    per_chain = (dsq_prop - dsq_cur) * proj
    per_chain = torch.where(torch.isfinite(per_chain), per_chain, 0.0)
    # d t / d log T = t, and t = u*T shared across chains
    grad_logT = shard.sum((w * per_chain).sum()) / wsum * u

    stats = NutsStats(
        acceptance_rate=alpha,
        is_divergent=divergent,
        tree_depth=torch.zeros((C,), dtype=torch.int32, device=Theta.device),
        n_steps=torch.full((C,), L, dtype=torch.int32, device=Theta.device),
        energy=H0,
        step_size=torch.full((C,), eps, dtype=Theta.dtype, device=Theta.device),
    )
    return Theta_new, lp_new, Grad_new, stats, grad_logT, L


def _chees_transition_rungs(vg_batch, Theta, lp, Grad, generator, eps, sigma,
                            n_steps, u, n_rungs, shard=None):
    """One shared-trajectory ChEES transition of every rung of a ladder.

    Theta (C, D) holds C = W * n_rungs chains, walker-major: row
    w * n_rungs + n is walker w at rung n. eps (n_rungs,) and sigma
    (n_rungs, D) are each rung's step size and diagonal metric; n_steps
    (n_rungs,) host integers are each rung's leapfrog count. All rows take
    max(n_steps) leapfrog steps, evaluated together; a rung's rows stop
    changing once they have taken their own count (its later steps are
    computed and masked out), as under the JAX package's vmap of a
    `while_loop`.

    Returns the new Theta, each row's acceptance probability (C,), and the
    ChEES gradient of log T per rung (n_rungs,), each estimated from that
    rung's W walkers. (A ladder re-evaluates its states after the swaps
    that follow, so lp and Grad are not returned.)

    Under a `shard` over the (walkers, rungs) grid, Theta holds this
    rank's block (n_rungs of its rungs): the draws are the whole ladder's,
    and the criterion's sums over a rung's walkers are all-reduced over
    the walker axis."""
    C, D = Theta.shape
    shard = as_shard(shard, (C // n_rungs, n_rungs))
    W = C // n_rungs
    eps_r = eps.repeat(W)[:, None]
    metric_r = chain_metric(sigma.repeat(W, 1))
    Z = shard.randn(generator, (D,), Theta.dtype)
    R0 = _sample_momentum(metric_r, Z)
    H0 = -lp + _kinetic(metric_r, R0)

    steps_r = torch.as_tensor(np.tile(n_steps, W), device=Theta.device)
    Theta1, R1, lp1, _ = leapfrogs_masked(vg_batch, Theta, R0, lp, Grad, eps_r, metric_r,
                                          steps_r, int(np.min(n_steps)), int(np.max(n_steps)))

    H1 = -lp1 + _kinetic(metric_r, R1)
    delta = H1 - H0
    delta = torch.where(torch.isnan(delta), torch.inf, delta)
    alpha = torch.clamp(torch.exp(-delta), max=1.0)
    divergent = delta > MAX_DELTA_ENERGY
    accept = shard.rand(generator, (), Theta.dtype) < alpha
    Theta_new = torch.where(accept[:, None], Theta1, Theta)

    # the ChEES gradient estimate of `_chees_transition`, per rung: rungs
    # are the second axis of the (W, n_rungs, ...) views, walkers the first
    w = torch.where(divergent, 0.0, alpha).view(W, n_rungs)
    Th0 = Theta.view(W, n_rungs, D)
    Th1 = Theta1.view(W, n_rungs, D)
    sums = shard.sum(torch.cat([Th0.sum(dim=0), (w[..., None] * Th1).sum(dim=0),
                                w.sum(dim=0)[:, None]], dim=1))  # (n_rungs, 2 D + 1)
    mean_cur = sums[:, :D] / shard.axes[0].n
    wsum = torch.clamp(sums[:, 2 * D], min=1e-12)
    mean_prop = sums[:, D:2 * D] / wsum[:, None]
    dsq_prop = torch.sum((Th1 - mean_prop) ** 2, dim=-1)
    dsq_cur = torch.sum((Th0 - mean_cur) ** 2, dim=-1)
    V1 = _velocity(metric_r, R1).view(W, n_rungs, D)
    proj = torch.sum((Th1 - mean_prop) * V1, dim=-1)
    per_chain = (dsq_prop - dsq_cur) * proj
    per_chain = torch.where(torch.isfinite(per_chain), per_chain, 0.0)
    grad_logT = shard.sum((w * per_chain).sum(dim=0)) / wsum * u
    return Theta_new, alpha, grad_logT


# --------------------------------------------------------------------------
# Full run
# --------------------------------------------------------------------------

def run_chees(
    value_and_grad,
    theta0_batch: torch.Tensor,
    generator: torch.Generator,
    n_warmup: int = 1000,
    n_samples: int = 1000,
    target_accept: float = 0.75,
    metric: str = "dense",
    initial_sigma=None,
    max_leapfrog: int = 1024,
    initial_step_size: float = 0.05,
    adam_lr: float = 0.025,
    warmup_state: dict | None = None,
    drop_warmup: bool = True,
    shard=None,
):
    """Warmup + sample with cross-chain ChEES adaptation.

    Returns (samples [C, S, D], lps [C, S], NutsStats with [C, S]
    leaves, info dict). Step size, trajectory length and metric are
    adapted jointly from all chains.

    warmup_state: dict(step_size, trajectory_length, sigma) from a
    previous run's info: skips warmup and samples with the saved tuning.
    drop_warmup: when False, the adaptation-phase draws are prepended to
    the returned draws (reference octofit `drop_warmup`).
    info["n_grad_evals"] counts batched gradient evaluations, warmup
    included. shard: the block of a batch sharded across processes that
    theta0_batch holds (`samplers/shard.py`): every cross-chain quantity
    (the acceptance, the ChEES criterion, the metric, the divergences) is
    the whole batch's.
    """
    Theta = theta0_batch
    C, D = Theta.shape
    shard = as_shard(shard, C)
    dtype, device = Theta.dtype, Theta.device
    dense = metric == "dense"

    if initial_sigma is None:
        sigma0 = torch.eye(D, dtype=dtype, device=device) if dense else torch.ones((D,), dtype=dtype, device=device)
    else:
        sigma0 = torch.as_tensor(initial_sigma, dtype=dtype, device=device)
        if dense and sigma0.ndim == 1:
            sigma0 = torch.diag(sigma0)
        if not dense and sigma0.ndim == 2:
            sigma0 = torch.diagonal(sigma0)

    lp, Grad = value_and_grad(Theta)
    n_grad_evals = 1
    Thetas, lps, stats_list = [], [], []
    wdivs = []
    T_trace = []

    if warmup_state is not None:
        eps_f = float(warmup_state["step_size"])
        T_f = float(warmup_state["trajectory_length"])
        metric_f = metric_from_sigma(torch.as_tensor(warmup_state["sigma"], dtype=dtype, device=device))
    else:
        is_slow, window_end = build_warmup_schedule(n_warmup)
        da = da_init(initial_step_size)
        log_T = math.log(16.0 * initial_step_size)
        adam = AdamState(0.0, 0.0, 0.0)
        welford = welford_init(D, dtype, dense, device=device)
        metric_cur = metric_from_sigma(sigma0)
        for s, u in enumerate(halton_sequence(n_warmup).tolist()):
            Theta, lp, Grad, stats, g_logT, L = _chees_transition(
                value_and_grad, Theta, lp, Grad, generator,
                math.exp(da.log_eps), math.exp(log_T), u, metric_cur, max_leapfrog, shard,
            )
            n_grad_evals += L
            mean_alpha, g_logT = torch.stack(
                [shard.sum(stats.acceptance_rate.sum()) / shard.axes[0].n, g_logT.to(dtype)]
            ).tolist()
            # shared dual averaging on the cross-chain mean acceptance
            da_new = da_update(da, mean_alpha, target_accept)
            # Adam ascent on log T, kept within [eps, max_leapfrog * eps]
            adam, delta_logT = _adam_step(adam, g_logT, adam_lr)
            log_T = min(max(log_T + delta_logT, da.log_eps),
                        da.log_eps + math.log(float(max_leapfrog)))
            da = da_new
            # cross-chain Welford in slow windows
            if is_slow[s]:
                welford = welford_update_batch(welford, Theta, shard)
            if window_end[s]:
                metric_cur = metric_from_sigma(welford_sigma(welford))
                welford = welford_init(D, dtype, dense, device=device)
                da = da_init(math.exp(da.log_eps))
            wdivs.append(stats.is_divergent.sum())
            T_trace.append(math.exp(log_T))
            if not drop_warmup:  # record adaptation draws too
                Thetas.append(Theta)
                lps.append(lp)
                stats_list.append(stats)
        eps_f = math.exp(da.log_eps_avg)
        T_f = math.exp(log_T)
        metric_f = metric_cur

    for u in halton_sequence(n_samples).tolist():
        Theta, lp, Grad, stats, _, L = _chees_transition(
            value_and_grad, Theta, lp, Grad, generator, eps_f, T_f, u,
            metric_f, max_leapfrog, shard,
        )
        n_grad_evals += L
        Thetas.append(Theta)
        lps.append(lp)
        stats_list.append(stats)

    samples, lps_out, stats_out = _stack_draws(Thetas, lps, stats_list)
    info = {
        "step_size": eps_f,
        "trajectory_length": T_f,
        "sigma": metric_f.sigma,
        "warmup_divergences": int(shard.sum(torch.stack(wdivs).sum())) if wdivs else 0,
        "trajectory_length_trace": np.asarray(T_trace),
        "n_grad_evals": n_grad_evals,
    }
    return samples, lps_out, stats_out, info
