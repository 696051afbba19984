"""Helpers shared by the HMC samplers: statistics, metric, step-size dual
averaging, Welford covariance, and the warmup window schedule.

PyTorch port of the parts of `octofitter_tpu/samplers/nuts.py` that
ChEES uses (`chees.py:40-50`); the NUTS transition itself is not ported
yet. Adaptation state (dual averaging) is kept on the host: Python floats
for one shared step size, or numpy arrays for one per tempering rung
(the arithmetic is elementwise, so one update serves both). The sampler
reads the mean acceptance from the device once per step to drive it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

MAX_DELTA_ENERGY = 1000.0  # divergence threshold, as Stan/AdvancedHMC


class NutsStats(NamedTuple):
    acceptance_rate: torch.Tensor
    is_divergent: torch.Tensor
    tree_depth: torch.Tensor
    n_steps: torch.Tensor
    energy: torch.Tensor
    step_size: torch.Tensor


# --------------------------------------------------------------------------
# Metric (Euclidean; diagonal or dense decided by ndim)
# --------------------------------------------------------------------------

class Metric(NamedTuple):
    """sigma = M^{-1} (posterior-covariance estimate); chol = chol(sigma)."""

    sigma: torch.Tensor   # (D,) diagonal or (D, D) dense
    chol: torch.Tensor    # sqrt(sigma) or lower-Cholesky of sigma


def metric_from_sigma(sigma: torch.Tensor) -> Metric:
    if sigma.ndim == 1:
        return Metric(sigma, torch.sqrt(sigma))
    return Metric(sigma, torch.linalg.cholesky(sigma))


# --------------------------------------------------------------------------
# Leapfrog steps of a batch, each chain stopping at its own count
# --------------------------------------------------------------------------

def leapfrogs_masked(value_and_grad, Theta, R, lp, Grad, eps, sigma, n_steps, n_min, n_max):
    """`n_max` leapfrog steps of a (C, D) batch under a diagonal metric
    (velocity = sigma * R), every chain evaluated at every step; chain c
    stops changing after n_steps[c] (a (C,) tensor) steps, all chains
    taking at least the host integer n_min. eps and sigma broadcast
    against (C, 1) and (C, D). Returns (Theta, R, lp, Grad)."""
    for i in range(n_max):
        R_half = R + 0.5 * eps * Grad
        Theta2 = Theta + eps * (R_half * sigma)
        lp2, Grad2 = value_and_grad(Theta2)
        R2 = R_half + 0.5 * eps * Grad2
        if i < n_min:
            Theta, R, lp, Grad = Theta2, R2, lp2, Grad2
            continue
        go = n_steps > i
        Theta = torch.where(go[:, None], Theta2, Theta)
        R = torch.where(go[:, None], R2, R)
        lp = torch.where(go, lp2, lp)
        Grad = torch.where(go[:, None], Grad2, Grad)
    return Theta, R, lp, Grad


# --------------------------------------------------------------------------
# Step-size dual averaging (Stan parameters)
# --------------------------------------------------------------------------

class DualAveragingState(NamedTuple):
    """Leaves are floats (one step size) or (NT,) numpy arrays (one per
    rung); every operation on them is elementwise."""

    log_eps: float | np.ndarray
    log_eps_avg: float | np.ndarray
    h_avg: float | np.ndarray
    mu: float | np.ndarray
    count: float | np.ndarray


def da_init(eps) -> DualAveragingState:
    """Fresh state at step size `eps`: a float, or an array of them.
    A float keeps Python floats (and `math`) throughout, so the one-step-
    size sampler's arithmetic does not depend on numpy's vector math."""
    if np.ndim(eps) == 0:
        eps = float(eps)
        return DualAveragingState(math.log(eps), math.log(eps), 0.0, math.log(10.0 * eps), 0.0)
    eps = np.asarray(eps, dtype=np.float64)
    zero = np.zeros_like(eps)
    return DualAveragingState(np.log(eps), np.log(eps), zero, np.log(10.0 * eps), zero)


def da_update(state: DualAveragingState, alpha, target=0.8,
              gamma=0.05, t0=10.0, kappa=0.75) -> DualAveragingState:
    t = state.count + 1
    h_avg = (1 - 1 / (t + t0)) * state.h_avg + (target - alpha) / (t + t0)
    sqrt_t = math.sqrt(t) if isinstance(t, float) else np.sqrt(t)
    log_eps = state.mu - sqrt_t / gamma * h_avg
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1 - eta) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_avg, state.mu, t)


# --------------------------------------------------------------------------
# Welford accumulator for the metric (diag or dense)
# --------------------------------------------------------------------------

class WelfordState(NamedTuple):
    n: float
    mean: torch.Tensor
    m2: torch.Tensor      # (D,) for diag, (D, D) for dense


def welford_init(D, dtype, dense: bool, *, device) -> WelfordState:
    return WelfordState(
        n=0.0,
        mean=torch.zeros((D,), dtype=dtype, device=device),
        m2=torch.zeros((D, D) if dense else (D,), dtype=dtype, device=device),
    )


def welford_sigma(w: WelfordState) -> torch.Tensor:
    """Regularized covariance estimate (Stan's shrinkage to identity)."""
    var = w.m2 / max(w.n - 1, 1)
    shrink = w.n / (w.n + 5.0)
    if w.m2.ndim == 2:
        D = w.mean.shape[0]
        eye = torch.eye(D, dtype=var.dtype, device=var.device)
        return shrink * var + 1e-3 * (1 - shrink) * eye
    return shrink * var + 1e-3 * (1 - shrink)


# --------------------------------------------------------------------------
# Warmup schedule (host-side static arrays)
# --------------------------------------------------------------------------

def build_warmup_schedule(n_warmup: int):
    """Stan's three-stage windowed schedule: returns boolean arrays
    (is_slow[s], window_end[s]) of length n_warmup."""
    init_buffer, term_buffer, base_window = 75, 50, 25
    if n_warmup < init_buffer + term_buffer + base_window:
        # degenerate short warmup: single window covering the middle
        init_buffer = max(1, int(0.15 * n_warmup))
        term_buffer = max(1, int(0.1 * n_warmup))
        base_window = max(1, n_warmup - init_buffer - term_buffer)
    is_slow = np.zeros(n_warmup, bool)
    window_end = np.zeros(n_warmup, bool)
    slow_lo = init_buffer
    slow_hi = n_warmup - term_buffer
    is_slow[slow_lo:slow_hi] = True
    # doubling windows
    w = base_window
    pos = slow_lo
    while pos < slow_hi:
        end = pos + w
        if end + 2 * w > slow_hi:
            end = slow_hi
        window_end[min(end, slow_hi) - 1] = True
        pos = end
        w *= 2
    return is_slow, window_end
