"""Helpers shared by the HMC samplers: statistics, metric, step-size dual
averaging, Welford covariance, and the warmup window schedule.

PyTorch port of the parts of `octofitter_tpu/samplers/nuts.py` that
ChEES uses (`chees.py:40-50`); the NUTS transition itself is not ported
yet. Scalar adaptation state (dual averaging) is kept in Python floats
on the host; the sampler reads one scalar per step from the device to
drive it.
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
# Step-size dual averaging (Stan parameters)
# --------------------------------------------------------------------------

class DualAveragingState(NamedTuple):
    log_eps: float
    log_eps_avg: float
    h_avg: float
    mu: float
    count: float


def da_init(eps: float) -> DualAveragingState:
    return DualAveragingState(
        log_eps=math.log(eps),
        log_eps_avg=math.log(eps),
        h_avg=0.0,
        mu=math.log(10.0 * eps),
        count=0.0,
    )


def da_update(state: DualAveragingState, alpha: float, target=0.8,
              gamma=0.05, t0=10.0, kappa=0.75) -> DualAveragingState:
    t = state.count + 1
    h_avg = (1 - 1 / (t + t0)) * state.h_avg + (target - alpha) / (t + t0)
    log_eps = state.mu - math.sqrt(t) / gamma * h_avg
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
