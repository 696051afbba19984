"""Vectorized No-U-Turn sampler and the helpers the HMC samplers share.

PyTorch port of `octofitter_tpu/samplers/nuts.py`: the multinomial NUTS
transition (iterative tree building with trailing-zero momentum
checkpoints, the generalized U-turn criterion, biased progressive
sampling), the step-size search, dual averaging, Welford covariance, the
warmup window schedule, and `run_nuts`, Stan-style window adaptation of a
per-chain step size and diagonal or dense metric followed by sampling.

The JAX package writes the transition for one chain and vmaps it over the
chains, which runs every chain's `while_loop`s in lockstep, masked. Here
the chain axis is written out and the lockstep is explicit: all chains
still building their trees are at the same depth and the same leaf index
k, so the checkpoint slot tz(k) and the U-turn span tz(k + 1) are host
integers, and each leaf is one batched value-and-gradient evaluation of
every chain, the finished ones masked. The host reads one "any chain
still building" flag per leaf, so a transition costs the deepest chain's
leaves. Per-chain quantities are the direction, the step size and the
metric (`chain_metric`: sigma (C, D) diagonal or (C, D, D) dense). The
metric and leapfrog helpers take a per-chain or a shared `Metric`, so
ChEES and HMC use them too.

Adaptation state (dual averaging) is kept on the host: Python floats for
one shared step size (ChEES), or numpy arrays with one entry per chain
(NUTS) or per tempering rung (the arithmetic is elementwise, so one update
serves all three). The samplers read the acceptance from the device once
per transition to drive it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .shard import as_shard

MAX_DELTA_ENERGY = 1000.0  # divergence threshold, as Stan/AdvancedHMC


class NutsStats(NamedTuple):
    acceptance_rate: torch.Tensor
    is_divergent: torch.Tensor
    tree_depth: torch.Tensor
    n_steps: torch.Tensor
    energy: torch.Tensor
    step_size: torch.Tensor


# --------------------------------------------------------------------------
# Metric (Euclidean; diagonal or dense, shared or one per chain)
# --------------------------------------------------------------------------

class Metric(NamedTuple):
    """sigma = M^{-1} (posterior-covariance estimate); chol = chol(sigma).

    Shared by every chain (`metric_from_sigma`): sigma (D,) diagonal or
    (D, D) dense. One per chain (`chain_metric`): (C, D) or (C, D, D).
    `dense` tells them apart: a diagonal sigma broadcasts against a (C, D)
    batch either way, and a dense one is shared when it is 2-D."""

    sigma: torch.Tensor
    chol: torch.Tensor    # sqrt(sigma) or lower-Cholesky of sigma
    dense: bool


def metric_from_sigma(sigma: torch.Tensor) -> Metric:
    """One metric shared by all chains: sigma (D,) or (D, D)."""
    if sigma.ndim == 1:
        return Metric(sigma, torch.sqrt(sigma), False)
    return Metric(sigma, torch.linalg.cholesky(sigma), True)


def chain_metric(sigma: torch.Tensor) -> Metric:
    """One metric per chain: sigma (C, D) diagonal or (C, D, D) dense."""
    if sigma.ndim == 3:
        return Metric(sigma, torch.linalg.cholesky(sigma), True)
    return Metric(sigma, torch.sqrt(sigma), False)


def _velocity(metric: Metric, R):
    """M^{-1} r of every chain of R (C, D)."""
    if not metric.dense:
        return metric.sigma * R
    if metric.sigma.ndim == 2:
        return R @ metric.sigma.T
    return (metric.sigma @ R[..., None])[..., 0]


def _kinetic(metric: Metric, R):
    return 0.5 * torch.sum(R * _velocity(metric, R), dim=-1)


def _sample_momentum(metric: Metric, Z):
    """r ~ N(0, sigma^{-1}) of every chain from standard normals Z (C, D):
    with sigma = L L^T, r = L^{-T} z."""
    if not metric.dense:
        return Z / metric.chol
    if metric.sigma.ndim == 2:
        return torch.linalg.solve_triangular(metric.chol.T, Z.T, upper=True).T
    return torch.linalg.solve_triangular(metric.chol.transpose(-1, -2), Z[..., None],
                                         upper=True)[..., 0]


def _per_chain(x, C, like: torch.Tensor) -> torch.Tensor:
    """A float, or a tensor of C entries, as a (C,) tensor like `like`."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).reshape(-1).expand(C)


# --------------------------------------------------------------------------
# Leapfrog
# --------------------------------------------------------------------------

def _leapfrog(value_and_grad, Theta, R, Grad, eps, metric: Metric):
    """One leapfrog step of a (C, D) batch; eps broadcasts against (C, 1)."""
    R_half = R + 0.5 * eps * Grad
    Theta2 = Theta + eps * _velocity(metric, R_half)
    lp2, Grad2 = value_and_grad(Theta2)
    return Theta2, R_half + 0.5 * eps * Grad2, lp2, Grad2


def leapfrogs_masked(value_and_grad, Theta, R, lp, Grad, eps, metric: Metric, n_steps, n_min,
                     n_max):
    """`n_max` leapfrog steps of a (C, D) batch, every chain evaluated at
    every step; chain c stops changing after n_steps[c] (a (C,) tensor)
    steps, all chains taking at least the host integer n_min. eps
    broadcasts against (C, 1). Returns (Theta, R, lp, Grad)."""
    for i in range(n_max):
        Theta2, R2, lp2, Grad2 = _leapfrog(value_and_grad, Theta, R, Grad, eps, metric)
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
# Iterative subtree construction with trailing-zero checkpointing
# --------------------------------------------------------------------------

def _tz(n: int) -> int:
    """Number of trailing zero bits of the positive integer n."""
    return (n & -n).bit_length() - 1


def _is_turning(v_a, v_b, rho):
    return (torch.sum(v_a * rho, dim=-1) <= 0) | (torch.sum(v_b * rho, dim=-1) <= 0)


class NutsDraws(NamedTuple):
    """The random numbers of one NUTS transition of C chains: the momentum's
    standard normals z (C, D); per depth d the direction go_right[d] (C,)
    and the merge uniform merge_u[d] (C,); and leaf_u[d] (C, 2**d), the
    uniform of each leaf of depth d's subtree."""

    z: torch.Tensor
    go_right: torch.Tensor
    merge_u: torch.Tensor
    leaf_u: list


def _build_subtree(value_and_grad, Theta0, R0, Grad0, depth, seps, metric, H0, building,
                   leaf_u, max_depth, shard):
    """Build a subtree of 2**depth leapfrog steps from (Theta0, R0) on the
    chains where `building` (C,) holds; the others' entries are left as
    they start.

    Returns (state dict, batched evaluations made): the far edge, the
    multinomially sampled candidate, the summed momentum, the log weight,
    termination flags, the summed acceptance and each chain's leaf count.
    U-turn checks between every completed sub-subtree's endpoints use
    momentum checkpoints indexed by trailing-zero counts, O(max_depth)
    tensors regardless of the subtree's size. A chain stops building at
    its first U-turn or divergence and stays stopped, so a checkpoint slot
    that a stopped chain overwrites is never read for it again: the
    checkpoints are written for all chains. The leaves stop when no chain
    of any rank of `shard` is still building."""
    C = Theta0.shape[0]
    dtype, dev = Theta0.dtype, Theta0.device
    ckpt_v = [None] * (max_depth + 1)  # velocities M^{-1} r of the checkpointed momenta
    ckpt_rsum = [None] * (max_depth + 1)
    Theta, R, Grad = Theta0, R0, Grad0
    rho = torch.zeros_like(Theta0)
    logw = torch.full((C,), -torch.inf, dtype=dtype, device=dev)
    prop_theta, prop_lp, prop_grad = Theta0, logw, Grad0
    turning = torch.zeros((C,), dtype=torch.bool, device=dev)
    divergent = torch.zeros_like(turning)
    sum_alpha = torch.zeros((C,), dtype=dtype, device=dev)
    n_leaves = torch.zeros((C,), dtype=torch.int32, device=dev)
    n_evals = 0
    for k in range(2**depth):
        active = building & ~turning & ~divergent
        # the caller has seen building.any() before leaf 0
        if k > 0 and not shard.any(active):
            break
        n_evals += 1
        # if this leaf starts a sub-subtree, checkpoint its momentum (as its
        # velocity) and the momentum sum before it: slot tz(k), the top
        # slot for k == 0
        slot = max_depth if k == 0 else _tz(k)
        Theta2, R2, lp2, Grad2 = _leapfrog(value_and_grad, Theta, R, Grad, seps, metric)
        V2 = _velocity(metric, R2)
        H = -lp2 + 0.5 * torch.sum(R2 * V2, dim=-1)
        delta = H - H0
        delta = torch.where(torch.isnan(delta), torch.inf, delta)
        ckpt_v[slot] = V2
        ckpt_rsum[slot] = rho
        rho2 = rho + R2

        # multinomial progressive sampling within the subtree
        logw2 = torch.logaddexp(logw, -H)
        take = active & (leaf_u[:, k] < torch.exp(-H - logw2))

        # U-turn checks across every completed sub-subtree ending at k
        turn = turning
        for j in range(1, _tz(k + 1) + 1):
            s0 = k + 1 - (1 << j)
            c = max_depth if s0 == 0 else _tz(s0)
            turn = turn | _is_turning(ckpt_v[c], V2, rho2 - ckpt_rsum[c])

        act = active[:, None]
        Theta = torch.where(act, Theta2, Theta)
        R = torch.where(act, R2, R)
        Grad = torch.where(act, Grad2, Grad)
        rho = torch.where(act, rho2, rho)
        logw = torch.where(active, logw2, logw)
        prop_theta = torch.where(take[:, None], Theta2, prop_theta)
        prop_lp = torch.where(take, lp2, prop_lp)
        prop_grad = torch.where(take[:, None], Grad2, prop_grad)
        turning = torch.where(active, turn, turning)
        divergent = divergent | (active & (delta > MAX_DELTA_ENERGY))
        sum_alpha = torch.where(active, sum_alpha + torch.clamp(torch.exp(-delta), max=1.0),
                                sum_alpha)
        n_leaves = n_leaves + active.to(torch.int32)
    out = dict(theta=Theta, r=R, grad=Grad, rho=rho, logw=logw, prop_theta=prop_theta,
               prop_lp=prop_lp, prop_grad=prop_grad, turning=turning, divergent=divergent,
               sum_alpha=sum_alpha, n_leaves=n_leaves)
    return out, n_evals


# --------------------------------------------------------------------------
# One NUTS transition of every chain
# --------------------------------------------------------------------------

def nuts_step(value_and_grad, Theta, lp, Grad, generator, eps, metric: Metric,
              max_depth: int = 10, draws: NutsDraws | None = None, shard=None):
    """One multinomial-NUTS transition of every chain of a (C, D) batch.

    value_and_grad(Theta) -> (lp (C,), Grad (C, D)). eps: a float or a
    (C,) tensor of per-chain step sizes. metric: per chain (`chain_metric`)
    or shared (`metric_from_sigma`). The random numbers come from
    `generator`, a depth's at its start, unless `draws` gives them all.
    shard: this rank's block of a batch sharded across processes
    (`samplers/shard.py`): the draws are the whole batch's, and the tree
    stops growing when no chain of any rank is still building.

    Returns (Theta', lp', Grad', NutsStats with (C,) leaves, the number of
    batched value-and-gradient evaluations made): per depth, the deepest
    chain's leaves."""
    C, D = Theta.shape
    dtype, dev = Theta.dtype, Theta.device
    eps = _per_chain(eps, C, Theta)
    shard = as_shard(shard, C)

    def uniform(*trailing):
        return shard.rand(generator, trailing, dtype)

    Z = draws.z if draws is not None else shard.randn(generator, (D,), dtype)
    R0 = _sample_momentum(metric, Z)
    H0 = -lp + _kinetic(metric, R0)

    left = right = (Theta, R0, Grad)
    prop_theta, prop_lp, prop_grad = Theta, lp, Grad
    logw = -H0
    rho = R0
    turning = torch.zeros((C,), dtype=torch.bool, device=dev)
    divergent = torch.zeros_like(turning)
    sum_alpha = torch.zeros((C,), dtype=dtype, device=dev)
    n_leaves = torch.zeros((C,), dtype=torch.int32, device=dev)
    depth = torch.zeros((C,), dtype=torch.int32, device=dev)
    n_evals = 0
    for d in range(max_depth):
        building = ~turning & ~divergent
        if d > 0 and not shard.any(building):
            break
        if draws is None:
            go_right, merge_u, leaf_u = uniform() < 0.5, uniform(), uniform(2**d)
        else:
            go_right, merge_u, leaf_u = draws.go_right[d], draws.merge_u[d], draws.leaf_u[d]
        gr = go_right[:, None]
        edge = [torch.where(gr, a, b) for a, b in zip(right, left)]
        seps = torch.where(go_right, eps, -eps)[:, None]
        sub, n = _build_subtree(value_and_grad, *edge, d, seps, metric, H0, building, leaf_u,
                                max_depth, shard)
        n_evals += n

        # biased progressive sampling between the old tree and the subtree
        ok = ~sub["turning"] & ~sub["divergent"]
        p_new = torch.exp(torch.clamp(sub["logw"] - logw, max=0.0))
        take = building & ok & (merge_u < p_new)
        prop_theta = torch.where(take[:, None], sub["prop_theta"], prop_theta)
        prop_lp = torch.where(take, sub["prop_lp"], prop_lp)
        prop_grad = torch.where(take[:, None], sub["prop_grad"], prop_grad)

        # the subtree's far edge replaces the edge it grew from
        far = (sub["theta"], sub["r"], sub["grad"])
        b = building[:, None]
        left = tuple(torch.where(b & ~gr, f, x) for f, x in zip(far, left))
        right = tuple(torch.where(b & gr, f, x) for f, x in zip(far, right))
        rho = torch.where(b, rho + sub["rho"], rho)
        turning_total = _is_turning(_velocity(metric, left[1]), _velocity(metric, right[1]), rho)
        logw = torch.where(building, torch.logaddexp(logw, sub["logw"]), logw)
        turning = torch.where(building, sub["turning"] | sub["divergent"] | turning_total,
                              turning)
        divergent = torch.where(building, sub["divergent"], divergent)
        sum_alpha = torch.where(building, sum_alpha + sub["sum_alpha"], sum_alpha)
        n_leaves = torch.where(building, n_leaves + sub["n_leaves"], n_leaves)
        depth = depth + building.to(torch.int32)

    stats = NutsStats(
        acceptance_rate=sum_alpha / torch.clamp(n_leaves, min=1),
        is_divergent=divergent,
        tree_depth=depth,
        n_steps=n_leaves,
        energy=H0,
        step_size=eps,
    )
    return prop_theta, prop_lp, prop_grad, stats, n_evals


# --------------------------------------------------------------------------
# Step-size search
# --------------------------------------------------------------------------

def find_reasonable_step_size(value_and_grad, Theta, lp, Grad, generator, metric: Metric,
                              z=None, shard=None):
    """Per chain, double or halve eps from 0.1 until the one-leapfrog
    acceptance probability crosses 0.5 (AdvancedHMC's `find_good_stepsize`,
    `sampling.jl:376`), then step back once on the doubling side. The
    momentum's standard normals come from `generator` unless `z` (C, D)
    gives them; under a `shard` the search stops when no chain of any rank
    is still searching. Returns (eps (C,), batched evaluations made)."""
    C, D = Theta.shape
    shard = as_shard(shard, C)
    if z is None:
        z = shard.randn(generator, (D,), Theta.dtype)
    R0 = _sample_momentum(metric, z)
    H0 = -lp + _kinetic(metric, R0)

    def accept_prob(eps):
        _, R1, lp1, _ = _leapfrog(value_and_grad, Theta, R0, Grad, eps[:, None], metric)
        H1 = -lp1 + _kinetic(metric, R1)
        p = torch.exp(torch.clamp(H0 - H1, -1e3, 0.0))
        return torch.where(torch.isnan(p), 0.0, p), torch.isfinite(H1)

    eps = torch.full((C,), 0.1, dtype=Theta.dtype, device=Theta.device)
    p, ok = accept_prob(eps)
    up = ok & (p > 0.5)
    searching = torch.ones_like(up)
    n_evals = 1
    for i in range(61):
        crossed = torch.where(up, ~ok | (p < 0.5), ok & (p > 0.5))
        searching = searching & ~crossed & (i < 60)
        if not shard.any(searching):
            break
        eps = torch.where(searching, eps * torch.where(up, 2.0, 0.5), eps)
        p, ok = accept_prob(eps)
        n_evals += 1
    return torch.clamp(eps * torch.where(up, 0.5, 1.0), 1e-8, 1e3), n_evals


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
    mean: torch.Tensor    # (D,), or (C, D) with one accumulator per chain
    m2: torch.Tensor      # (D,) or (C, D) for diag, (D, D) or (C, D, D) for dense


def welford_init(D, dtype, dense: bool, *, device, n_chains: int | None = None) -> WelfordState:
    """An empty accumulator: one shared, or one per chain for n_chains."""
    lead = () if n_chains is None else (n_chains,)
    return WelfordState(
        n=0.0,
        mean=torch.zeros(lead + (D,), dtype=dtype, device=device),
        m2=torch.zeros(lead + ((D, D) if dense else (D,)), dtype=dtype, device=device),
    )


def welford_update(w: WelfordState, X) -> WelfordState:
    """Add one draw per chain, X (C, D), to per-chain accumulators."""
    n = w.n + 1
    delta = X - w.mean
    mean = w.mean + delta / n
    delta2 = X - mean
    if w.m2.ndim > w.mean.ndim:
        m2 = w.m2 + delta[..., :, None] * delta2[..., None, :]
    else:
        m2 = w.m2 + delta * delta2
    return WelfordState(n, mean, m2)


def welford_sigma(w: WelfordState) -> torch.Tensor:
    """Regularized covariance estimate (Stan's shrinkage to identity)."""
    var = w.m2 / max(w.n - 1, 1)
    shrink = w.n / (w.n + 5.0)
    if w.m2.ndim > w.mean.ndim:
        D = w.mean.shape[-1]
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


# --------------------------------------------------------------------------
# Warmup + sampling of a batch of chains
# --------------------------------------------------------------------------

def initial_chain_metric(initial_sigma, C, D, dense: bool, dtype, device) -> Metric:
    """Every chain's starting metric: `initial_sigma` ((D,) or (D, D),
    turned into the kind `dense` asks for), or the identity."""
    if initial_sigma is None:
        sigma0 = (torch.eye(D, dtype=dtype, device=device) if dense
                  else torch.ones((D,), dtype=dtype, device=device))
    else:
        sigma0 = torch.as_tensor(initial_sigma, dtype=dtype, device=device)
        if dense and sigma0.ndim == 1:
            sigma0 = torch.diag(sigma0)
        if not dense and sigma0.ndim == 2:
            sigma0 = torch.diagonal(sigma0)
    return chain_metric(sigma0.expand((C,) + sigma0.shape).contiguous())


def _stack_draws(Thetas, lps, stats_list):
    """Per-step lists -> samples (C, S, D), lps (C, S), stats with (C, S)
    leaves (chains first)."""
    samples = torch.stack(Thetas, dim=1)
    lps_out = torch.stack(lps, dim=1)
    stats = NutsStats(*(torch.stack(leaf, dim=1) for leaf in zip(*stats_list)))
    return samples, lps_out, stats


def run_nuts(
    value_and_grad,
    theta0_batch: torch.Tensor,
    generator: torch.Generator,
    n_warmup: int = 1000,
    n_samples: int = 1000,
    max_depth: int = 10,
    target_accept: float = 0.8,
    metric: str = "dense",
    initial_sigma=None,
    sampler: str = "nuts",
    initial_step_size=None,
    drop_warmup: bool = True,
    shard=None,
):
    """Warmup + sample a batch of chains, every chain adapting its own
    step size and metric, all chains stepping together.

    sampler: "nuts" (multinomial NUTS) or "hmc" (jittered-trajectory HMC
    with up to 2**(max_depth//2+2) leapfrog steps, at least 8).

    theta0_batch: (n_chains, D) initial points (unconstrained space).
    metric: "dense" (default, the reference's dense metric,
    `sampling.jl:336-363`) or "diag".
    initial_sigma: optional (D,)/(D,D) initial M^{-1} shared by chains,
    e.g. the covariance of the starting points.
    initial_step_size: manual initial step size (skips the automatic
    search; adaptation still refines it), reference octofit `step_size=`
    (`sampling.jl:133`).
    drop_warmup: when False, warmup draws are recorded and prepended to
    the returned draws (reference octofit `drop_warmup`,
    `sampling.jl:129`).
    shard: the block of a batch sharded across processes that
    theta0_batch holds (`samplers/shard.py`); the chains adapt on their
    own, so the draws and the loop exits are all that the ranks share.

    The warmup is Stan's window schedule (`build_warmup_schedule`): each
    chain's step size by dual averaging on its own acceptance, and in the
    slow windows its own Welford covariance, which becomes its metric at a
    window's end (a step shared by all chains, so the per-chain Cholesky
    factorizations run only there) while dual averaging restarts from the
    current step size.

    Returns (samples [chains, draws, D], lps [chains, draws], NutsStats with
    [chains, draws] leaves, info dict with "step_size" (C,), "sigma" (C, D)
    or (C, D, D), "warmup_divergences" (C,), "n_grad_evals", the batched
    value-and-gradient evaluations made, warmup included, and
    "transition_evals", those of each transition, warmup first).
    """
    Theta = theta0_batch
    C, D = Theta.shape
    dtype, device = Theta.dtype, Theta.device
    dense = metric == "dense"
    is_slow, window_end = build_warmup_schedule(n_warmup)

    if sampler == "hmc":
        from .hmc import hmc_step

        n_leap = max(2 ** (max_depth // 2 + 2), 8)

        def transition(Theta, lp, Grad, eps, metric_c):
            return (*hmc_step(value_and_grad, Theta, lp, Grad, generator, eps, metric_c, n_leap,
                              shard=shard), n_leap)
    elif sampler == "nuts":
        def transition(Theta, lp, Grad, eps, metric_c):
            return nuts_step(value_and_grad, Theta, lp, Grad, generator, eps, metric_c, max_depth,
                             shard=shard)
    else:
        raise ValueError(f"unknown sampler {sampler!r}; run_nuts takes 'nuts' or 'hmc'")

    metric_c = initial_chain_metric(initial_sigma, C, D, dense, dtype, device)

    lp, Grad = value_and_grad(Theta)
    n_grad_evals = 1
    if initial_step_size is None:
        eps0, n = find_reasonable_step_size(value_and_grad, Theta, lp, Grad, generator, metric_c,
                                            shard=shard)
        eps0 = eps0.cpu().double().numpy()
        n_grad_evals += n
    else:
        eps0 = np.full(C, float(initial_step_size))
    da = da_init(eps0)
    welford = welford_init(D, dtype, dense, device=device, n_chains=C)
    Thetas, lps, stats_list = [], [], []
    wdivs = torch.zeros((C,), dtype=torch.int64, device=device)
    transition_evals = []

    def host_tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    for s in range(n_warmup):
        Theta, lp, Grad, stats, n = transition(Theta, lp, Grad, host_tensor(np.exp(da.log_eps)),
                                               metric_c)
        transition_evals.append(n)
        da = da_update(da, stats.acceptance_rate.cpu().double().numpy(), target_accept)
        if is_slow[s]:
            welford = welford_update(welford, Theta)
        if window_end[s]:
            metric_c = chain_metric(welford_sigma(welford))
            welford = welford_init(D, dtype, dense, device=device, n_chains=C)
            da = da_init(np.exp(da.log_eps))
        wdivs += stats.is_divergent
        if not drop_warmup:  # record adaptation draws too
            Thetas.append(Theta)
            lps.append(lp)
            stats_list.append(stats)

    eps_f = np.exp(da.log_eps_avg)
    eps_t = host_tensor(eps_f)
    for _ in range(n_samples):
        Theta, lp, Grad, stats, n = transition(Theta, lp, Grad, eps_t, metric_c)
        transition_evals.append(n)
        Thetas.append(Theta)
        lps.append(lp)
        stats_list.append(stats)

    samples, lps_out, stats_out = _stack_draws(Thetas, lps, stats_list)
    info = {
        "step_size": eps_f,
        "sigma": metric_c.sigma,
        "warmup_divergences": wdivs.cpu().numpy(),
        "n_grad_evals": n_grad_evals + sum(transition_evals),
        "transition_evals": np.asarray(transition_evals),
    }
    return samples, lps_out, stats_out, info
