"""Jittered-trajectory HMC transition.

PyTorch port of `octofitter_tpu/samplers/hmc.py`: a randomly jittered
number of leapfrog steps with a Metropolis correction (Neal 2011), the
transition of `run_nuts(sampler="hmc")` and the parallel-tempering
explorer `explorer="hmc"`. The JAX package writes it for one chain and
vmaps it; here the chain axis is written out, and each chain of the batch
draws its own count.
"""

from __future__ import annotations

import torch

from .nuts import (
    MAX_DELTA_ENERGY,
    Metric,
    NutsStats,
    _kinetic,
    _per_chain,
    _sample_momentum,
    leapfrogs_masked,
)
from .shard import as_shard


def hmc_step(
    value_and_grad,
    Theta,
    lp,
    Grad,
    generator: torch.Generator,
    eps,
    metric: Metric,
    n_leapfrog: int = 32,
    draws=None,
    shard=None,
):
    """One jittered-HMC transition of every chain of a (C, D) batch.

    value_and_grad(Theta) -> (lp (C,), Grad (C, D)). eps: a float, or a
    (C,) tensor of per-chain step sizes. metric: per chain (`chain_metric`:
    diagonal (C, D) or dense (C, D, D)) or shared (`metric_from_sigma`).
    Each chain draws its leapfrog count L uniformly in [1, n_leapfrog]; the
    loop runs n_leapfrog steps over all chains and a chain stops changing
    after its own L. The random numbers come from `generator` unless
    `draws` = (z (C, D) standard normals, L (C,), u (C,) accept uniforms)
    gives them; under a `shard` (`samplers/shard.py`) they are the whole
    sharded batch's. Returns (Theta, lp, Grad, NutsStats) with (C,)
    statistics."""
    C, D = Theta.shape
    eps = _per_chain(eps, C, Theta)
    shard = as_shard(shard, C)
    if draws is None:
        Z = shard.randn(generator, (D,), Theta.dtype)
        # jitter the trajectory length uniformly in [1, n_leapfrog]
        L = shard.randint(generator, 1, n_leapfrog + 1)
    else:
        Z, L, u = draws
    R0 = _sample_momentum(metric, Z)
    H0 = -lp + _kinetic(metric, R0)
    Theta1, R1, lp1, Grad1 = leapfrogs_masked(value_and_grad, Theta, R0, lp, Grad, eps[:, None],
                                              metric, L, 1, n_leapfrog)

    H1 = -lp1 + _kinetic(metric, R1)
    delta = H1 - H0
    delta = torch.where(torch.isnan(delta), torch.inf, delta)
    alpha = torch.clamp(torch.exp(-delta), max=1.0)
    if draws is None:
        u = shard.rand(generator, (), Theta.dtype)
    accept = u < alpha
    divergent = delta > MAX_DELTA_ENERGY

    stats = NutsStats(
        acceptance_rate=alpha,
        is_divergent=divergent,
        tree_depth=torch.zeros((C,), dtype=torch.int32, device=Theta.device),
        n_steps=L.to(torch.int32),
        energy=H0,
        step_size=eps,
    )
    return (torch.where(accept[:, None], Theta1, Theta), torch.where(accept, lp1, lp),
            torch.where(accept[:, None], Grad1, Grad), stats)
