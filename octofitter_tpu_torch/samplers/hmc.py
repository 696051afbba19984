"""Jittered-trajectory HMC transition.

PyTorch port of `octofitter_tpu/samplers/hmc.py`: a randomly jittered
number of leapfrog steps with a Metropolis correction (Neal 2011), the
parallel-tempering explorer `explorer="hmc"`. The JAX package writes it
for one chain and vmaps it; here the chain axis is written out, and each
chain of the batch draws its own count.
"""

from __future__ import annotations

import torch

from .nuts import MAX_DELTA_ENERGY, Metric, NutsStats, leapfrogs_masked


def hmc_step(
    value_and_grad,
    Theta,
    lp,
    Grad,
    generator: torch.Generator,
    eps,
    metric: Metric,
    n_leapfrog: int = 32,
):
    """One jittered-HMC transition of every chain of a (C, D) batch.

    value_and_grad(Theta) -> (lp (C,), Grad (C, D)). eps: a float, or a
    (C, 1) tensor of per-chain step sizes. metric: diagonal, with `sigma`
    and `chol` broadcasting against (C, D) (one for all chains, or one
    row per chain). Each chain draws its leapfrog count L uniformly in
    [1, n_leapfrog]; the loop runs n_leapfrog steps over all chains and a
    chain stops changing after its own L. Returns (Theta, lp, Grad,
    NutsStats) with (C,) statistics."""
    C, D = Theta.shape
    dev = generator.device
    Z = torch.randn((C, D), generator=generator, dtype=Theta.dtype, device=dev)
    R0 = Z / metric.chol
    H0 = -lp + 0.5 * torch.sum(R0 * R0 * metric.sigma, dim=-1)

    # jitter the trajectory length uniformly in [1, n_leapfrog]
    L = torch.randint(1, n_leapfrog + 1, (C,), generator=generator, device=dev)
    Theta1, R1, lp1, Grad1 = leapfrogs_masked(value_and_grad, Theta, R0, lp, Grad, eps,
                                              metric.sigma, L, 1, n_leapfrog)

    H1 = -lp1 + 0.5 * torch.sum(R1 * R1 * metric.sigma, dim=-1)
    delta = H1 - H0
    delta = torch.where(torch.isnan(delta), torch.inf, delta)
    alpha = torch.clamp(torch.exp(-delta), max=1.0)
    accept = torch.rand((C,), generator=generator, dtype=Theta.dtype, device=dev) < alpha
    divergent = delta > MAX_DELTA_ENERGY

    stats = NutsStats(
        acceptance_rate=alpha,
        is_divergent=divergent,
        tree_depth=torch.zeros((C,), dtype=torch.int32, device=Theta.device),
        n_steps=L.to(torch.int32),
        energy=H0,
        step_size=torch.as_tensor(eps, dtype=Theta.dtype, device=Theta.device).expand(C, 1)[:, 0],
    )
    return (torch.where(accept[:, None], Theta1, Theta), torch.where(accept, lp1, lp),
            torch.where(accept[:, None], Grad1, Grad), stats)
