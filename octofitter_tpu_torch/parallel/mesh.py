"""Chains and tempering replicas sharded over the ranks of a process group.

PyTorch port of `octofitter_tpu/parallel/mesh.py`. The framework's
parallel axes (chains, tempering replicas, epochs, trials) map onto a
`torch.distributed.device_mesh.DeviceMesh`:

  - `octofit_sharded`: the chain axis is data parallelism. Each rank runs
    its block of the chains; what crosses chains (ChEES's shared tuning,
    the lockstep exits of NUTS trees) is all-reduced, and the draws are
    gathered at the end (the replacement for the reference's
    one-chain-per-thread / MPI-rank model).
  - `sharded_pt_swap_step`: the temperature ladder one replica per rank;
    the deterministic even/odd (DEO) exchange passes each rank's (theta,
    ll, beta) to its neighbours, Pigeons' MPI swap of (beta, logdensity)
    pairs. `octofit_pigeons(mesh=)` shards the ladder of walkers x rungs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..samplers.shard import Shard


def chain_mesh(n_devices=None, axis_name="chains", *, device=None):
    """1-D `DeviceMesh` over the ranks of the process group, on the device
    type `initialize_distributed` placed them on.

    In a process outside any process group this starts a one-rank default
    group on an in-process store and returns a mesh over it, what the JAX
    package's function gives on a single device: every collective then
    runs and returns its input. The mesh is on `device`: by default this
    process's current card (NCCL), raising with no GPU unless the caller
    passes device="cpu" (gloo). That group stays until
    `torch.distributed.destroy_process_group()`, which must come before an
    `initialize_distributed` in the same process (`octofit_sharded` with
    no mesh ends the group it started). n_devices: the mesh's size, which
    must be the group's (1 outside a group). Inside a group, a `device`
    of another type than the group's raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .distributed import _record_placement, group_device_type

    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"chain_mesh: {n_devices} ranks asked for outside a process group; "
                             "call initialize_distributed first")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("chain_mesh: no GPU; pass device='cpu' for a mesh on the CPU")
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type == "cuda":
            dist.init_process_group("nccl", store=dist.HashStore(), world_size=1, rank=0,
                                    device_id=device)
        else:
            dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
        _record_placement(device)
    device_type = group_device_type()
    if device is not None and torch.device(device).type != device_type:
        raise ValueError(f"chain_mesh: device {device} for a process group on {device_type}")
    n = dist.get_world_size()
    if n_devices not in (None, n):
        raise ValueError(f"chain_mesh: n_devices={n_devices} != process count {n}")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis_name,))


def octofit_sharded(model, *, mesh=None, chains=None, **kwargs):
    """`octofit` with the chain axis sharded over the ranks of a 1-D mesh.

    Chains defaults to 256 per rank and is rounded up to a multiple of the
    rank count. Every rank calls this with the same arguments (and, where
    given, a generator in the same state). The starting points are the
    model's (running `initialize` first if it has none), cycled to the
    chain count, unless `starting_points=` gives them; each rank samples
    its block of them, and the returned `Chains`, every chain gathered, is
    the same on every rank. With no mesh, outside a process group, this
    runs on a one-rank `chain_mesh` on the model's device and ends its
    group before returning. sampler: "chees" (the default), "nuts" or
    "hmc"; the other keywords are `octofit`'s.
    """
    import torch.distributed as dist

    from ..samplers.driver import octofit

    own_group = mesh is None and not dist.is_initialized()
    if mesh is None:
        mesh = chain_mesh(device=model.device)
    try:
        if mesh.ndim != 1:
            raise ValueError(f"octofit_sharded takes a 1-D mesh (the chain axis), not {mesh.ndim}-D")
        n_dev = mesh.size()
        if chains is None:
            chains = 256 * n_dev
        if chains % n_dev != 0:
            chains = (chains // n_dev + 1) * n_dev

        generator = kwargs.pop("generator", None)
        if generator is None:
            generator = torch.Generator(device=model.device).manual_seed(0)
        starting_points = kwargs.pop("starting_points", None)
        if starting_points is None:
            if model.starting_points is None:
                model.initialize(generator, verbosity=kwargs.get("verbosity", 1))
            pts = model.starting_points
            starting_points = pts[torch.as_tensor(np.resize(np.arange(len(pts)), chains),
                                                  device=pts.device)]
        return octofit(model, generator=generator, chains=chains,
                       starting_points=starting_points, mesh=mesh, **kwargs)
    finally:
        if own_group:
            dist.destroy_process_group()


def sharded_pt_swap_step(mesh, axis_name="temps"):
    """Return a function performing one DEO swap pass with the temperature
    axis sharded one replica per rank along `axis_name` of `mesh`.

    Each rank calls the returned function with its replica:
       swap(theta (D,), ll (), beta (), even (bool), u ())
    where u is the rank's uniform draw in (0, 1). The ranks' (theta, ll,
    beta, u) are exchanged over the axis's group; the pair (i, i + 1) is
    active when i is even on an even pass (odd on an odd one), its log
    acceptance (beta_{i+1} - beta_i) (ll_i - ll_{i+1}) is computed on both
    partners, and the lower partner's uniform decides it on both, as the
    left neighbour's key does in the JAX package. Returns the (possibly
    swapped) theta and ll, and whether this rank swapped.
    """
    shard = Shard.along(mesh, axis_name)
    n, i = shard.axes[0].n, shard.axes[0].index

    def swap(theta, ll, beta, even, u):
        theta = torch.as_tensor(theta)
        scalars = torch.stack([torch.as_tensor(x, dtype=theta.dtype).to(theta.device).reshape(())
                               for x in (ll, beta, u)])
        parts = shard.stack_gather(torch.cat([theta.reshape(-1), scalars]), 0)
        D = theta.numel()
        ll, beta, u = scalars
        lower = (i % 2) == (0 if even else 1)
        j = i + 1 if lower else i - 1  # the partner, where it exists
        if not 0 <= j < n:
            return theta, ll, torch.tensor(False)
        ll_j, beta_j, u_j = parts[j, D], parts[j, D + 1], parts[j, D + 2]
        if lower:
            accept = torch.log(u) < (beta_j - beta) * (ll - ll_j)
        else:
            accept = torch.log(u_j) < (beta - beta_j) * (ll_j - ll)
        theta_new = torch.where(accept, parts[j, :D].reshape(theta.shape), theta)
        return theta_new, torch.where(accept, ll_j, ll), accept

    return swap
