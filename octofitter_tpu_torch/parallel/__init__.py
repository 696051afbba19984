"""Chains, tempering ladders and epoch axes sharded across processes on
`torch.distributed` (the JAX package's device-mesh parallelism)."""

from .mesh import (
    chain_mesh,
    octofit_sharded,
    sharded_pt_swap_step,
)
from .epoch_sharding import (
    sharded_epoch_sum,
    sharded_fit_5param,
    sharded_gaia_dr4_ll,
)
from .distributed import (
    global_mesh,
    initialize_distributed,
    resolve_distributed_config,
)

__all__ = [
    "chain_mesh",
    "octofit_sharded",
    "sharded_pt_swap_step",
    "sharded_epoch_sum",
    "sharded_fit_5param",
    "sharded_gaia_dr4_ll",
    "global_mesh",
    "initialize_distributed",
    "resolve_distributed_config",
]
