"""Multi-process runtime wiring on `torch.distributed`.

PyTorch port of `octofitter_tpu/parallel/distributed.py`, the replacement
for the reference's MPI path (Pigeons `MPIProcesses` and its Slurm
launchers): every process runs the same program, `initialize_distributed`
joins them into one process group, and a `DeviceMesh` over the group's
ranks shards the chains or the tempering ladder.

Usage on each process (or through a launcher that sets the environment,
such as `torchrun` or Slurm):

    import octofitter_tpu_torch as ot
    ot.parallel.initialize_distributed()           # from the environment
    mesh = ot.parallel.global_mesh(("chains",))
    chain = ot.parallel.octofit_sharded(model, mesh=mesh, ...)

Environment variables read by `resolve_distributed_config`:
OCTOFITTER_COORDINATOR, OCTOFITTER_NUM_PROCESSES, OCTOFITTER_PROCESS_ID;
then torchrun's MASTER_ADDR with MASTER_PORT, WORLD_SIZE and RANK; then
Slurm's SLURM_NTASKS, SLURM_PROCID and SLURM_JOB_NODELIST.
`initialize_distributed` also reads LOCAL_RANK and LOCAL_WORLD_SIZE
(torchrun's), or SLURM_LOCALID and SLURM_NTASKS_PER_NODE /
SLURM_TASKS_PER_NODE, to place each rank on a card and pick the backend.
"""

from __future__ import annotations

import math
import os

import torch


def resolve_distributed_config(env=None) -> dict | None:
    """Resolve (coordinator_address, num_processes, process_id) from the
    environment. Returns None when no multi-process configuration is
    present (a single process; nothing to initialize); raises on an
    incomplete one."""
    env = os.environ if env is None else env

    def pick(*names):
        for n in names:
            v = env.get(n)
            if v not in (None, ""):
                return v
        return None

    addr = pick("OCTOFITTER_COORDINATOR")
    master, port = pick("MASTER_ADDR"), pick("MASTER_PORT")
    if addr is None and master is not None and port is not None:
        addr = f"{master}:{port}"
    nproc = pick("OCTOFITTER_NUM_PROCESSES", "WORLD_SIZE", "SLURM_NTASKS")
    pid = pick("OCTOFITTER_PROCESS_ID", "RANK", "SLURM_PROCID")
    if addr is None and nproc is None:
        return None
    if addr is None and "SLURM_JOB_NODELIST" in env:
        # the first node of the allocation on a default port, as the
        # reference's generated Slurm scripts bootstrap MPI
        first = env["SLURM_JOB_NODELIST"].split(",")[0].split("[")[0]
        addr = f"{first}:8476"
    if addr is None or nproc is None or pid is None:
        raise ValueError(
            "incomplete multi-process configuration: need coordinator "
            "address, process count, and process id "
            f"(got addr={addr!r}, num={nproc!r}, id={pid!r})"
        )
    return dict(
        coordinator_address=addr,
        num_processes=int(nproc),
        process_id=int(pid),
    )


def _local_count(env) -> int | None:
    """The ranks on each host, from the launcher: torchrun's
    LOCAL_WORLD_SIZE, Slurm's SLURM_NTASKS_PER_NODE, or the most tasks on
    any node of SLURM_TASKS_PER_NODE ("4(x2),3"); None where none is set.
    Every rank reads the same number, so every rank picks the same backend."""
    for name in ("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE"):
        if env.get(name) not in (None, ""):
            return int(env[name])
    if env.get("SLURM_TASKS_PER_NODE") not in (None, ""):
        return max(int(p.split("(")[0]) for p in env["SLURM_TASKS_PER_NODE"].split(","))
    return None


def _local_rank(env) -> int | None:
    """This rank's index on its host: torchrun's LOCAL_RANK or Slurm's
    SLURM_LOCALID; None where neither is set."""
    for name in ("LOCAL_RANK", "SLURM_LOCALID"):
        if env.get(name) not in (None, ""):
            return int(env[name])
    return None


def _placement(config, env, device=None, backend=None):
    """(device, backend) of this rank for `initialize_distributed`."""
    n, pid = config["num_processes"], config["process_id"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu"), backend or "gloo"
    if cards == 0:
        raise RuntimeError("initialize_distributed: no GPU; pass device='cpu' to run the "
                           "ranks on the CPU")
    # a world no larger than this host's cards gives each rank a card of its
    # own wherever it runs; else the launcher has to say how ranks share hosts
    local_n = _local_count(env) if n > cards else n
    if local_n is None and (device is None or backend is None):
        raise RuntimeError(
            f"initialize_distributed: {n} ranks for {cards} cards a host, and no LOCAL_WORLD_SIZE, "
            "SLURM_NTASKS_PER_NODE or SLURM_TASKS_PER_NODE to say how many share a host; "
            "launch with torchrun or srun, or pass device= and backend=")
    if device is None:
        local_rank = _local_rank(env)
        if local_rank is None:
            if local_n != n:
                raise RuntimeError(
                    "initialize_distributed: ranks span hosts and no LOCAL_RANK or SLURM_LOCALID "
                    "says which card is this rank's; pass device=")
            local_rank = pid
        device = torch.device("cuda", local_rank % cards)
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if local_n <= cards else "gloo"
    return device, backend


# the device `initialize_distributed` or `chain_mesh` placed this process on,
# with the default group it belongs to
_placed = {"group": None, "device": None}


def _record_placement(device) -> None:
    import torch.distributed as dist

    _placed.update(group=dist.group.WORLD, device=torch.device(device))


def group_device_type() -> str:
    """The device type of the meshes over the default process group: that
    of the device `initialize_distributed` (or `chain_mesh`) placed this
    rank on; for a group started by other means, "cuda" under NCCL and
    "cpu" under any other backend. Raises with no group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group; call initialize_distributed first")
    if _placed["group"] is dist.group.WORLD:
        return _placed["device"].type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def initialize_distributed(config: dict | None = None, *, backend: str | None = None,
                           device=None) -> bool:
    """Join this process into a `torch.distributed` process group.

    config: dict(coordinator_address, num_processes, process_id), else
    resolved from the environment. The address is host:port (a TCP
    store) or a URL such as file:///path. Returns True if the group was
    initialized, False for a single process (nothing to do).

    device: this rank's device; by default its card, cuda:(local rank %
    cards a host), the local rank being LOCAL_RANK or SLURM_LOCALID, or
    the process id where the world runs on one host. With no GPU this
    raises unless the caller passes device="cpu".
    backend: by default "nccl" when every rank has a card of its own (the
    ranks on a host, LOCAL_WORLD_SIZE or Slurm's tasks per node, are no
    more than its cards; every host is taken to hold as many cards as this
    one), and "gloo" on the CPU or when ranks share a card, which NCCL
    refuses. Where the world is larger than one host's cards and no
    launcher variable gives the ranks a host, this raises unless both
    device= and backend= are given.
    The meshes of `global_mesh` and `chain_mesh` take this device's type.
    """
    import torch.distributed as dist

    if config is None:
        config = resolve_distributed_config()
    if config is None or config["num_processes"] <= 1:
        return False
    device, backend = _placement(config, os.environ, device, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    addr = config["coordinator_address"]
    dist.init_process_group(
        backend,
        init_method=addr if "://" in addr else f"tcp://{addr}",
        world_size=config["num_processes"],
        rank=config["process_id"],
        **({"device_id": device} if backend == "nccl" else {}),
    )
    _record_placement(device)
    return True


def global_mesh(axis_names=("chains",), axis_sizes=None):
    """A `DeviceMesh` over every rank of the initialized process group, on
    the device type of `group_device_type()`.

    With one axis, all ranks form one row (the chain axis: no
    communication during trajectories, all-reduces only for cross-chain
    adaptation, loop exits and swaps). axis_sizes reshapes the ranks for
    multi-axis layouts; put the axis whose ranks share a host last.
    Raises before `initialize_distributed`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("global_mesh: no process group; call initialize_distributed first")
    n = dist.get_world_size()
    if axis_sizes is None:
        if len(axis_names) != 1:
            raise ValueError("axis_sizes required for multi-axis meshes")
        shape = (n,)
    else:
        shape = tuple(axis_sizes)
        if math.prod(shape) != n:
            raise ValueError(f"axis_sizes {shape} != process count {n}")
    return init_device_mesh(group_device_type(), shape, mesh_dim_names=tuple(axis_names))
