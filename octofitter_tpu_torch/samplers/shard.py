"""This process's block of a batch of chains, and the collectives that
make a cross-chain reduction or a lockstep loop exit global.

A batch of chains is laid out on a grid of one or two axes: the chains of
`octofit` on one, a tempering ladder's (walkers, rungs) on two. With no
process group every axis is held whole by this process, and every method
is the identity: `Shard.whole((C,))` is what the samplers run with when
the caller gives no mesh. Under a `torch.distributed.device_mesh.DeviceMesh`
(`Shard.from_mesh`) mesh dimension d shards grid axis d in equal
contiguous blocks, and:

- random numbers are drawn at the global shape, from the same generator on
  every rank, and each rank keeps its block (`draw`, `randn`, `rand`,
  `randint`): a sharded run draws what the unsharded run draws;
- a reduction over the first axis (the chains, or the walkers of each
  rung) sums this rank's rows and all-reduces the sum over the first axis's
  group (`sum`, `max`): with no group the local sum is the whole sum, so
  the same code runs either way;
- a lockstep loop exit is all-reduced over every group (`any`), so that
  every rank takes the same number of steps and draws the same numbers;
- `gather` all-gathers blocks along an axis, for the reads the host needs
  whole.

Every collective is counted (`calls`, `bytes`: the tensor this rank hands
in). The gloo backend, which ranks that share one card run, takes each of
these collectives on CUDA tensors (`scripts/parallel_probe.py`), so none
is staged through host memory. A failed collective raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

class Axis(NamedTuple):
    """One grid axis: `n` entries split over the `size` ranks of `group`
    (None: this process holds all of them), this rank `index`-th."""

    n: int
    group: object = None
    size: int = 1
    index: int = 0

    @property
    def block(self) -> slice:
        m = self.n // self.size
        return slice(self.index * m, (self.index + 1) * m)


class Shard:
    def __init__(self, axes):
        self.axes = tuple(axes)
        self.calls = self.bytes = 0

    @classmethod
    def whole(cls, grid) -> "Shard":
        """Every axis of `grid` held by this process: no collective."""
        return cls(Axis(n) for n in grid)

    @classmethod
    def from_mesh(cls, mesh, grid, names, device) -> "Shard":
        """Mesh dimension d shards grid axis d; grid axes past the mesh's
        dimensions are held whole. `names` name the grid axes in errors;
        `device` is the batch's. Raises unless `mesh` is a DeviceMesh on
        the batch's device type, of at most len(grid) dimensions whose
        sizes divide the grid."""
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh, not {type(mesh).__name__}")
        if mesh.device_type != torch.device(device).type:
            raise ValueError(f"a mesh on {mesh.device_type} for a model on {device}")
        if mesh.ndim > len(grid):
            raise ValueError(f"a mesh of {mesh.ndim} dimensions for {len(grid)} axes ({names})")
        dims = mesh.mesh_dim_names or tuple(str(d) for d in range(mesh.ndim))
        axes = []
        for d, n in enumerate(grid):
            if d >= mesh.ndim:
                axes.append(Axis(n))
                continue
            size = mesh.size(d)
            if n % size:
                raise ValueError(f"{names[d]}={n} not divisible by mesh axis '{dims[d]}'={size}")
            axes.append(Axis(n, mesh.get_group(d), size, mesh.get_local_rank(d)))
        return cls(axes)

    @classmethod
    def along(cls, mesh, axis_name=None) -> "Shard":
        """One axis of one entry per rank along the dimension `axis_name`
        (default: the first) of `mesh`."""
        name = axis_name or mesh.mesh_dim_names[0]
        dim = mesh.mesh_dim_names.index(name)
        n = mesh.size(dim)
        return cls([Axis(n, mesh.get_group(dim), n, mesh.get_local_rank(name))])

    @property
    def local_grid(self) -> tuple:
        return tuple(a.n // a.size for a in self.axes)

    @property
    def blocks(self) -> tuple:
        return tuple(a.block for a in self.axes)

    @property
    def stats(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes}

    # ------------------------------------------------------------------
    # random numbers at the global shape
    # ------------------------------------------------------------------

    def draw(self, sample, axes=None):
        """`sample(n)` -> a tensor of n global rows over the grid axes
        `axes` (default: all), row-major; returns this rank's rows, in the
        same order, as (local rows, ...)."""
        axes = tuple(range(len(self.axes))) if axes is None else tuple(axes)
        shape = tuple(self.axes[a].n for a in axes)
        x = sample(math.prod(shape))
        if all(self.axes[a].size == 1 for a in axes):
            return x
        trailing = tuple(x.shape[1:])
        x = x.view(shape + trailing)[tuple(self.axes[a].block for a in axes)]
        return x.reshape((-1,) + trailing)

    def randn(self, generator, trailing, dtype, axes=None):
        return self.draw(lambda n: torch.randn((n,) + tuple(trailing), generator=generator,
                                               dtype=dtype, device=generator.device), axes)

    def rand(self, generator, trailing, dtype, axes=None):
        return self.draw(lambda n: torch.rand((n,) + tuple(trailing), generator=generator,
                                              dtype=dtype, device=generator.device), axes)

    def randint(self, generator, low, high, axes=None):
        return self.draw(lambda n: torch.randint(low, high, (n,), generator=generator,
                                                 device=generator.device), axes)

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------

    def _count(self, x) -> None:
        self.calls += 1
        self.bytes += x.numel() * x.element_size()

    def _all_reduce(self, x, op, axis):
        import torch.distributed as dist

        group = self.axes[axis].group
        if group is None:
            return x
        y = x.clone(memory_format=torch.contiguous_format)
        self._count(y)
        dist.all_reduce(y, op=getattr(dist.ReduceOp, op), group=group)
        return y

    def sum(self, x, axis=0):
        """x summed over the ranks along grid `axis` (the chains by
        default): x is this rank's partial sum."""
        return self._all_reduce(x, "SUM", axis)

    def max(self, x, axis=0):
        return self._all_reduce(x, "MAX", axis)

    def sum_all(self, x):
        """x summed over every rank of the grid."""
        for axis in range(len(self.axes)):
            x = self.sum(x, axis)
        return x

    def max_all(self, x):
        for axis in range(len(self.axes)):
            x = self.max(x, axis)
        return x

    def any(self, flag) -> bool:
        """Whether `flag` (a bool tensor) holds anywhere on any rank: the
        exit test of a loop that every rank runs in lockstep."""
        f = flag.any()
        if all(a.group is None for a in self.axes):
            return bool(f)
        return bool(self.max_all(f.to(torch.int32)))

    def gather(self, x, axis, dim=0):
        """The blocks of x along grid `axis`, all-gathered and concatenated
        along tensor dimension `dim`: every rank gets the whole."""
        import torch.distributed as dist

        ax = self.axes[axis]
        if ax.group is None:
            return x
        x = x.contiguous()
        self._count(x)
        parts = [torch.empty_like(x) for _ in range(ax.size)]
        dist.all_gather(parts, x, group=ax.group)
        return torch.cat(parts, dim=dim)

    def gather_all(self, x, dims):
        """x gathered along every grid axis, axis a along tensor
        dimension dims[a]."""
        for axis, dim in enumerate(dims):
            x = self.gather(x, axis, dim)
        return x

    def stack_gather(self, x, axis):
        """Every rank's x along grid `axis`, stacked: (size, ...)."""
        return self.gather(x[None], axis, 0)


def as_shard(shard, grid) -> Shard:
    """`shard`, or a batch on `grid` (a chain count, or a tuple of axis
    lengths) held whole by this process."""
    if shard is not None:
        return shard
    return Shard.whole(grid if isinstance(grid, tuple) else (grid,))
