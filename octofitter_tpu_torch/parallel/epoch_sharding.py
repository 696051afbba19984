"""Epoch-axis sharding for long scan tables.

PyTorch port of `octofitter_tpu/parallel/epoch_sharding.py`. Gaia DR4 IAD
and G23H scan tables reach hundreds to thousands of scans per source; the
epoch axis can be spread over the ranks of a `DeviceMesh` axis, each rank
reducing its block and one all-reduce summing the blocks:

- per-epoch log-likelihood terms are a plain sum: all-reduce the partial
  sums;
- the 5-parameter astrometric least squares inside HGCA / G23H / DR4 is
  linear, so its normal equations A'WA (5 x 5) and A'Wb (5) are sums over
  epochs: each rank sums its block, one all-reduce of 31 numbers crosses
  the group, and every rank solves the small system.

Every entry point takes the global arrays on every rank and pads the
epoch axis to a multiple of the axis's rank count with zero weights, as
the JAX package does, so the results are exact and the same on every
rank.
"""

from __future__ import annotations

import math

import torch

from ..astrom.fitting import _rhs, ordered_parameters
from ..samplers.shard import Shard


def _device(mesh, *arrays):
    """The device of the arrays that are tensors, else the mesh's; raises
    where they differ in type from the mesh's."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            if a.device.type != mesh.device_type:
                raise ValueError(f"a tensor on {a.device} for a mesh on {mesh.device_type}")
            return a.device
    return torch.device(mesh.device_type)


def _padded_block(arr, n_pad, shard, fill=0.0):
    """Rows of this rank's block of `arr` padded with `fill` to n_pad rows."""
    pad = n_pad - arr.shape[0]
    if pad:
        arr = torch.cat([arr, torch.full((pad,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                                         device=arr.device)])
    m = n_pad // shard.axes[0].size
    i = shard.axes[0].index
    return arr[i * m:(i + 1) * m]


def sharded_epoch_sum(term_fn, arrays, mesh, axis_name: str | None = None, weights=None):
    """Sum per-epoch scalar terms over an epoch axis sharded along
    `axis_name` of `mesh` (default: its first axis).

    term_fn(*block_arrays) -> per-epoch terms (n_block,); the total is the
    all-reduced sum of each rank's terms times its weights. `arrays` is a
    tuple of equal-length epoch-axis arrays (numpy or tensors). Returns
    the global sum as a 0-d tensor, the same on every rank."""
    shard = Shard.along(mesh, axis_name)
    dev = _device(mesh, *arrays, weights)
    ref = next((a for a in arrays if isinstance(a, torch.Tensor)), None)
    like = dict(dtype=ref.dtype if ref is not None else torch.float64, device=dev)
    arrays = [torch.as_tensor(a, **like) for a in arrays]
    n = arrays[0].shape[0]
    n_pad = math.ceil(n / shard.axes[0].size) * shard.axes[0].size
    w = torch.ones(n, **like) if weights is None else torch.as_tensor(weights, **like)
    # pad data with 1s (not 0s) so that term_fn stays finite on the padded
    # rows; their zero weight removes them from the sum regardless
    blocks = [_padded_block(a, n_pad, shard, fill=1.0) for a in arrays]
    w_l = _padded_block(w, n_pad, shard)
    terms = term_fn(*blocks)
    contrib = torch.where(w_l > 0, w_l * terms, 0.0)
    return shard.sum(torch.sum(contrib))


def sharded_fit_5param(A, cosphi, sinphi, dalpha, ddelta, mesh, axis_name: str | None = None,
                       weights=None, residuals=0.0, sigma=None, include_chi2=False,
                       n_rows=None):
    """Epoch-sharded 5-parameter astrometric fit by normal equations.

    The contract of `astrom.fitting.fit_5param` for one fit (epoch-axis
    arrays (N,)), with the epoch axis spread over the ranks along
    `axis_name` of `mesh`: each rank sums its block's A'WA, A'Wb and b'Wb,
    one all-reduce crosses the group, and the 5 x 5 solve is repeated on
    every rank. Exact up to the normal equations' conditioning (run in
    float64)."""
    shard = Shard.along(mesh, axis_name)
    dev = _device(mesh, A, dalpha, ddelta, weights, sigma)
    like = dict(dtype=next((a.dtype for a in (A, dalpha, ddelta) if isinstance(a, torch.Tensor)),
                           torch.float64), device=dev)
    A = torch.as_tensor(A, **like)
    n = A.shape[0]
    b = _rhs(torch.as_tensor(dalpha, **like), torch.as_tensor(ddelta, **like), cosphi, sinphi,
             residuals)
    w = torch.ones(n, **like) if weights is None else torch.as_tensor(weights, **like)
    if sigma is not None and torch.as_tensor(sigma).ndim > 0:
        w = w / torch.as_tensor(sigma, **like) ** 2
    n_pad = math.ceil(n / shard.axes[0].size) * shard.axes[0].size
    A_l, b_l, w_l = (_padded_block(x, n_pad, shard) for x in (A, b, w))
    Aw = A_l * w_l[:, None]
    k = A.shape[1]
    sums = shard.sum(torch.cat([(A_l.T @ Aw).reshape(-1), Aw.T @ b_l,
                                torch.sum(w_l * b_l * b_l)[None]]))
    ata, atb, btb = sums[:k * k].reshape(k, k), sums[k * k:k * k + k], sums[-1]
    x = torch.linalg.solve(ata, atb)
    out = {"parameters": ordered_parameters(x)}
    if include_chi2:
        # chi2 = b'Wb - x'A'Wb (exact for the weighted LSQ solution)
        chi2 = btb - x @ atb
        if sigma is not None and torch.as_tensor(sigma).ndim == 0:
            chi2 = chi2 / (sigma * sigma)
        dof = (n if n_rows is None else n_rows) - 5
        out["chi_squared_astro"] = chi2
        out["chi2_reduced"] = chi2 / dof
    return out


def sharded_gaia_dr4_ll(table, model_al, jitter, mesh, axis_name: str | None = None):
    """Epoch-sharded Gaia DR4 along-scan Gaussian log-likelihood.

    table: dict with centroid_pos_al and centroid_pos_error_al (the
    ten-thousand-scan case); model_al: the model's along-scan positions.
    The per-scan terms are independent Gaussians: one all-reduce of the
    ranks' partial sums."""

    def term(d, e, m):
        var = e * e + jitter * jitter
        return -0.5 * ((d - m) ** 2 / var + torch.log(2 * math.pi * var))

    return sharded_epoch_sum(term, (table["centroid_pos_al"], table["centroid_pos_error_al"],
                                    model_al), mesh, axis_name)
