"""Shared vectorized likelihood helpers."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..orbits.elements import OrbitSolution

_LOG_2PI = math.log(2 * math.pi)


def gauss2d_logpdf(r1, r2, sigma1, sigma2, cor):
    """Elementwise log-density of correlated 2-vector residuals: the
    reference's per-epoch 2x2 `MvNormal` blocks in closed form."""
    one_m_c2 = 1 - cor * cor
    z = (
        (r1 / sigma1) ** 2
        - 2 * cor * r1 * r2 / (sigma1 * sigma2)
        + (r2 / sigma2) ** 2
    )
    logdet = 2 * torch.log(sigma1) + 2 * torch.log(sigma2) + torch.log(one_m_c2)
    return -_LOG_2PI - 0.5 * logdet - 0.5 * z / one_m_c2


def gauss_logpdf(resid, sigma):
    """Elementwise univariate normal log-density of residuals."""
    return -0.5 * (resid / sigma) ** 2 - torch.log(sigma) - 0.5 * _LOG_2PI


def take_epochs(sol: OrbitSolution, start: int, n: int) -> OrbitSolution:
    """Slice the epoch axis (the last) of a batched OrbitSolution, and of
    its `compensated` block where it has one."""
    sliced = {
        f.name: getattr(sol, f.name)[..., start : start + n]
        for f in dataclasses.fields(sol)
        if f.name not in ("elem", "compensated")
    }
    comp = sol.compensated
    if comp is not None:
        comp = type(comp)(**{f.name: getattr(comp, f.name)[..., start : start + n]
                             for f in dataclasses.fields(comp)})
    return OrbitSolution(elem=sol.elem, compensated=comp, **sliced)


def row_shape(ctx) -> tuple:
    """The shape of a likelihood context's rows (chains, or chains times
    discrete combinations): its `batch_shape`, which the model sets, or
    where a caller left that out, its orbit solutions' without the epoch
    axis."""
    if ctx.batch_shape is not None:
        return tuple(ctx.batch_shape)
    for sol in ctx.solutions:
        if sol is not None:
            return tuple(sol.EA.shape[: sol.EA.ndim - sol.t.ndim])
    return ()


def per_epoch(x, ctx):
    """A parameter shaped to broadcast against the epoch axis of `ctx`'s
    likelihood. A per-row value (of the context's row shape, or 0-d) gets
    a trailing axis; a per-epoch one (the row shape plus the epoch axis,
    e.g. a jitter derived from one flag per epoch) and a number stay as
    they are."""
    if isinstance(x, torch.Tensor) and (x.ndim == 0 or tuple(x.shape) == row_shape(ctx)):
        return x.unsqueeze(-1)
    return x
