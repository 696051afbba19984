"""Gaussian-process kernels for RV noise, and the dense GP log-likelihood.

PyTorch port of `octofitter_tpu/rv/kernels.py` (the reference's
AbstractGPs usage in `OctofitterRadialVelocity`, `rv-absolute.jl:199-315`).
A kernel is built per evaluation from the observation's variables, so its
hyperparameters are numbers, 0-d tensors or per-row tensors of shape (C,);
`matrix(t1, t2)` of (n,) and (m,) epochs gives (C, n, m), or (n, m) when
no hyperparameter has a row axis. Every kernel depends on the epochs only
through their differences, so callers may pass epochs relative to any
origin (the RV likelihoods pass them relative to their first epoch, taken
in float64, so that float32 keeps the spacing of MJD epochs).

The dense log-likelihood factors K + diag(var) by library calls
(`torch.linalg.cholesky_ex`, `solve_triangular`, `cholesky_solve`), as the
JAX package leaves it to XLA. Celerite terms (`rv/celerite.py`) go to the
O(N) recursion instead.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_LOG_2PI = math.log(2 * math.pi)


def _hyper(x):
    """A hyperparameter shaped to broadcast against an (n, m) matrix: a
    tensor with a row axis gets two trailing axes."""
    if isinstance(x, torch.Tensor) and x.ndim:
        return x[..., None, None]
    return x


def _lag(t1, t2):
    """t1[:, None] - t2[None, :] of two 1-D epoch tensors."""
    return t1[:, None] - t2[None, :]


@dataclasses.dataclass(frozen=True)
class Kernel:
    def matrix(self, t1, t2):
        raise NotImplementedError

    def __add__(self, other):
        return SumKernel(self, other)

    def __mul__(self, other):
        return ProductKernel(self, other)


@dataclasses.dataclass(frozen=True)
class SumKernel(Kernel):
    a: Kernel
    b: Kernel

    def matrix(self, t1, t2):
        return self.a.matrix(t1, t2) + self.b.matrix(t1, t2)


@dataclasses.dataclass(frozen=True)
class ProductKernel(Kernel):
    a: Kernel
    b: Kernel

    def matrix(self, t1, t2):
        return self.a.matrix(t1, t2) * self.b.matrix(t1, t2)


@dataclasses.dataclass(frozen=True)
class SqExponentialKernel(Kernel):
    """amp^2 * exp(-dt^2 / (2 len^2))"""

    amplitude: object = 1.0
    lengthscale: object = 1.0

    def matrix(self, t1, t2):
        dt = _lag(t1, t2)
        return _hyper(self.amplitude) ** 2 * torch.exp(-0.5 * (dt / _hyper(self.lengthscale)) ** 2)


@dataclasses.dataclass(frozen=True)
class Matern32Kernel(Kernel):
    amplitude: object = 1.0
    lengthscale: object = 1.0

    def matrix(self, t1, t2):
        dt = torch.abs(_lag(t1, t2))
        arg = math.sqrt(3.0) * dt / _hyper(self.lengthscale)
        return _hyper(self.amplitude) ** 2 * (1 + arg) * torch.exp(-arg)


@dataclasses.dataclass(frozen=True)
class QuasiPeriodicKernel(Kernel):
    """The standard RV activity kernel (e.g. HARPS analyses, reference
    `docs/src/rv-gp.md`):

      eta1^2 exp(-dt^2/(2 eta2^2) - sin^2(pi dt / eta3) / (2 eta4^2))
    """

    eta1: object = 1.0   # amplitude (m/s)
    eta2: object = 1.0   # evolution timescale (days)
    eta3: object = 1.0   # rotation period (days)
    eta4: object = 0.5   # periodic scale

    def matrix(self, t1, t2):
        dt = _lag(t1, t2)
        decay = -0.5 * (dt / _hyper(self.eta2)) ** 2
        periodic = -torch.sin(math.pi * dt / _hyper(self.eta3)) ** 2 / (2 * _hyper(self.eta4) ** 2)
        return _hyper(self.eta1) ** 2 * torch.exp(decay + periodic)


def _gated_cholesky(K):
    """(L, bad): the Cholesky factor of every (n, n) matrix of K, and the
    rows whose matrix is not positive definite. Those rows are factored as
    the identity instead, so that their values and gradients stay finite
    (a failed factor's zero cotangent can still meet an infinity); the
    caller replaces their results."""
    with torch.no_grad():
        bad = torch.linalg.cholesky_ex(K.detach()).info > 0
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    L = torch.linalg.cholesky_ex(torch.where(bad[..., None, None], eye, K)).L
    return L, bad


def _covariance(kernel, t, var):
    """K(t, t) + diag(var), broadcast to var's rows: (..., n, n)."""
    K = kernel.matrix(t, t)
    return K + torch.diag_embed(var)


def gp_loglike(kernel, t, resid, var, method="scan", *, fused=True):
    """log N(resid | 0, K(t,t) + diag(var)), one value per row: resid and
    var are (..., n), t is (n,). A row whose matrix is not positive
    definite gives -inf with a zero gradient row (the JAX package returns
    NaN there and its model gate makes it -inf; the reference catches
    PosDefException, `rv-absolute.jl:229-239`).

    Celerite terms go to the O(N) recursion (`celerite_loglike`, the CUDA
    kernel pair on the GPU unless `fused` is false) or, with
    method="associative", to the parallel Kalman filter; dense kernels to
    a Cholesky factorization."""
    from .celerite import CeleriteTerm, celerite_loglike, celerite_loglike_assoc

    if isinstance(kernel, CeleriteTerm):
        if method == "associative":
            return celerite_loglike_assoc(kernel, t, resid, var)
        return celerite_loglike(kernel, t, resid, var, fused=fused)
    L, bad = _gated_cholesky(_covariance(kernel, t, var))
    alpha = torch.linalg.solve_triangular(L, resid[..., None], upper=False)[..., 0]
    n = t.shape[-1]
    ll = (-0.5 * torch.sum(alpha**2, dim=-1)
          - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
          - 0.5 * n * _LOG_2PI)
    return torch.where(bad, -torch.inf, ll)


def _gp_predict(kernel, t_train, resid_train, var_train, t_test):
    """(mean, var, bad): `gp_predict`'s conditional mean and variance, (...,
    m), with rows whose training matrix is not positive definite marked in
    `bad` and given the prior's finite mean 0 and variance instead."""
    L, bad = _gated_cholesky(_covariance(kernel, t_train, var_train))
    Ks = kernel.matrix(t_test, t_train)
    alpha = torch.cholesky_solve(resid_train[..., None], L)
    mean = (Ks @ alpha)[..., 0]
    v = torch.linalg.solve_triangular(L, Ks.mT, upper=False)
    prior_var = torch.diagonal(kernel.matrix(t_test, t_test), dim1=-2, dim2=-1)
    var = prior_var - torch.sum(v**2, dim=-2)
    keep = ~bad[..., None]
    return torch.where(keep, mean, 0.0), torch.where(keep, var, prior_var), bad


def gp_predict(kernel: Kernel, t_train, resid_train, var_train, t_test):
    """GP conditional mean and variance at t_test, (..., m), for held-out
    cross-validation and plots (reference `rv-absolute.jl:253-304`); NaN in
    the rows whose training matrix is not positive definite, as the JAX
    package gives."""
    mean, var, bad = _gp_predict(kernel, t_train, resid_train, var_train, t_test)
    return (torch.where(bad[..., None], torch.nan, mean),
            torch.where(bad[..., None], torch.nan, var))
