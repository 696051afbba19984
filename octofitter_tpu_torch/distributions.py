"""Prior distributions.

PyTorch port of `octofitter_tpu/distributions.py`: Normal, Uniform,
LogNormal, LogUniform, Exponential, Beta, Gamma, TruncatedNormal with
`truncated`, Sine, UniformImproper and KDEDist, and the discrete
DiscreteUniform and Categorical, which `LogDensityModel` marginalizes or
samples by Gibbs updates. All but KDEDist stay frozen dataclasses, so `LogDensityModel` can stack the priors of one class
into a single instance whose fields are tensors (one entry per parameter)
and evaluate each class in one vector op; a KDEDist is evaluated on its
own.

A field is a Python float (a prior written by a user) or a tensor (a
stacked group). ``logpdf`` is branch-free: out-of-support inputs give
``-inf`` through ``torch.where``. ``sample`` draws from an explicit
``torch.Generator`` on the generator's device.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import bijectors

__all__ = [
    "Distribution",
    "Normal",
    "Uniform",
    "LogNormal",
    "LogUniform",
    "Exponential",
    "Beta",
    "Gamma",
    "TruncatedNormal",
    "truncated",
    "Sine",
    "UniformImproper",
    "KDEDist",
    "DiscreteUniform",
    "Categorical",
]

_SQRT2 = math.sqrt(2.0)
_LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _lgamma(v):
    return torch.lgamma(v) if isinstance(v, torch.Tensor) else math.lgamma(v)


def _uniform(generator, shape, dtype):
    return torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)


def gumbel(generator, shape, dtype):
    """Standard Gumbel draws -log(-log U), U uniform on [tiny, 1), as
    `jax.random.gumbel` makes them."""
    u = torch.clamp(_uniform(generator, shape, dtype), min=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def categorical(logits, generator=None, noise=None):
    """Index of one draw from softmax(logits) over the last axis by the
    Gumbel-max trick, argmax(logits + g), as `jax.random.categorical`
    draws it; g are Gumbel draws from `generator` unless `noise` (of
    logits' shape) gives them."""
    if noise is None:
        noise = gumbel(generator, logits.shape, logits.dtype)
    return torch.argmax(logits + torch.as_tensor(noise, dtype=logits.dtype,
                                                 device=logits.device), dim=-1)


def _standard_gamma(alpha, generator, shape, dtype):
    """Gamma(alpha, 1) draws of `shape` (alpha a float or a tensor that
    broadcasts to it) by Marsaglia and Tsang's (2000) squeeze-free
    rejection, every draw from `generator`; alpha < 1 draws at alpha + 1
    and scales by U^(1 / alpha). Rejected draws are redrawn in batches
    until every element is accepted."""
    dev = generator.device
    alpha = torch.as_tensor(alpha, dtype=dtype, device=dev).expand(shape)
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros(shape, dtype=dtype, device=dev)
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    while not bool(done.all()):
        x = torch.randn(shape, generator=generator, dtype=dtype, device=dev)
        v = (1 + c * x) ** 3
        u = _uniform(generator, shape, dtype)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v))
        out = torch.where(ok & ~done, d * v, out)
        done = done | ok
    u = _uniform(generator, shape, dtype)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


@dataclasses.dataclass(frozen=True)
class Distribution:
    """Base class: continuous univariate distribution with static params."""

    #: discrete distributions are detected by LogDensityModel, which
    #: marginalizes them or samples them by Gibbs updates
    discrete = False

    def logpdf(self, x):
        raise NotImplementedError

    def sample(self, generator, shape=(), dtype=torch.float64):
        raise NotImplementedError

    @property
    def support(self) -> tuple:
        return (-math.inf, math.inf)

    def bijector(self) -> bijectors.Bijector:
        lo, hi = self.support
        return bijectors.from_support(lo, hi)

    def __len__(self):
        return 1


def _in_support(d: Distribution, x, lp):
    # bounds are floats, or tensors with one entry per stacked parameter
    lo, hi = d.support
    if isinstance(lo, torch.Tensor):
        ok = torch.where(torch.isneginf(lo), True, x > lo)
    else:
        ok = torch.ones_like(x, dtype=torch.bool) if lo == -math.inf else x > lo
    if isinstance(hi, torch.Tensor):
        ok = ok & torch.where(torch.isposinf(hi), True, x < hi)
    elif hi != math.inf:
        ok = ok & (x < hi)
    return torch.where(ok, lp, -math.inf)


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    mu: float = 0.0
    sigma: float = 1.0

    def logpdf(self, x):
        z = (x - self.mu) / self.sigma
        return -0.5 * z * z - _log(self.sigma) - _LOG_SQRT_2PI

    def sample(self, generator, shape=(), dtype=torch.float64):
        z = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
        return self.mu + self.sigma * z

    def mean(self):
        return self.mu

    def std(self):
        return self.sigma


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    a: float = 0.0
    b: float = 1.0

    def logpdf(self, x):
        lp = torch.zeros_like(x) - _log(self.b - self.a)
        return _in_support(self, x, lp)

    def sample(self, generator, shape=(), dtype=torch.float64):
        return self.a + (self.b - self.a) * _uniform(generator, shape, dtype)

    @property
    def support(self):
        return (self.a, self.b)

    def mean(self):
        return 0.5 * (self.a + self.b)

    def std(self):
        return (self.b - self.a) / math.sqrt(12.0)


@dataclasses.dataclass(frozen=True)
class LogNormal(Distribution):
    mu: float = 0.0
    sigma: float = 1.0

    def logpdf(self, x):
        safe_x = torch.where(x > 0, x, 1.0)
        lx = torch.log(safe_x)
        z = (lx - self.mu) / self.sigma
        lp = -0.5 * z * z - lx - _log(self.sigma) - _LOG_SQRT_2PI
        return torch.where(x > 0, lp, -math.inf)

    def sample(self, generator, shape=(), dtype=torch.float64):
        z = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
        return torch.exp(self.mu + self.sigma * z)

    @property
    def support(self):
        return (0.0, math.inf)

    def mean(self):
        return math.exp(self.mu + self.sigma**2 / 2)

    def std(self):
        m2 = math.exp(self.sigma**2)
        return math.sqrt((m2 - 1) * math.exp(2 * self.mu + self.sigma**2))


@dataclasses.dataclass(frozen=True)
class LogUniform(Distribution):
    a: float = 1.0
    b: float = 10.0

    def logpdf(self, x):
        safe_x = torch.where(x > 0, x, 1.0)
        lp = -torch.log(safe_x) - _log(_log(self.b / self.a))
        return _in_support(self, x, lp)

    def sample(self, generator, shape=(), dtype=torch.float64):
        u = _uniform(generator, shape, dtype)
        return self.a * torch.exp(u * _log(self.b / self.a))

    @property
    def support(self):
        return (self.a, self.b)

    def mean(self):
        return (self.b - self.a) / math.log(self.b / self.a)

    def std(self):
        lr = math.log(self.b / self.a)
        m1 = (self.b - self.a) / lr
        m2 = (self.b**2 - self.a**2) / (2 * lr)
        return math.sqrt(max(m2 - m1**2, 0.0))


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    """Exponential with *scale* (mean) theta, Distributions.jl convention."""

    theta: float = 1.0

    def logpdf(self, x):
        lp = -x / self.theta - _log(self.theta)
        return torch.where(x >= 0, lp, -math.inf)

    def sample(self, generator, shape=(), dtype=torch.float64):
        e = torch.empty(shape, dtype=dtype, device=generator.device).exponential_(generator=generator)
        return self.theta * e

    @property
    def support(self):
        return (0.0, math.inf)

    def mean(self):
        return self.theta

    def std(self):
        return self.theta


@dataclasses.dataclass(frozen=True)
class Beta(Distribution):
    alpha: float = 1.0
    beta: float = 1.0

    def logpdf(self, x):
        a, b = self.alpha, self.beta
        lbeta = _lgamma(a) + _lgamma(b) - _lgamma(a + b)
        safe_x = torch.clamp(x, 1e-300, 1 - 1e-16)
        lp = (a - 1) * torch.log(safe_x) + (b - 1) * torch.log1p(-safe_x) - lbeta
        return _in_support(self, x, lp)

    def sample(self, generator, shape=(), dtype=torch.float64):
        # X / (X + Y) with X ~ Gamma(alpha), Y ~ Gamma(beta)
        x = _standard_gamma(self.alpha, generator, shape, dtype)
        y = _standard_gamma(self.beta, generator, shape, dtype)
        return x / (x + y)

    @property
    def support(self):
        return (0.0, 1.0)

    def mean(self):
        return self.alpha / (self.alpha + self.beta)

    def std(self):
        a, b = self.alpha, self.beta
        return math.sqrt(a * b / ((a + b) ** 2 * (a + b + 1)))


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    """Gamma with shape alpha and *scale* theta (Distributions.jl)."""

    alpha: float = 1.0
    theta: float = 1.0

    def logpdf(self, x):
        a, t = self.alpha, self.theta
        safe_x = torch.where(x > 0, x, 1.0)
        lp = (a - 1) * torch.log(safe_x) - safe_x / t - _lgamma(a) - a * _log(t)
        return torch.where(x > 0, lp, -math.inf)

    def sample(self, generator, shape=(), dtype=torch.float64):
        return self.theta * _standard_gamma(self.alpha, generator, shape, dtype)

    @property
    def support(self):
        return (0.0, math.inf)

    def mean(self):
        return self.alpha * self.theta

    def std(self):
        return math.sqrt(self.alpha) * self.theta


def _ndtr_clipped(z):
    # standard normal cdf, argument clipped to +-38 as the JAX package does
    if isinstance(z, torch.Tensor):
        return 0.5 * torch.special.erfc(-torch.clamp(z, -38.0, 38.0) / _SQRT2)
    return 0.5 * math.erfc(-min(max(z, -38.0), 38.0) / _SQRT2)


@dataclasses.dataclass(frozen=True)
class TruncatedNormal(Distribution):
    """Normal(mu, sigma) truncated to (lower, upper): the reference's
    `truncated(Normal(mu, sigma), lower=..., upper=...)`."""

    mu: float = 0.0
    sigma: float = 1.0
    lower: float = -math.inf
    upper: float = math.inf

    @functools.cached_property
    def _log_norm(self):
        # log(sigma sqrt(2 pi) Z), Z the normal mass between the bounds:
        # constant, so computed once per instance
        za = (self.lower - self.mu) / self.sigma
        zb = (self.upper - self.mu) / self.sigma
        return _log(self.sigma) + _LOG_SQRT_2PI + _log(_ndtr_clipped(zb) - _ndtr_clipped(za))

    def logpdf(self, x):
        z = (x - self.mu) / self.sigma
        lp = -0.5 * z * z - self._log_norm
        return _in_support(self, x, lp)

    def sample(self, generator, shape=(), dtype=torch.float64):
        # inverse cdf between the bounds' cdf values
        ca = _ndtr_clipped((self.lower - self.mu) / self.sigma)
        cb = _ndtr_clipped((self.upper - self.mu) / self.sigma)
        u = ca + (cb - ca) * _uniform(generator, shape, dtype)
        return self.mu + self.sigma * torch.special.ndtri(u)

    @property
    def support(self):
        return (self.lower, self.upper)

    def mean(self):
        return self.mu  # approximation, used only for diagnostics

    def std(self):
        return self.sigma


def truncated(dist: Normal, lower=-math.inf, upper=math.inf) -> Distribution:
    """Match the reference API `truncated(Normal(...), lower=, upper=)`."""
    if isinstance(dist, Normal):
        return TruncatedNormal(dist.mu, dist.sigma, lower, upper)
    raise NotImplementedError(
        f"truncated() currently supports Normal, got {type(dist).__name__}"
    )


@dataclasses.dataclass(frozen=True)
class Sine(Distribution):
    """pdf = sin(x)/2 on (0, pi): the isotropic-inclination prior."""

    def logpdf(self, x):
        safe = torch.clamp(x, 1e-12, math.pi - 1e-12)
        lp = torch.log(torch.sin(safe) / 2)
        return _in_support(self, x, lp)

    def sample(self, generator, shape=(), dtype=torch.float64):
        # quantile(p) = acos(1 - 2p)
        return torch.arccos(1 - 2 * _uniform(generator, shape, dtype))

    @property
    def support(self):
        return (0.0, math.pi)

    def mean(self):
        return math.pi / 2

    def std(self):
        return math.sqrt(0.25 - 2 / math.pi**2)


@dataclasses.dataclass(frozen=True)
class UniformImproper(Distribution):
    """Improper flat prior on the whole real line."""

    def logpdf(self, x):
        return torch.zeros_like(x)

    def sample(self, generator, shape=(), dtype=torch.float64):
        # the reference's quantile(d, p) = p convention
        return _uniform(generator, shape, dtype)

    def mean(self):
        return 0.5

    def std(self):
        return 1.0


def _interp(x, xp, fp):
    """`jnp.interp(x, xp, fp)` for increasing xp: linear between the
    bracketing knots, fp[0] below xp[0] and fp[-1] above xp[-1]."""
    i = torch.searchsorted(xp, x.reshape(-1).contiguous(), right=True).reshape(x.shape)
    i = torch.clamp(i, 1, len(xp) - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx = xp[i] - x0
    # knots that coincide (a cdf flat to the dtype's precision) give fp
    # at the left one, as jnp.interp does
    flat = dx.abs() <= np.spacing(torch.finfo(xp.dtype).eps)
    f = torch.where(flat, f0, f0 + (x - x0) / torch.where(flat, 1.0, dx) * (fp[i] - f0))
    return torch.where(x < xp[0], fp[0], torch.where(x > xp[-1], fp[-1], f))


class KDEDist(Distribution):
    """1-D kernel density estimate prior.

    The Gaussian-KDE density (Silverman's bandwidth by default, reflected
    at the bounds) is computed once on a fixed grid with numpy, as the JAX
    package does; ``logpdf`` interpolates it linearly on that grid and
    ``sample`` inverts its cdf on the same grid. The grid goes to a
    tensor's device and dtype at first use there."""

    def __init__(self, data, bandwidth=None, lower=None, upper=None, gridsize=2048):
        data = np.asarray(data, dtype=np.float64)
        if bandwidth is None:
            # Silverman's rule, as KernelDensity.jl's default_bandwidth
            n = data.size
            sig = min(np.std(data), (np.percentile(data, 75) - np.percentile(data, 25)) / 1.349)
            bandwidth = 0.9 * sig * n ** (-1 / 5)
        self.bandwidth = float(bandwidth)
        self.lower = float(np.min(data) if lower is None else lower)
        self.upper = float(np.max(data) if upper is None else upper)
        self.data = data
        grid = np.linspace(self.lower, self.upper, gridsize)
        # density as a mixture of normals, reflected at the bounds as
        # KernelDensity.jl's boundary= handling does
        z = (grid[:, None] - data[None, :]) / self.bandwidth
        dens = np.exp(-0.5 * z**2).sum(axis=1)
        zl = (grid[:, None] - (2 * self.lower - data[None, :])) / self.bandwidth
        zu = (grid[:, None] - (2 * self.upper - data[None, :])) / self.bandwidth
        dens += np.exp(-0.5 * zl**2).sum(axis=1)
        dens += np.exp(-0.5 * zu**2).sum(axis=1)
        dens /= data.size * self.bandwidth * math.sqrt(2 * math.pi)
        # normalize on the truncated domain
        cdf = np.concatenate([[0.0], np.cumsum((dens[1:] + dens[:-1]) / 2) * np.diff(grid)])
        self._grid_np, self._dens_np, self._cdf_np = grid, dens / cdf[-1], cdf / cdf[-1]
        self._tables = {}

    def _table(self, ref: torch.Tensor):
        """(grid, density, cdf) as tensors of ref's dtype on ref's device."""
        key = (ref.device, ref.dtype)
        if key not in self._tables:
            self._tables[key] = tuple(torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
                                      for a in (self._grid_np, self._dens_np, self._cdf_np))
        return self._tables[key]

    def logpdf(self, x):
        grid, dens, _ = self._table(x)
        lp = torch.log(torch.clamp(_interp(x, grid, dens), min=1e-300))
        return _in_support(self, x, lp)

    def sample(self, generator, shape=(), dtype=torch.float64):
        p = _uniform(generator, shape, dtype)
        grid, _, cdf = self._table(p)
        return _interp(p, cdf, grid)

    @property
    def support(self):
        return (self.lower, self.upper)

    def mean(self):
        return float(np.mean(self.data))

    def std(self):
        return float(np.std(self.data))


# --------------------------------------------------------------------------
# Discrete distributions (marginalized or Gibbs-sampled by LogDensityModel)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiscreteUniform(Distribution):
    """Uniform over the integers a..b inclusive. Detected by
    LogDensityModel, which marginalizes it over its domain by logsumexp
    or, for large domain products, samples it by Gibbs updates."""

    a: int = 0
    b: int = 1

    discrete = True

    def domain(self):
        return np.arange(int(self.a), int(self.b) + 1)

    def logpmf(self, k):
        n = int(self.b) - int(self.a) + 1
        inside = (k >= self.a) & (k <= self.b)
        return torch.where(inside, torch.full_like(k, -math.log(n)), -math.inf)

    # continuous-interface shims
    def logpdf(self, x):
        return self.logpmf(torch.round(x))

    def sample(self, generator, shape=(), dtype=torch.float64):
        return torch.randint(int(self.a), int(self.b) + 1, shape, generator=generator,
                             device=generator.device).to(dtype)

    @property
    def support(self):
        return (float(self.a) - 0.5, float(self.b) + 0.5)


@dataclasses.dataclass(frozen=True)
class Categorical(Distribution):
    """Categorical over explicit values (default 0, 1, ...) with the given
    probabilities (normalized here). Handled like DiscreteUniform."""

    probs: tuple = (0.5, 0.5)
    values: tuple | None = None

    discrete = True

    def domain(self):
        if self.values is not None:
            return np.asarray(self.values, float)
        return np.arange(len(self.probs), dtype=float)

    def _logp(self):
        p = np.asarray(self.probs, float)
        p = p / p.sum()
        return np.log(np.maximum(p, 1e-300))

    def logpmf(self, k):
        out = torch.full_like(k, -math.inf)
        for v, lp in zip(self.domain(), self._logp()):
            out = torch.where(k == v, float(lp), out)
        return out

    def logpdf(self, x):
        return self.logpmf(x)

    def sample(self, generator, shape=(), dtype=torch.float64):
        dev = generator.device
        logp = torch.as_tensor(self._logp(), dtype=dtype, device=dev)
        idx = categorical(logp.expand(tuple(shape) + logp.shape), generator)
        return torch.as_tensor(self.domain(), dtype=dtype, device=dev)[idx]

    @property
    def support(self):
        dom = self.domain()
        return (float(dom.min()) - 0.5, float(dom.max()) + 0.5)
