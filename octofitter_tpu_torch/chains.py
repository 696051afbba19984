"""Posterior chain container + convergence diagnostics.

A copy of the numpy-only part of `octofitter_tpu/chains.py` (importing
that package would import JAX); `flatten_params_batch` also takes
tensors. `ess_rhat_batch_device` is the port of the JAX package's
on-device diagnostics: the same rank-normalized ESS and split-R̂ as the
numpy `ess_rhat_batch`, in torch on the card (or the CPU if asked).

Equivalent of the reference's MCMCChains integration
(`result2mcmcchain` / `mcmcchain2result`,
Octofitter.jl `src/sampling.jl:551-981`): flat named columns following
the naming contract `var`, `planet_var`, `obsname_var`,
`planet_obsname_var`, an `:internals` section with sampler statistics,
and an `info` metadata dict. Adds rank-normalized split-R̂ and
bulk/tail ESS diagnostics (Vehtari et al. 2021).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import ndtri


def _autocovariance_fft(x):
    """Per-chain autocovariance via FFT; x shape (chains, draws)."""
    n = x.shape[1]
    xc = x - x.mean(axis=1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n].real
    return acov / n


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Fractional-rank inverse-normal transform over ALL draws jointly
    (Vehtari et al. 2021 eq. 14): z = Phi^-1((rank - 3/8)/(S + 1/4))."""
    from scipy.stats import rankdata

    flat = x.reshape(-1)
    ranks = rankdata(flat, method="average")
    z = ndtri((ranks - 0.375) / (flat.size + 0.25))
    return z.reshape(x.shape)


def _split_ess_rhat_raw(x: np.ndarray):
    """Split-R̂ and ESS on the values as given; x shape (chains, draws)."""
    x = np.asarray(x, dtype=np.float64)
    m, n = x.shape
    if n < 4:
        return float("nan"), float("nan")
    # split chains in half
    half = n // 2
    xs = np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)
    mm, nn = xs.shape
    chain_means = xs.mean(axis=1)
    chain_vars = xs.var(axis=1, ddof=1)
    W = chain_vars.mean()
    B = nn * chain_means.var(ddof=1)
    var_plus = (nn - 1) / nn * W + B / nn
    rhat = np.sqrt(var_plus / W) if W > 0 else float("nan")

    # combined autocovariance (Geyer initial monotone sequence)
    acov = _autocovariance_fft(xs)
    mean_acov = acov.mean(axis=0)
    rho = 1 - (W - mean_acov) / var_plus
    # pair sums
    t_max = (nn // 2) * 2
    pair = rho[:t_max].reshape(-1, 2).sum(axis=1)
    # initial positive + monotone
    pos = pair > 0
    if not pos.all():
        first_neg = np.argmax(~pos)
        pair = pair[:first_neg]
    if len(pair) > 0:
        pair = np.minimum.accumulate(pair)
        tau = -1 + 2 * pair.sum()
    else:
        tau = 1.0
    tau = max(tau, 1.0 / np.log10(nn + 10))
    ess = mm * nn / tau
    return float(ess), float(rhat)


def ess_rhat(x: np.ndarray):
    """Rank-normalized bulk ESS and split-R̂ (Vehtari et al. 2021).

    x shape (chains, draws). Rank-normalization makes the diagnostics
    robust to heavy tails and to chains stuck in minor modes — the
    honest accounting the reference community standard (posterior /
    ArviZ) uses. Constant columns return (nan, nan).
    """
    x = np.asarray(x, dtype=np.float64)
    if not np.all(np.isfinite(x)):
        return float("nan"), float("nan")
    if np.allclose(x, x.reshape(-1)[0]):
        return float("nan"), float("nan")
    z = _rank_normalize(x)
    ess_bulk, rhat_bulk = _split_ess_rhat_raw(z)
    # folded split-R̂ for scale mis-mixing; report max of the two
    zf = _rank_normalize(np.abs(x - np.median(x)))
    _, rhat_folded = _split_ess_rhat_raw(zf)
    rhat = np.nanmax([rhat_bulk, rhat_folded])
    return float(ess_bulk), float(rhat)


def _half_rank_table(S: int) -> np.ndarray:
    """Normal scores for every rank value scipy's average-tie ranking
    can produce on S samples: tie-group averages are always integers or
    half-integers, so ndtri evaluated once at ranks 1, 1.5, 2, …, S
    (index = 2·rank − 2) covers distinct AND tied data exactly."""
    ranks = np.arange(2.0, 2.0 * S + 1.0) / 2.0
    return ndtri((ranks - 0.375) / (S + 0.25))


def _rank_normalize_batch(x: np.ndarray, table=None) -> np.ndarray:
    """Vectorized `_rank_normalize` over the leading axis; x shape
    (P, S). Matches scipy's rankdata(method="average") exactly,
    including tied samples — real sampler output always has ties
    (an MH rejection duplicates the previous draw), and ordinal ranks
    would systematically overstate ESS there. ndtri never runs on the
    data: all possible average ranks are half-integers, looked up in
    the precomputed `table` (see `_half_rank_table`; pass it in to
    amortize across calls). Rows are processed one at a time — the
    (P, S) sort/take temporaries at bench scale (P≈13, S≈2.5e7) blow
    the cache and peak memory otherwise."""
    P, S = x.shape
    if table is None:
        table = _half_rank_table(S)
    distinct_scores = table[::2]  # integer ranks 1..S
    z = np.empty((P, S), dtype=np.float64)
    for p in range(P):
        order = np.argsort(x[p])
        s = x[p, order]
        boundary = np.empty(S, dtype=bool)
        boundary[0] = True
        np.not_equal(s[1:], s[:-1], out=boundary[1:])
        starts = np.flatnonzero(boundary)
        if starts.size == S:  # no ties: ordinal == average ranks
            z[p, order] = distinct_scores
        else:
            ends = np.append(starts[1:], S)
            # 1-based ranks starts+1 .. ends average to
            # (starts+ends+1)/2 → table index starts+ends-1
            z[p, order] = np.repeat(
                table[starts + ends - 1], ends - starts
            )
    return z


def _constant_rows(flat: np.ndarray) -> np.ndarray:
    """Per-row equivalent of `np.allclose(row, row[0])` without the
    full-size temporaries: max |row - row[0]| <= atol + rtol*|row[0]|
    iff both (max - row0) and (row0 - min) satisfy the bound."""
    row0 = flat[:, 0]
    tol = 1e-08 + 1e-05 * np.abs(row0)
    return ((flat.max(axis=1) - row0) <= tol) & ((row0 - flat.min(axis=1)) <= tol)


def _split_ess_rhat_raw_batch(x: np.ndarray, compute_ess: bool = True):
    """Vectorized `_split_ess_rhat_raw` over the leading axis; x shape
    (P, chains, draws). Returns (ess (P,), rhat (P,)).

    Two algebraic savings over looping the scalar path: the combined
    autocovariance uses irfft(mean over chains of |F|²) — by linearity
    of the inverse transform this equals the mean of per-chain
    irfft(|F|²), so ONE inverse FFT per parameter replaces one per
    chain — and `compute_ess=False` (the folded-R̂ pass, which only
    needs W/B) skips the FFT entirely."""
    x = np.asarray(x, dtype=np.float64)
    P, m, n = x.shape
    if n < 4:
        return np.full(P, np.nan), np.full(P, np.nan)
    half = n // 2
    xs = np.concatenate([x[:, :, :half], x[:, :, half : 2 * half]], axis=1)
    _, mm, nn = xs.shape
    chain_means = xs.mean(axis=2)
    chain_vars = xs.var(axis=2, ddof=1)
    W = chain_vars.mean(axis=1)
    B = nn * chain_means.var(axis=1, ddof=1)
    var_plus = (nn - 1) / nn * W + B / nn
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.where(W > 0, np.sqrt(var_plus / W), np.nan)
    if not compute_ess:
        return np.full(P, np.nan), rhat

    # combined autocovariance (Geyer initial monotone sequence),
    # accumulated in chain blocks to bound the FFT working set. Any
    # nfft >= 2*nn gives the identical linear autocovariance; the
    # smallest fast size beats the next power of two.
    from scipy.fft import next_fast_len

    xc = xs - xs.mean(axis=2, keepdims=True)
    nfft = next_fast_len(2 * nn, real=True)
    power = np.zeros((P, nfft // 2 + 1))
    block = max(1, int(2**24 // max(nfft, 1)))
    for i in range(0, mm, block):
        f = np.fft.rfft(xc[:, i : i + block], nfft, axis=2)
        power += (f * np.conj(f)).real.sum(axis=1)
    power /= mm
    mean_acov = np.fft.irfft(power, nfft, axis=1)[:, :nn] / nn
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = 1 - (W[:, None] - mean_acov) / var_plus[:, None]
    t_max = (nn // 2) * 2
    pair = rho[:, :t_max].reshape(P, -1, 2).sum(axis=2)
    T = pair.shape[1]
    pos = pair > 0
    any_neg = ~pos.all(axis=1)
    first_neg = np.where(any_neg, np.argmax(~pos, axis=1), T)
    mask = np.arange(T)[None, :] < first_neg[:, None]
    cummin = np.minimum.accumulate(np.where(mask, pair, np.inf), axis=1)
    tau = -1.0 + 2.0 * np.where(mask, cummin, 0.0).sum(axis=1)
    tau = np.where(first_neg == 0, 1.0, tau)
    tau = np.maximum(tau, 1.0 / np.log10(nn + 10))
    ess = mm * nn / tau
    return ess, rhat


def ess_rhat_batch(x: np.ndarray):
    """Rank-normalized bulk ESS and split-R̂ for every parameter at
    once; x shape (chains, draws, P). Identical accounting to looping
    `ess_rhat` over the last axis (exact, including tied samples),
    but one vectorized pass — the per-parameter python loop dominates
    wall time for the 10⁷-draw chains a batched sampler produces.
    Returns (ess (P,), rhat (P,)); non-finite or constant parameters
    get (nan, nan)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 2:
        x = x[:, :, None]
    m, n, P = x.shape
    flat = np.ascontiguousarray(np.moveaxis(x, 2, 0)).reshape(P, -1)
    ok = np.isfinite(flat).all(axis=1) & ~_constant_rows(flat)
    if not ok.any():
        return np.full(P, np.nan), np.full(P, np.nan)
    sub = flat if ok.all() else flat[ok]
    S = sub.shape[1]
    table = _half_rank_table(S)
    z = _rank_normalize_batch(sub, table).reshape(-1, m, n)
    ess_b, rhat_b = _split_ess_rhat_raw_batch(z)
    folded = np.abs(sub - np.median(sub, axis=1, keepdims=True))
    zf = _rank_normalize_batch(folded, table).reshape(-1, m, n)
    _, rhat_f = _split_ess_rhat_raw_batch(zf, compute_ess=False)
    with np.errstate(invalid="ignore"):
        rhat_sub = np.fmax(rhat_b, rhat_f)
    ess = np.full(P, np.nan)
    rhat = np.full(P, np.nan)
    ess[ok] = ess_b
    rhat[ok] = rhat_sub
    return ess, rhat


# Device memory that one draw of one parameter row takes at the peak of
# a call (the input and its row-major copy, the sort, the tie-group bounds
# in int64, the scores and the FFT): 73.5-77.0 bytes in float32 on an
# NVIDIA H100 80GB HBM3 (700 W), measured by `chip_smoke.py`'s diagnostics
# phase, rounded up; it sets how many rows one pass takes.
_PEAK_BYTES_PER_DRAW = 80
# the CPU's pass: at most this many draws (rows x draws per row)
_CPU_DRAWS_PER_PASS = 2**24


def _rank_normal_scores(x):
    """Rank-normal scores of each row of x (R, S), with average ranks for
    ties, and the sorted rows.

    One sort per row; each sorted position's tie group [start, end) comes
    from a forward cummax over the boundary indices and a reverse cummin
    over the next boundary's, giving the average 1-based rank
    (start + end + 1) / 2, as scipy's rankdata(method="average"). The
    Blom score of rank k / 2 is ndtri((k - 3/4) / (2S + 1/2)); in float32
    that argument rounds to 1.0 near the top ranks once S >= 2^23, so the
    upper half is evaluated as -ndtri((2S - k + 5/4) / (2S + 1/2)), with
    the integer 2S - k formed in int64."""
    R, S = x.shape
    s, order = torch.sort(x, dim=-1)
    idx = torch.arange(S, device=x.device)
    boundary = torch.ones_like(s, dtype=torch.bool)
    boundary[:, 1:] = s[:, 1:] != s[:, :-1]
    starts = torch.cummax(torch.where(boundary, idx, 0), dim=-1).values
    nxt = torch.where(boundary, idx, S)
    ends = torch.cummin(nxt.flip(-1), dim=-1).values.flip(-1)
    ends = torch.cat([ends[:, 1:], ends.new_full((R, 1), S)], dim=-1)
    k = starts + ends + 1
    del starts, ends, nxt, boundary
    upper = k > S
    num = torch.where(upper, 2 * S - k, k).to(x.dtype)
    p = (num + torch.where(upper, 1.25, -0.75).to(x.dtype)) / (2.0 * S + 0.5)
    z0 = torch.special.ndtri(p)
    z_sorted = torch.where(upper, -z0, z0)
    return torch.empty_like(x).scatter_(-1, order, z_sorted), s


def _split_rhat_ess(z, m, n, nfft, compute_ess=True):
    """Split-R̂ and (if asked) ESS with the Geyer initial monotone
    sequence for each row of z (R, m * n); the torch form of
    `_split_ess_rhat_raw_batch`, with the FFT at `nfft`."""
    R = z.shape[0]
    zc = z.reshape(R, m, n)
    half = n // 2
    xs = torch.cat([zc[:, :, :half], zc[:, :, half: 2 * half]], dim=1)
    mm, nn = 2 * m, half
    W = xs.var(dim=-1, correction=1).mean(dim=-1)
    B = nn * xs.mean(dim=-1).var(dim=-1, correction=1)
    var_plus = (nn - 1) / nn * W + B / nn
    rhat = torch.where(W > 0, torch.sqrt(var_plus / W), torch.nan)
    if not compute_ess:
        return None, rhat
    f = torch.fft.rfft(xs - xs.mean(dim=-1, keepdim=True), n=nfft, dim=-1)
    power = (f.real * f.real + f.imag * f.imag).sum(dim=1) / mm
    del f
    mean_acov = torch.fft.irfft(power, n=nfft, dim=-1)[:, :nn] / nn
    rho = 1 - (W[:, None] - mean_acov) / var_plus[:, None]
    t_max = (nn // 2) * 2
    pair = rho[:, :t_max].reshape(R, -1, 2).sum(dim=-1)
    T = pair.shape[1]
    pos = pair > 0
    first_neg = torch.where(pos.all(dim=-1), T, torch.argmax((~pos).to(torch.uint8), dim=-1))
    mask = torch.arange(T, device=z.device) < first_neg[:, None]
    cummin = torch.cummin(torch.where(mask, pair, torch.inf), dim=-1).values
    tau = -1.0 + 2.0 * torch.where(mask, cummin, 0.0).sum(dim=-1)
    tau = torch.where(first_neg == 0, 1.0, tau)
    tau = torch.clamp(tau, min=1.0 / math.log10(nn + 10))
    return mm * nn / tau, rhat


def _ess_rhat_rows(flat, m, n, nfft):
    """Bulk ESS and max of bulk and folded split-R̂ of each row of flat
    (R, m * n). Rows that are not finite, or constant (`_constant_rows`'
    test), are replaced by arange so the arithmetic stays finite, and
    their results are NaN."""
    S = flat.shape[1]
    row0 = flat[:, :1]
    tol = 1e-08 + 1e-05 * row0.abs()
    constant = (((flat.amax(dim=1, keepdim=True) - row0) <= tol)
                & ((row0 - flat.amin(dim=1, keepdim=True)) <= tol))[:, 0]
    ok = torch.isfinite(flat).all(dim=1) & ~constant
    safe = torch.where(ok[:, None], flat, torch.arange(S, device=flat.device, dtype=flat.dtype))
    z, s = _rank_normal_scores(safe)
    ess, rhat_bulk = _split_rhat_ess(z, m, n, nfft)
    del z
    # the median from the sorted rows, as np.median takes it
    med = (s[:, (S - 1) // 2] + s[:, S // 2]) * 0.5
    del s
    zf, _ = _rank_normal_scores((safe - med[:, None]).abs())
    _, rhat_folded = _split_rhat_ess(zf, m, n, nfft, compute_ess=False)
    rhat = torch.fmax(rhat_bulk, rhat_folded)
    return torch.where(ok, ess, torch.nan), torch.where(ok, rhat, torch.nan)


def ess_rhat_batch_device(x, *, device=None):
    """`ess_rhat_batch` computed with torch on a device: the same
    accounting (rank-normalized bulk ESS with exact average-tie ranks,
    max of bulk and folded split-R̂, NaN for non-finite or constant
    parameters), on x of shape (chains, draws, P) or (chains, draws).

    A tensor runs on its own device, in its own floating dtype; anything
    else is converted (a numpy array keeps its float dtype) and sent to
    `device`, the GPU unless the caller says `device="cpu"`. With no CUDA
    device that raises. Rows are processed in passes of as many as a
    quarter of the free device memory holds (on the CPU, up to 2^24 draws
    a pass). In float64 this matches the numpy oracle to ~1e-12; the
    sampler's float32 gives ~1e-5, far inside a 1.05 R̂ gate. Returns
    numpy (ess (P,), rhat (P,))."""
    if not isinstance(x, torch.Tensor):
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ess_rhat_batch_device was asked for device {dev!s}, but no CUDA "
                "device is available; pass device=\"cpu\" for the CPU"
            )
        x = torch.as_tensor(np.asarray(x), device=dev)
    elif device is not None:
        x = x.to(device)
    if not x.is_floating_point():
        x = x.double()
    if x.ndim == 2:
        x = x[:, :, None]
    m, n, P = x.shape
    if n < 4:
        return np.full(P, np.nan), np.full(P, np.nan)
    from scipy.fft import next_fast_len

    nfft = next_fast_len(2 * (n // 2), real=True)
    S = m * n
    if x.device.type == "cuda":
        budget = torch.cuda.mem_get_info(x.device)[0] // 4 // _PEAK_BYTES_PER_DRAW
    else:
        budget = _CPU_DRAWS_PER_PASS
    rows = int(min(P, max(1, budget // S)))
    flat = x.detach().permute(2, 0, 1).reshape(P, S)
    with torch.no_grad():
        parts = [_ess_rhat_rows(flat[i: i + rows], m, n, nfft) for i in range(0, P, rows)]
    ess = torch.cat([e for e, _ in parts])
    rhat = torch.cat([r for _, r in parts])
    return ess.cpu().numpy(), rhat.cpu().numpy()


def ess_tail(x: np.ndarray):
    """Tail ESS: min of ESS of the 5% and 95% quantile indicators."""
    x = np.asarray(x, dtype=np.float64)
    if not np.all(np.isfinite(x)) or np.allclose(x, x.reshape(-1)[0]):
        return float("nan")
    out = []
    for q in (0.05, 0.95):
        ind = (x <= np.quantile(x, q)).astype(np.float64)
        e, _ = _split_ess_rhat_raw(ind)
        out.append(e)
    return float(np.nanmin(out))


def ess_tail_batch(x: np.ndarray):
    """Vectorized `ess_tail` over the last axis; x shape
    (chains, draws, P). Returns ess_tail (P,)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 2:
        x = x[:, :, None]
    m, n, P = x.shape
    xt = np.ascontiguousarray(np.moveaxis(x, 2, 0))
    flat = xt.reshape(P, -1)
    ok = np.isfinite(flat).all(axis=1) & ~_constant_rows(flat)
    out = np.full(P, np.nan)
    if not ok.any():
        return out
    sub = xt if ok.all() else xt[ok]
    qs = np.quantile(sub.reshape(sub.shape[0], -1), [0.05, 0.95], axis=1)
    inds = np.concatenate(
        [
            (sub <= qs[0][:, None, None]).astype(np.float64),
            (sub <= qs[1][:, None, None]).astype(np.float64),
        ],
        axis=0,
    )
    e, _ = _split_ess_rhat_raw_batch(inds)
    k = ok.sum()
    out[ok] = np.fmin(e[:k], e[k:])
    return out


class Chains:
    """Named posterior samples with shape (n_chains, n_draws) per column."""

    def __init__(self, data: dict, internals: dict | None = None, info: dict | None = None):
        self.data = {k: np.asarray(v) for k, v in data.items()}
        self.internals = {k: np.asarray(v) for k, v in (internals or {}).items()}
        self.info = dict(info or {})
        shapes = {v.shape for v in self.data.values()}
        if len(shapes) > 1:
            raise ValueError(f"inconsistent column shapes: {shapes}")
        some = next(iter(self.data.values()))
        self.n_chains, self.n_draws = some.shape[0], some.shape[1]

    # --------------------------------------------------------------
    @property
    def names(self):
        return list(self.data.keys())

    def __getitem__(self, name):
        if name in self.data:
            return self.data[name]
        if name in self.internals:
            return self.internals[name]
        raise KeyError(name)

    def __contains__(self, name):
        return name in self.data or name in self.internals

    def flat(self, name):
        """Column flattened over (chains, draws)."""
        return self[name].reshape(-1)

    def subset(self, chains=None, draws=None):
        sel_c = slice(None) if chains is None else chains
        sel_d = slice(None) if draws is None else draws
        return Chains(
            {k: v[sel_c, sel_d] for k, v in self.data.items()},
            {k: v[sel_c, sel_d] if v.ndim == 2 else v for k, v in self.internals.items()},
            self.info,
        )

    # --------------------------------------------------------------
    def _diagnostics(self):
        """Batched (ess, rhat, ess_tail) for every 2-D column, one
        vectorized pass (`ess_rhat_batch`)."""
        keys = [k for k, v in self.data.items() if v.ndim == 2]
        if not keys:
            return {}
        x = np.stack([self.data[k] for k in keys], axis=-1)
        ess, rhat = ess_rhat_batch(x)
        tail = ess_tail_batch(x)
        return {
            k: (float(ess[j]), float(rhat[j]), float(tail[j]))
            for j, k in enumerate(keys)
        }

    def summary(self):
        """dict of per-parameter stats: mean, std, ess (rank-normalized
        bulk), ess_tail, rhat (rank-normalized split, max of bulk/folded)."""
        diag = self._diagnostics()
        out = {}
        for k, v in self.data.items():
            if v.ndim != 2:
                continue
            ess, rhat, tail = diag[k]
            out[k] = {
                "mean": float(v.mean()),
                "std": float(v.std()),
                "ess": ess,
                "ess_tail": tail,
                "rhat": rhat,
            }
        return out

    def describe(self):
        """Summary + quantile tables as pandas DataFrames (the reference
        re-exports MCMCChains `describe`, src/Octofitter.jl:47, which
        prints exactly these two tables). Returns (summary, quantiles):
        summary has mean/std/mcse/ess_bulk/ess_tail/rhat per parameter,
        quantiles the 2.5/25/50/75/97.5 percent points."""
        import pandas as pd

        diag = self._diagnostics()
        srows, qrows = [], []
        for k, v in self.data.items():
            if v.ndim != 2:
                continue
            ess, rhat, tail = diag[k]
            flat = v.reshape(-1)
            srows.append(
                dict(
                    parameters=k,
                    mean=float(flat.mean()),
                    std=float(flat.std()),
                    mcse=float(flat.std() / np.sqrt(max(ess, 1e-12))),
                    ess_bulk=ess,
                    ess_tail=tail,
                    rhat=rhat,
                )
            )
            q = np.percentile(flat, [2.5, 25.0, 50.0, 75.0, 97.5])
            qrows.append(
                {
                    "parameters": k,
                    "2.5%": q[0],
                    "25.0%": q[1],
                    "50.0%": q[2],
                    "75.0%": q[3],
                    "97.5%": q[4],
                }
            )
        return (
            pd.DataFrame(srows).set_index("parameters"),
            pd.DataFrame(qrows).set_index("parameters"),
        )

    def __repr__(self):
        lines = [
            f"Chains ({self.n_chains} chains, {self.n_draws} draws, "
            f"{len(self.data)} parameters)"
        ]
        s = self.summary()
        lines.append(f"{'parameter':>24} {'mean':>12} {'std':>12} {'ess':>10} {'rhat':>8}")
        for k, st in s.items():
            lines.append(
                f"{k:>24} {st['mean']:>12.5g} {st['std']:>12.5g} "
                f"{st['ess']:>10.0f} {st['rhat']:>8.4f}"
            )
        return "\n".join(lines)


def _to_numpy(v):
    if hasattr(v, "detach"):  # a torch tensor, on any device
        return v.detach().cpu().numpy()
    return np.asarray(v)


def flatten_params_batch(params, prefix="") -> dict:
    """Flatten a (batched) Params tree into named numpy arrays following
    the chain naming contract (`sampling.jl:908-981`)."""
    from .model.params import Params

    out = {}
    for k, v in params.items():
        if k in ("planets", "observations") and isinstance(v, Params):
            for name2, sub in v.items():
                if k == "planets":
                    subprefix = f"{prefix}{name2}_"
                else:
                    subprefix = f"{prefix}{name2}_"
                out.update(flatten_params_batch(sub, subprefix))
        elif isinstance(v, Params):
            out.update(flatten_params_batch(v, f"{prefix}{k}_"))
        else:
            out[f"{prefix}{k}"] = _to_numpy(v)
    return out
