"""Celerite semiseparable Gaussian-process likelihood, O(N), differentiable.

PyTorch port of `octofitter_tpu/rv/celerite.py` (the reference vendors
Celerite.jl, which is not differentiable, `Celerite.jl:1-8`). Kernel
terms: RealTerm(a, c), ComplexTerm(a, b, c, d) and SHOTerm(S0, w0, Q)
(underdamped Q > 1/2), with

    k(tau) = sum_j exp(-c_j tau) (a_j cos(d_j tau) + b_j sin(d_j tau)).

The chain axis is written out: a term's parameters are numbers or per-row
tensors (C,), `coefficients()` gives (C, J) or (J,), and residuals and
variances are (C, n); the epochs (n,) are shared by every row.

`celerite_loglike` runs the celerite Cholesky recursion (Foreman-Mackey
et al. 2017), which is sequential over the epochs. On a CUDA tensor it
launches a hand-written forward and backward kernel pair
(`csrc/celerite.cu` through `celerite_cuda.py`: tiles of rows, chunks of
epochs staged in shared memory, a backward that recomputes each chunk from
a checkpoint); on
the CPU, or where the caller asks for composed torch ops (`fused=False`,
for a second derivative or a `torch.func` transform), it runs
`_celerite_plain`, a Python loop over the epochs of batched torch ops,
which is also the kernels' plain version. `celerite_loglike_assoc` is the
parallel Kalman filter of the same likelihood, a log-depth associative
scan, for few rows and long series.

The likelihood depends on the epochs only through their differences, so
both paths take them relative to the first epoch, shifted in the epochs'
own dtype (float64 for an array) before the cast to the residuals' dtype:
at MJD 57,000 and d up to ~2 rad/day, cos(d t) in float32 would see
arguments near 1.1e5 rad, where its spacing is 0.0078 rad.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_LOG_2PI = math.log(2 * math.pi)


def _as_tensors(*xs):
    """The fields `xs` as tensors of one dtype and device: those of the
    first tensor among them, else float64 on the CPU."""
    ref = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    dtype = ref.dtype if ref is not None else torch.float64
    device = ref.device if ref is not None else torch.device("cpu")
    return torch.broadcast_tensors(*(torch.as_tensor(x, dtype=dtype, device=device) for x in xs))


def _one_term(*xs):
    """Coefficients of one term, each with a trailing term axis of 1."""
    return tuple(x[..., None] for x in xs)


@dataclasses.dataclass(frozen=True)
class CeleriteTerm:
    """Base: provides the (a, b, c, d) coefficients, each (..., J)."""

    def coefficients(self):
        raise NotImplementedError

    def __add__(self, other):
        return CeleriteSum(self, other)

    def matrix(self, t1, t2):
        """The dense covariance, (..., n, m), in the epochs' dtype and on
        their device, for tests, prediction and short series."""
        a, b, c, d = (x.to(dtype=t1.dtype, device=t1.device)[..., None, None, :]
                      for x in self.coefficients())
        tau = torch.abs(t1[:, None] - t2[None, :])[..., None]
        return torch.sum(torch.exp(-c * tau) * (a * torch.cos(d * tau) + b * torch.sin(d * tau)),
                         dim=-1)


@dataclasses.dataclass(frozen=True)
class CeleriteSum(CeleriteTerm):
    t1: CeleriteTerm
    t2: CeleriteTerm

    def coefficients(self):
        """Both terms' coefficients side by side, in the dtype and on the
        device of the first term that lies off the CPU (a term built from
        plain numbers is float64 on the CPU), else of the first term."""
        first, second = self.t1.coefficients(), self.t2.coefficients()
        on_cpu = first[0].device.type == "cpu"
        lead = second if on_cpu and second[0].device.type != "cpu" else first
        batch = torch.broadcast_shapes(first[0].shape[:-1], second[0].shape[:-1])
        out = []
        for x, y in zip(first, second):
            x, y = (z.to(dtype=lead[0].dtype, device=lead[0].device) for z in (x, y))
            out.append(torch.cat([x.expand(batch + x.shape[-1:]),
                                  y.expand(batch + y.shape[-1:])], dim=-1))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class RealTerm(CeleriteTerm):
    a: object = 1.0
    c: object = 1.0

    def coefficients(self):
        a, c = _as_tensors(self.a, self.c)
        zero = torch.zeros_like(a)
        return _one_term(a, zero, c, zero)


@dataclasses.dataclass(frozen=True)
class ComplexTerm(CeleriteTerm):
    a: object = 1.0
    b: object = 0.0
    c: object = 1.0
    d: object = 1.0

    def coefficients(self):
        return _one_term(*_as_tensors(self.a, self.b, self.c, self.d))


@dataclasses.dataclass(frozen=True)
class SHOTerm(CeleriteTerm):
    """Stochastically-driven harmonic oscillator, underdamped (Q > 1/2)."""

    S0: object = 1.0
    w0: object = 1.0
    Q: object = 2.0

    def coefficients(self):
        S0, w0, Q = _as_tensors(self.S0, self.w0, self.Q)
        eta = torch.sqrt(torch.clamp(4 * Q * Q - 1, min=1e-12))
        a = S0 * w0 * Q
        b = S0 * w0 * Q / eta
        c = w0 / (2 * Q)
        d = c * eta
        return _one_term(a, b, c, d)


def _relative_epochs(t, like):
    """Epochs relative to the first, shifted in their own dtype (float64
    for an array), as a 1-D tensor of `like`'s dtype and device."""
    t = torch.as_tensor(t, device=like.device)
    if not t.is_floating_point():
        t = t.to(torch.float64)
    return (t - t[:1]).to(like.dtype).reshape(-1)


def _flat_inputs(term, t, resid, var):
    """(a, b, c, d, t, y, var, batch): the coefficients as (B, J), the
    relative epochs (n,), residuals and variances as (B, n), every row
    axis broadcast and flattened into B; `batch` is the rows' shape."""
    y = torch.as_tensor(resid)
    var = torch.as_tensor(var, dtype=y.dtype, device=y.device)
    coefs = [x.to(dtype=y.dtype, device=y.device) for x in term.coefficients()]
    batch = torch.broadcast_shapes(y.shape[:-1], var.shape[:-1], coefs[0].shape[:-1])
    n, J = y.shape[-1], coefs[0].shape[-1]
    y = y.expand(batch + (n,)).reshape(-1, n)
    var = var.expand(batch + (n,)).reshape(-1, n)
    coefs = [x.expand(batch + (J,)).reshape(-1, J) for x in coefs]
    return (*coefs, _relative_epochs(t, y), y, var, batch)


def _celerite_plain(a, b, c, d, t, y, var):
    """The celerite log-likelihood of every row, the recursion written as
    a Python loop over the epochs of batched torch ops.

    a, b, c, d: (B, J); t: (n,), sorted; y, var: (B, n). Returns (B,).
    Per epoch k, with state size m = 2J and phi_k = exp(-c dt_k) twice:

        S_k = phi_k phi_k^T o (S_{k-1} + D_{k-1} W_{k-1} W_{k-1}^T)
        D_k = var_k + sum(a) - U_k . S_k U_k
        W_k = (V_k - S_k U_k) / D_k
        f_k = phi_k o (f_{k-1} + W_{k-1} z_{k-1})
        z_k = y_k - U_k . f_k

    and ll = -sum(z^2 / D)/2 - sum(log D)/2 - n log(2 pi)/2. A row with any
    D_k that is not positive gives -inf: from that epoch on its recursion
    carries D = 1 and W = 0, so that its state decays instead of growing
    without bound, and every value, and the row's zero gradient, stay
    finite."""
    B, n = y.shape
    arg = d[:, None, :] * t[None, :, None]                    # (B, n, J)
    cd, sd = torch.cos(arg), torch.sin(arg)
    a3, b3 = a[:, None, :], b[:, None, :]
    U = torch.cat([a3 * cd + b3 * sd, a3 * sd - b3 * cd], dim=-1)  # (B, n, 2J)
    V = torch.cat([cd, sd], dim=-1)
    dt = torch.diff(t, prepend=t[:1])
    phi = torch.exp(-c[:, None, :] * dt[None, :, None])
    phi = torch.cat([phi, phi], dim=-1)
    A = var + torch.sum(a, dim=-1, keepdim=True)
    m = U.shape[-1]
    S = y.new_zeros((B, m, m))
    W = y.new_zeros((B, m))
    f = y.new_zeros((B, m))
    D_prev = y.new_zeros((B,))
    z_prev = y.new_zeros((B,))
    alive = torch.ones((B,), dtype=torch.bool, device=y.device)
    Ds, zs = [], []
    for k in range(n):
        p, u = phi[:, k], U[:, k]
        S = p[:, :, None] * p[:, None, :] * (S + D_prev[:, None, None] * W[:, :, None] * W[:, None, :])
        Su = torch.einsum("bij,bj->bi", S, u)
        D = A[:, k] - torch.sum(u * Su, dim=-1)
        f = p * (f + W * z_prev[:, None])
        z = y[:, k] - torch.sum(u * f, dim=-1)
        alive = alive & (D > 0)
        D_prev = torch.where(alive, D, 1.0)
        W = torch.where(alive[:, None], (V[:, k] - Su) / D_prev[:, None], 0.0)
        z_prev = z
        Ds.append(D_prev)
        zs.append(z)
    D, z = torch.stack(Ds, dim=-1), torch.stack(zs, dim=-1)
    ll = (-0.5 * torch.sum(z * z / D, dim=-1) - 0.5 * torch.sum(torch.log(D), dim=-1)
          - 0.5 * n * _LOG_2PI)
    return torch.where(alive, ll, -torch.inf)


def celerite_loglike(term: CeleriteTerm, t, resid, var, *, fused=True):
    """log N(resid | 0, K_celerite(t) + diag(var)) in O(N J^2), one value
    per row: resid and var (..., n), t (n,) sorted (an array, or a tensor
    whose dtype the relative epochs are taken in).

    On a CUDA tensor with `fused` (the default) the CUDA kernel pair runs
    (`celerite_cuda.celerite_loglike_cuda`, J <= 4; a build or launch
    failure raises); otherwise `_celerite_plain`, whose composed ops also
    give higher derivatives. Non-positive-definite rows (any D <= 0, the
    reference's PosDefException, `rv-absolute.jl:229-239`) give -inf with
    a zero gradient row."""
    a, b, c, d, t, y, var, batch = _flat_inputs(term, t, resid, var)
    if y.device.type == "cuda" and fused:
        from .celerite_cuda import celerite_loglike_cuda

        ll = celerite_loglike_cuda(a, b, c, d, t, y, var)
    else:
        ll = _celerite_plain(a, b, c, d, t, y, var)
    return ll.reshape(batch)


# ----------------------------------------------------------------------
# associative-scan (parallel-in-time) path
# ----------------------------------------------------------------------

def associative_scan(combine, elems, dim):
    """Inclusive scan of the tuple of tensors `elems` along `dim` with the
    associative `combine(earlier, later)`, in O(log N) depth: the odd/even
    recursion of `jax.lax.associative_scan`. `combine` takes and returns
    tuples whose tensors have any length along `dim`."""
    def take(x, start, stop=None, step=1):
        index = [slice(None)] * x.ndim
        index[dim] = slice(start, stop, step)
        return x[tuple(index)]

    def interleave(even, odd):
        n_odd = odd.shape[dim]
        pairs = torch.stack([take(even, 0, n_odd), odd], dim=dim + 1)
        shape = list(even.shape)
        shape[dim] = 2 * n_odd
        out = pairs.reshape(shape)
        if even.shape[dim] > n_odd:
            out = torch.cat([out, take(even, n_odd)], dim=dim)
        return out

    def scan(xs):
        n = xs[0].shape[dim]
        if n < 2:
            return xs
        reduced = combine(tuple(take(x, 0, -1, 2) for x in xs), tuple(take(x, 1, None, 2) for x in xs))
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine(tuple(take(x, 0, -1) for x in odd), tuple(take(x, 2, None, 2) for x in xs))
        else:
            even = combine(odd, tuple(take(x, 2, None, 2) for x in xs))
        even = tuple(torch.cat([take(x, 0, 1), e], dim=dim) for x, e in zip(xs, even))
        return tuple(interleave(e, o) for e, o in zip(even, odd))

    return scan(tuple(elems))


def _term_ssm(a, b, c, d, t):
    """Exact linear-Gaussian state-space form of the celerite kernel.

    Each (a, b, c, d) term is a 2-D damped-rotation state with transition
    A(dt) = e^{-c dt} [[cos d dt, sin d dt], [-sin, cos]], measurement
    H = [1, 0] and stationary covariance P_inf = [[a, b], [b, a]]; then
    E[y(t+tau) y(t)] = [A(tau) P_inf]_00 = e^{-c tau}(a cos d tau + b sin
    d tau), the celerite kernel exactly. Terms stack block-diagonally. Valid
    when a >= |b| per term (every RealTerm; an SHOTerm with Q >= 1/sqrt(2);
    celerite2's default constraint).

    a, b, c, d: (B, J); t: (n,). Returns (F, Q, H) with F, Q (B, n, m, m)
    and H (m,), m = 2J, where the first step encodes the stationary prior
    (F_0 = 0, Q_0 = P_inf)."""
    B, J = a.shape
    m = 2 * J
    dt = torch.diff(t)                                            # (n-1,)
    decay = torch.exp(-c[:, None, :] * dt[None, :, None])         # (B, n-1, J)
    cosd = torch.cos(d[:, None, :] * dt[None, :, None])
    sind = torch.sin(d[:, None, :] * dt[None, :, None])
    rot = torch.stack([torch.stack([cosd, sind], dim=-1),
                       torch.stack([-sind, cosd], dim=-1)], dim=-2)  # (B, n-1, J, 2, 2)
    eye_J = torch.eye(J, dtype=a.dtype, device=a.device)
    F_blocks = torch.einsum("bkjrs,jl->bkjrls", decay[..., None, None] * rot, eye_J)
    F_blocks = F_blocks.reshape(B, -1, m, m)
    P_blocks = torch.stack([torch.stack([a, b], dim=-1), torch.stack([b, a], dim=-1)], dim=-2)
    P_inf = torch.einsum("bjrs,jl->bjrls", P_blocks, eye_J).reshape(B, m, m)
    H = torch.zeros(m, dtype=a.dtype, device=a.device)
    H[0::2] = 1.0
    Q_blocks = P_inf[:, None] - F_blocks @ P_inf[:, None] @ F_blocks.mT
    F = torch.cat([F_blocks.new_zeros((B, 1, m, m)), F_blocks], dim=1)
    Q = torch.cat([P_inf[:, None], Q_blocks], dim=1)
    return F, Q, H


def _kalman_combine(e1, e2):
    """Compose two filtering elements (A, b, C, eta, J), e1 the earlier
    (Sarkka & Garcia-Fernandez 2021)."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    m = A1.shape[-1]
    eye = torch.eye(m, dtype=A1.dtype, device=A1.device)
    mv = lambda M, v: (M @ v[..., None])[..., 0]  # noqa: E731
    # (I + C1 J2)^{-1} applied from the left
    M = torch.linalg.solve(eye + C1 @ J2, torch.cat(
        [A1, (b1 + mv(C1, eta2))[..., None], C1], dim=-1))
    MA1, Mb, MC1 = M[..., :m], M[..., m], M[..., m + 1:]
    A = A2 @ MA1
    b = mv(A2, Mb) + b2
    C = A2 @ MC1 @ A2.mT + C2
    # dual part: (I + J2 C1)^{-1}
    N = torch.linalg.solve(eye + J2 @ C1, torch.cat(
        [(eta2 - mv(J2, b1))[..., None], J2 @ A1], dim=-1))
    eta = mv(A1.mT, N[..., 0]) + eta1
    Jc = A1.mT @ N[..., 1:] + J1
    return A, b, C, eta, Jc


def celerite_loglike_assoc(term: CeleriteTerm, t, resid, var):
    """log N(resid | 0, K_celerite + diag(var)) by the parallel Kalman
    filter: the filtering recursion's affine-Gaussian elements compose
    associatively (Sarkka & Garcia-Fernandez 2021), so `associative_scan`
    gives every filtered state in O(log N) depth instead of the recursion's
    O(N). The same likelihood as `celerite_loglike` to float precision
    whenever the kernel has the stationary state-space form of `_term_ssm`
    (a >= |b| per term). Its (2J x 2J) solves multiply the work per row:
    for few rows and long series (MAP optimization, per-dataset cross
    validation), not for thousands of chains. Plain torch, no kernel; a row
    with a non-positive innovation variance gives -inf."""
    a, b, c, d, t, y, R, batch = _flat_inputs(term, t, resid, var)
    F, Q, H = _term_ssm(a, b, c, d, t)
    B, n = y.shape
    m = H.shape[0]

    # per-step associative elements (rank one: y is a scalar)
    QH = Q @ H
    S0 = QH @ H + R                                             # (B, n)
    K = QH / S0[..., None]                                      # (B, n, m)
    HF = torch.einsum("i,bnij->bnj", H, F)
    A_el = F - K[..., :, None] * HF[..., None, :]
    b_el = K * y[..., None]
    C_el = Q - K[..., :, None] * QH[..., None, :]
    eta_el = HF * (y / S0)[..., None]
    J_el = HF[..., :, None] * HF[..., None, :] / S0[..., None, None]

    _, m_f, P_f, _, _ = associative_scan(_kalman_combine, (A_el, b_el, C_el, eta_el, J_el), dim=1)

    # innovation log-likelihood: step i predicts from the filtered state of
    # step i-1 (step 0 from the prior, which element 0 encodes)
    m_prev = torch.cat([m_f.new_zeros((B, 1, m)), m_f[:, :-1]], dim=1)
    P_prev = torch.cat([P_f.new_zeros((B, 1, m, m)), P_f[:, :-1]], dim=1)
    m_pred = (F @ m_prev[..., None])[..., 0]
    P_pred = F @ P_prev @ F.mT + Q
    mu = m_pred @ H
    S = (P_pred @ H) @ H + R
    positive = S > 0
    S_safe = torch.where(positive, S, 1.0)
    ll = torch.sum(-0.5 * (y - mu) ** 2 / S_safe - 0.5 * torch.log(S_safe), dim=-1) - 0.5 * n * _LOG_2PI
    return torch.where(positive.all(dim=-1), ll, -torch.inf).reshape(batch)
