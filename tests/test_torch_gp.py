"""The port's Gaussian-process kernels and celerite solvers against the JAX
package in float64 on the CPU, and against dense multivariate normals.

Inputs are made with numpy from a seed and go through the JAX function and
its port. The port takes the chain axis written out: a kernel's
hyperparameters are (C,) tensors and residuals and variances (C, n), so
each of its rows is held to one JAX call with that row's numbers. JAX is
imported inside a fixture, so this file also imports on a machine without
JAX, where only the test marked `cuda` (the celerite kernel pair against
its plain version) is meant to run:

    python -m pytest --noconftest -q tests/test_torch_gp.py -m cuda

The kernels' schedule (chunks of epochs, checkpoints, the backward's
recomputation) and their step arithmetic (`rv/csrc/celerite.cuh`) are also
built for the host with g++ (`rv/csrc/celerite_host.cpp`) and held to the
plain version here on the CPU; those tests skip where g++ is missing.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.stats
import torch

from octofitter_tpu_torch.interop import gp_kernel_from_jax
from octofitter_tpu_torch.rv import celerite as cel
from octofitter_tpu_torch.rv import celerite_cuda as cc
from octofitter_tpu_torch.rv import kernels as ker

RTOL = 1e-10
C = 3  # rows (chains) of the port's batched calls

# name: (make(module, *hyperparameters), one row of hyperparameters per chain)
DENSE = {
    "sqexp": (lambda m, amp, ell: m.SqExponentialKernel(amplitude=amp, lengthscale=ell),
              [[1.5, 8.0], [0.7, 20.0], [2.2, 3.5]]),
    "matern32": (lambda m, amp, ell: m.Matern32Kernel(amplitude=amp, lengthscale=ell),
                 [[1.5, 8.0], [0.7, 20.0], [2.2, 3.5]]),
    "quasiperiodic": (lambda m, e1, e2, e3, e4: m.QuasiPeriodicKernel(eta1=e1, eta2=e2, eta3=e3, eta4=e4),
                      [[2.0, 20.0, 7.0, 0.5], [1.0, 40.0, 11.0, 0.3], [3.0, 15.0, 5.0, 0.8]]),
    "sum": (lambda m, amp, ell, a2: (m.SqExponentialKernel(amplitude=amp, lengthscale=ell)
                                     + m.Matern32Kernel(amplitude=a2, lengthscale=4.0)),
            [[1.5, 8.0, 0.5], [0.7, 20.0, 1.0], [2.2, 3.5, 0.2]]),
    "product": (lambda m, e1, e3, ell: (m.QuasiPeriodicKernel(eta1=e1, eta2=30.0, eta3=e3, eta4=0.6)
                                        * m.SqExponentialKernel(amplitude=1.0, lengthscale=ell)),
                [[2.0, 7.0, 50.0], [1.0, 11.0, 25.0], [3.0, 5.0, 80.0]]),
}

CELERITE = {
    "sho": lambda m, s: m.SHOTerm(S0=s, w0=0.5, Q=2.0),
    "real": lambda m, s: m.RealTerm(a=s, c=0.3),
    "sho+real": lambda m, s: m.SHOTerm(S0=s, w0=0.5, Q=2.0) + m.RealTerm(a=1.0, c=0.1),
    "complex": lambda m, s: m.ComplexTerm(a=s, b=0.5, c=0.2, d=0.7),
}
CELERITE_S = [1.5, 0.6, 3.0]


def _data(n, seed=0, t0=0.0, span=100.0):
    """Sorted epochs (n,), residuals and variances (C, n)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(t0, t0 + span, n))
    return t, rng.standard_normal((C, n)), rng.uniform(0.5, 2.0, (C, n))


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax, jax.numpy and the JAX package's GP modules."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from octofitter_tpu.rv import celerite, kernels

    return SimpleNamespace(jax=jax, jnp=jnp, cel=celerite, ker=kernels)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def _dense_logpdf(K, y):
    return scipy.stats.multivariate_normal(np.zeros(len(y)), K).logpdf(y)


@pytest.mark.parametrize("name", list(DENSE))
def test_dense_gp_loglike_and_predict_match_jax(jx, name):
    """`gp_loglike` per row within 1e-10 of JAX's and of the dense normal;
    `gp_predict`'s mean and variance at 7 new epochs within 1e-10 of JAX's;
    `matrix` gives (C, n, m)."""
    build, values = DENSE[name]
    t, y, var = _data(30)
    t_test = np.linspace(-5.0, 105.0, 7)
    hyper = torch.as_tensor(np.asarray(values))
    kt = build(ker, *hyper.unbind(-1))
    tt, yt, vt = (torch.as_tensor(x) for x in (t, y, var))
    assert kt.matrix(tt, torch.as_tensor(t_test)).shape == (C, 30, 7)
    ll_t = ker.gp_loglike(kt, tt, yt, vt).numpy()
    mean_t, pvar_t = (x.numpy() for x in ker.gp_predict(kt, tt, yt, vt, torch.as_tensor(t_test)))
    for row in range(C):
        kj = build(jx.ker, *values[row])
        ll_j = float(jx.ker.gp_loglike(kj, jx.jnp.asarray(t), jx.jnp.asarray(y[row]), jx.jnp.asarray(var[row])))
        K = np.asarray(kj.matrix(jx.jnp.asarray(t), jx.jnp.asarray(t))) + np.diag(var[row])
        assert _rel(ll_t[row], ll_j) < RTOL
        assert _rel(ll_t[row], _dense_logpdf(K, y[row])) < RTOL
        mean_j, pvar_j = jx.ker.gp_predict(kj, jx.jnp.asarray(t), jx.jnp.asarray(y[row]),
                                            jx.jnp.asarray(var[row]), jx.jnp.asarray(t_test))
        assert _rel(mean_t[row], mean_j) < RTOL
        assert _rel(pvar_t[row], pvar_j) < RTOL


def test_dense_gp_non_positive_definite_gate(jx):
    """A row whose K + diag(var) is not positive definite (here a negative
    variance) gives -inf and a zero, NaN-free gradient row, in the value,
    the hyperparameters and the residuals; the other rows are untouched.
    `gp_predict` gives NaN there, as the JAX package does."""
    t, y, var = _data(20, seed=1)
    var[1, 4] = -50.0
    amp = torch.tensor([1.5, 0.7, 2.2], dtype=torch.float64, requires_grad=True)
    yt = torch.as_tensor(y).requires_grad_(True)
    kt = ker.SqExponentialKernel(amplitude=amp, lengthscale=8.0)
    ll = ker.gp_loglike(kt, torch.as_tensor(t), yt, torch.as_tensor(var))
    assert ll[1] == -torch.inf and torch.isfinite(ll[[0, 2]]).all()
    g_amp, g_y = torch.autograd.grad(torch.where(torch.isfinite(ll), ll, 0.0).sum(), (amp, yt))
    assert torch.isfinite(g_amp).all() and torch.isfinite(g_y).all()
    assert g_amp[1] == 0 and (g_y[1] == 0).all() and (g_y[0] != 0).any()
    ll_j = float(jx.ker.gp_loglike(jx.ker.SqExponentialKernel(amplitude=2.2, lengthscale=8.0),
                                    jx.jnp.asarray(t), jx.jnp.asarray(y[2]), jx.jnp.asarray(var[2])))
    assert _rel(ll[2].detach().numpy(), ll_j) < RTOL
    mean, pvar = ker.gp_predict(kt, torch.as_tensor(t), yt, torch.as_tensor(var),
                                torch.tensor([3.0, 50.0], dtype=torch.float64))
    assert torch.isnan(mean[1]).all() and torch.isnan(pvar[1]).all()
    assert torch.isfinite(mean[[0, 2]]).all()


def _jax_rows(jx, fn):
    """`fn` of one row's arguments, vmapped over rows and jitted: one XLA
    compile for the C rows (the JAX functions are slow op by op)."""
    return jx.jax.jit(jx.jax.vmap(fn))


@pytest.mark.parametrize("name", list(CELERITE))
def test_celerite_scan_and_assoc_match_jax_and_dense(jx, name):
    """`celerite_loglike` and `celerite_loglike_assoc` per row within 1e-10
    of JAX's scan and associative paths and of the dense normal on the
    term's own matrix, at 64 epochs in MJD (the port shifts them to the
    first epoch in float64; JAX takes them as they are); `coefficients()`
    gives (C, J)."""
    build = CELERITE[name]
    t, y, var = _data(64, seed=2, t0=57000.0)
    s = torch.as_tensor(CELERITE_S, dtype=torch.float64)
    term = build(cel, s)
    assert term.coefficients()[0].shape[0] == C
    yt, vt = torch.as_tensor(y), torch.as_tensor(var)
    ll_scan = cel.celerite_loglike(term, t, yt, vt).numpy()
    ll_assoc = cel.celerite_loglike_assoc(term, t, yt, vt).numpy()
    tj = jx.jnp.asarray(t)
    jax_args = (jx.jnp.asarray(CELERITE_S), jx.jnp.asarray(y), jx.jnp.asarray(var))
    for port, jfn in ((ll_scan, jx.cel.celerite_loglike), (ll_assoc, jx.cel.celerite_loglike_assoc)):
        ll_j = _jax_rows(jx, lambda sj, yj, vj: jfn(build(jx.cel, sj), tj, yj, vj))(*jax_args)
        assert _rel(port, ll_j) < RTOL, jfn.__name__
    K = term.matrix(torch.as_tensor(t), torch.as_tensor(t)).numpy() + var[:, :, None] * np.eye(64)
    dense = [_dense_logpdf(K[row], y[row]) for row in range(C)]
    assert _rel(ll_scan, dense) < RTOL
    assert _rel(ll_assoc, dense) < RTOL


@pytest.mark.parametrize("method", ["scan", "associative"])
def test_celerite_gradients_match_jax(jx, method):
    """Gradients of an SHOTerm's log-likelihood with respect to S0, w0, Q,
    the residuals and the variances, per row, within 1e-10 of jax.grad
    (relative to the largest entry of each gradient, and at least 1)."""
    t, y, var = _data(48, seed=3, t0=57000.0)
    S0 = np.array([1.5, 0.6, 3.0])
    w0 = np.array([0.5, 0.9, 0.2])
    Q = np.array([2.0, 3.0, 1.2])
    xs = [torch.as_tensor(v).requires_grad_(True) for v in (S0, w0, Q, y, var)]
    fn = cel.celerite_loglike if method == "scan" else cel.celerite_loglike_assoc
    ll = fn(cel.SHOTerm(S0=xs[0], w0=xs[1], Q=xs[2]), t, xs[3], xs[4])
    grads = [g.numpy() for g in torch.autograd.grad(ll.sum(), xs)]
    jfn = jx.cel.celerite_loglike if method == "scan" else jx.cel.celerite_loglike_assoc
    tj = jx.jnp.asarray(t)

    def f(s, w, q, yy, vv):
        return jfn(jx.cel.SHOTerm(S0=s, w0=w, Q=q), tj, yy, vv)

    gj = _jax_rows(jx, jx.jax.grad(f, argnums=(0, 1, 2, 3, 4)))(
        *(jx.jnp.asarray(v) for v in (S0, w0, Q, y, var)))
    for k, g in enumerate(gj):
        g = np.asarray(g).reshape(C, -1)
        scale = np.maximum(np.abs(g).max(axis=-1), 1.0)
        err = np.abs(grads[k].reshape(C, -1) - g).max(axis=-1) / scale
        assert err.max() < RTOL, (method, k, err)


def test_celerite_float32_gate_and_relative_epochs():
    """In float32: rows with a non-positive D (a term with b >> a and tiny
    variances) give -inf and a zero, finite gradient row, and the other
    rows agree with float64 to float32's precision, at MJD epochs, which
    the port shifts to the first in float64 before the cast (unshifted,
    cos(d t) at t ~ 57,000 would be off by ~1e-2 rad)."""
    t, y, var = _data(40, seed=4, t0=57000.0)
    a = np.array([1.5, 1.0, 2.0, 0.8])
    b = np.array([0.3, 8.0, 0.2, 0.1])
    y = np.concatenate([y, y[:1]])
    var = np.concatenate([var, var[:1]])
    var[1] = 1e-4
    ll64 = cel.celerite_loglike(cel.ComplexTerm(a=a, b=b, c=0.05, d=1.7), t,
                                torch.as_tensor(y), torch.as_tensor(var))
    xs = [torch.as_tensor(v, dtype=torch.float32).requires_grad_(True) for v in (a, b, y, var)]
    ll32 = cel.celerite_loglike(cel.ComplexTerm(a=xs[0], b=xs[1], c=0.05, d=1.7), t, xs[2], xs[3])
    assert ll32.dtype == torch.float32
    assert ll32[1] == -torch.inf and ll64[1] == -torch.inf
    ok = torch.tensor([True, False, True, True])
    assert torch.isfinite(ll32[ok]).all()
    assert float((ll32[ok].double() - ll64[ok]).abs().max()) < 1e-5 * float(ll64[ok].abs().max())
    grads = torch.autograd.grad(torch.where(ok, ll32, 0.0).sum(), xs)
    for g in grads:
        assert torch.isfinite(g).all() and (g[1] == 0).all()
        assert (g[ok] != 0).any()


def test_celerite_sum_of_tensor_and_number_terms():
    """A sum of a term built from float32 per-row tensors and one built
    from plain numbers (float64 on the CPU) takes the tensors' dtype, in its
    coefficients, its matrix and its log-likelihood, and agrees with the
    same sum in float64 to float32 precision."""
    S0 = torch.tensor([1.5, 0.6, 3.0])
    t, y, var = _data(30, seed=6, t0=57000.0)
    term32 = cel.SHOTerm(S0=S0, w0=0.5, Q=2.0) + cel.RealTerm(a=1.0, c=0.1)
    term64 = cel.SHOTerm(S0=S0.double(), w0=0.5, Q=2.0) + cel.RealTerm(a=1.0, c=0.1)
    assert all(x.dtype == torch.float32 and x.shape == (C, 2) for x in term32.coefficients())
    t32 = torch.as_tensor(t - t[0], dtype=torch.float32)
    assert term32.matrix(t32, t32).dtype == torch.float32
    ll32 = cel.celerite_loglike(term32, t, torch.as_tensor(y, dtype=torch.float32),
                                torch.as_tensor(var, dtype=torch.float32))
    ll64 = cel.celerite_loglike(term64, t, torch.as_tensor(y), torch.as_tensor(var))
    assert ll32.dtype == torch.float32
    assert float((ll32.double() - ll64).abs().max()) < 1e-5 * float(ll64.abs().max())


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_associative_scan_is_an_inclusive_scan(n):
    """The log-depth helper gives every prefix of an associative,
    non-commutative combine (2 x 2 matrix products, earlier on the right),
    along a middle axis, as a running product does."""
    rng = np.random.default_rng(n)
    M = torch.as_tensor(rng.standard_normal((3, n, 2, 2)))
    (out,) = cel.associative_scan(lambda e1, e2: (e2[0] @ e1[0],), (M,), dim=1)
    ref, acc = [], None
    for k in range(n):
        acc = M[:, k] if acc is None else M[:, k] @ acc
        ref.append(acc)
    np.testing.assert_allclose(out.numpy(), torch.stack(ref, dim=1).numpy(), rtol=1e-12, atol=1e-12)


def test_gp_kernel_from_jax(jx):
    """A JAX sum of kernels and a JAX sum of celerite terms, with numpy
    fields, rebuilt in the port give the JAX matrices and log-likelihoods."""
    t, y, var = _data(25, seed=5, t0=57000.0)
    tj = jx.jnp.asarray(t)
    dense_j = (jx.ker.QuasiPeriodicKernel(eta1=np.float64(2.0), eta2=np.float64(20.0),
                                           eta3=np.float64(7.0), eta4=np.float64(0.5))
               + jx.ker.Matern32Kernel(amplitude=np.float64(0.5), lengthscale=np.float64(4.0)))
    cel_j = jx.cel.SHOTerm(S0=np.float64(1.5), w0=np.float64(0.5), Q=np.float64(2.0)) + \
        jx.cel.RealTerm(a=np.float64(1.0), c=np.float64(0.1))
    dense_t = gp_kernel_from_jax(dense_j, device="cpu")
    cel_t = gp_kernel_from_jax(cel_j, device="cpu")
    assert isinstance(dense_t, ker.SumKernel) and isinstance(cel_t, cel.CeleriteSum)
    tt = torch.as_tensor(t)
    np.testing.assert_allclose(dense_t.matrix(tt, tt).numpy(), np.asarray(dense_j.matrix(tj, tj)),
                               rtol=1e-12)
    for kt, kj in ((dense_t, dense_j), (cel_t, cel_j)):
        ll_t = float(ker.gp_loglike(kt, tt, torch.as_tensor(y[0]), torch.as_tensor(var[0])))
        ll_j = float(jx.ker.gp_loglike(kj, tj, jx.jnp.asarray(y[0]), jx.jnp.asarray(var[0])))
        assert _rel(ll_t, ll_j) < RTOL
    with pytest.raises(TypeError):
        gp_kernel_from_jax(object(), device="cpu")


def _worst_rows(outs, refs, ok):
    """For each output, the worst row's max |out - ref| against the row's
    largest |ref| entry (at least 1), over the rows `ok`."""
    errs = []
    for x, r in zip(outs, refs):
        x, r = x.detach().reshape(x.shape[0], -1).double(), r.detach().reshape(r.shape[0], -1).double()
        err = (x - r).abs().amax(dim=-1) / r.abs().amax(dim=-1).clamp(min=1.0)
        errs.append(float(err[ok].max()))
    return errs


def _kernel_pair_inputs(rng, B, n, J, edge_rows):
    """Coefficients (B, J) over the RV-GP model's prior ranges (an SHOTerm,
    then alternately a RealTerm and another SHOTerm), sorted relative epochs
    (n,) over 183 days, residuals and variances (B, n), and a cotangent (B,);
    the rows `edge_rows` made non-positive-definite (first term a = 10, b =
    50; variances 1e-4)."""
    terms = []
    for j in range(J):
        if j % 2 == 0:
            S0 = np.exp(rng.uniform(np.log(0.1), np.log(100.0), B))
            w0 = np.exp(rng.uniform(np.log(0.01), np.log(2.0), B))
            Q = rng.uniform(0.8, 5.0, B)
            eta = np.sqrt(4 * Q * Q - 1)
            a, c = S0 * w0 * Q, w0 / (2 * Q)
            terms.append((a, a / eta, c, c * eta))
        else:
            terms.append((rng.uniform(0.1, 30.0, B), np.zeros(B), rng.uniform(0.01, 1.0, B),
                          np.zeros(B)))
    coefs = [np.stack(x, axis=-1) for x in zip(*terms)]
    coefs[0][edge_rows, 0], coefs[1][edge_rows, 0] = 10.0, 50.0
    t = np.sort(rng.uniform(0.0, 183.0, n))
    t -= t[0]
    y = 3.0 * rng.standard_normal((B, n))
    var = rng.uniform(1.0, 6.0, (B, n))
    var[edge_rows] = 1e-4
    return coefs, t, y, var, rng.uniform(0.5, 1.5, B)


@pytest.fixture(scope="module")
def host_schedule(tmp_path_factory):
    """`rv/csrc/celerite_host.cpp` (the kernels' schedule and `celerite.cuh`'s
    arithmetic on the host) built with g++ and loaded; skips without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host schedule of the celerite kernels")
    source = Path(cc.SOURCE).with_name("celerite_host.cpp")
    out = tmp_path_factory.mktemp("celerite_host") / "libcelerite_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(out), str(source)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.celerite_host_fwd_f64.argtypes = [ptr] * 9 + [i32, i64, i64, i32]
    lib.celerite_host_bwd_f64.argtypes = [ptr] * 16 + [i32, i64, i64, i32]
    lib.celerite_host_checkpoint_words.argtypes = [i32]
    return lib


def _host_pair(lib, coefs, t, y, var, gll, chunk):
    """The host schedule's forward (with checkpoints) and backward: ll, the
    six gradients and the checkpoints."""
    B, J = coefs[0].shape
    n = t.shape[0]
    ins = [torch.as_tensor(x, dtype=torch.float64).contiguous() for x in (*coefs, t, y, var)]
    ll = torch.empty(B, dtype=torch.float64)
    ckpt = torch.full(cc.checkpoint_shape(B, n, J, chunk), torch.nan, dtype=torch.float64)
    ck = ckpt.data_ptr() if ckpt.numel() else None
    assert lib.celerite_host_fwd_f64(*(x.data_ptr() for x in ins), ll.data_ptr(), ck,
                                     J, B, n, chunk) == 0
    grads = [torch.empty((B, J), dtype=torch.float64) for _ in range(4)]
    grads += [torch.empty((B, n), dtype=torch.float64) for _ in range(2)]
    g = torch.as_tensor(gll, dtype=torch.float64)
    assert lib.celerite_host_bwd_f64(*(x.data_ptr() for x in ins), ck, ll.data_ptr(),
                                     g.data_ptr(), *(x.data_ptr() for x in grads),
                                     J, B, n, chunk) == 0
    return ll, grads, ckpt


@pytest.mark.parametrize("J", [1, 2, 3, 4])
def test_celerite_host_schedule_matches_plain(host_schedule, J):
    """The kernels' chunked forward and checkpoint-recompute backward, built
    for the host, against the plain version and autograd through it in
    float64 within 1e-10 (ll per row against max(|ll|, 1), each gradient per
    row against its largest entry and 1), at the kernels' own float64 chunk
    lengths C (for few and for many rows) and at C = 2, with n = 1 and n below, at and across C; one row
    non-positive-definite at the first epoch and one at the last (the first
    and the last chunk), which give -inf and zero gradients in both. The
    checkpoints fill `checkpoint_shape` (none where n <= C), whose record is
    the header's."""
    assert host_schedule.celerite_host_checkpoint_words(J) == cc.checkpoint_words(J)
    rng = np.random.default_rng(10 + J)
    B = 5
    chunks = {cc.chunk_epochs(J, torch.float64, B) for B in (1, cc.MANY_ROWS)}
    for chunk in sorted(chunks | {2}):
        for n in sorted({1, max(chunk - 1, 1), chunk, chunk + 1, 3 * chunk - 1}):
            coefs, t, y, var, gll = _kernel_pair_inputs(rng, B, n, J, [])
            asum = coefs[0].sum(axis=-1)
            var[1, 0] = -2.0 * asum[1] - 1.0  # D_0 < 0
            var[3, n - 1] = -2.0 * asum[3] - 1.0
            ll, grads, ckpt = _host_pair(host_schedule, coefs, t, y, var, gll, chunk)
            assert ckpt.shape == (max(-(-n // chunk) - 1, 0), cc.checkpoint_words(J), B)
            assert not torch.isnan(ckpt).any()
            xs = [torch.as_tensor(x).requires_grad_(True) for x in (*coefs, y, var)]
            ll_p = cel._celerite_plain(*xs[:4], torch.as_tensor(t), *xs[4:])
            ok = torch.isfinite(ll_p)
            assert torch.equal(ok, torch.isfinite(ll)) and ok.tolist() == [True, False, True, False, True]
            g_p = torch.autograd.grad(torch.where(ok, ll_p, 0.0) @ torch.as_tensor(gll), xs)
            for g in grads:
                assert torch.isfinite(g).all() and (g[~ok] == 0).all()
            errs = _worst_rows([ll[:, None], *grads], [ll_p[:, None], *g_p], ok)
            assert max(errs) <= RTOL, (chunk, n, errs)


def test_checkpoint_shape_is_one_record_per_chunk_but_the_last():
    """The forward's checkpoint allocation: ceil(n / C) - 1 records of
    m(m+1)/2 + 2m + 2 words per row (none where n <= C), at most ceil(n / C)
    records; the default chunk lengths are whole 16-byte copies, and no
    longer for many rows than for few."""
    for J, words in ((1, 9), (2, 20), (3, 35), (4, 54)):
        assert cc.checkpoint_words(J) == words
        for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
            few, many = (cc.chunk_epochs(J, dtype, B) for B in (4096, cc.MANY_ROWS))
            assert many <= few
            for B, C in ((4096, few), (cc.MANY_ROWS, many)):
                assert C > 0 and (C * size) % 16 == 0
                for n, records in ((1, 0), (C, 0), (C + 1, 1), (80, -(-80 // C) - 1),
                                   (2048, -(-2048 // C) - 1)):
                    shape = cc.checkpoint_shape(B, n, J, C)
                    assert shape == (records, words, B) and records <= -(-n // C)


@pytest.mark.cuda
def test_celerite_kernel_pair_matches_plain():
    """On the card: the CUDA forward and backward against the plain version
    and autograd through it, with coefficients over the RV-GP model's prior
    ranges: J = 1 and 2 at (300, 80) (300 rows, no multiple of a block's 16;
    80 epochs, no multiple of the float32 chunk of 32), J = 3 at (301, 37)
    and J = 4 at (77, 37) (37 epochs, odd, so most rows do not start on a
    16-byte boundary), J = 1 at (45, 5) (one chunk, no checkpoint), and the
    many-rows chunks (8 epochs in float32, 4 in float64) at (16,421, 37)
    and (33,797, 21), whose tiles on an H100's SMs are 32 rows, and 128
    (forward) and 64 (backward) rows, each with a partial last tile; with
    3 non-positive-definite rows at the start, one inside a later tile and
    one in the last tile, which must give -inf and zero gradients in both.
    Float64 within 1e-10
    (log-likelihood and every gradient, the worst row against the row's
    largest entry); float32 within 4 times the plain version's own float32
    error against float64 on the same inputs, and at least 1e-5 (ll) and
    1e-4 (gradients), the rule of `chip_smoke.py`. Each call launches each
    kernel once, and the forward allocates `checkpoint_shape`; the tiles
    run 16 to 128 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")

    rng = np.random.default_rng(0)
    tile_rows = set()
    for B, n, J in ((300, 80, 1), (300, 80, 2), (301, 37, 3), (77, 37, 4), (45, 5, 1),
                    (16421, 37, 1), (33797, 21, 1)):
        edge = [0, 1, 2, min(B - 1, 21), B - 2]
        coefs, t, y, var, _ = _kernel_pair_inputs(rng, B, n, J, edge)
        results = {}
        for dtype in (torch.float64, torch.float32):
            to = lambda x: torch.as_tensor(x, dtype=dtype, device="cuda")  # noqa: E731
            xs = [to(x).requires_grad_(True) for x in (*coefs, y, var)]
            _, ckpt = cc.celerite_forward_cuda(*(x.detach() for x in xs[:4]), to(t),
                                               *(x.detach() for x in xs[4:]), save=True)
            assert ckpt.shape == cc.checkpoint_shape(B, n, J, cc.chunk_epochs(J, dtype, B))
            tile_rows |= {cc.occupancy(B, J, dtype, bwd)["rows_per_block"] for bwd in (0, 1)}
            before = (cc.launches_fwd, cc.launches_bwd)
            ll_k = cc.celerite_loglike_cuda(*xs[:4], to(t), *xs[4:])
            g_k = torch.autograd.grad(ll_k.where(torch.isfinite(ll_k), 0.0).sum(), xs)
            assert (cc.launches_fwd, cc.launches_bwd) == (before[0] + 1, before[1] + 1)
            ll_p = cel._celerite_plain(*xs[:4], to(t), *xs[4:])
            g_p = torch.autograd.grad(ll_p.where(torch.isfinite(ll_p), 0.0).sum(), xs)
            ok = torch.isfinite(ll_p)
            assert torch.equal(ok, torch.isfinite(ll_k)) and int((~ok).sum()) >= len(set(edge))
            for gk in g_k:
                assert torch.isfinite(gk).all() and (gk[~ok] == 0).all()
            results[dtype] = ([ll_k[:, None], *g_k], [ll_p[:, None], *g_p], ok)
        k64, p64, ok = results[torch.float64]
        assert max(_worst_rows(k64, p64, ok)) <= 1e-10, (B, n, J)
        k32, p32, ok32 = results[torch.float32]
        assert torch.equal(ok32, ok)
        errs = _worst_rows(k32, p32, ok)
        own = _worst_rows(p32, p64, ok)
        for i, (err, o) in enumerate(zip(errs, own)):
            assert err <= max(4.0 * o, 1e-5 if i == 0 else 1e-4), (B, n, J, i, err, o)
    assert {16, 32, 128} <= tile_rows, tile_rows
