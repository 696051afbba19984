"""The port's device diagnostics (`ess_rhat_batch_device`) against the
numpy oracle `ess_rhat_batch` and the JAX package's own device version,
on the CPU: the cases of tests/test_chains_batch.py (ties, degenerate
rows, 2-D input, short chains, float32 past S = 2^23)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octofitter_tpu.chains import ess_rhat_batch_device as jax_ess_rhat_batch_device
from octofitter_tpu_torch.chains import ess_rhat_batch, ess_rhat_batch_device


def _make_chains(seed=0, m=8, n=512, p=6):
    """AR(1) chains with per-parameter autocorrelation and per-chain mean
    offsets, so that ESS < m n and R-hat > 1 (tests/test_chains_batch.py)."""
    rng = np.random.default_rng(seed)
    phi = np.linspace(0.0, 0.9, p)
    eps = rng.standard_normal((m, n, p))
    x = np.empty((m, n, p))
    x[:, 0] = eps[:, 0]
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + eps[:, t]
    return x + 0.3 * rng.standard_normal((m, 1, p))


def _with_ties_and_degenerate_rows():
    """MH-style repeated draws, multi-way ties, a constant and a
    non-finite parameter."""
    rng = np.random.default_rng(11)
    x = _make_chains(seed=6, p=5)
    rej = rng.random(x.shape) < 0.3
    for t in range(1, x.shape[1]):
        x[:, t] = np.where(rej[:, t], x[:, t - 1], x[:, t])
    x[:, :, 2] = np.round(x[:, :, 2] * 2.0) / 2.0   # multi-way ties
    x[:, :, 3] = 7.0                                 # constant -> nan
    x[0, 5, 4] = np.nan                              # non-finite -> nan
    return x


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_device_matches_numpy_oracle(as_tensor):
    """Float64 on the CPU: ESS and R-hat within 1e-12 (relative, ESS being
    of order m n) of the numpy oracle, NaN for the degenerate rows; a
    numpy array and a CPU tensor give the same numbers."""
    x = _with_ties_and_degenerate_rows()
    arg = torch.as_tensor(x) if as_tensor else x
    ess_d, rhat_d = ess_rhat_batch_device(arg, device="cpu")
    ess_b, rhat_b = ess_rhat_batch(x)
    np.testing.assert_allclose(ess_d, ess_b, rtol=1e-12)
    np.testing.assert_allclose(rhat_d, rhat_b, rtol=0, atol=1e-12)
    assert np.isnan(ess_d[3:]).all() and np.isnan(rhat_d[3:]).all()


def test_device_matches_jax_device_version():
    """The same float64 inputs through the JAX package's
    `ess_rhat_batch_device` (on the CPU) agree to 1e-12."""
    x = _with_ties_and_degenerate_rows()
    ess_t, rhat_t = ess_rhat_batch_device(x, device="cpu")
    ess_j, rhat_j = jax_ess_rhat_batch_device(jnp.asarray(x))
    np.testing.assert_allclose(ess_t, ess_j, rtol=1e-12)
    np.testing.assert_allclose(rhat_t, rhat_j, rtol=0, atol=1e-12)


def test_device_accepts_2d_and_short():
    x = _make_chains(seed=2, p=1)[:, :, 0]
    ess_d, rhat_d = ess_rhat_batch_device(x, device="cpu")
    ess_b, rhat_b = ess_rhat_batch(x)
    np.testing.assert_allclose(ess_d, ess_b, rtol=1e-12)
    np.testing.assert_allclose(rhat_d, rhat_b, rtol=1e-12)
    e, r = ess_rhat_batch_device(np.zeros((4, 3, 2)), device="cpu")   # n < 4
    assert e.shape == (2,) and np.isnan(e).all() and np.isnan(r).all()


def test_device_f32_large_s_no_ndtri_saturation():
    """Float32 at S = 1024 chains x 8200 draws, just past 2^23, one
    parameter: there the plain Blom argument (r - 3/8) / (S + 1/4) rounds
    to 1.0 for the top rank, even with correctly rounded division, so
    ndtri gives +inf, R-hat NaN and ESS exactly m n; the upper tail
    evaluated as -ndtri(1 - p), with 2S - k in int64, keeps every score
    finite. Tolerances as the JAX package's test of the same case."""
    rng = np.random.default_rng(3)
    m, n = 1024, 8200
    x = (rng.standard_normal((m, n, 1)).cumsum(axis=1) * 0.02
         + rng.standard_normal((m, 1, 1)))
    ess_d, rhat_d = ess_rhat_batch_device(x.astype(np.float32), device="cpu")
    assert np.isfinite(ess_d).all() and np.isfinite(rhat_d).all()
    assert not np.allclose(ess_d[0], m * n)   # the saturation signature
    ess_h, rhat_h = ess_rhat_batch(x)
    np.testing.assert_allclose(ess_d, ess_h, rtol=2e-3)
    np.testing.assert_allclose(rhat_d, rhat_h, rtol=1e-4)


def test_default_device_is_the_gpu():
    """A numpy input goes to the GPU unless the caller asks for the CPU;
    with no CUDA device that raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ess_rhat_batch_device(_make_chains(p=1))
