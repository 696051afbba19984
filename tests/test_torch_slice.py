"""The port's headline fit end to end against the JAX package, on the CPU.

`initialize` and `octofit` run on the benchmark's headline model
(`bench.py:build_model`) in float64 at small sizes in both packages.
Initialization is deterministic up to the optimizers' tolerance, so its
results are compared as numbers; the samplers draw from different random
streams, so their posteriors are compared statistically.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import octofitter_tpu as oc
import octofitter_tpu_torch as ot
from octofitter_tpu_torch.interop import load_jax_state
from octofitter_tpu_torch.model.initialization import laplace

from test_torch_model import bench_table, build_bench, jax_bench_model

INIT_SIZES = dict(n_prior_samples=2000, n_multistart=32, n_opt_steps=200, n_draws=200)
CHAINS, WARMUP, DRAWS = 128, 150, 300


@pytest.fixture(scope="module")
def table():
    return bench_table()


@pytest.fixture(scope="module")
def initialized(table):
    """Both packages' models after their initialization pipelines, and
    their modes. The JAX run (mostly XLA compiling, which releases the
    GIL) overlaps the port's eager one; the two share no state."""
    mj, mt = jax_bench_model(), build_bench(ot, table, device="cpu")
    with ThreadPoolExecutor(1) as pool:
        future_j = pool.submit(mj.initialize, jax.random.PRNGKey(0), verbosity=0, **INIT_SIZES)
        mode_t = mt.initialize(torch.Generator().manual_seed(0), verbosity=0, **INIT_SIZES)
        mode_j = np.array(future_j.result(timeout=600))
    return mj, mode_j, mt, mode_t


def test_initialize_matches_jax(initialized):
    """Prior search -> multistart Adam -> L-BFGS-B -> Laplace in the port
    finds the JAX mode: log posterior within 1e-3, and every coordinate
    within 0.05 posterior sd. Both L-BFGS-B runs stop at scipy's default
    tolerances with |grad| near 0.07, so the two modes differ by up to
    ~0.01 sd, and the Laplace covariances taken at them by ~2e-3
    relative. The Laplace step is therefore held to the JAX package's at
    the JAX mode: 1e-10 relative (Frobenius norm), as both run the same
    float64 arithmetic."""
    mj, mode_j, mt, mode_t = initialized
    lp_t = float(mt.ln_post(mode_t))
    lp_j = float(mj.ln_post(jax.numpy.asarray(mode_j)))
    assert abs(lp_t - lp_j) < 1e-3, (lp_t, lp_j)
    sig_j = np.asarray(mj.laplace_sigma)
    sd_j = np.sqrt(np.diag(sig_j))
    assert (np.abs(mode_t.numpy() - mode_j) < 0.05 * sd_j).all()
    sig_t, _ = laplace(mt, mode_j)
    assert np.linalg.norm(sig_t - sig_j) <= 1e-10 * np.linalg.norm(sig_j)
    np.testing.assert_allclose(mt.laplace_sigma.numpy(), laplace(mt, mode_t.numpy())[0],
                               rtol=0, atol=0)
    pts = mt.starting_points
    assert pts.shape == (INIT_SIZES["n_draws"], mt.D)
    assert torch.isfinite(mt.ln_post(pts)).all()


def _summaries(chain, names):
    """Per-parameter posterior mean, sd, bulk ESS and split-R-hat."""
    x = np.stack([chain[n] for n in names], axis=-1)
    ess, rhat = ot.ess_rhat_batch(x)
    flat = x.reshape(-1, len(names))
    return flat.mean(axis=0), flat.std(axis=0), ess, rhat


def test_octofit_matches_jax_posterior(table, initialized):
    """Both samplers start from the JAX initialization (carried across by
    `interop.load_jax_state` to a fresh port model) and run ChEES at the
    same sizes. Every parameter's posterior mean agrees within 4 combined
    Monte-Carlo standard errors (sd / sqrt(ESS) from each run), and both
    runs have max split-R-hat < 1.05."""
    mj = initialized[0]
    mt = build_bench(ot, table, device="cpu")
    load_jax_state(
        mt,
        parameter_names=mj.parameter_names,
        starting_points=np.asarray(mj.starting_points),
        laplace_sigma=np.asarray(mj.laplace_sigma),
    )
    np.testing.assert_array_equal(mt.starting_points.numpy(), np.asarray(mj.starting_points))

    # the JAX run (mostly XLA compiling, which releases the GIL) overlaps
    # the port's eager one; the two share no state
    with ThreadPoolExecutor(1) as pool:
        future_j = pool.submit(oc.octofit, mj, chains=CHAINS, adaptation=WARMUP,
                               iterations=DRAWS, key=jax.random.PRNGKey(2), verbosity=0)
        chain_t = ot.octofit(mt, chains=CHAINS, adaptation=WARMUP, iterations=DRAWS,
                             generator=torch.Generator().manual_seed(2), verbosity=0)
        chain_j = future_j.result(timeout=600)
    names = mt.parameter_names
    assert chain_t["b_a"].shape == (CHAINS, DRAWS)
    for extra in ("b_tp", "b_omega", "b_Omega", "b_theta", "logpost"):
        assert chain_t[extra].shape == (CHAINS, DRAWS)
    mean_t, sd_t, ess_t, rhat_t = _summaries(chain_t, names)
    mean_j, sd_j, ess_j, rhat_j = _summaries(chain_j, names)
    assert np.isfinite(mean_t).all()
    assert rhat_t.max() < 1.05 and rhat_j.max() < 1.05, (rhat_t, rhat_j)
    mcse = np.hypot(sd_t / np.sqrt(ess_t), sd_j / np.sqrt(ess_j))
    z = np.abs(mean_t - mean_j) / mcse
    assert (z < 4).all(), dict(zip(names, z))
    # the derived tp too, by the same rule with its own ESS
    (tp_mean_t, tp_sd_t, tp_ess_t, _), (tp_mean_j, tp_sd_j, tp_ess_j, _) = (
        _summaries(c, ["b_tp"]) for c in (chain_t, chain_j))
    assert abs(tp_mean_t - tp_mean_j)[0] < 4 * np.hypot(
        tp_sd_t / np.sqrt(tp_ess_t), tp_sd_j / np.sqrt(tp_ess_j))[0]
