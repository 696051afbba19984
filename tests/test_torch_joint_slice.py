"""A short joint astrometry + HGCA + marginalized-RV fit in both packages,
on the CPU in float64, compared by posterior statistics.

The JAX model is `examples/02_joint_astrom_pma_rv.py:build_model`; the
port's is `chip_smoke.build_joint_model` on `chip_smoke.joint_data`, which
tests/test_torch_hgca_rv.py holds to the example's tables. The starting
state is the initialization's last stage taken at the truth rather than at
an optimized mode (which may be a local one, and costs most of the time):
the port's Laplace covariance there and draws from it. It is set as the
JAX model's state, `interop.load_jax_state` carries that state (after
checking the parameter order) to a fresh port model, and both packages run
ChEES from the same starting points with their own random streams.
"""

import importlib.util
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octofitter_tpu as oc
import octofitter_tpu_torch as ot
from octofitter_tpu_torch.interop import load_jax_state
from octofitter_tpu_torch.model.initialization import laplace

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
CHAINS, WARMUP, DRAWS = 64, 100, 100


def _jax_example_model():
    spec = importlib.util.spec_from_file_location(
        "example_02", ROOT / "examples" / "02_joint_astrom_pma_rv.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example.build_model()[0]


def _median_and_mcse(x):
    """Posterior median and its Monte-Carlo standard error, sqrt(pi / 2)
    sd / sqrt(ESS) (the median's asymptotic error for a normal posterior,
    with the bulk ESS for the draw count), and max split-R-hat."""
    ess, rhat = ot.ess_rhat_batch(x)
    return float(np.median(x)), math.sqrt(math.pi / 2) * x.std() / math.sqrt(ess[0]), rhat[0]


@pytest.fixture(scope="module")
def fits():
    """Both packages' chains from the same starting points."""
    # the JAX model's build (mostly XLA compiling, which releases the GIL)
    # overlaps the port's Laplace step; the two share no state
    with ThreadPoolExecutor(1) as pool:
        future_j = pool.submit(_jax_example_model)
        data = chip_smoke.joint_data(ot)
        init_model = chip_smoke.build_joint_model(ot, data, device="cpu")
        truth = chip_smoke.joint_points_near_truth(ot, init_model, 1, seed=0)[0].numpy()
        sigma, L = laplace(init_model, truth)
        draws = truth + np.random.default_rng(1).standard_normal((4 * CHAINS, len(truth))) @ L.T
        with torch.no_grad():
            lps = init_model.ln_post(draws).numpy()
        mj = future_j.result(timeout=600)
    mj.starting_points = jnp.asarray(draws[np.isfinite(lps)])
    mj.laplace_sigma = jnp.asarray(sigma)

    mt = chip_smoke.build_joint_model(ot, data, device="cpu")
    load_jax_state(mt, parameter_names=mj.parameter_names,
                   starting_points=np.asarray(mj.starting_points),
                   laplace_sigma=np.asarray(mj.laplace_sigma))
    with ThreadPoolExecutor(1) as pool:
        future_j = pool.submit(oc.octofit, mj, chains=CHAINS, adaptation=WARMUP,
                               iterations=DRAWS, key=jax.random.PRNGKey(2), verbosity=0)
        chain_t = ot.octofit(mt, chains=CHAINS, adaptation=WARMUP, iterations=DRAWS,
                             generator=torch.Generator().manual_seed(2), verbosity=0)
        chain_j = future_j.result(timeout=600)
    assert chain_t["b_mass"].shape == (CHAINS, DRAWS)
    return chain_t, chain_j


@pytest.mark.parametrize("name", ["b_mass", "b_a"])
def test_joint_fit_matches_jax_posterior(fits, name):
    """The posterior median agrees within 4 combined Monte-Carlo standard
    errors, and both runs have R-hat < 1.05 on the parameter."""
    chain_t, chain_j = fits
    med_t, se_t, rhat_t = _median_and_mcse(chain_t[name])
    med_j, se_j, rhat_j = _median_and_mcse(chain_j[name])
    assert rhat_t < 1.05 and rhat_j < 1.05, (rhat_t, rhat_j)
    assert abs(med_t - med_j) < 4 * math.hypot(se_t, se_j), (med_t, med_j, se_t, se_j)
