"""The port's NUTS and HMC samplers against the JAX package, on the CPU in
float64.

The transition is deterministic given its random numbers, so the port's
batched `nuts_step` is held to the JAX package's `nuts_step` vmapped over
the same chains, with every random number the JAX transition draws rebuilt
from its own key splits and handed to the port: the new states, log
densities and acceptance rates to 1e-10, tree depths, leaf counts and
divergences exactly, for every chain, on the benchmark's headline model
and on a correlated Gaussian, under per-chain diagonal and dense metrics.
The step-size search, the dense HMC transition, the per-chain Welford
accumulators and dual averaging are held the same way, and the warmup's
window schedule exactly. `run_nuts` is checked by moments on Gaussian
targets (tests/test_nuts.py's), and its adapted runs against the JAX
package's `run_nuts` on the same targets (posterior, step sizes and
metrics within Monte-Carlo error); `octofit(sampler="nuts")` on the
headline model against the JAX package's posterior within Monte-Carlo
error.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octofitter_tpu as oc
from octofitter_tpu.samplers import hmc as jhmc
from octofitter_tpu.samplers import nuts as jnuts

import octofitter_tpu_torch as ot
from octofitter_tpu_torch.model.initialization import laplace
from octofitter_tpu_torch.samplers import hmc as thmc
from octofitter_tpu_torch.samplers import nuts as tnuts

from test_torch_model import bench_table, build_bench

import chip_smoke

C = 8
MAX_DEPTH = 8


# --------------------------------------------------------------------------
# targets and the random numbers of the JAX transitions
# --------------------------------------------------------------------------

def _gaussian_targets():
    """A correlated 4-D Gaussian (scales 0.1 to 3, correlations up to 0.9)
    as (JAX value_and_grad of one point, port value_and_grad of a batch)."""
    rng = np.random.default_rng(0)
    scales = np.array([0.1, 0.5, 1.0, 3.0])
    corr = np.array([[1.0, 0.9, 0.3, 0.0], [0.9, 1.0, 0.5, 0.2],
                     [0.3, 0.5, 1.0, -0.4], [0.0, 0.2, -0.4, 1.0]])
    prec = np.linalg.inv(corr * np.outer(scales, scales))
    mu = rng.standard_normal(4)
    prec_j, mu_j = jnp.asarray(prec), jnp.asarray(mu)
    prec_t, mu_t = torch.as_tensor(prec), torch.as_tensor(mu)

    def vg_t(X):
        d = X - mu_t
        return -0.5 * torch.sum(d * (d @ prec_t), dim=-1), -(d @ prec_t)

    vg_j = jax.value_and_grad(lambda x: -0.5 * (x - mu_j) @ prec_j @ (x - mu_j))
    theta = mu + rng.standard_normal((C, 4)) * scales
    return vg_j, vg_t, theta, scales


def _metrics(scales, dense, seed):
    """Per-chain metrics (C, D) or (C, D, D): each chain's own random
    positive-definite sigma around the target's scales."""
    rng = np.random.default_rng(seed)
    D = len(scales)
    if not dense:
        return (scales**2)[None, :] * rng.uniform(0.3, 3.0, (C, D))
    A = rng.standard_normal((C, D, D)) * 0.3
    base = np.diag(scales) @ (np.eye(D) + A) @ np.transpose(np.eye(D) + A, (0, 2, 1)) @ np.diag(scales)
    return base + 1e-3 * np.diag(scales**2)[None]


def _jax_metric(sigma):
    sigma = jnp.asarray(sigma)
    if sigma.ndim == 2:
        return jnuts.Metric(sigma, jnp.sqrt(sigma))
    return jnuts.Metric(sigma, jnp.linalg.cholesky(sigma))


@jax.jit
def _jax_keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), C)


@functools.cache
def _jax_draws_fn(D, max_depth):
    """Every random number `nuts_step` draws from each chain's key, in the
    JAX package's own order of splits: the momentum from the first half of
    split(key); per depth split(key, 4) into the next key, the direction,
    the subtree's key and the merge uniform; per leaf of the subtree
    split(key) into the next key and the leaf's uniform."""

    def one(key):
        key_r, key_tree = jax.random.split(key)
        z = jax.random.normal(key_r, (D,), jnp.float64)
        go, merge, leaves = [], [], []
        for d in range(max_depth):
            key_tree, k_dir, k_sub, k_merge = jax.random.split(key_tree, 4)
            go.append(jax.random.bernoulli(k_dir))
            merge.append(jax.random.uniform(k_merge))

            def leaf(kk, _):
                kk, k_acc = jax.random.split(kk)
                return kk, jax.random.uniform(k_acc)

            leaves.append(jax.lax.scan(leaf, k_sub, None, length=2**d)[1])
        return z, jnp.stack(go), jnp.stack(merge), leaves

    return jax.jit(jax.vmap(one))


def _jax_transition(vg_j, theta, eps, sigma, max_depth, seed):
    """The JAX package's vmapped `nuts_step` from `theta` (C, D), and the
    random numbers it drew, all as numpy arrays."""
    keys = _jax_keys(seed)
    lp, g = jax.vmap(vg_j)(jnp.asarray(theta))
    step = jax.jit(jax.vmap(
        lambda th, lp, g, k, e, m: jnuts.nuts_step(vg_j, th, lp, g, k, e, m, max_depth)))
    th, lp2, _, st = step(jnp.asarray(theta), lp, g, keys, jnp.asarray(eps), _jax_metric(sigma))
    z, go, merge, leaves = _jax_draws_fn(theta.shape[1], max_depth)(keys)
    draws = (np.array(z), np.array(go).T, np.array(merge).T, [np.array(u) for u in leaves])
    return np.asarray(th), np.asarray(lp2), jax.tree.map(np.asarray, st), draws


def _check_transition(vg_t, theta, eps, sigma, max_depth, jax_result):
    """The port's `nuts_step` on the JAX transition's random numbers
    against the JAX transition's result."""
    th_j, lp2_j, st_j, (z, go, merge, leaves) = jax_result
    draws = tnuts.NutsDraws(torch.as_tensor(z), torch.as_tensor(go), torch.as_tensor(merge),
                            [torch.as_tensor(u) for u in leaves])
    Theta = torch.as_tensor(theta)
    lp_t, g_t = vg_t(Theta)
    th_t, lp2_t, _, st_t, n_evals = tnuts.nuts_step(
        vg_t, Theta, lp_t, g_t, None, torch.as_tensor(eps), tnuts.chain_metric(torch.as_tensor(sigma)),
        max_depth, draws=draws)

    np.testing.assert_allclose(th_t.numpy(), th_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(lp2_t.numpy(), lp2_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(st_t.acceptance_rate.numpy(), st_j.acceptance_rate, rtol=0, atol=1e-10)
    for field in ("tree_depth", "n_steps", "is_divergent"):
        np.testing.assert_array_equal(getattr(st_t, field).numpy(), getattr(st_j, field),
                                      err_msg=field)
    np.testing.assert_allclose(st_t.energy.numpy(), st_j.energy, rtol=1e-12, atol=1e-10)
    # the batch costs, per depth, its deepest chain's leaves
    assert st_j.n_steps.max() <= n_evals <= 2 ** int(st_j.tree_depth.max()) - 1
    return st_t


# --------------------------------------------------------------------------
# the headline model's JAX side runs in a thread from the start of the
# module (mostly XLA compiling, which releases the GIL), so that it
# overlaps the port-only tests; its tests come last
# --------------------------------------------------------------------------

def _jax_step_size(vg_j, pts, sig, seed):
    keys = _jax_keys(seed)
    lp, g = jax.vmap(vg_j)(jnp.asarray(pts))
    eps = jax.jit(jax.vmap(lambda th, lp, g, k, m: jnuts.find_reasonable_step_size(
        vg_j, th, lp, g, k, m)))(jnp.asarray(pts), lp, g, keys, _jax_metric(sig))
    z = jax.vmap(lambda k: jax.random.normal(k, (pts.shape[1],), jnp.float64))(keys)
    return np.asarray(eps), np.asarray(z)


OCTOFIT_KW = dict(chains=8, adaptation=0, iterations=100, sampler="nuts", max_depth=5,
                  step_size=0.4, verbosity=0)


@pytest.fixture(scope="module", autouse=True)
def headline():
    """The headline model in both packages with the same state (64
    starting points drawn from the Laplace approximation at the truth, and
    its covariance), points near the truth, per-chain step sizes and
    metrics around that covariance, and the futures of the JAX side."""
    mt = build_bench(ot, bench_table(), device="cpu")
    mj = build_bench(oc, bench_table())
    pts = chip_smoke.headline_points(ot, mt)[:C].numpy()
    sigma, chol = laplace(mt, pts[0])
    starts = pts[0] + np.random.default_rng(9).standard_normal((64, mt.D)) @ chol.T
    mt.starting_points, mt.laplace_sigma = torch.as_tensor(starts), torch.as_tensor(sigma)
    mj.starting_points, mj.laplace_sigma = jnp.asarray(starts), jnp.asarray(sigma)
    rng = np.random.default_rng(2)
    eps = np.geomspace(0.05, 1.5, C)
    sigma_dense = sigma[None] * rng.uniform(0.5, 2.0, (C, 1, 1))
    # metrics from 1e-4 to 1e2 times the Laplace diagonal, so that the
    # step-size search doubles for some chains and halves for others
    sig_search = np.diag(sigma)[None, :].repeat(C, 0) * np.geomspace(1e-4, 1e2, C)[:, None]
    vg_j = jax.value_and_grad(mj._ln_post_py)
    with ThreadPoolExecutor(1) as pool:
        jax_side = {
            "nuts_step": pool.submit(_jax_transition, vg_j, pts, eps, sigma_dense, MAX_DEPTH, 4),
            "step_size": pool.submit(_jax_step_size, vg_j, pts, sig_search, 5),
            "octofit": pool.submit(oc.octofit, mj, key=jax.random.PRNGKey(2), **OCTOFIT_KW),
        }
        yield dict(mt=mt, pts=pts, eps=eps, sigma_dense=sigma_dense, sig_search=sig_search,
                   jax=jax_side)


# --------------------------------------------------------------------------
# deterministic pieces on Gaussian targets
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_nuts_step_matches_jax_on_gaussian(dense):
    """Step sizes from 0.02 to 2, and one of 40: shallow and deep trees,
    U-turns at several depths, the last chain diverging."""
    vg_j, vg_t, theta, scales = _gaussian_targets()
    eps = np.geomspace(0.02, 2.0, C)
    eps[-1] = 40.0
    sigma = _metrics(scales, dense, seed=1)
    st = _check_transition(vg_t, theta, eps, sigma, MAX_DEPTH,
                           _jax_transition(vg_j, theta, eps, sigma, MAX_DEPTH, 3))
    depth = st.tree_depth.numpy()
    assert len(set(depth.tolist())) >= 3, depth
    assert st.is_divergent.numpy().any()


def test_dense_hmc_step_matches_jax():
    vg_j, vg_t, theta, scales = _gaussian_targets()
    sigma = _metrics(scales, True, seed=6)
    eps = np.geomspace(0.05, 0.6, C)
    n_leap = 16
    keys = _jax_keys(7)
    lp_j, g_j = jax.vmap(vg_j)(jnp.asarray(theta))
    th_j, lp2_j, _, st_j = jax.jit(jax.vmap(
        lambda th, lp, g, k, e, m: jhmc.hmc_step(vg_j, th, lp, g, k, e, m, n_leap)))(
        jnp.asarray(theta), lp_j, g_j, keys, jnp.asarray(eps), _jax_metric(sigma))

    def split_draws(key):
        k_mom, k_len, k_acc = jax.random.split(key, 3)
        return (jax.random.normal(k_mom, (4,), jnp.float64),
                jax.random.randint(k_len, (), 1, n_leap + 1), jax.random.uniform(k_acc))

    z, L, u = (torch.as_tensor(np.asarray(a)) for a in jax.vmap(split_draws)(keys))
    Theta = torch.as_tensor(theta)
    lp_t, g_t = vg_t(Theta)
    th_t, lp2_t, _, st_t = thmc.hmc_step(vg_t, Theta, lp_t, g_t, None, torch.as_tensor(eps),
                                         tnuts.chain_metric(torch.as_tensor(sigma)), n_leap,
                                         draws=(z, L, u))
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(lp2_t.numpy(), np.asarray(lp2_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(st_t.acceptance_rate.numpy(), np.asarray(st_j.acceptance_rate),
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(st_t.n_steps.numpy(), np.asarray(st_j.n_steps))
    acc = st_t.acceptance_rate.numpy()
    assert (acc < 1).any() and (acc > 0.5).any()


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_welford_and_dual_averaging_match_jax(dense):
    """Per-chain Welford accumulators over 7 draws and their regularized
    covariance, and per-chain dual averaging over 30 acceptances."""
    rng = np.random.default_rng(8)
    D = 3
    X = rng.standard_normal((7, C, D)) * np.array([0.1, 1.0, 5.0])
    wj = jax.vmap(lambda _: jnuts.welford_init(D, jnp.float64, dense))(jnp.arange(C))
    wt = tnuts.welford_init(D, torch.float64, dense, device="cpu", n_chains=C)
    for x in X:
        wj = jax.vmap(jnuts.welford_update)(wj, jnp.asarray(x))
        wt = tnuts.welford_update(wt, torch.as_tensor(x))
    np.testing.assert_allclose(wt.mean.numpy(), np.asarray(wj.mean), rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(wt.m2.numpy(), np.asarray(wj.m2), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tnuts.welford_sigma(wt).numpy(),
                               np.asarray(jax.vmap(jnuts.welford_sigma)(wj)), rtol=1e-12, atol=1e-15)

    eps0 = np.geomspace(1e-3, 1.0, C)
    dj = jax.vmap(jnuts.da_init)(jnp.asarray(eps0))
    dt = tnuts.da_init(eps0)
    for alpha in rng.uniform(0.0, 1.0, (30, C)):
        dj = jax.vmap(lambda s, a: jnuts.da_update(s, a, 0.8))(dj, jnp.asarray(alpha))
        dt = tnuts.da_update(dt, alpha, 0.8)
    for field in ("log_eps", "log_eps_avg", "h_avg", "count"):
        np.testing.assert_allclose(getattr(dt, field), np.asarray(getattr(dj, field)),
                                   rtol=1e-10, atol=1e-12, err_msg=field)


@pytest.mark.parametrize("n_warmup", [20, 100, 150, 300, 600, 1000])
def test_warmup_schedule_matches_jax(n_warmup):
    """Stan's windows: the slow steps and the window ends, exactly."""
    slow_t, end_t = tnuts.build_warmup_schedule(n_warmup)
    slow_j, end_j = jnuts.build_warmup_schedule(n_warmup)
    np.testing.assert_array_equal(slow_t, np.asarray(slow_j))
    np.testing.assert_array_equal(end_t, np.asarray(end_j))
    assert end_t.sum() >= 1


# --------------------------------------------------------------------------
# run_nuts on analytic targets (tests/test_nuts.py's checks), the adapted
# runs also against the JAX package's run_nuts on the same target
# --------------------------------------------------------------------------

STANDARD = dict(scales=(1.0,) * 5, n_warmup=300, n_samples=800)
CORRELATED = dict(scales=(0.01, 0.1, 1.0, 10.0), n_warmup=600, n_samples=500, max_depth=8,
                  metric="diag")


def _theta0(seed, D):
    return torch.randn((8, D), generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float64) * 0.5


def _run_on(scales, n_warmup, n_samples, seed=0, max_depth=10, **kw):
    """`run_nuts` on 8 chains of the Gaussian N(0, diag(scales^2))."""
    prec = 1.0 / torch.as_tensor(scales, dtype=torch.float64) ** 2

    def vg(X):
        return -0.5 * torch.sum(X * X * prec, dim=-1), -X * prec

    gen = torch.Generator().manual_seed(seed)
    theta0 = torch.randn((8, len(scales)), generator=gen, dtype=torch.float64) * 0.5
    return tnuts.run_nuts(vg, theta0, gen, n_warmup=n_warmup, n_samples=n_samples,
                          max_depth=max_depth, **kw)


def _jax_run_on(scales, n_warmup, n_samples, seed=0, max_depth=10, **kw):
    """The JAX package's `run_nuts` on `_run_on`'s target, settings and
    starting points, as numpy arrays."""
    prec = jnp.asarray(1.0 / np.asarray(scales) ** 2)
    vg = jax.value_and_grad(lambda x: -0.5 * jnp.sum(x * x * prec))
    theta0 = jnp.asarray(_theta0(seed, len(scales)).numpy())
    out = jnuts.run_nuts(vg, theta0, jax.random.PRNGKey(seed), n_warmup=n_warmup,
                         n_samples=n_samples, max_depth=max_depth, **kw)
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module", autouse=True)
def gaussian_runs_j():
    """The JAX package's adapted runs of the two Gaussian targets, started
    in a thread at module start so that they overlap the port's tests."""
    with ThreadPoolExecutor(1) as pool:
        yield {"standard": pool.submit(_jax_run_on, **STANDARD),
               "correlated": pool.submit(_jax_run_on, **CORRELATED)}


def _assert_same_posterior(x_t, x_j, names):
    """Draws (chains, draws, P) of two samplers of one target: every
    parameter's mean and sd within 4 combined Monte-Carlo standard errors
    (sd / sqrt(ESS), and sd / sqrt(2 ESS) for the sd)."""
    P = x_t.shape[-1]
    (ess_t, _), (ess_j, _) = ot.ess_rhat_batch(x_t), ot.ess_rhat_batch(x_j)
    flat_t, flat_j = x_t.reshape(-1, P), x_j.reshape(-1, P)
    sd_t, sd_j = flat_t.std(axis=0), flat_j.std(axis=0)
    z_mean = np.abs(flat_t.mean(axis=0) - flat_j.mean(axis=0)) / np.hypot(
        sd_t / np.sqrt(ess_t), sd_j / np.sqrt(ess_j))
    z_sd = np.abs(sd_t - sd_j) / np.hypot(sd_t / np.sqrt(2 * ess_t), sd_j / np.sqrt(2 * ess_j))
    assert (z_mean < 4).all(), dict(zip(names, z_mean))
    assert (z_sd < 4).all(), dict(zip(names, z_sd))


def _assert_same_adaptation(info_t, run_j):
    """The warmup (window schedule, per-chain metric swaps at the window
    ends, dual averaging restarted there) against the JAX package's: the
    same posterior within Monte-Carlo error, and medians over chains of the
    adapted step size within a factor 1.5 and of the metric's diagonal
    within a factor 2 of the JAX run's."""
    _, _, _, info_j = run_j
    eps_ratio = np.median(info_t["step_size"]) / np.median(info_j["step_size"])
    assert 1 / 1.5 < eps_ratio < 1.5, (info_t["step_size"], info_j["step_size"])

    def diag(sig):
        return np.diagonal(sig, axis1=-2, axis2=-1) if sig.ndim == 3 else sig

    sig_ratio = (np.median(diag(info_t["sigma"].numpy()), axis=0)
                 / np.median(diag(info_j["sigma"]), axis=0))
    assert np.all(sig_ratio > 0.5) and np.all(sig_ratio < 2.0), sig_ratio


def test_run_nuts_standard_gaussian_moments(gaussian_runs_j):
    samples, _, stats, info = _run_on(**STANDARD)
    flat = samples.reshape(-1, 5).numpy()
    assert np.abs(flat.mean(axis=0)).max() < 0.05
    assert np.abs(flat.std(axis=0) - 1.0).max() < 0.05
    assert float(stats.is_divergent.double().mean()) < 0.01
    assert info["step_size"].shape == (8,) and info["sigma"].shape == (8, 5, 5)
    assert info["n_grad_evals"] >= int(stats.n_steps.amax(dim=0).sum())
    run_j = gaussian_runs_j["standard"].result(timeout=600)
    _assert_same_posterior(samples.numpy(), run_j[0], [f"x{i}" for i in range(5)])
    _assert_same_adaptation(info, run_j)


def test_run_nuts_correlated_gaussian_adapts_the_metric(gaussian_runs_j):
    scales = np.asarray(CORRELATED["scales"])
    samples, _, _, info = _run_on(**CORRELATED)
    ratio = samples.reshape(-1, 4).numpy().std(axis=0) / scales
    assert np.abs(ratio - 1).max() < 0.1
    med = np.median(info["sigma"].numpy(), axis=0) / scales**2
    assert np.all(med > 0.2) and np.all(med < 5.0)
    run_j = gaussian_runs_j["correlated"].result(timeout=600)
    _assert_same_posterior(samples.numpy(), run_j[0], [f"x{i}" for i in range(4)])
    _assert_same_adaptation(info, run_j)


def test_run_nuts_hmc_moments():
    # at most 2**(6 // 2 + 2) = 32 leapfrog steps per transition
    samples, _, stats, _ = _run_on([1.0] * 4, n_warmup=300, n_samples=800, seed=1, max_depth=6,
                                   sampler="hmc")
    flat = samples.reshape(-1, 4).numpy()
    assert np.abs(flat.mean(axis=0)).max() < 0.06
    assert np.abs(flat.std(axis=0) - 1.0).max() < 0.06
    assert float(stats.acceptance_rate.mean()) > 0.6


@pytest.mark.parametrize("sampler", ["nuts", "hmc"])
def test_run_nuts_keeps_warmup_and_takes_a_step_size(sampler):
    """drop_warmup=False prepends the adaptation draws; initial_step_size
    skips the step-size search (no evaluations beyond the transitions')."""
    samples, lps, stats, info = _run_on([1.0] * 3, n_warmup=20, n_samples=10, max_depth=4,
                                        sampler=sampler, initial_step_size=0.3,
                                        drop_warmup=False)
    assert samples.shape == (8, 30, 3) and lps.shape == stats.n_steps.shape == (8, 30)
    assert info["n_grad_evals"] == 1 + int(info["transition_evals"].sum())
    assert len(info["transition_evals"]) == 30 and np.isfinite(info["step_size"]).all()
    assert info["warmup_divergences"].shape == (8,)


# --------------------------------------------------------------------------
# the headline model, against the JAX side started with the module
# --------------------------------------------------------------------------

def test_nuts_step_matches_jax_on_headline_model(headline):
    """The benchmark's headline model (D = 11), per-chain dense metrics
    around the Laplace covariance at the truth, step sizes 0.05 to 1.5."""
    h = headline
    st = _check_transition(h["mt"].ln_post_and_grad, h["pts"], h["eps"], h["sigma_dense"],
                           MAX_DEPTH, h["jax"]["nuts_step"].result(timeout=600))
    assert len(set(st.tree_depth.tolist())) >= 3


def test_find_reasonable_step_size_matches_jax(headline):
    h = headline
    mt = h["mt"]
    eps_j, z = h["jax"]["step_size"].result(timeout=600)
    Theta = torch.as_tensor(h["pts"])
    lp_t, g_t = mt.ln_post_and_grad(Theta)
    eps_t, n_evals = tnuts.find_reasonable_step_size(
        mt.ln_post_and_grad, Theta, lp_t, g_t, None,
        tnuts.chain_metric(torch.as_tensor(h["sig_search"])), z=torch.as_tensor(z))
    np.testing.assert_allclose(eps_t.numpy(), eps_j, rtol=1e-12, atol=0)
    assert eps_t.min() < 0.05 and eps_t.max() > 0.1 and n_evals > 2


def test_octofit_nuts_matches_jax_posterior(headline):
    """Both packages sample the headline model by `octofit(sampler="nuts")`
    from the same model state with the same fixed step size and no
    adaptation, so that both run the same NUTS transition on the same
    tuning (the adaptation is held by the moment tests above): every
    parameter's posterior mean and sd agree within 4 combined Monte-Carlo
    standard errors (sd / sqrt(ESS), and sd / sqrt(2 ESS) for the sd), and
    both runs have max split-R-hat < 1.05."""
    mt = headline["mt"]
    chain_t = ot.octofit(mt, generator=torch.Generator().manual_seed(2), **OCTOFIT_KW)
    chain_j = headline["jax"]["octofit"].result(timeout=600)
    n_chains, draws = OCTOFIT_KW["chains"], OCTOFIT_KW["iterations"]
    assert chain_t.info["sampler"] == "nuts_vectorized"
    assert chain_t.info["step_size"].shape == (n_chains,)
    names = mt.parameter_names
    x_t = np.stack([chain_t[n] for n in names], axis=-1)
    x_j = np.stack([chain_j[n] for n in names], axis=-1)
    assert x_t.shape == (n_chains, draws, mt.D)
    assert chain_t.internals["tree_depth"].shape == (n_chains, draws)
    (_, rhat_t), (_, rhat_j) = ot.ess_rhat_batch(x_t), ot.ess_rhat_batch(x_j)
    assert rhat_t.max() < 1.05 and rhat_j.max() < 1.05, (rhat_t, rhat_j)
    _assert_same_posterior(x_t, x_j, names)
