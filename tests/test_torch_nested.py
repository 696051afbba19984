"""The port's batched nested sampler against the JAX package, on the CPU in
float64.

Number for number: with the initial live points and every iteration's
random numbers rebuilt from the JAX package's own key splits and passed in
(`prior_draws`, `draws`), both packages run the conjugate Normal-Normal
model, examples/10's two-parameter model and examples/04's eccentric
model (11 parameters, UniformCircular pairs, tp derived) to the same
iterations, dead points, evidence and progress lines. Statistically, with the port's own
generator: the conjugate model's analytic posterior and evidence (the
JAX package's tolerances, tests/test_tempering.py), and examples/10's
evidence from both packages against a grid quadrature of the JAX
package's likelihood. The JAX runs start in a thread with the module.
"""

import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octofitter_tpu as oc
from octofitter_tpu.samplers import nested as nested_mod_j
from octofitter_tpu.samplers.nested import octofit_nested as nested_j

import octofitter_tpu_torch as ot
from octofitter_tpu_torch.samplers import nested as nested_mod_t
from octofitter_tpu_torch.samplers.nested import NestedDraws, octofit_nested as nested_t

import chip_smoke

LOGZ_TRUE = -0.5 * (1.0 / 1.25) - 0.5 * math.log(2 * math.pi * 1.25)
# the replayed runs: live points, batch fraction, walker steps, iterations
REPLAY = dict(n_live=100, batch_frac=0.25, n_mcmc_steps=5, dlogz_tol=0.01, max_iterations=40)
REPLAY_SEED = 3
STAT_LIVE = 500
GRID = 500


def _conjugate(pkg, **model_kw):
    """Prior x ~ N(0, 1), one observation y = 1 ~ N(x, 0.5): posterior
    N(0.8, 0.2), evidence N(1; 0, sqrt(1.25))."""
    d = pkg.distributions
    obs = pkg.UserLikelihood(d.Normal(1.0, 0.5), "x", name="obs1")
    system = pkg.System(name="conjugate", variables=dict(x=d.Normal(0.0, 1.0)),
                        observations=[obs])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


EX10_TABLE = chip_smoke.ex10_table(ot)
EX04_TABLE = chip_smoke.ex04_table(ot)
BUILD = {"conjugate": _conjugate,
         "examples/10": lambda pkg, **kw: chip_smoke.build_ex10_model(pkg, EX10_TABLE, **kw),
         "examples/04": lambda pkg, **kw: chip_smoke.build_ex04_model(pkg, EX04_TABLE, True, **kw)}


def _replay_draws(model_j, seed):
    """The JAX run's initial live points and, per iteration, its seeds,
    normals and uniforms, from its key splits (`nested.py:61,148,86-127`)."""
    n_live, n_steps = REPLAY["n_live"], REPLAY["n_mcmc_steps"]
    K = int(REPLAY["batch_frac"] * n_live)
    D = model_j.D
    key, k0 = jax.random.split(jax.random.PRNGKey(seed))
    live0 = np.asarray(model_j.sample_priors(k0, n_live))

    @jax.jit
    def iteration(k_it):
        k_seed, k_mcmc = jax.random.split(k_it)
        seeds = jax.random.randint(k_seed, (K,), 0, n_live - K)

        def walker(k):
            def step(k_step):
                k1, k2 = jax.random.split(k_step)
                return jax.random.normal(k1, (D,)), jax.random.uniform(k2)

            return jax.vmap(step)(jax.random.split(k, n_steps))

        z, u = jax.vmap(walker)(jax.random.split(k_mcmc, K))
        return seeds, jnp.swapaxes(z, 0, 1), jnp.swapaxes(u, 0, 1)

    draws = []
    for _ in range(REPLAY["max_iterations"]):
        key, k_it = jax.random.split(key)
        draws.append(NestedDraws(*(torch.as_tensor(np.array(x)) for x in iteration(k_it))))
    return live0, draws


def _run_recording(module, fn, *args, **kwargs):
    """fn's result and the lines `module` printed meanwhile, recorded by a
    module-level `print` (the JAX side runs in a thread, where swapping
    sys.stdout races pytest's own capture)."""
    lines = []
    module.print = lambda *a, **k: lines.append(" ".join(map(str, a)))
    try:
        res = fn(*args, **kwargs)
    finally:
        del module.print
    return res, lines


def _jax_side():
    """The JAX package's runs: each model's replayed run with its draws,
    examples/10 at STAT_LIVE live points and its grid quadrature."""
    out = {}
    for label, build in BUILD.items():
        mj = build(oc)
        out[label] = {"replay": _run_recording(nested_mod_j, nested_j, mj,
                                               key=jax.random.PRNGKey(REPLAY_SEED), verbosity=2,
                                               **REPLAY),
                      "draws": _replay_draws(mj, REPLAY_SEED)}
    mj = BUILD["examples/10"](oc)
    out["stat"] = nested_j(mj, key=jax.random.PRNGKey(0), n_live=STAT_LIVE, verbosity=0)[1]
    a = 8.0 + 4.0 * (np.arange(GRID) + 0.5) / GRID
    e = 0.3 * (np.arange(GRID) + 0.5) / GRID
    ga, ge = np.meshgrid(a, e, indexing="ij")
    cols = {"b_a": ga.ravel(), "b_e": ge.ravel()}
    pts = jnp.asarray(np.stack([cols[n] for n in mj.parameter_names], axis=-1))
    ll = np.asarray(jax.jit(jax.vmap(lambda th: mj.ln_like_nt(mj.arr2nt(th))))(pts))
    top = ll.max()
    w = np.exp(ll - top)
    logz = float(np.log(w.sum()) + top - np.log(len(ll)))
    out["grid"] = {"logz": logz, "information": float(np.sum(w / w.sum() * ll) - logz)}
    return out


_POOL = ThreadPoolExecutor(1)
_JAX = _POOL.submit(_jax_side)


@pytest.fixture(scope="module")
def jax_side():
    res = _JAX.result()
    _POOL.shutdown()
    return res


@pytest.mark.parametrize("label", list(BUILD))
def test_replay_matches_jax_number_for_number(jax_side, label):
    """The port with JAX's random numbers: the same iterations and dead
    points, the resampled draws and their log-likelihoods within 1e-9, the
    evidence within 1e-9 and the same progress lines (evidence, remaining
    evidence and acceptance every 20 iterations)."""
    (chain_j, info_j), lines_j = jax_side[label]["replay"]
    live0, draws = jax_side[label]["draws"]
    mt = BUILD[label](ot, device="cpu")
    (chain_t, info_t), lines_t = _run_recording(
        nested_mod_t, nested_t, mt, verbosity=2, prior_draws=lambda r: live0,
        draws=lambda it: draws[it], **REPLAY)
    assert info_t["n_iterations"] == info_j["n_iterations"] >= 20
    assert info_t["n_dead"] == info_j["n_dead"]
    assert abs(info_t["logz"] - info_j["logz"]) <= 1e-9
    assert lines_t == lines_j and len(lines_t) >= 2
    for name in mt.parameter_names:
        np.testing.assert_allclose(chain_t[name], chain_j[name], rtol=0, atol=1e-9)
    np.testing.assert_allclose(chain_t.internals["loglike"], chain_j.internals["loglike"],
                               rtol=1e-9, atol=0)
    assert info_t["sampler"] == info_j["sampler"] and info_t["model_name"] == info_j["model_name"]


def test_conjugate_posterior_and_evidence():
    """The port's own draws at 500 live points: the analytic evidence
    within 0.15 and the posterior's mean and variance within 0.05."""
    chain, info = nested_t(_conjugate(ot, device="cpu"), n_live=STAT_LIVE, verbosity=0)
    assert abs(info["logz"] - LOGZ_TRUE) < 0.15
    x = chain.flat("x")
    assert abs(x.mean() - 0.8) < 0.05
    assert abs(x.var() - 0.2) < 0.05
    assert info["information"] > 0 and len(info["acceptance"]) == info["n_iterations"]


def test_examples10_evidence_against_grid(jax_side):
    """examples/10's evidence from the port and from the JAX package, each
    with its own random numbers at 500 live points, within 4 sqrt(H /
    n_live) of a 500 x 500 midpoint quadrature of the JAX package's
    likelihood over the prior box (H the grid's information)."""
    grid = jax_side["grid"]
    _, info = nested_t(BUILD["examples/10"](ot, device="cpu"), n_live=STAT_LIVE, verbosity=0)
    tol = 4 * math.sqrt(grid["information"] / STAT_LIVE)
    assert abs(info["logz"] - grid["logz"]) <= tol
    assert abs(jax_side["stat"]["logz"] - grid["logz"]) <= tol
    assert abs(info["information"] - grid["information"]) <= 0.5


def test_non_finite_live_points_are_redrawn():
    """Live points whose log-likelihood is NaN are replaced by the next
    round's prior draws before the first iteration; no draw of the chain
    is NaN."""
    mt = _conjugate(ot, device="cpu")
    gen = torch.Generator().manual_seed(5)
    rounds = [mt.sample_priors(gen, 100) for _ in range(2)]
    rounds[0][:30] = math.nan
    chain, info = nested_t(mt, n_live=100, n_mcmc_steps=5, verbosity=0,
                           prior_draws=lambda r: rounds[r])
    assert np.isfinite(chain.flat("x")).all() and np.isfinite(info["logz"])


def test_sampler_keeps_no_graph(monkeypatch):
    """Every likelihood evaluation runs with autograd off; the alias and
    the package export are the same function."""
    mt = _conjugate(ot, device="cpu")
    seen = []
    inner = mt.ln_like_nt

    def spy(theta_nt, **kw):
        seen.append(torch.is_grad_enabled())
        return inner(theta_nt, **kw)

    monkeypatch.setattr(mt, "ln_like_nt", spy)
    nested_t(mt, n_live=40, n_mcmc_steps=3, max_iterations=5, verbosity=0)
    assert seen and not any(seen)
    assert ot.dysample is nested_t is ot.samplers.dysample
