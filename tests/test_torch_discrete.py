"""Discrete priors in the port against the JAX package, on the CPU in float64.

The six tests of tests/test_discrete.py run on the port (detection, the
analytic marginal, the conditional and sampling, the prior draw, the
DiscreteUniform domain, Gibbs-within-HMC on a large domain), with the
samplers held to the analytic posteriors. Then the deterministic parts are
held to the JAX package at 1e-10 on two models built with both packages
from the same tables (`chip_smoke.py`): the calibration model (K = 2
combinations) and the 12-epoch outlier model at the marginalization cap
(K = 4096), and the 13-epoch outlier model in the Gibbs mode, whose sweep
(`gibbs_update_disc`) is held to JAX's draw exactly, the JAX Gumbel noise
rebuilt from its key splits and passed in. The JAX side runs in a thread
started with the module, overlapping the port-only tests.
"""

import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp as sp_logsumexp

import octofitter_tpu as oc
import octofitter_tpu_torch as ot
from octofitter_tpu_torch import distributions as dist

import chip_smoke

N_POINTS = 4  # per model: 2 near the truth, 2 prior draws


def _two_component_model(datum=2.0, sigma=1.0, p0=0.5, x_sigma=10.0):
    """x observed ~ N(mu_k, sigma), mu_0 = -2, mu_1 = 3, k ~ Categorical."""
    system = ot.System(
        name="disc",
        variables=dict(
            k=dist.Categorical(probs=(p0, 1 - p0)),
            x=dist.Normal(0.0, x_sigma),
            ll=lambda s, _d=datum, _s=sigma: (
                -0.5 * ((_d - (s.x + torch.where(s.k == 0, -2.0, 3.0))) / _s) ** 2
                - math.log(_s) - 0.5 * math.log(2 * math.pi)
            ),
        ),
        companions=[],
        observations=[ot.DirectLL("ll")],
    )
    return ot.LogDensityModel(system, verbosity=0, device="cpu")


def _nan_model(pkg, where):
    """k ~ Categorical(0.3, 0.7); the likelihood of k = 0 is NaN, that of
    k = 1 a Gaussian in x (check g: NaN becomes -inf before the logsumexp)."""
    system = pkg.System(
        name="nanll",
        variables=dict(
            k=pkg.distributions.Categorical(probs=(0.3, 0.7)),
            x=pkg.distributions.Normal(0.0, 1.0),
            ll=lambda s: where(s.k == 0, math.nan, -0.5 * (s.x - 0.5) ** 2),
        ),
        companions=[],
        observations=[pkg.DirectLL("ll")],
    )
    return system


def _points(mt, seed):
    """N_POINTS unconstrained points of a headline-shaped model: two near
    the truth, two prior draws."""
    near = chip_smoke.headline_points(ot, mt)[:2]
    prior = mt.link(mt.sample_priors(torch.Generator().manual_seed(seed), 2))
    return torch.cat([near, prior]).numpy()


def _jax_reference(tables, points, discs):
    """Every JAX number the parity tests read, as numpy arrays."""
    out = {}
    builders = dict(cal=chip_smoke.build_calibration_model, out12=chip_smoke.build_outlier_model,
                    out13=chip_smoke.build_outlier_model)
    for name, build in builders.items():
        mj = build(oc, tables[name])
        pts = jnp.asarray(points[name])
        disc = jnp.asarray(discs[name])
        r = dict(mode=mj.discrete_mode, names=list(mj.discrete_names),
                 parameter_names=list(mj.parameter_names))
        lp, g = jax.jit(jax.vmap(jax.value_and_grad(mj._ln_post_py)))(pts)
        r["ln_post"], r["grad"] = np.asarray(lp), np.asarray(g)
        r["given"] = np.asarray(jax.jit(jax.vmap(mj.ln_post_given_disc))(pts, disc))
        r["logpmf"] = np.asarray(jax.vmap(mj.disc_logpmf)(disc))
        if mj.discrete_mode == "marginalize":
            r["logits"] = np.asarray(jax.jit(jax.vmap(mj.discrete_conditional_logits))(pts))
            r["logw"] = np.asarray(mj._disc_logw)
            r["combos"] = np.asarray(mj._disc_combos)
        else:
            keys = jax.random.split(jax.random.PRNGKey(7), len(pts))
            r["gibbs"] = np.asarray(jax.jit(jax.vmap(mj.gibbs_update_disc))(pts, disc, keys))
            n_disc = disc.shape[-1]
            r["noise"] = [
                np.asarray(jax.vmap(lambda k, j=j: jax.random.gumbel(
                    jax.random.split(k, n_disc)[j], (2,), jnp.float64))(keys))
                for j in range(n_disc)
            ]
        out[name] = r
    mj = oc.LogDensityModel(_nan_model(oc, jnp.where), verbosity=0)
    xs = jnp.asarray([[-1.0], [0.3], [2.0]])
    out["nan"] = dict(ln_post=np.asarray(jax.vmap(mj.ln_post)(xs)),
                      logits=np.asarray(jax.vmap(mj.discrete_conditional_logits)(xs)))
    return out


@pytest.fixture(scope="module", autouse=True)
def models():
    """The port's models and the points, discrete values and tables they
    share with the JAX side, whose run starts in a thread here, with the
    module, so that it overlaps the port-only tests."""
    tables = dict(cal=chip_smoke.calibration_table(ot),
                  out12=chip_smoke.outlier_table(ot, chip_smoke.CAP_EPOCHS),
                  out13=chip_smoke.outlier_table(ot, chip_smoke.OUTLIER_EPOCHS))
    mts = dict(cal=chip_smoke.build_calibration_model(ot, tables["cal"], device="cpu"),
               out12=chip_smoke.build_outlier_model(ot, tables["out12"], device="cpu"),
               out13=chip_smoke.build_outlier_model(ot, tables["out13"], device="cpu"))
    rng = np.random.default_rng(11)
    points = {name: _points(mt, seed) for seed, (name, mt) in enumerate(mts.items())}
    discs = {name: rng.integers(0, 2, (N_POINTS, len(mt.discrete_names))).astype(float)
             for name, mt in mts.items()}
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_jax_reference, tables, points, discs)
        yield dict(mt=mts, points=points, discs=discs, ref=ref)


# --------------------------------------------------------------------------
# tests/test_discrete.py, on the port
# --------------------------------------------------------------------------

def test_discrete_detection_and_dims():
    m = _two_component_model()
    assert m.discrete_names == ["k"]
    assert m.parameter_names == ["x"]
    assert m.D == 1
    assert m.discrete_mode == "marginalize"
    assert tuple(m._disc_combos.shape) == (2, 1)
    # prior weights normalized
    np.testing.assert_allclose(float(sp_logsumexp(m._disc_logw.numpy())), 0.0, atol=1e-12)


def test_discrete_marginal_matches_analytic():
    """ln_post equals the analytic logsumexp mixture; gradient finite."""
    datum, sigma, p0 = 2.0, 1.0, 0.3
    m = _two_component_model(datum, sigma, p0)

    for xv in (-1.0, 0.0, 2.5):
        got = float(m.ln_post(m.link(torch.tensor([xv], dtype=torch.float64))))

        def comp(mu, p):
            return (math.log(p) - 0.5 * ((datum - (xv + mu)) / sigma) ** 2
                    - math.log(sigma) - 0.5 * math.log(2 * math.pi))

        lprior = -0.5 * (xv / 10.0) ** 2 - math.log(10.0) - 0.5 * math.log(2 * math.pi)
        want = lprior + sp_logsumexp([comp(-2.0, p0), comp(3.0, 1 - p0)])
        np.testing.assert_allclose(got, want, rtol=1e-10)

    val, g = m.ln_post_and_grad(m.link(torch.tensor([[0.5]], dtype=torch.float64)))
    assert torch.isfinite(val).all() and torch.isfinite(g).all()


def test_discrete_conditional_and_sampling():
    """P(k | x) matches Bayes, and octofit's chains carry the recovered
    discrete column at about the right frequency."""
    datum, sigma = 2.0, 1.0
    # tight x prior -> k=1 (mu=3, needs x=-1) strongly beats k=0
    # (mu=-2, would need x=+4 against a N(0, 0.5) prior)
    m = _two_component_model(datum, sigma, 0.5, x_sigma=0.5)
    xv = 0.0
    logits = m.discrete_conditional_logits(m.link(torch.tensor([xv], dtype=torch.float64))).numpy()
    p = np.exp(logits - sp_logsumexp(logits))
    w0 = -0.5 * ((datum - (xv - 2.0)) / sigma) ** 2
    w1 = -0.5 * ((datum - (xv + 3.0)) / sigma) ** 2
    np.testing.assert_allclose(p, np.exp([w0, w1]) / (np.exp(w0) + np.exp(w1)), rtol=1e-8)

    m.initialize(torch.Generator().manual_seed(0), n_prior_samples=2000, n_multistart=16,
                 n_opt_steps=100, verbosity=0)
    chain = ot.octofit(m, chains=8, adaptation=100, iterations=100, sampler="chees",
                       verbosity=0)
    assert "k" in chain.names
    ks = chain["k"].reshape(-1)
    assert set(np.unique(ks)) <= {0.0, 1.0}
    # the marginal P(k = 1 | datum): the mixture's weights under the x prior,
    # sigma_eff^2 = sigma^2 + 0.5^2, about 0.998
    s2 = sigma**2 + 0.25
    w = np.array([-0.5 * (datum + 2.0) ** 2 / s2, -0.5 * (datum - 3.0) ** 2 / s2])
    p1 = np.exp(w[1] - sp_logsumexp(w))
    assert ks.mean() > 0.9 and abs(ks.mean() - p1) < 0.02, (ks.mean(), p1)


def test_drawfrompriors_includes_discrete():
    m = _two_component_model(p0=0.9)
    nt = m.drawfrompriors(torch.Generator().manual_seed(0))
    assert float(nt["k"]) in (0.0, 1.0)
    ks = [float(m.drawfrompriors(torch.Generator().manual_seed(i))["k"]) for i in range(60)]
    assert np.mean(ks) < 0.4  # p(k=1) = 0.1


def test_discrete_uniform_domain():
    d = dist.DiscreteUniform(0, 3)
    np.testing.assert_array_equal(d.domain(), [0, 1, 2, 3])
    lp = d.logpmf(torch.tensor([0.0, 3.0, 4.0], dtype=torch.float64)).numpy()
    np.testing.assert_allclose(lp[:2], math.log(0.25))
    assert lp[2] == -np.inf
    c = dist.Categorical(probs=(1.0, 3.0), values=(2.0, 5.0))
    draws = c.sample(torch.Generator().manual_seed(0), (4000,))
    assert set(np.unique(draws.numpy())) == {2.0, 5.0}
    assert abs(float((draws == 5.0).double().mean()) - 0.75) < 0.03


def test_gibbs_within_hmc_large_domain():
    """Domains whose product exceeds the marginalization cap switch to
    Gibbs-within-HMC; the informative discrete variable follows its
    analytic posterior and an uninformative one stays ~uniform."""
    datum = 7.3
    system = ot.System(
        name="gibbs",
        variables=dict(
            k1=dist.DiscreteUniform(0, 19),
            k2=dist.DiscreteUniform(0, 19),
            k3=dist.DiscreteUniform(0, 19),
            x=dist.Normal(0.0, 1.0),
            ll=lambda s, _d=datum: -0.5 * ((_d - (s.k1 + 0.1 * s.x)) / 0.5) ** 2,
        ),
        companions=[],
        observations=[ot.DirectLL("ll")],
    )
    m = ot.LogDensityModel(system, verbosity=0, device="cpu")
    assert m.discrete_mode == "gibbs"
    assert m.parameter_names == ["x"]
    assert m.discrete_names == ["k1", "k2", "k3"]

    # the conditional log posterior and one sweep work on their own
    disc = torch.tensor([0.0, 3.0, 5.0], dtype=torch.float64)
    theta_t = m.link(torch.tensor([0.0], dtype=torch.float64))
    assert torch.isfinite(m.ln_post_given_disc(theta_t, disc))
    assert m.gibbs_update_disc(theta_t, disc, torch.Generator().manual_seed(0)).shape == (3,)

    with pytest.raises(ValueError, match="drop_warmup=False"):
        ot.octofit(m, chains=2, adaptation=2, iterations=2, drop_warmup=False, verbosity=0,
                   starting_points=theta_t)
    chain = ot.octofit(m, chains=8, adaptation=60, iterations=120, verbosity=0,
                       starting_points=theta_t)
    assert chain.info["sampler"] == "gibbs_vectorized"
    assert chain.info["n_sweep_evals"] == 3 * 180
    k1 = chain["k1"].reshape(-1)
    k2 = chain["k2"].reshape(-1)
    # the analytic posterior of k1 (x marginalized: sigma_eff^2 = 0.5^2 +
    # 0.1^2): P(7) ~ 0.63, P(8) ~ 0.28
    ks = np.arange(20.0)
    w = -0.5 * (datum - ks) ** 2 / (0.25 + 0.01)
    p = np.exp(w - sp_logsumexp(w))
    assert abs(np.mean(k1 == 7.0) - p[7]) < 0.12, (np.mean(k1 == 7.0), p[7])
    assert abs(np.mean(k1 == 8.0) - p[8]) < 0.12, (np.mean(k1 == 8.0), p[8])
    assert np.all(np.isin(np.unique(k1), [5.0, 6.0, 7.0, 8.0, 9.0, 10.0]))
    # the uninformative one keeps exploring its domain
    assert len(np.unique(k2)) > 10
    assert 5.0 < k2.mean() < 14.0
    assert np.isfinite(chain["x"]).all()


# --------------------------------------------------------------------------
# The port against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cal", "out12", "out13"])
def test_modes_and_names_match(models, name):
    mt, ref = models["mt"][name], models["ref"].result()[name]
    assert mt.discrete_mode == ref["mode"] == ("gibbs" if name == "out13" else "marginalize")
    assert mt.discrete_names == ref["names"]
    assert mt.parameter_names == ref["parameter_names"]
    if name == "out12":
        assert len(mt._disc_combos) == 4096
        np.testing.assert_array_equal(mt._disc_combos.numpy(), ref["combos"])
        np.testing.assert_allclose(mt._disc_logw.numpy(), ref["logw"], rtol=1e-12)


@pytest.mark.parametrize("name", ["cal", "out12", "out13"])
def test_ln_post_and_grad_match(models, name):
    """The marginalized (or, in the Gibbs mode, first-value) ln_post and its
    gradient at 1e-10, relative to each point's value and largest gradient
    entry."""
    mt, ref = models["mt"][name], models["ref"].result()[name]
    lp, g = mt.ln_post_and_grad(torch.as_tensor(models["points"][name]))
    np.testing.assert_allclose(lp.numpy(), ref["ln_post"], rtol=1e-10, atol=0)
    scale = np.abs(ref["grad"]).max(axis=1, keepdims=True)
    assert (np.abs(g.numpy() - ref["grad"]) <= 1e-10 * scale).all()


@pytest.mark.parametrize("name", ["cal", "out12", "out13"])
def test_ln_post_given_disc_and_logpmf_match(models, name):
    mt, ref = models["mt"][name], models["ref"].result()[name]
    pts = torch.as_tensor(models["points"][name])
    disc = torch.as_tensor(models["discs"][name])
    np.testing.assert_allclose(mt.ln_post_given_disc(pts, disc).numpy(), ref["given"],
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(mt.disc_logpmf(disc).numpy(), ref["logpmf"], rtol=1e-12)


@pytest.mark.parametrize("name", ["cal", "out12"])
def test_discrete_conditional_logits_match(models, name):
    """Every combination's logit at 1e-10 of the largest in magnitude (at
    K = 4096 they span many orders)."""
    mt, ref = models["mt"][name], models["ref"].result()[name]
    logits = mt.discrete_conditional_logits(torch.as_tensor(models["points"][name])).numpy()
    assert logits.shape == ref["logits"].shape == (N_POINTS, len(mt._disc_combos))
    scale = np.abs(ref["logits"]).max(axis=1, keepdims=True)
    assert (np.abs(logits - ref["logits"]) <= 1e-10 * scale).all()


def test_gibbs_update_matches_jax_exactly(models):
    """One sweep over the 13 flags of every point from JAX's own Gumbel
    noise gives JAX's draws exactly."""
    mt, ref = models["mt"]["out13"], models["ref"].result()["out13"]
    new = mt.gibbs_update_disc(torch.as_tensor(models["points"]["out13"]),
                               torch.as_tensor(models["discs"]["out13"]), noise=ref["noise"])
    np.testing.assert_array_equal(new.numpy(), ref["gibbs"])


def test_nan_combination_is_minus_inf(models):
    """Check g: a combination whose likelihood is NaN counts as -inf before
    the logsumexp, so ln_post is the other combination's, as in JAX."""
    mt = ot.LogDensityModel(_nan_model(ot, torch.where), verbosity=0, device="cpu")
    xs = torch.tensor([[-1.0], [0.3], [2.0]], dtype=torch.float64)
    lp = mt.ln_post(xs).numpy()
    want = (-0.5 * xs[:, 0] ** 2 - 0.5 * math.log(2 * math.pi) + math.log(0.7)
            - 0.5 * (xs[:, 0] - 0.5) ** 2).numpy()
    np.testing.assert_allclose(lp, want, rtol=1e-12)
    logits = mt.discrete_conditional_logits(xs).numpy()
    assert np.isneginf(logits[:, 0]).all()
    ref = models["ref"].result()["nan"]
    np.testing.assert_allclose(lp, ref["ln_post"], rtol=1e-12)
    np.testing.assert_array_equal(np.isneginf(ref["logits"]), np.isneginf(logits))
    np.testing.assert_allclose(logits[:, 1], ref["logits"][:, 1], rtol=1e-12)


def test_chunked_marginalization_matches_one_pass(models, monkeypatch):
    """At the cap, the combinations taken in chunks, each recomputed in the
    backward pass, give the one-pass value and gradient."""
    mt = models["mt"]["out12"]
    pts = torch.as_tensor(models["points"]["out12"][:2])
    lp1, g1 = mt.ln_post_and_grad(pts)
    monkeypatch.setattr(mt, "_combo_chunk", lambda n_theta: 1000)
    lp5, g5 = mt.ln_post_and_grad(pts)
    np.testing.assert_allclose(lp5.numpy(), lp1.numpy(), rtol=1e-13)
    np.testing.assert_allclose(g5.numpy(), g1.numpy(), rtol=1e-11, atol=1e-11)


def test_marginalized_octofit_recovers_the_calibration(models):
    """`octofit` on the calibration model (jittered HMC, a few chains and
    steps, from a point near the truth): the discrete column is in the chain and picks
    the plate scale the data were made with, and `octofit_pigeons` raises
    on a discrete model."""
    mt = models["mt"]["cal"]
    pts = torch.as_tensor(models["points"]["cal"][:2])
    chain = ot.octofit(mt, chains=2, adaptation=20, iterations=10, verbosity=0,
                       starting_points=pts[0], metric="diag", sampler="hmc", max_depth=2)
    assert chain["b_simdata_cal"].shape == (2, 10)
    assert chain["b_simdata_cal"].mean() > 0.9
    with pytest.raises(NotImplementedError, match="discrete priors"):
        ot.octofit_pigeons(mt, n_rounds=1, n_walkers=2, verbosity=0)


@pytest.mark.parametrize("scale, gap", [(chip_smoke.CAL_SCALE, (10.0, np.inf)), (1.05, (0.0, 1.0))])
def test_calibration_data_choose_the_plate_scale(models, scale, gap):
    """The premise of the smoke's calibration gate (mean cal > 0.9): a
    plate scale s is degenerate with a smaller orbit, a / s, whose period
    the data pin, so M / s^3; the M prior N(1.2, 0.1) then sets the second
    mode's height. At CAL_SCALE the cal = 0 mode's log posterior lies more
    than 10 below the cal = 1 mode's; at s = 1.05 the two lie within one
    nat, and a fit's cal would follow whichever mode it started in."""
    from scipy.optimize import minimize

    if scale == chip_smoke.CAL_SCALE:
        mt = models["mt"]["cal"]
    else:
        table = chip_smoke.calibration_table(ot, scale)
        mt = chip_smoke.build_calibration_model(ot, table, scale, device="cpu")

    def mode(theta_t):
        def fun(x):
            lp, g = mt.ln_post_and_grad(x)
            return -float(lp), -g.numpy()

        res = minimize(fun, theta_t, jac=True, method="L-BFGS-B")
        return -res.fun, torch.as_tensor(res.x)

    lp1, x1 = mode(models["points"]["cal"][0])
    nat = mt.invlink(x1)
    nat[0] /= scale**3  # M
    nat[2] /= scale  # a
    lp0, x0 = mode(mt.link(nat).numpy())
    for x, k in ((x1, 1), (x0, 0)):
        assert int(torch.argmax(mt.discrete_conditional_logits(x))) == k
    assert gap[0] < lp1 - lp0 < gap[1], (lp1, lp0)


def test_load_jax_state_checks_discrete_names(models):
    mt = models["mt"]["cal"]
    D = mt.D
    kw = dict(parameter_names=mt.parameter_names, starting_points=np.zeros((3, D)),
              laplace_sigma=np.eye(D))
    with pytest.raises(ValueError, match="discrete variables differ"):
        ot.interop.load_jax_state(mt, **kw)
    ot.interop.load_jax_state(mt, discrete_names=["b_simdata_cal"], **kw)
    assert mt.starting_points.shape == (3, D)
    mt.starting_points = None
    mt.laplace_sigma = None
