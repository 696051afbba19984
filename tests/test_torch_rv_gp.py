"""The port's Gaussian-process RV likelihoods and `examples/03_rv_gp.py`'s
model against the JAX package in float64 on the CPU, the RV archive
loaders, `radvel_posterior`, and a short fit of the GP model in both
packages.

The JAX model is the example's own (`examples/03_rv_gp.py:model`); the
port's is `chip_smoke.build_rvgp_model` on the example's table, and
`chip_smoke.rvgp_data` makes that table again with the port's orbit solve.
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
from octofitter_tpu.model import variables as jax_vars
from octofitter_tpu_torch.interop import load_jax_state
from octofitter_tpu_torch.model import variables as port_vars

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-10
# the short fit: the example's first FIT_EPOCHS epochs (about 45 days, one
# period), initialized by the port and sampled by both packages with ChEES
FIT_EPOCHS = 20
CHAINS, WARMUP, DRAWS = 32, 100, 100
INIT_SIZES = dict(n_prior_samples=1000, n_multistart=8, n_opt_steps=60, n_draws=4 * CHAINS)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def _jax_example():
    spec = importlib.util.spec_from_file_location("example_03", ROOT / "examples" / "03_rv_gp.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


@pytest.fixture(scope="module")
def example():
    """(JAX model, port model on the CPU in float64, the example's table,
    16 unconstrained points: 8 near the truth and 8 prior draws)."""
    mj = _jax_example().model
    table = dict(mj.system.observations[0].table)
    mt = chip_smoke.build_rvgp_model(ot, table, device="cpu")
    near = chip_smoke.rvgp_points_near_truth(ot, mt, 8, seed=1).numpy()
    draws = np.asarray(jax.vmap(lambda k: mj.link(mj.sample_priors(k)))(
        jax.random.split(jax.random.PRNGKey(3), 8)))
    return mj, mt, table, np.concatenate([near, draws])


def _value_and_grad(mj, mt, pts):
    vj, gj = jax.jit(jax.vmap(mj.ln_post_and_grad))(jnp.asarray(pts))
    vt, gt = mt.ln_post_and_grad(torch.as_tensor(pts))
    return (vt.numpy(), gt.numpy()), (np.asarray(vj), np.asarray(gj))


def test_rvgp_data_is_the_examples(example):
    """`chip_smoke.rvgp_data` (the port's orbit solve) makes the example's
    table to float64 rounding."""
    _, _, table, _ = example
    data = chip_smoke.rvgp_data(ot)
    for k in ("epoch", "rv", "σ_rv"):
        np.testing.assert_allclose(data[k], table[k], rtol=1e-12, atol=1e-9)


def test_rvgp_ln_post_and_grad_match_jax(example):
    """`ln_post_and_grad` of the example's model at the 16 points within
    1e-10 of the JAX package's; the associative method gives the same
    values."""
    mj, mt, table, pts = example
    assert list(mt.parameter_names) == list(mj.parameter_names)
    (vt, gt), (vj, gj) = _value_and_grad(mj, mt, pts)
    assert np.isfinite(vt).all() and np.isfinite(gt).all()
    assert _rel(vt, vj) < RTOL
    assert _rel(gt, gj) < RTOL
    ma = chip_smoke.build_rvgp_model(ot, table, gp_method="associative", device="cpu")
    with torch.no_grad():
        assert _rel(ma.ln_post(torch.as_tensor(pts)).numpy(), vj) < RTOL


def test_rvgp_composed_hessian_matches_jax(example):
    """The Laplace step's Hessian (`fused=False`, `torch.func`) through the
    plain celerite recursion within 1e-8 of `jax.hessian` at a point near
    the truth."""
    mj, mt, _, pts = example
    x = torch.as_tensor(pts[0])
    H_t = torch.func.hessian(lambda th: mt.ln_post(th[None, :], fused=False)[0])(x).numpy()
    H_j = np.asarray(jax.jit(jax.hessian(mj.ln_post))(jnp.asarray(pts[0])))
    assert np.isfinite(H_t).all()
    assert np.abs(H_t - H_j).max() <= 1e-8 * np.abs(H_j).max()


def test_rvgp_held_out_matches_jax(example):
    """Cross-validation: the model conditioned on 60 of the 80 rows and
    scored at the other 20 through `gp_predict` and the orbit solved at the
    held-out epochs, `ln_post_and_grad` within 1e-10 of JAX's on the same
    split."""
    _, _, table, pts = example
    keep = np.sort(np.random.default_rng(4).choice(80, 60, replace=False))
    mj = chip_smoke.build_rvgp_model(oc, table, epoch_subset=keep)
    mt = chip_smoke.build_rvgp_model(ot, table, epoch_subset=keep, device="cpu")
    obs = mt.system.observations[0]
    assert len(obs.table["epoch"]) == 60 and len(obs.held_out_table["epoch"]) == 20
    (vt, gt), (vj, gj) = _value_and_grad(mj, mt, pts)
    assert np.isfinite(vt[:8]).all()
    assert _rel(vt, vj) < RTOL
    assert _rel(gt, gj) < RTOL


def _contexts(mt, mj, obs_t, obs_j, pts, theta_obs, planet=None):
    """Observation contexts of both packages at the points, the orbits
    solved at the observation's epochs: (port context, JAX function of one
    point and its theta_obs dict that builds the JAX context)."""
    nt = mt.arr2nt(mt.invlink(torch.as_tensor(pts)))
    orbits = mt.construct_orbits(nt)
    sols = tuple(ot.orbitsolve(o, obs_t.epochs) for o in orbits)
    th_obs = ot.Params({k: torch.as_tensor(v) for k, v in theta_obs.items()})
    if planet is None:
        ctx_t = port_vars.SystemObservationContext(
            theta_system=nt, theta_obs=th_obs, orbits=orbits, solutions=sols, epoch_start=0)
    else:
        ctx_t = port_vars.PlanetObservationContext(
            theta_system=nt, theta_planet=nt.planets[planet], theta_obs=th_obs,
            orbits=orbits, solutions=sols, i_planet=0, epoch_start=0)

    def ctx_j(th, ex):
        ntj = mj.arr2nt(mj.invlink(th))
        orbits_j = mj.construct_orbits(ntj)
        sols_j = tuple(oc.orbitsolve(o, jnp.asarray(obs_j.epochs)) for o in orbits_j)
        if planet is None:
            return jax_vars.SystemObservationContext(
                theta_system=ntj, theta_obs=oc.Params(ex), orbits=orbits_j, solutions=sols_j,
                epoch_start=0)
        return jax_vars.PlanetObservationContext(
            theta_system=ntj, theta_planet=ntj.planets[planet], theta_obs=oc.Params(ex),
            orbits=orbits_j, solutions=sols_j, i_planet=0, epoch_start=0)

    return ctx_t, ctx_j


def _obs_variables(n, seed):
    rng = np.random.default_rng(seed)
    return dict(offset=rng.uniform(5.0, 15.0, n), jitter=rng.uniform(0.2, 2.0, n),
                gp_S0=rng.uniform(1.0, 20.0, n), gp_w0=rng.uniform(0.1, 0.6, n))


@pytest.mark.parametrize("kind", ["star", "planet"])
def test_gp_obs_ln_like_and_pointwise_match_jax(example, kind):
    """`StarAbsoluteRVObs` (system-attached) and `PlanetRelativeRVObs`
    (planet-attached, relative RVs of planet b) with an SHOTerm GP: `ln_like`
    per point and `pointwise_ln_like` (the per-point marginal with the
    kernel's diagonal), (C,) and (C, n), within 1e-10 of JAX's at the 16
    points with per-point GP hyperparameters."""
    mj, mt, table, pts = example
    cls_t, cls_j = ((ot.StarAbsoluteRVObs, oc.StarAbsoluteRVObs) if kind == "star"
                    else (ot.PlanetRelativeRVObs, oc.PlanetRelativeRVObs))
    gp_t = lambda o: ot.rv.SHOTerm(S0=o.gp_S0, w0=o.gp_w0, Q=3.0)  # noqa: E731
    gp_j = lambda o: oc.rv.SHOTerm(S0=o.gp_S0, w0=o.gp_w0, Q=3.0)  # noqa: E731
    obs_t = cls_t(table, name="inst", gaussian_process=gp_t)
    obs_j = cls_j(table, name="inst", gaussian_process=gp_j)
    theta_obs = _obs_variables(len(pts), seed=5)
    planet = None if kind == "star" else "b"
    ctx_t, ctx_j = _contexts(mt, mj, obs_t, obs_j, pts, theta_obs, planet)
    with torch.no_grad():
        ll_t = obs_t.ln_like(ctx_t).numpy()
        pw_t = obs_t.pointwise_ln_like(ctx_t).numpy()
    ex = {k: jnp.asarray(v) for k, v in theta_obs.items()}
    ll_j = jax.jit(jax.vmap(lambda th, e: obs_j.ln_like(ctx_j(th, e))))(jnp.asarray(pts), ex)
    pw_j = jax.jit(jax.vmap(lambda th, e: obs_j.pointwise_ln_like(ctx_j(th, e))))(
        jnp.asarray(pts), ex)
    assert ll_t.shape == (len(pts),) and pw_t.shape == (len(pts), 80)
    assert _rel(ll_t, ll_j) < RTOL
    assert _rel(pw_t, pw_j) < RTOL


def test_gp_method_associative_matches_scan_and_jax():
    """gp_method="associative" on StarAbsoluteRVObs gives the scan path's
    log posterior, and both the JAX package's (a model with no companions,
    as in tests/test_rv.py), at 8 prior draws."""
    rng = np.random.default_rng(1)
    n = 40
    data = dict(epoch=np.sort(rng.uniform(58000, 59000, n)), rv=rng.standard_normal(n) * 5.0,
                σ_rv=np.full(n, 3.0))

    def build(pkg, method, **kw):
        obs = pkg.StarAbsoluteRVObs(
            data, name="inst",
            variables=dict(offset=pkg.distributions.Normal(0.0, 10.0),
                           jitter=pkg.distributions.LogUniform(0.01, 10.0),
                           eta1=pkg.distributions.LogUniform(0.1, 20.0)),
            gaussian_process=lambda th: pkg.rv.SHOTerm(S0=th.eta1**2, w0=0.3, Q=2.0),
            gp_method=method)
        system = pkg.System(name=f"gp_{method}", variables=dict(M=1.0, plx=50.0),
                            observations=[obs], companions=[])
        return pkg.LogDensityModel(system, verbosity=0, **kw)

    mj = build(oc, "scan")
    pts = np.asarray(jax.vmap(lambda k: mj.link(mj.sample_priors(k)))(
        jax.random.split(jax.random.PRNGKey(2), 8)))
    lp_j = np.asarray(jax.jit(jax.vmap(mj.ln_post))(jnp.asarray(pts)))
    with torch.no_grad():
        lp_scan = build(ot, "scan", device="cpu").ln_post(torch.as_tensor(pts)).numpy()
        lp_assoc = build(ot, "associative", device="cpu").ln_post(torch.as_tensor(pts)).numpy()
    assert _rel(lp_scan, lp_j) < RTOL
    assert _rel(lp_assoc, lp_scan) < RTOL


def test_dense_gp_model_gradient_matches_jax():
    """A model with a dense SqExponentialKernel GP (tests/test_rv.py's
    `test_gp_model_gradient`): `ln_post_and_grad` within 1e-10 of JAX's at
    8 prior draws, all finite."""
    rng = np.random.default_rng(2)
    n = 25
    data = dict(epoch=np.sort(rng.uniform(57000, 57100, n)), rv=rng.standard_normal(n) * 5.0,
                σ_rv=np.full(n, 2.0))

    def build(pkg, **kw):
        dist = pkg.distributions
        obs = pkg.StarAbsoluteRVObs(
            data, dict(offset=dist.Normal(0, 100.0), jitter=dist.LogUniform(0.01, 30.0),
                       gp_amp=dist.LogUniform(0.1, 30.0), gp_len=dist.LogUniform(1.0, 100.0)),
            name="inst",
            gaussian_process=lambda th: pkg.rv.SqExponentialKernel(amplitude=th.gp_amp,
                                                                   lengthscale=th.gp_len))
        b = pkg.Planet(name="b", basis="RadialVelocityOrbit",
                       variables=dict(a=dist.Uniform(0.01, 1.0), e=dist.Uniform(0.0, 0.9),
                                      omega=pkg.UniformCircular(),
                                      tp=dist.Uniform(56994.0, 57006.0),
                                      mass=dist.Uniform(0.0, 20.0)))
        system = pkg.System(name="rvgp", variables=dict(M=dist.truncated(dist.Normal(1.0, 0.05),
                                                                         lower=0.1)),
                            companions=[b], observations=[obs])
        return pkg.LogDensityModel(system, verbosity=0, **kw)

    mj, mt = build(oc), build(ot, device="cpu")
    pts = np.asarray(jax.vmap(lambda k: mj.link(mj.sample_priors(k)))(
        jax.random.split(jax.random.PRNGKey(2), 8)))
    (vt, gt), (vj, gj) = _value_and_grad(mj, mt, pts)
    assert np.isfinite(vt).all() and np.isfinite(gt).all()
    assert _rel(vt, vj) < RTOL
    assert _rel(gt, gj) < RTOL


# each loader with a CSV in its archive's columns
LOADERS = {
    "HARPS_RVBank_rvs": dict(target=["HD1", "HD1", "HD2"], BJD=[2455000.5, 2455001.5, 2455002.5],
                             RV_mlc_nzp=[10.0, 12.0, -5.0], e_RV_mlc_nzp=[1.0, 1.1, 0.9]),
    "HARPS_DR1_rvs": dict(target=["HD1", "HD2", "HD1"], bjd=[2455000.5, 2455001.5, 2455002.5],
                          rv=[10.0, 12.0, -5.0], e_RV=[1.0, 1.1, 0.9]),
    "HIRES_rvs": dict(Star=["HD1", "HD1", "HD2"], JD=[2455000.5, 2455001.5, 2455002.5],
                      mnvel=[10.0, 12.0, -5.0], errvel=[1.0, 1.1, 0.9]),
    "Lick_rvs": dict(target=["HD2", "HD1", "HD1"], BJD=[2455000.5, 2455001.5, 2455002.5],
                     RV=[10.0, 12.0, -5.0], e_RV=[1.0, 1.1, 0.9]),
    "CES_lc_rvs": dict(target=["HD1", "HD1", "HD2"], BJD=[2455000.5, 2455001.5, 2455002.5],
                       RV=[10.0, 12.0, -5.0], e_RV=[1.0, 1.1, 0.9]),
    "CES_vlc_rvs": dict(target=["HD1", "HD2", "HD1"], BJD=[2455000.5, 2455001.5, 2455002.5],
                        RV=[10.0, 12.0, -5.0], e_RV=[1.0, 1.1, 0.9]),
}


@pytest.mark.parametrize("name", list(LOADERS))
def test_loader_matches_jax(tmp_path, name):
    """Each archive loader on a CSV written to `tmp_path`: the port's table
    equals the JAX package's (epochs in MJD), and an unknown target raises
    KeyError in both."""
    pd = pytest.importorskip("pandas")
    path = tmp_path / f"{name}.csv"
    pd.DataFrame(LOADERS[name]).to_csv(path, index=False)
    tab_t = getattr(ot, name)("HD1", path)
    tab_j = getattr(oc, name)("HD1", path)
    assert set(tab_t) == {"epoch", "rv", "σ_rv"} and len(tab_t["epoch"]) == 2
    for k in tab_t:
        np.testing.assert_array_equal(tab_t[k], tab_j[k])
    assert tab_t["epoch"].min() >= 55000.0
    for loader in (getattr(ot, name), getattr(oc, name)):
        with pytest.raises(KeyError):
            loader("HD99", path)


def test_radvel_posterior_matches_jax():
    """`radvel_posterior` on a RadVel table: the columns that do not depend
    on the drawn stellar mass and parallax equal the JAX package's; a and
    msini follow from the port's own draws by the same formulas (to 1e-12)
    and lie where JAX's do."""
    rng = np.random.default_rng(6)
    n = 200
    table = dict(per1=rng.uniform(900.0, 1100.0, n), k1=rng.uniform(25.0, 35.0, n),
                 e1=rng.uniform(0.0, 0.3, n), w1=rng.uniform(0.0, 6.0, n),
                 tp1=rng.uniform(2455000.0, 2455100.0, n))
    M_t, plx_t = ot.distributions.Normal(1.0, 0.01), ot.distributions.Normal(50.0, 0.1)
    ch_t = ot.radvel_posterior(table, M_t, plx_t, seed=3, device="cpu")
    ch_j = oc.radvel_posterior(table, oc.distributions.Normal(1.0, 0.01),
                               oc.distributions.Normal(50.0, 0.1), seed=3)
    assert ch_t.info["sampler"] == "radvel" and ch_t["b_a"].shape == (1, n)
    for k in ("b_P", "b_e", "b_omega", "b_tp"):
        np.testing.assert_array_equal(ch_t[k], ch_j[k])
    M = ch_t["M"][0]
    assert abs(M.mean() - 1.0) < 0.005 and abs(ch_t["plx"].mean() - 50.0) < 0.05
    a = np.cbrt(M * (table["per1"] / ot.constants.KEPLER_YEAR_DAYS) ** 2)
    np.testing.assert_allclose(ch_t["b_a"][0], a, rtol=1e-12)
    msini = (table["k1"] / ot.constants.AUDAY_TO_MS * np.sqrt(1 - table["e1"] ** 2) * M
             * table["per1"] / (2 * np.pi * a) / ot.constants.MJUP2MSOL)
    np.testing.assert_allclose(ch_t["b_msini"][0], msini, rtol=1e-12)
    for k in ("b_a", "b_msini"):
        assert abs(np.median(ch_t[k]) - np.median(ch_j[k])) < 0.01 * np.median(ch_j[k])


def _median_and_mcse(x):
    """Posterior median, its Monte-Carlo standard error sqrt(pi / 2) sd /
    sqrt(ESS), and max split-R-hat."""
    ess, rhat = ot.ess_rhat_batch(x)
    return float(np.median(x)), math.sqrt(math.pi / 2) * x.std() / math.sqrt(ess[0]), rhat[0]


@pytest.fixture(scope="module")
def fits():
    """A short fit of the GP model on the example's first FIT_EPOCHS epochs
    in both packages: the port's `initialize` finds the starting state,
    which `interop.load_jax_state` checks against the JAX model and both
    start from; then ChEES in both. The JAX model's build, then its run
    (mostly XLA compiling, which releases the GIL), go in a thread beside
    the port's initialization and run."""
    data = {k: v[:FIT_EPOCHS] for k, v in chip_smoke.rvgp_data(ot).items()}
    mt = chip_smoke.build_rvgp_model(ot, data, device="cpu")
    with ThreadPoolExecutor(1) as pool:
        future_mj = pool.submit(chip_smoke.build_rvgp_model, oc, data)
        mt.initialize(torch.Generator().manual_seed(0), verbosity=0, **INIT_SIZES)
        mj = future_mj.result(timeout=600)
        load_jax_state(mt, parameter_names=mj.parameter_names,
                       starting_points=mt.starting_points.numpy(),
                       laplace_sigma=mt.laplace_sigma.numpy())
        mj.starting_points = jnp.asarray(mt.starting_points.numpy())
        mj.laplace_sigma = jnp.asarray(mt.laplace_sigma.numpy())
        future_j = pool.submit(oc.octofit, mj, chains=CHAINS, adaptation=WARMUP,
                               iterations=DRAWS, key=jax.random.PRNGKey(2), verbosity=0)
        chain_t = ot.octofit(mt, chains=CHAINS, adaptation=WARMUP, iterations=DRAWS,
                             generator=torch.Generator().manual_seed(2), verbosity=0)
        chain_j = future_j.result(timeout=600)
    assert chain_t["b_mass"].shape == (CHAINS, DRAWS)
    return chain_t, chain_j


@pytest.mark.parametrize("name", ["b_mass", "b_a"])
def test_rvgp_fit_matches_jax_posterior(fits, name):
    """The posterior median agrees within 4 combined Monte-Carlo standard
    errors, and both runs have R-hat < 1.05 on the parameter."""
    chain_t, chain_j = fits
    med_t, se_t, rhat_t = _median_and_mcse(chain_t[name])
    med_j, se_j, rhat_j = _median_and_mcse(chain_j[name])
    assert rhat_t < 1.05 and rhat_j < 1.05, (rhat_t, rhat_j)
    assert abs(med_t - med_j) < 4 * math.hypot(se_t, se_j), (med_t, med_j, se_t, se_j)
