"""The port's HGCA and RV likelihoods, and the joint astrometry + HGCA +
marginalized-RV model, against the JAX package in float64 on the CPU.

The joint model is `examples/02_joint_astrom_pma_rv.py:build_model`, built
once per module by the JAX package; the port's model is built from that
model's own data tables with `chip_smoke.build_joint_model`. Each
observation is evaluated by both packages through observation contexts
made the same way (solutions at the observation's own epochs), at 32
unconstrained points: 16 near the truth and 16 prior draws.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.integrate
import torch

import octofitter_tpu as oc
import octofitter_tpu_torch as ot
from octofitter_tpu.likelihoods import hgca as jax_hgca
from octofitter_tpu.model import variables as jax_vars
from octofitter_tpu_torch.interop import load_jax_state
from octofitter_tpu_torch.io import write_bintable
from octofitter_tpu_torch.likelihoods import hgca as port_hgca
from octofitter_tpu_torch.model import variables as port_vars

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-10


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


@pytest.fixture(scope="module")
def joint():
    """(JAX model, port model on the CPU in float64, the data tables)."""
    spec = importlib.util.spec_from_file_location(
        "example_02", ROOT / "examples" / "02_joint_astrom_pma_rv.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    mj, _, _ = example.build_model()
    sysj = mj.system
    data = {"astrom": dict(sysj.planets[0].observations[0].table),
            "hgca": dict(sysj.observations[0].hgca),
            "rv": dict(sysj.observations[1].table)}
    mt = chip_smoke.build_joint_model(ot, data, device="cpu")
    return mj, mt, data


@pytest.fixture(scope="module")
def points(joint):
    """(32, 15) unconstrained points, numpy float64."""
    mj, mt, _ = joint
    near = chip_smoke.joint_points_near_truth(ot, mt, 16, seed=7).numpy()
    draws = np.asarray(jax.vmap(lambda k: mj.link(mj.sample_priors(k)))(
        jax.random.split(jax.random.PRNGKey(3), 16)))
    return np.concatenate([near, draws])


def _port_obs_ln_like(mt, obs, theta, theta_obs=None, planet=None, pointwise=False):
    """`obs.ln_like` (or `pointwise_ln_like`) in the port at the (C, D)
    points `theta`, with the orbits solved at the observation's own epochs."""
    nt = mt.arr2nt(mt.invlink(torch.as_tensor(theta)))
    orbits = mt.construct_orbits(nt)
    sols = tuple(ot.orbitsolve(o, obs.epochs) for o in orbits)
    if theta_obs is None:
        theta_obs = nt.observations.get(obs.normalized_name, ot.Params())
    if planet is None:
        ctx = port_vars.SystemObservationContext(
            theta_system=nt, theta_obs=theta_obs, orbits=orbits, solutions=sols, epoch_start=0)
    else:
        ctx = port_vars.PlanetObservationContext(
            theta_system=nt, theta_planet=nt.planets[planet], theta_obs=theta_obs,
            orbits=orbits, solutions=sols, i_planet=0, epoch_start=0)
    with torch.no_grad():
        return (obs.pointwise_ln_like if pointwise else obs.ln_like)(ctx).numpy()


def _jax_obs_ln_like(mj, obs, theta, theta_obs=None, planet=None):
    """The same through the JAX package, vmapped over the points;
    `theta_obs` is a dict of per-point arrays."""
    extra = {} if theta_obs is None else {k: jnp.asarray(v) for k, v in theta_obs.items()}

    def one(th, ex):
        nt = mj.arr2nt(mj.invlink(th))
        orbits = mj.construct_orbits(nt)
        sols = tuple(oc.orbitsolve(o, jnp.asarray(obs.epochs)) for o in orbits)
        t_obs = (oc.Params(ex) if theta_obs is not None
                 else nt.observations.get(obs.normalized_name, oc.Params()))
        if planet is None:
            ctx = jax_vars.SystemObservationContext(
                theta_system=nt, theta_obs=t_obs, orbits=orbits, solutions=sols, epoch_start=0)
        else:
            ctx = jax_vars.PlanetObservationContext(
                theta_system=nt, theta_planet=nt.planets[planet], theta_obs=t_obs,
                orbits=orbits, solutions=sols, i_planet=0, epoch_start=0)
        return obs.ln_like(ctx)

    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(theta), extra))


@pytest.mark.parametrize("n_ave", [1, 5])
def test_hgca_ln_like_matches_jax(joint, points, n_ave):
    """`HGCAInstantaneousObs.ln_like` at the 32 points, one value per
    point, within 1e-10 relative of the JAX package's. The declination
    epochs are moved off the right ascension's, as in real catalog rows,
    so that the two coordinates' averages differ."""
    mj, mt, data = joint
    row = dict(data["hgca"], epoch_dec_hip=1991.29, epoch_dec_gaia=2016.03)
    obs_t = ot.HGCAInstantaneousObs(hgca=row, N_ave=n_ave)
    obs_j = oc.HGCAInstantaneousObs(hgca=row, N_ave=n_ave)
    np.testing.assert_array_equal(obs_t.epochs, obs_j.epochs)
    ll_t = _port_obs_ln_like(mt, obs_t, points)
    assert ll_t.shape == (len(points),)
    np.testing.assert_array_equal(_port_obs_ln_like(mt, obs_t, points, pointwise=True),
                                  ll_t[:, None])
    assert _rel_err(ll_t, _jax_obs_ln_like(mj, obs_j, points)) < RTOL


def test_hgca_generate_from_params_matches_jax(joint, points):
    """Without noise, the catalog values a single parameter set implies."""
    mj, mt, data = joint
    obs_t = ot.HGCAInstantaneousObs(hgca=data["hgca"], N_ave=5)
    obs_j = oc.HGCAInstantaneousObs(hgca=data["hgca"], N_ave=5)
    th = points[0]
    nt_t = mt.arr2nt(mt.invlink(torch.as_tensor(th)))
    orbits_t = mt.construct_orbits(nt_t)
    ctx_t = port_vars.SystemObservationContext(
        theta_system=nt_t, theta_obs=ot.Params(), orbits=orbits_t,
        solutions=tuple(ot.orbitsolve(o, obs_t.epochs) for o in orbits_t), epoch_start=0)
    nt_j = mj.arr2nt(mj.invlink(jnp.asarray(th)))
    orbits_j = mj.construct_orbits(nt_j)
    ctx_j = jax_vars.SystemObservationContext(
        theta_system=nt_j, theta_obs=oc.Params(), orbits=orbits_j,
        solutions=tuple(oc.orbitsolve(o, jnp.asarray(obs_j.epochs)) for o in orbits_j),
        epoch_start=0)
    rng = np.random.default_rng(0)
    gen_t = obs_t.generate_from_params(ctx_t, rng)
    gen_j = obs_j.generate_from_params(ctx_j, rng)
    for key in ("pmra_hip", "pmdec_hip", "pmra_gaia", "pmdec_gaia", "pmra_hg", "pmdec_hg"):
        assert gen_t.hgca[key] == pytest.approx(gen_j.hgca[key], rel=RTOL)


def test_gaia_plx_logpdf_matches_jax(joint):
    _, _, data = joint
    d_t = ot.gaia_plx(hgca_row=data["hgca"])
    d_j = oc.gaia_plx(hgca_row=data["hgca"])
    assert (d_t.lower, d_t.upper) == (d_j.lower, d_j.upper)
    x = np.array([50.0, 50.9, 51.0, 51.05, 51.99, 52.1])   # the last outside
    lp_t = d_t.logpdf(torch.as_tensor(x)).numpy()
    lp_j = np.asarray(d_j.logpdf(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isfinite(lp_t), np.isfinite(lp_j))
    fin = np.isfinite(lp_j)
    assert _rel_err(lp_t[fin], lp_j[fin]) < RTOL


def test_load_hgca_reads_the_row(joint, tmp_path):
    """A catalog written with the port's `write_bintable` gives the JAX
    `load_hgca`'s row, by gaia_source_id and by hip_id."""
    _, _, data = joint
    keys = [k for k in data["hgca"] if not k.startswith("nonlinear")]
    rows = 3
    table = {k: np.array([data["hgca"][k] + 0.5 * j for j in range(rows)]) for k in keys}
    table["gaia_source_id"] = np.array([111, 222, 333], dtype=np.int64)
    table["hip_id"] = np.array([1, 2, 3], dtype=np.int64)
    path = tmp_path / "hgca.fits"
    write_bintable(str(path), table)
    row_t = port_hgca.load_hgca(str(path), gaia_id=222)
    row_j = jax_hgca.load_hgca(str(path), gaia_id=222)
    assert row_t.keys() == row_j.keys()
    for k in row_j:
        assert row_t[k] == row_j[k], k
    assert row_t["pmra_gaia"] == data["hgca"]["pmra_gaia"] + 0.5
    assert port_hgca.load_hgca(str(path), hip_id=3)["gaia_source_id"] == 333
    with pytest.raises(KeyError):
        port_hgca.load_hgca(str(path), gaia_id=999)
    obs = ot.HGCAInstantaneousObs(catalog=str(path), gaia_id=111)
    assert obs.hgca["pmra_hip"] == data["hgca"]["pmra_hip"]


def _rv_table(data):
    return {k: np.asarray(v) for k, v in data["rv"].items()}


@pytest.mark.parametrize("kind", ["star", "marginalized", "planet"])
def test_rv_ln_like_matches_jax(joint, points, kind):
    """The three RV likelihoods at the 32 points, with an offset and a
    jitter per point (drawn with numpy) where the class has them."""
    mj, mt, data = joint
    rng = np.random.default_rng(5)
    pars = {"offset": rng.uniform(20.0, 40.0, len(points)),
            "jitter": rng.uniform(0.5, 20.0, len(points))}
    table = _rv_table(data)
    planet = None
    if kind == "star":
        obs_t, obs_j = (pkg.StarAbsoluteRVObs(table, name="rvs") for pkg in (ot, oc))
    elif kind == "marginalized":
        obs_t, obs_j = (pkg.MarginalizedStarAbsoluteRVObs(table, name="rvs") for pkg in (ot, oc))
        pars.pop("offset")
    else:
        obs_t, obs_j = (pkg.PlanetRelativeRVObs(table, name="rvs") for pkg in (ot, oc))
        planet = "b"
    theta_obs_t = ot.Params({k: torch.as_tensor(v) for k, v in pars.items()})
    ll_t = _port_obs_ln_like(mt, obs_t, points, theta_obs_t, planet)
    ll_j = _jax_obs_ln_like(mj, obs_j, points, pars, planet)
    assert ll_t.shape == (len(points),)
    assert _rel_err(ll_t, ll_j) < RTOL


def test_marginalized_rv_matches_numerical_integral(joint, points):
    """The marginalized formula against the integral over the zero point
    c of prod_i N(r_i - c; 0, var_i), by quadrature. The reference's
    formula (`rv-absolute-margin.jl:164-181`) is -sum log(2 pi var) -
    (C - B^2/(4A) + log A), which is 2 log(integral) - log(2 pi)."""
    mj, mt, data = joint
    table = _rv_table(data)
    obs = ot.MarginalizedStarAbsoluteRVObs(table, name="rvs")
    jitter = np.array([0.5, 3.0, 12.0, 29.0])
    theta = points[:4]
    ll = _port_obs_ln_like(mt, obs, theta, ot.Params(jitter=torch.as_tensor(jitter)))
    nt = mt.arr2nt(mt.invlink(torch.as_tensor(theta)))
    (orbit,) = mt.construct_orbits(nt)
    with torch.no_grad():
        model_rv = ot.orbits.radvel(ot.orbitsolve(orbit, table["epoch"]),
                                    nt.planets["b"].mass * ot.constants.MJUP2MSOL).numpy()
    for k in range(len(theta)):
        r = table["rv"] - model_rv[k]
        var = table["σ_rv"] ** 2 + jitter[k] ** 2
        A = (1 / var).sum()
        c0 = (r / var).sum() / A

        def log_f(c):
            return -0.5 * ((r - c) ** 2 / var).sum() - 0.5 * np.log(2 * np.pi * var).sum()

        width = 12 / math.sqrt(A)
        integral, _ = scipy.integrate.quad(lambda c: math.exp(log_f(c) - log_f(c0)),
                                           c0 - width, c0 + width, epsabs=0, epsrel=1e-13)
        log_integral = log_f(c0) + math.log(integral)
        assert ll[k] == pytest.approx(2 * log_integral - math.log(2 * math.pi), rel=1e-10)


def test_rv_gaussian_process_raises():
    """Both RV likelihoods take a Gaussian process (they raised
    NotImplementedError until the GP stack was ported), and a copy on a
    subset of epochs keeps it with the other rows held out. What raises is
    the celerite kernels' wrapper, which has no CPU path and no fallback:
    on CPU tensors, and for epochs that require a gradient."""
    from octofitter_tpu_torch.rv import celerite_cuda

    table = {"epoch": np.array([57000.0, 57100.0]), "rv": np.zeros(2), "σ_rv": np.ones(2)}
    for cls in (ot.StarAbsoluteRVObs, ot.PlanetRelativeRVObs):
        obs = cls(table, name="rvs", gaussian_process=lambda theta_obs: None)
        assert obs.gaussian_process is not None and obs.gp_method == "scan"
        part = obs.likeobj_from_epoch_subset([1])
        assert part.gaussian_process is obs.gaussian_process and part.gp_method == "scan"
        np.testing.assert_array_equal(part.held_out_table["epoch"], [57000.0])
    x = torch.ones((2, 1), dtype=torch.float64)
    t, y = torch.zeros(3, dtype=torch.float64), torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        celerite_cuda.celerite_loglike_cuda(x, x, x, x, t, y, y)
    with pytest.raises(ValueError, match="epochs"):
        celerite_cuda.celerite_loglike_cuda(x, x, x, x, t.requires_grad_(True), y, y)


@pytest.fixture(scope="module")
def jax_ln_post_and_grad(joint, points):
    mj = joint[0]
    lp, g = jax.jit(jax.vmap(jax.value_and_grad(mj.ln_post)))(jnp.asarray(points))
    return np.asarray(lp), np.asarray(g)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
def test_joint_ln_post_and_grad_match_jax(joint, points, jax_ln_post_and_grad, fused):
    """The whole joint model: ln_post and its gradient at the 32 points,
    through the fused orbit solve (its plain version on the CPU) and
    through the composed path, within 1e-10 relative of the JAX model."""
    mt = joint[1]
    lp_j, g_j = jax_ln_post_and_grad
    theta = torch.as_tensor(points).requires_grad_(True)
    lp_t = mt.ln_post(theta, fused=fused)
    (g_t,) = torch.autograd.grad(lp_t.sum(), theta)
    assert np.isfinite(lp_j).all()
    assert _rel_err(lp_t.detach().numpy(), lp_j) < RTOL
    g_scale = np.maximum(np.abs(g_j).max(axis=1, keepdims=True), 1.0)
    assert float(np.max(np.abs(g_t.numpy() - g_j) / g_scale)) < RTOL
    if fused:
        lp2, g2 = mt.ln_post_and_grad(points)
        np.testing.assert_array_equal(lp2.numpy(), lp_t.detach().numpy())
        np.testing.assert_array_equal(g2.numpy(), g_t.numpy())


def test_joint_model_layout_and_load_jax_state(joint, points):
    """Both packages flatten the joint model alike (the RV jitter, a
    system observation's variable, sits between the system's and the
    planet's), pack 70 epochs, and `load_jax_state` takes the JAX model's
    state as it stands; a parameter order that differs is refused."""
    mj, mt, _ = joint
    assert mt.parameter_names == list(mj.parameter_names)
    assert mt.parameter_names[4] == "rvs_jitter" and mt.D == 15
    assert mt.n_epochs == chip_smoke.JOINT_EPOCHS == mj.n_epochs
    np.testing.assert_array_equal(mt._all_epochs, mj._all_epochs)
    sigma = np.diag(np.linspace(0.1, 1.0, mt.D))
    load_jax_state(mt, parameter_names=mj.parameter_names, starting_points=points,
                   laplace_sigma=sigma)
    np.testing.assert_array_equal(mt.starting_points.numpy(), points)
    np.testing.assert_array_equal(mt.laplace_sigma.numpy(), sigma)
    names = list(mj.parameter_names)
    names[4], names[5] = names[5], names[4]
    with pytest.raises(ValueError, match="parameter order differs"):
        load_jax_state(mt, parameter_names=names, starting_points=points, laplace_sigma=sigma)


def test_chip_smoke_joint_data_follows_the_example(joint):
    """`chip_smoke.joint_data` (the port's orbitsolve, numpy seed 0) makes
    the example's tables and HGCA row."""
    _, _, data = joint
    mine = chip_smoke.joint_data(ot)
    for key in ("astrom", "rv"):
        for col, v in mine[key].items():
            np.testing.assert_allclose(v, data[key][col], rtol=1e-12, atol=1e-9, err_msg=col)
    for k, v in mine["hgca"].items():
        assert v == pytest.approx(data["hgca"][k], rel=1e-12, abs=1e-12), k
