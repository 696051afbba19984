"""The port's observable and stability priors, photometry and atmosphere
grids against the JAX package, in float64 on the CPU.

The two-planet headline model of `chip_smoke.build_obs_prior_model` (b's
relative astrometry wrapped in `ObsPriorAstromONeil2019`;
`NonCrossingPrior`, `HillStabilityPrior`, `PlanetOrderPrior`; c's
`PhotometryObs` through a Sonora-format grid written to `tmp_path`) is
built once in each package and held at shared points, rows that break
each hard prior among them (-inf with a finite gradient), by
`chip_smoke.hold_values_and_gradients`. Each prior's own value is held to
JAX's row by row, the soft closest-approach penalty included; then
`PhotometryObs` (pointwise values, generation with the same numpy rng),
`interp2d_bilinear` (values and gradients, NaN outside the grid), the
Sonora photometry and cooling interpolators and the BHAC15 loader.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octofitter_tpu as oc
import octofitter_tpu_torch as ot
from octofitter_tpu import atmosphere as atm_j
from octofitter_tpu_torch import atmosphere as atm_t
from octofitter_tpu_torch.interop import load_jax_state

import chip_smoke
from test_torch_orbit_bases import jax_ln_post_and_grad, shared_prior_draws


@pytest.fixture(scope="module")
def sonora_file(tmp_path_factory):
    return chip_smoke.write_sonora_grid(tmp_path_factory.mktemp("sonora"))


@pytest.fixture(scope="module")
def obs_models(sonora_file):
    """The model in both packages and 12 shared points: the valid point,
    one row per violation, 4 points near the valid one and 4 prior draws."""
    table = chip_smoke.bench_table(ot)
    mj = chip_smoke.build_obs_prior_model(oc, table, sonora_file)
    mt = chip_smoke.build_obs_prior_model(ot, table, sonora_file, device="cpu")
    nat = chip_smoke.obs_prior_points(mt)
    structured = np.stack([np.asarray(mj.link(jnp.asarray(r))) for r in nat])
    near = structured[0] + 1e-3 * np.random.default_rng(1).standard_normal((4, mj.D))
    pts = np.concatenate([structured, near, shared_prior_draws(mj, 4, 3)])
    load_jax_state(mt, parameter_names=mj.parameter_names, starting_points=pts,
                   laplace_sigma=np.eye(mj.D))
    return mj, mt, mt.starting_points


def test_obs_prior_model_matches_jax(obs_models):
    mj, mt, pts = obs_models
    vj, gj = jax_ln_post_and_grad(mj, pts)
    vt, gt = mt.ln_post_and_grad(pts)
    zero = torch.zeros_like(vt)
    chip_smoke.hold_values_and_gradients("port vs JAX", vt, gt, vj, gj, zero, zero)
    fin = torch.isfinite(vt)
    assert fin[[0, 4, 5, 6, 7]].all() and not fin[1:4].any()
    assert bool(torch.isfinite(gt).all()) and bool((gt[~fin] == 0).all())


def _contexts(mj, mt, pts):
    """Both packages' system contexts at the points `pts` (JAX's vmapped
    by the caller: a function of one point)."""
    nt_t = mt.arr2nt(mt.invlink(pts))
    orbits_t = mt.construct_orbits(nt_t)
    ctx_t = ot.model.SystemObservationContext(
        theta_system=nt_t, theta_obs=ot.Params(), orbits=orbits_t,
        solutions=tuple(ot.orbitsolve(o, mt._epochs_t) for o in orbits_t), epoch_start=0)

    def ctx_j(th):
        nt = mj.arr2nt(mj.invlink(th))
        orbits = mj.construct_orbits(nt)
        return oc.model.SystemObservationContext(
            theta_system=nt, theta_obs=oc.Params(), orbits=orbits,
            solutions=tuple(oc.orbitsolve(o, jnp.asarray(mj._all_epochs)) for o in orbits),
            epoch_start=0)

    return ctx_j, ctx_t


def test_each_prior_matches_jax_row_by_row(obs_models):
    """Each system prior's value at every point, and which hard prior each
    violation row breaks: crossing orbits NonCrossingPrior, c inside b
    PlanetOrderPrior, Hill-unstable masses alone HillStabilityPrior (the
    first two rows also fail the Hill criterion). The soft closest-approach penalty (1 AU, hard limit
    0.1 AU) is held too."""
    mj, mt, pts = obs_models
    ctx_j, ctx_t = _contexts(mj, mt, pts)
    priors_t = list(mt.system.observations) + [ot.LimitClosestApproachAUPrior(1.0, 0.1)]
    priors_j = list(mj.system.observations) + [oc.LimitClosestApproachAUPrior(1.0, 0.1)]
    vals = {}
    for key, p_t, p_j in zip(("crossing", "hill", "order", "soft"), priors_t, priors_j):
        v_j = np.asarray(jax.jit(jax.vmap(lambda th: p_j.ln_like(ctx_j(th))))(
            jnp.asarray(pts.numpy())))
        vals[key] = p_t.ln_like(ctx_t).numpy()
        np.testing.assert_allclose(vals[key], v_j, rtol=1e-12)
    # rows 1-3: crossing orbits, c inside b, Hill-unstable masses
    broken = np.stack([~np.isfinite(vals[k][:4]) for k in ("crossing", "order", "hill")])
    assert broken.tolist() == [[False, True, False, False],
                               [False, False, True, False],
                               [False, True, True, True]]
    assert np.any((vals["soft"] < 0) & np.isfinite(vals["soft"]))


def test_obs_prior_wrapper_and_photometry_generate_match_jax(obs_models):
    """The wrapper's and the photometry's `generate_from_params` at the valid
    point with the same numpy rng write the JAX package's tables; the
    wrapper's subset is a wrapper."""
    from octofitter_tpu.model.generate import generate_from_params as generate_j

    mj, mt, pts = obs_models
    nat = chip_smoke.obs_prior_points(mt)[0]
    sys_j = generate_j(mj, mj.arr2nt(jnp.asarray(nat)), add_noise=True,
                       rng=np.random.default_rng(2))
    sys_t = ot.generate_from_params(mt, mt.arr2nt(mt.tensor(nat)), add_noise=True,
                                    rng=np.random.default_rng(2))
    for pl_j, pl_t in zip(sys_j.planets, sys_t.planets):
        for o_j, o_t in zip(pl_j.observations, pl_t.observations):
            assert type(o_t).__name__ == type(o_j).__name__
            if not hasattr(o_j, "table"):  # the UniformCircular pseudo-priors
                continue
            tab_j = getattr(o_j, "wrapped_like", o_j).table
            tab_t = getattr(o_t, "wrapped_like", o_t).table
            for k in tab_j:
                np.testing.assert_allclose(tab_t[k], tab_j[k], rtol=1e-10, atol=1e-10)
    wrapper = mt.system.planets[0].observations[0]
    sub = wrapper.likeobj_from_epoch_subset(np.arange(4))
    assert isinstance(sub, ot.ObsPriorAstromONeil2019) and len(sub.table["epoch"]) == 4


def test_photometry_pointwise_matches_jax(obs_models):
    mj, mt, pts = obs_models
    nt_t = mt.arr2nt(mt.invlink(pts))
    obs_t = mt.system.planets[1].observations[0]
    ctx_t = ot.model.PlanetObservationContext(
        theta_system=nt_t, theta_planet=nt_t.planets["c"], theta_obs=ot.Params(), orbits=(),
        solutions=(), i_planet=1, epoch_start=0, batch_shape=(len(pts),))
    obs_j = mj.system.planets[1].observations[0]

    def pointwise_j(th):
        nt = mj.arr2nt(mj.invlink(th))
        ctx = oc.model.PlanetObservationContext(
            theta_system=nt, theta_planet=nt.planets["c"], theta_obs=oc.Params(), orbits=(),
            solutions=(), i_planet=1, epoch_start=0)
        return obs_j.pointwise_ln_like(ctx)

    want = np.asarray(jax.jit(jax.vmap(pointwise_j))(jnp.asarray(pts.numpy())))
    np.testing.assert_allclose(obs_t.pointwise_ln_like(ctx_t).numpy(), want, rtol=1e-12)


# ---------------------------------------------------------------------------
# the atmosphere grids

def test_interp2d_bilinear_matches_jax():
    """Values and gradients in both coordinates on a random grid, at points
    inside (grid nodes and edges included) and outside (NaN)."""
    rng = np.random.default_rng(0)
    xg, yg = np.linspace(1.0, 5.0, 9), np.linspace(-2.0, 3.0, 7)
    values = rng.standard_normal((9, 7))
    x = np.concatenate([rng.uniform(1.0, 5.0, 20), [1.0, 5.0, 3.0, 0.5, 6.0]])
    y = np.concatenate([rng.uniform(-2.0, 3.0, 20), [-2.0, 3.0, 3.5, 0.0, 0.0]])
    f_j = atm_j.interp2d_bilinear(xg, yg, values)
    v_j = np.asarray(f_j(jnp.asarray(x), jnp.asarray(y)))
    g_j = jax.jit(jax.vmap(jax.grad(lambda a, b: f_j(a, b), argnums=(0, 1))))(
        jnp.asarray(x[:20]), jnp.asarray(y[:20]))
    xt = torch.as_tensor(x).requires_grad_(True)
    yt = torch.as_tensor(y).requires_grad_(True)
    v_t = atm_t.interp2d_bilinear(xg, yg, values)(xt, yt)
    np.testing.assert_allclose(v_t.detach().numpy(), v_j, rtol=1e-12, equal_nan=True)
    assert np.isnan(v_t.detach().numpy()[-3:]).all()
    gx, gy = torch.autograd.grad(v_t[:20].sum(), (xt, yt))
    np.testing.assert_allclose(gx[:20].numpy(), np.asarray(g_j[0]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gy[:20].numpy(), np.asarray(g_j[1]), rtol=1e-10, atol=1e-12)


def test_sonora_photometry_interpolator_matches_jax(sonora_file):
    teff = np.array([250.0, 800.0, 1500.0, 2300.0, 100.0])
    mass = np.array([1.0, 10.0, 40.0, 79.0, 10.0])
    f_j = oc.sonora_photometry_interpolator(chip_smoke.SONORA_BAND, sonora_file)
    f_t = ot.sonora_photometry_interpolator(chip_smoke.SONORA_BAND, sonora_file)
    np.testing.assert_allclose(f_t(torch.as_tensor(teff), torch.as_tensor(mass)).numpy(),
                               np.asarray(f_j(jnp.asarray(teff), jnp.asarray(mass))),
                               rtol=1e-12, equal_nan=True)
    table_t = atm_t.load_sonora_mag_table(sonora_file)
    table_j = atm_j.load_sonora_mag_table(sonora_file)
    assert all(np.array_equal(table_t[k], table_j[k]) for k in table_j)
    with pytest.raises(KeyError):
        ot.sonora_photometry_interpolator("not_a_band", sonora_file)


def _write_cooling(path):
    """An evolution table in the Sonora `nc+0.0_co1.0_age` layout: columns
    separated by two or more spaces, ages 0.01-10 Gyr x 6 masses."""
    lines = ["age(Gyr)  M/Msun  log L/Lsun  Teff(K)  log g  R/Rsun"]
    for age in np.geomspace(0.01, 10.0, 8):
        for m in np.linspace(0.001, 0.07, 6):
            teff = 3000.0 * (m / 0.07) ** 0.8 * (age / 0.01) ** -0.25
            lines.append(f"{age:.5f}  {m:.6f}  {-5.0:.3f}  {teff:.3f}  {5.0:.3f}  {0.1:.4f}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _write_bhac15(path):
    """A BHAC15-format track file: two age blocks of five masses."""
    lines = ["! BHAC15 isochrones (made-up values)", ""]
    for age in (0.01, 0.1):
        lines += [f"!  t (Gyr) = {age}", "!  M/Ms    Teff(K)  L/Ls   g   R/Rs",
                  "!---------------------------------------"]
        for m in (0.1, 0.3, 0.5, 0.8, 1.2):
            lines.append(f"  {m:.4f}  {3000.0 + 2000.0 * m - 500.0 * age:.1f}  {-1.5:.3f}"
                         f"  {4.5:.3f}  {m:.3f}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_cooling_and_bhac15_interpolators_match_jax(tmp_path):
    cooling = _write_cooling(tmp_path / "nc+0.0_co1.0_age")
    age = np.array([20.0, 300.0, 5000.0])
    mass = np.array([5.0, 20.0, 60.0])
    f_j = oc.sonora_cooling_interpolator(cooling)
    f_t = ot.sonora_cooling_interpolator(cooling)
    np.testing.assert_allclose(f_t(torch.as_tensor(age), torch.as_tensor(mass)).numpy(),
                               np.asarray(f_j(jnp.asarray(age), jnp.asarray(mass))), rtol=1e-12)
    bhac = _write_bhac15(tmp_path / "BHAC15_tracks.txt")
    rec_t, rec_j = atm_t.load_bhac15(bhac), atm_j.load_bhac15(bhac)
    assert len(rec_t) == len(rec_j) == 2
    for a, b in zip(rec_t, rec_j):
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in b)
    g_j = atm_j.bhac15_mass_age_interpolator(bhac)
    g_t = atm_t.bhac15_mass_age_interpolator(bhac)
    age, m = np.array([20.0, 50.0]), np.array([0.2, 0.9])
    np.testing.assert_allclose(g_t(torch.as_tensor(age), torch.as_tensor(m)).numpy(),
                               np.asarray(g_j(jnp.asarray(age), jnp.asarray(m))), rtol=1e-12)
