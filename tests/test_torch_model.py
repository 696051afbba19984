"""The port's model layer against the JAX package, in float64 on the CPU.

Both packages build the same models from the same numpy tables: the
benchmark's headline model (`bench.py:build_model`) and the (sep, pa) /
(ra, dec) northangle cases of tests/test_conventions.py. Points are made
with numpy or drawn by the JAX model and handed to both as numpy arrays.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octofitter_tpu as oc
import octofitter_tpu_torch as ot

TRUE = dict(a=7.0, e=0.2, i=0.6, omega=1.0, Omega=2.0, tp=57000.0, M=1.2, plx=50.0)


def _jax_radec(elements, epochs):
    """The JAX package's (raoff, decoff) of one orbit, as numpy arrays;
    jitted, since eager JAX compiles each op of orbitsolve separately."""
    sol = jax.jit(lambda t: oc.orbitsolve(oc.VisualOrbit.from_params(**elements), t))(
        jnp.asarray(epochs))
    return np.asarray(oc.orbits.raoff(sol)), np.asarray(oc.orbits.decoff(sol))


@functools.cache
def bench_table():
    """`bench.py:build_model`'s data: 12 epochs, 2 mas noise, seed 0.
    Cached: the arrays are only read."""
    n = 12
    rng = np.random.default_rng(0)
    epochs = np.linspace(55000.0, 59500.0, n)
    ra, dec = _jax_radec(TRUE, epochs)
    return dict(
        epoch=epochs,
        ra=ra + rng.standard_normal(n) * 2.0,
        dec=dec + rng.standard_normal(n) * 2.0,
        σ_ra=np.full(n, 2.0),
        σ_dec=np.full(n, 2.0),
    )


def build_bench(pkg, table, **model_kw):
    """The headline model, built with either package's API."""
    dist = pkg.distributions
    astrom = pkg.PlanetRelAstromObs(table, name="simdata")
    b = pkg.Planet(
        name="b",
        basis="Visual{KepOrbit}",
        variables=dict(
            a=dist.Uniform(0.001, 100.0),
            e=dist.Uniform(0.0, 0.99),
            i=dist.Sine(),
            omega=pkg.UniformCircular(),
            Omega=pkg.UniformCircular(),
            theta=pkg.UniformCircular(),
            tp=lambda sys, pl: pkg.theta_at_epoch_to_tperi(
                pl.theta, 57000.0, M=sys.M, e=pl.e, a=pl.a,
                i=pl.i, omega=pl.omega, Omega=pl.Omega,
            ),
        ),
        observations=[astrom],
    )
    system = pkg.System(
        name="bench",
        variables=dict(
            M=dist.truncated(dist.Normal(1.2, 0.1), lower=0.1),
            plx=dist.truncated(dist.Normal(50.0, 0.02), lower=0.1),
        ),
        companions=[b],
    )
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


@functools.cache
def _seppa_tables():
    """tests/test_conventions.py: data rotated by a known PA offset 0.05.
    Cached: the arrays are only read."""
    epochs = np.array([50000.0, 50300.0, 50600.0, 50900.0, 51200.0])
    ra_m, dec_m = _jax_radec(dict(plx=50.0, M=1.2, a=15.0, e=0.2, i=0.6,
                                  omega=0.3, Omega=1.1, tp=50000.0), epochs)
    pa_d = np.arctan2(ra_m, dec_m) + 0.05
    sep_m = np.hypot(ra_m, dec_m)
    n = len(epochs)
    seppa = dict(epoch=epochs, sep=sep_m, pa=pa_d,
                 σ_sep=np.full(n, 1.0), σ_pa=np.full(n, 0.001))
    radec = dict(epoch=epochs, ra=sep_m * np.sin(pa_d), dec=sep_m * np.cos(pa_d),
                 σ_ra=np.full(n, 0.05), σ_dec=np.full(n, 0.05))
    return seppa, radec


def build_nuisance(pkg, table, variables, **model_kw):
    """Fixed orbit, free instrument nuisances on the astrometry."""
    obs = pkg.PlanetRelAstromObs(table, variables=variables, name="astromna")
    b = pkg.Planet(
        name="b", basis="Visual{KepOrbit}",
        variables=dict(a=15.0, e=0.2, i=0.6, omega=0.3, Omega=1.1, tp=50000.0),
        observations=[obs],
    )
    system = pkg.System(name="nasys", variables=dict(M=1.2, plx=50.0), companions=[b])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def _nuisance_vars(pkg):
    d = pkg.distributions
    return dict(
        northangle=d.Uniform(-0.5, 0.5),
        platescale=d.truncated(d.Normal(1.0, 0.01), lower=0.0),
        jitter=d.LogUniform(0.01, 10.0),
    )


@functools.cache
def jax_bench_model():
    """The JAX headline model on `bench_table()`. Cached, since its
    construction compiles a probe of ln_post (seconds); the tests here
    only read it, and tests/test_torch_slice.py initializes it."""
    return build_bench(oc, bench_table())


@pytest.fixture(scope="module")
def bench_pair():
    return jax_bench_model(), build_bench(ot, bench_table(), device="cpu")


def _prior_points(mj, mt, n=64, seed=1):
    """n prior draws (drawn by the port), natural and unconstrained (the
    JAX model's link)."""
    nat = mt.sample_priors(torch.Generator().manual_seed(seed), n).numpy()
    return nat, np.array(jax.jit(jax.vmap(mj.link))(jnp.asarray(nat)))


@pytest.fixture(scope="module")
def bench_points(bench_pair):
    return _prior_points(*bench_pair)


def _assert_lp_and_grad_match(mj, mt, pts_t):
    """ln_post to 1e-10 relative, gradient to 1e-10 relative to each
    draw's largest gradient entry: both packages run the same float64
    arithmetic, in a different order. The JAX side loops over its
    model's own compiled unbatched value-and-grad."""
    lp_j, g_j = zip(*(mj.ln_post_and_grad(jnp.asarray(p)) for p in pts_t))
    lp_j, g_j = np.asarray(lp_j), np.asarray(g_j)
    lp_t, g_t = mt.ln_post_and_grad(torch.as_tensor(pts_t))
    lp_t, g_t = lp_t.numpy(), g_t.numpy()
    assert np.isfinite(lp_j).all()
    np.testing.assert_allclose(lp_t, lp_j, rtol=1e-10, atol=0)
    scale = np.abs(g_j).max(axis=1, keepdims=True)
    assert (np.abs(g_t - g_j) <= 1e-10 * scale).all(), np.abs(g_t - g_j).max()


def test_default_device_is_the_gpu():
    """A model built with no `device` goes to the GPU; where there is none
    it raises, and never carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_bench(ot, bench_table())


def test_parameter_names_equal(bench_pair):
    mj, mt = bench_pair
    assert mt.parameter_names == mj.parameter_names
    assert mt.D == mj.D == 11
    assert mt.n_epochs == mj.n_epochs == 12


def test_link_invlink_match(bench_pair, bench_points):
    # elementwise transforms of the same values: 1e-12 absolute
    mj, mt = bench_pair
    nat, pts_t = bench_points
    np.testing.assert_allclose(mt.link(torch.as_tensor(nat)).numpy(), pts_t, rtol=0, atol=1e-12)
    back = mt.invlink(torch.as_tensor(pts_t)).numpy()
    np.testing.assert_allclose(back, np.asarray(jax.jit(jax.vmap(mj.invlink))(jnp.asarray(pts_t))),
                               rtol=0, atol=1e-12)


def test_ln_prior_transformed_matches(bench_pair, bench_points):
    mj, mt = bench_pair
    _, pts_t = bench_points
    ref = np.asarray(jax.jit(jax.vmap(mj.ln_prior_transformed))(jnp.asarray(pts_t)))
    np.testing.assert_allclose(mt.ln_prior_transformed(torch.as_tensor(pts_t)).numpy(),
                               ref, rtol=1e-12, atol=1e-12)


def test_ln_post_and_grad_match_at_prior_draws(bench_pair, bench_points):
    mj, mt = bench_pair
    _assert_lp_and_grad_match(mj, mt, bench_points[1])


def test_ln_post_single_point_and_nonfinite(bench_pair, bench_points):
    """An unbatched (D,) point gives a 0-d value; a non-finite input gives
    -inf, as in the JAX package."""
    mj, mt = bench_pair
    pts_t = bench_points[1][:2]
    lp = mt.ln_post(torch.as_tensor(pts_t[0]))
    assert lp.shape == ()
    np.testing.assert_allclose(float(lp), float(mj.ln_post(jnp.asarray(pts_t[0]))), rtol=1e-10)
    bad = pts_t.copy()
    bad[1, 3] = np.nan
    assert np.isneginf(mt.ln_post(torch.as_tensor(bad)).numpy()[1])
    assert np.isneginf(float(mj.ln_post(jnp.asarray(bad[1]))))


def test_hessian_matches_gradient_differences(bench_pair):
    """The Laplace step's Hessian (torch.func.hessian through the Kepler
    Function's jvp and vmap rules) against central differences of the
    gradient, which the test above holds to JAX's: step 1e-5 leaves a
    truncation error near 1e-7 of the largest entry; bound 1e-6."""
    mj, mt = bench_pair
    x = torch.as_tensor(np.array(mj.link(mj.sample_priors(jax.random.PRNGKey(4)))))
    H = torch.func.hessian(lambda th: mt.ln_post(th[None, :], fused=False)[0])(x).numpy()
    h = 1e-5
    steps = torch.eye(mt.D, dtype=torch.float64) * h
    _, g = mt.ln_post_and_grad(torch.cat([x + steps, x - steps]))
    H_fd = ((g[: mt.D] - g[mt.D:]) / (2 * h)).numpy()
    H_fd = 0.5 * (H_fd + H_fd.T)
    assert np.abs(H - H_fd).max() <= 1e-6 * np.abs(H).max()


@pytest.mark.parametrize("basis", ["VisualOrbit", "KepOrbit", "ThieleInnesOrbit",
                                   "RadialVelocityOrbit"])
def test_orbitsolve_fields_match(basis):
    """Every OrbitSolution field for 5 element sets x 12 epochs, batched in
    the port, vmapped in JAX: 1e-12 relative to the field's largest
    magnitude (an on-sky projection sums terms of opposite sign, so an
    entry near zero carries the rounding of the terms, not its own)."""
    rng = np.random.default_rng(5)
    n = 5
    els = dict(
        a=rng.uniform(1, 30, n), e=rng.uniform(0, 0.95, n), i=rng.uniform(0.1, 3.0, n),
        omega=rng.uniform(-3, 3, n), Omega=rng.uniform(-3, 3, n),
        tp=rng.uniform(50000, 60000, n), M=rng.uniform(0.5, 2.0, n),
        plx=rng.uniform(10, 100, n),
        A=rng.uniform(-50, 50, n), B=rng.uniform(-50, 50, n),
        F=rng.uniform(-50, 50, n), G=rng.uniform(-50, 50, n),
    )
    epochs = np.linspace(55000.0, 59500.0, 12)
    cls_j = getattr(oc.orbits, basis)
    cls_t = getattr(ot.orbits, basis)
    fields = [f for f in ("a", "e", "i", "omega", "Omega", "tp", "M", "plx",
                          "A", "B", "F", "G") if f in cls_t.__dataclass_fields__]

    def solve_j(*vals):
        return oc.orbitsolve(cls_j(**dict(zip(fields, vals))), jnp.asarray(epochs))

    sol_j = jax.jit(jax.vmap(solve_j))(*(jnp.asarray(els[f]) for f in fields))
    sol_t = ot.orbitsolve(cls_t(**{f: torch.as_tensor(els[f]) for f in fields}), epochs)
    names = ["EA", "nu", "r", "posx", "posy", "posz", "vx", "vy", "vz", "raoff_mas",
             "decoff_mas", "pmra_masyr", "pmdec_masyr", "radvel_ms"]
    for name in names:
        got = getattr(sol_t, name).numpy()
        ref = np.asarray(getattr(sol_j, name))
        assert got.shape == ref.shape == (n, 12), name
        if np.isnan(ref).all():  # RV-only orbits have no on-sky position
            assert np.isnan(got).all(), name
            continue
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max(), name
    if basis == "VisualOrbit":
        mass = torch.as_tensor(els["M"] * 0.01)
        np.testing.assert_allclose(
            ot.orbits.raoff(sol_t, mass).numpy(),
            np.asarray(jax.vmap(lambda s, m: oc.orbits.raoff(s, m))(sol_j, jnp.asarray(els["M"] * 0.01))),
            rtol=1e-12, atol=1e-12,
        )


@pytest.mark.parametrize("branch", ["seppa", "radec"])
def test_nuisance_likelihood_matches(branch):
    """northangle, platescale and jitter on both data branches: ln_post and
    gradient at 64 prior draws, to 1e-10 relative."""
    table = dict(zip(("seppa", "radec"), _seppa_tables()))[branch]
    mj = build_nuisance(oc, table, _nuisance_vars(oc))
    mt = build_nuisance(ot, table, _nuisance_vars(ot), device="cpu")
    assert mt.parameter_names == mj.parameter_names == [
        "b_astromna_northangle", "b_astromna_platescale", "b_astromna_jitter"]
    _, pts_t = _prior_points(mj, mt, seed=6)
    _assert_lp_and_grad_match(mj, mt, pts_t)


def test_northangle_convention_in_port():
    """tests/test_conventions.py's scan, run in the port (the JAX parity of
    these likelihoods is the test above): the argmax over northangle is
    the same on both branches, at the -0.05 that undoes the rotation."""
    seppa, radec = _seppa_tables()
    nas = np.linspace(-0.2, 0.2, 81)
    argmax = {}
    for name, table in (("seppa", seppa), ("radec", radec)):
        mt = build_nuisance(ot, table, dict(northangle=ot.distributions.Uniform(-0.5, 0.5)),
                            device="cpu")
        with torch.no_grad():
            ll = mt.ln_like_nt(mt.arr2nt(torch.as_tensor(nas[:, None]))).numpy()
        argmax[name] = nas[np.argmax(ll)]
        assert ll[np.argmin(np.abs(nas + 0.05))] > ll[np.argmin(np.abs(nas - 0.05))] + 10
    assert abs(argmax["seppa"] - argmax["radec"]) < 0.011
    assert abs(argmax["seppa"] - (-0.05)) < 0.011


DISTS = [
    ("Normal", (0.3, 2.0), np.linspace(-5, 5, 21)),
    ("Uniform", (0.001, 100.0), np.array([-1.0, 0.0, 0.001, 0.5, 50.0, 99.9, 100.0, 101.0])),
    ("LogNormal", (0.0, 0.1), np.array([-1.0, 0.0, 0.5, 1.0, 1.2, 3.0])),
    ("LogUniform", (0.01, 10.0), np.array([-1.0, 0.0, 0.01, 0.1, 5.0, 10.0, 11.0])),
    ("TruncatedNormal", (1.2, 0.1, 0.1, math.inf), np.array([0.0, 0.1, 0.2, 1.2, 2.0])),
    ("Sine", (), np.array([-0.1, 0.0, 1e-9, 0.5, math.pi / 2, 3.0, math.pi, 4.0])),
    ("Exponential", (2.0,), np.array([-1.0, 0.0, 1e-9, 0.5, 2.0, 30.0])),
    ("Beta", (2.0, 5.0), np.array([-0.1, 0.0, 1e-9, 0.2, 0.5, 0.99, 1.0, 1.5])),
    ("Gamma", (0.7, 1.5), np.array([-1.0, 0.0, 1e-9, 0.3, 1.0, 4.0, 20.0])),
    ("UniformImproper", (), np.array([-1e6, -1.0, 0.0, 0.5, 3.0, 1e6])),
    ("KDEDist", (np.random.default_rng(0).normal(1.0, 0.3, 500),),
     np.array([-1.0, 0.0, 0.2, 0.7, 1.0, 1.33, 1.8, 3.0])),
]


@pytest.mark.parametrize("name,args,x", DISTS, ids=[d[0] for d in DISTS])
def test_distribution_logpdf_and_bijector_match(name, args, x):
    """logpdf (with -inf outside the support at the same points), the
    chosen bijector and its log-Jacobian: 1e-12 relative."""
    dj = getattr(oc.distributions, name)(*args)
    dt = getattr(ot.distributions, name)(*args)
    ref = np.asarray(dj.logpdf(jnp.asarray(x)))
    got = dt.logpdf(torch.as_tensor(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    ok = np.isfinite(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-12, atol=1e-12)
    bj, bt = dj.bijector(), dt.bijector()
    assert type(bt).__name__ == type(bj).__name__
    y = np.linspace(-6, 6, 13)
    for meth in ("inverse", "logabsdet_inverse"):
        np.testing.assert_allclose(getattr(bt, meth)(torch.as_tensor(y)).numpy(),
                                   np.asarray(getattr(bj, meth)(jnp.asarray(y))),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,args,x", DISTS, ids=[d[0] for d in DISTS])
def test_distribution_samples_match_moments(name, args, x):
    """40,000 draws: sample mean within 5 standard errors of the JAX
    package's draws' mean (the streams differ), all inside the support."""
    dj = getattr(oc.distributions, name)(*args)
    dt = getattr(ot.distributions, name)(*args)
    n = 40_000
    s_t = dt.sample(torch.Generator().manual_seed(0), (n,)).numpy()
    s_j = np.asarray(dj.sample(jax.random.PRNGKey(0), (n,)))
    lo, hi = dt.support
    assert ((s_t > lo) & (s_t < hi)).all()
    se = np.hypot(s_t.std(), s_j.std()) / math.sqrt(n)
    assert abs(s_t.mean() - s_j.mean()) < 5 * se
