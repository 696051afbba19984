"""The port's G23H composite likelihood against the JAX package, in float64
on the CPU.

Both packages read the same synthetic files (the IAD of
tests/test_astrom.py and the DR2+DR3 GOST scan law of tests/test_g23h.py,
which `chip_smoke.synth_gost_dr23` writes byte for byte) and the same
synthetic catalog rows. Held to the JAX functions: the noncentral chi^2
series (and to scipy at nc = 0), the four selection-weight functions row
by row with ties in the priorities, the ln_post and gradient of G23H
models across `ueva_mode` RUWE / EAN / none, the RV channel on and off,
frozen and marginalized epochs, Visual{KepOrbit} and
AbsoluteVisual{KepOrbit} at 8 shared points (`interop.load_jax_state`;
`chip_smoke.hold_values_and_gradients`: ln_post within 1e-9 of
max(|ln_post|, 1), each point's gradient within 1e-7 of its largest entry,
plus 16 times what one ulp of the propagated degrees moves them by on
AbsoluteVisual), `debug_pulls` and `generate_from_params` with the same
numpy rng, and the catalog loader on a dict and a feather file. Then a
covariance that is not positive definite in some rows (-inf with a zero
gradient row), two planted faults that the comparison rejects, and the
slice end to end: the injected model through `initialize` and a short
ChEES fit. Each JAX model is built once (building one compiles its ln_post
and gradient) and evaluated by those compiled functions point by point.
"""

import contextlib
import filecmp
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octofitter_tpu as oc
import octofitter_tpu_torch as ot
from octofitter_tpu.astrom import g23h as gj
from octofitter_tpu_torch.astrom import g23h as gt
from octofitter_tpu_torch.interop import load_jax_state

import chip_smoke
import test_g23h
from test_torch_orbit_bases import jax_ln_post_and_grad, shared_prior_draws

ABSOLUTE = chip_smoke.ABSOLUTE


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    data = chip_smoke.g23h_data(tmp_path_factory.mktemp("g23h"))
    data["injected_row"] = chip_smoke.g23h_injected_row(ot, data)
    return data


def test_synthetic_scan_law_matches_the_jax_tests(tmp_path):
    (tmp_path / "x").mkdir()
    (tmp_path / "y").mkdir()
    assert filecmp.cmp(chip_smoke.synth_gost_dr23(tmp_path / "x"),
                       test_g23h.synth_gost_dr23(str(tmp_path / "y")), shallow=False)
    assert chip_smoke.g23h_catalog_row() == test_g23h.g23h_catalog_row()
    assert chip_smoke.g23h_catalog_row_full() == test_g23h.g23h_catalog_row_full()


# ---------------------------------------------------------------------------
# the noncentral chi^2 series

CHI2_CASES = [(5.0, 4, 2.0), (20.0, 9, 10.0), (1.0, 3, 0.01), (3.0, 9, 0.0), (40.0, 9, 25.0)]


def test_noncentral_chi2_logpdf_matches_scipy_and_jax():
    """Batched over the cases: values against scipy's ncx2 (nc = 0
    included) and the JAX function, gradients in x and nc against JAX's."""
    from scipy.stats import ncx2

    x = torch.tensor([c[0] for c in CHI2_CASES], dtype=torch.float64, requires_grad=True)
    nc = torch.tensor([c[2] for c in CHI2_CASES], dtype=torch.float64, requires_grad=True)
    for df in sorted({c[1] for c in CHI2_CASES}):
        rows = [i for i, c in enumerate(CHI2_CASES) if c[1] == df]
        val = gt.noncentral_chi2_logpdf(x[rows], df, nc[rows])
        gx, gnc = torch.autograd.grad(val.sum(), (x, nc))
        want = ncx2.logpdf(x[rows].detach().numpy(), df, nc[rows].detach().numpy())
        np.testing.assert_allclose(val.detach().numpy(), want, rtol=1e-10)
        fj = jax.jit(jax.vmap(lambda a, b: gj.noncentral_chi2_logpdf(a, df, b)))
        gfj = jax.jit(jax.vmap(jax.grad(lambda a, b: gj.noncentral_chi2_logpdf(a, df, b),
                                        argnums=(0, 1))))
        xs, ncs = jnp.asarray(x[rows].detach().numpy()), jnp.asarray(nc[rows].detach().numpy())
        np.testing.assert_allclose(val.detach().numpy(), np.asarray(fj(xs, ncs)), rtol=1e-12)
        gxj, gncj = gfj(xs, ncs)
        np.testing.assert_allclose(gx[rows].numpy(), np.asarray(gxj), rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(gnc[rows].numpy(), np.asarray(gncj), rtol=1e-10, atol=1e-14)


def test_noncentral_chi2_at_zero_noncentrality_is_finite_in_float32():
    """At nc = 0 in float32 the series is finite (the JAX package's
    1e-300 floor rounds to 0 there, and its j = 0 term is 0 log 0 = NaN),
    within float32's rounding of the central chi^2 value."""
    from scipy.stats import chi2

    x = torch.tensor([0.5, 3.0, 12.0], dtype=torch.float32, requires_grad=True)
    nc = torch.zeros(3, dtype=torch.float32, requires_grad=True)
    val = gt.noncentral_chi2_logpdf(x, 9, nc)
    g = torch.autograd.grad(val.sum(), (x, nc))
    assert bool(torch.isfinite(val).all()) and all(bool(torch.isfinite(t).all()) for t in g)
    np.testing.assert_allclose(val.detach().numpy(), chi2.logpdf([0.5, 3.0, 12.0], 9), rtol=1e-5)


# ---------------------------------------------------------------------------
# the selection weights, per row against JAX per sample

def _pools():
    pools = gj._EpochPools()
    pools.n_epochs = 40
    pools.dr3_win = np.arange(0, 25)
    pools.dr3_tail = np.arange(25, 40)
    pools.dr2_pool = np.arange(0, 20)
    pools.n2_win, pools.n_tail, pools.n_dr2_total = 10, 5, 13
    pools_t = gt._EpochPools()
    pools_t.__dict__.update(pools.__dict__)
    return pools, pools_t


def _priorities(n_rows=6, n=40):
    """Rows of priorities rounded to one decimal, so that many tie; the
    last row all equal."""
    p = np.round(np.random.default_rng(0).standard_normal((n_rows, n)), 1)
    p[-1] = 0.3
    return p


@pytest.mark.parametrize("kind", ["dr3", "dr2", "dr2_per_row", "rv"])
def test_selection_weights_match_jax_per_row(kind):
    pools, pools_t = _pools()
    p = _priorities()
    pt = torch.as_tensor(p)
    w3j = jax.jit(jax.vmap(lambda r: gj._dr3_weights(r, pools)))(jnp.asarray(p))
    if kind == "dr3":
        want, got = w3j, gt._dr3_weights(pt, pools_t)
        assert bool((got.sum(-1) == 15).all())
    elif kind == "dr2":
        want = jax.jit(jax.vmap(lambda r: gj._dr2_weights(r, 8, pools)))(jnp.asarray(p))
        got = gt._dr2_weights(pt, 8, pools_t)
    elif kind == "dr2_per_row":
        nd = np.array([1, 4, 8, 13, 2, 3])
        want = jax.jit(jax.vmap(lambda r, k: gj._dr2_weights(r, k, pools)))(jnp.asarray(p),
                                                                            jnp.asarray(nd))
        got = gt._dr2_weights(pt, torch.as_tensor(nd), pools_t)
        assert bool((got.sum(-1) == pools.n_dr2_total).all())
    else:
        want = jax.jit(jax.vmap(lambda r, w: gj._rv_weights(r, w, 7, 15)))(jnp.asarray(p), w3j)
        got = gt._rv_weights(pt, gt._dr3_weights(pt, pools_t), 7, 15)
        assert bool((got.sum(-1) == 7).all())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# ln_post and gradient at 8 shared points

def _ean_row():
    return dict(chip_smoke.g23h_catalog_row_full(), astrometric_excess_noise_dr3=0.2)


def _explicit_variables(pkg):
    """tests/test_g23h.py:g23h_model's observation variables: no transit
    priorities, so each release takes all its window's scans."""
    d = pkg.distributions
    return dict(σ_att=d.LogUniform(0.01, 1.0), σ_AL=d.LogUniform(0.01, 1.0),
                σ_calib=d.LogUniform(0.01, 1.0), iad_Δra=d.Normal(0.0, 10.0),
                iad_Δdec=d.Normal(0.0, 10.0), iad_pmra=d.Normal(0.0, 10.0),
                iad_pmdec=d.Normal(0.0, 10.0), iad_Δplx=d.Normal(0.0, 1.0),
                hip_iad_jitter=d.LogUniform(0.01, 10.0), σ_rv_per_transit=d.LogUniform(0.01, 10.0))


# (name, builder arguments, the natural point half the points are near)
CONFIGS = {
    "example_visual": (dict(example=True), chip_smoke.g23h_example_point),
    "frozen_visual_ruwe_rv": (dict(row="injected"), chip_smoke.g23h_injection_truth),
    "marginalized_absolute_none_rv": (dict(basis=ABSOLUTE, freeze=False, ueva_mode="none"), None),
    "frozen_absolute_ean_no_rv": (dict(basis=ABSOLUTE, ueva_mode="EAN", include_rv=False,
                                       row=_ean_row()), chip_smoke.g23h_injection_truth),
    "explicit_variables_visual_rv": (dict(row=chip_smoke.g23h_catalog_row(),
                                          variables=_explicit_variables), None),
}


def _build(pkg, data, example=False, basis="Visual{KepOrbit}", **kw):
    if kw.get("row") == "injected":
        kw = dict(kw, row=data["injected_row"])
    if example:
        return chip_smoke.build_g23h_example_model(pkg, data, basis, **kw)
    return chip_smoke.build_g23h_model(pkg, data, basis, **kw)


@pytest.fixture(scope="module", autouse=True)
def jax_models(data):
    """Every configuration's JAX model, built in a thread started with the
    module (mostly XLA compiling, which releases the GIL), so that the
    builds overlap the tests that need none."""
    with ThreadPoolExecutor(1) as pool:
        yield {name: pool.submit(_build, oc, data, **args) for name, (args, _) in CONFIGS.items()}


@pytest.fixture(scope="module")
def models(data, jax_models):
    """Each configuration's model in both packages and its 8 shared points
    (half near its point, half prior draws), built once."""
    cache = {}

    def get(name):
        if name not in cache:
            args, near = CONFIGS[name]
            mj = jax_models[name].result()
            mt = _build(ot, data, device="cpu", **args)
            draws = shared_prior_draws(mj, 8, 3)
            if near is not None:
                base = np.asarray(mj.link(jnp.asarray(near(mt))))
                draws[:4] = base + 1e-3 * np.random.default_rng(4).standard_normal((4, mj.D))
            load_jax_state(mt, parameter_names=mj.parameter_names, starting_points=draws,
                           laplace_sigma=np.eye(mj.D))
            cache[name] = (mj, mt, mt.starting_points)
        return cache[name]

    return get


def _hold(mj, mt, pts):
    vj, gj_ = jax_ln_post_and_grad(mj, pts)
    dv, dg = chip_smoke.ulp_sensitivity(mt.ln_post_and_grad, pts, mt.ln_post)
    vt, gt_ = mt.ln_post_and_grad(pts)
    assert int(torch.isfinite(vt).sum()) == len(pts)
    assert bool(torch.isfinite(gt_).all())
    return chip_smoke.hold_values_and_gradients("port vs JAX", vt, gt_, vj, gj_, dv, dg)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_g23h_ln_post_matches_jax(models, name):
    mj, mt, pts = models(name)
    obs = mt.system.observations[0]
    if "none" in name:
        assert "ueva_dr3" not in obs.kinds and obs.pools.marginalize_dup
    if "explicit" in name:
        assert not any("priorities" in n for n in mt.parameter_names)
    assert obs.include_rv == ("no_rv" not in name)
    _hold(mj, mt, pts)


# ---------------------------------------------------------------------------
# generation, pulls and the catalog loader

def _contexts(mj, mt, truth):
    nt_j = mj.arr2nt(jnp.asarray(truth))
    orbits_j = mj.construct_orbits(nt_j)
    ctx_j = oc.model.SystemObservationContext(
        theta_system=nt_j, theta_obs=nt_j.observations["G23H"], orbits=orbits_j,
        solutions=tuple(oc.orbitsolve(o, jnp.asarray(mj._all_epochs)) for o in orbits_j),
        epoch_start=0)
    nt_t = mt.arr2nt(mt.tensor(truth))
    orbits_t = mt.construct_orbits(nt_t)
    ctx_t = ot.model.SystemObservationContext(
        theta_system=nt_t, theta_obs=nt_t.observations["G23H"], orbits=orbits_t,
        solutions=tuple(ot.orbitsolve(o, mt._epochs_t) for o in orbits_t), epoch_start=0)
    return ctx_j, ctx_t


def test_generate_and_debug_pulls_match_jax(models, data):
    """`generate_from_params` at the injection's truth with noise drawn from
    the same numpy rng (seed 5, as the injection) writes the JAX package's
    catalog, and the pulls and whitened pulls at the truth of that catalog
    match JAX's. The catalog's proper motions do not enter the generation,
    so the frozen model on the injected row generates that row again: the
    port's model-level generation (`chip_smoke.g23h_injected_row`) is
    held to JAX's too."""
    mj, mt, _ = models("frozen_visual_ruwe_rv")
    truth = chip_smoke.g23h_injection_truth(mt)
    ctx_j, ctx_t = _contexts(mj, mt, truth)
    seed = chip_smoke.G23H_NOISE_SEED
    noisy_j = mj.system.observations[0].generate_from_params(ctx_j, np.random.default_rng(seed),
                                                             add_noise=True)
    noisy_t = mt.system.observations[0].generate_from_params(ctx_t, np.random.default_rng(seed),
                                                             add_noise=True)
    row_j, row_t = noisy_j.catalog, noisy_t.catalog
    assert sorted(row_j) == sorted(row_t)
    for k, v in row_j.items():
        if isinstance(v, float):
            assert abs(row_t[k] - v) <= 1e-9 * max(abs(v), 1.0), k
        else:
            assert row_t[k] == v, k
    out_j, out_t = noisy_j.debug_pulls(ctx_j), noisy_t.debug_pulls(ctx_t)
    assert out_t["kinds"] == out_j["kinds"]
    for key in ("pull", "whitened"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]), rtol=1e-9,
                                   atol=1e-9)
    injected = data["injected_row"]
    assert sorted(injected) == sorted(row_j)
    for k, v in row_j.items():
        assert injected[k] == v if not isinstance(v, float) else \
            abs(injected[k] - v) <= 1e-9 * max(abs(v), 1.0), k


def test_catalog_loader_matches_jax(tmp_path):
    """A two-source column mapping, and the same as a feather file with a
    DR2 sidecar: the same rows as the JAX package's loader."""
    from octofitter_tpu.astrom import load_g23h_catalog_row as load_j

    base = chip_smoke.g23h_catalog_row_full()
    cols = {k: [v * 0.5, v] for k, v in base.items()}
    cols["gaia_id"] = [111, 222]
    cols["radial_velocity_error"] = [np.nan, base["radial_velocity_error"]]
    for gid in (111, 222):
        assert ot.astrom.load_g23h_catalog_row(cols, gaia_id=gid) == load_j(cols, gaia_id=gid)
    pa = pytest.importorskip("pyarrow")
    import pyarrow.feather as feather

    cat, side = str(tmp_path / "g23h.feather"), str(tmp_path / "dr2.feather")
    cols.pop("astrometric_matched_observations_dr2")
    feather.write_feather(pa.table(cols), cat)
    feather.write_feather(pa.table({"gaia_id": [111, 222],
                                    "astrometric_matched_observations_dr2": [12, 30]}), side)
    row_t = ot.astrom.load_g23h_catalog_row(cat, gaia_id=222, dr2_transits_catalog=side)
    assert row_t == load_j(cat, gaia_id=222, dr2_transits_catalog=side)
    assert row_t["astrometric_matched_observations_dr2"] == 30
    assert "radial_velocity_error" not in ot.astrom.load_g23h_catalog_row(cat, gaia_id=111)
    with pytest.raises(KeyError):
        ot.astrom.load_g23h_catalog_row(cat, gaia_id=999)


# ---------------------------------------------------------------------------
# the Cholesky gate and planted faults

def test_non_positive_definite_rows_are_minus_inf_with_zero_gradient(data):
    """Central-epoch position errors as large as the DR3-DR2 block's make
    its deflation-adjusted form lose positive definiteness where a row's
    UEVA deflation is small (sigma_att large): those rows give -inf and an
    all-zero, finite gradient; the others stay finite."""
    row = dict(chip_smoke.g23h_catalog_row_full(), ra_error_central_dr3=0.05,
               dec_error_central_dr3=0.05, ra_error_central_dr2=0.05, dec_error_central_dr2=0.05)
    mt = chip_smoke.build_g23h_model(ot, data, row=row, device="cpu")
    truth = chip_smoke.g23h_injection_truth(mt)
    pts = np.tile(truth, (4, 1))
    pts[:, mt.parameter_names.index("G23H_σ_att")] = [0.0779, 0.08, 0.5, 2.0]
    theta = mt.link(mt.tensor(pts))
    lp, g = mt.ln_post_and_grad(theta)
    fin = torch.isfinite(lp)
    assert fin.tolist() == [True, True, False, False]
    assert bool(torch.isfinite(g).all())
    assert bool((g[~fin] == 0).all()) and bool((g[fin] != 0).any())


@contextlib.contextmanager
def planted_fault(fault, obs):
    """Within the block the port's G23H `obs` carries one fault:
    "cross_block" drops the DR2 x DR3 covariance block (every matrix square
    root 0), "ascending_ranks" selects the lowest priorities instead of the
    highest. The observation's cached constants are dropped on the way in
    and out."""
    name = {"cross_block": "_sqrt2x2", "ascending_ranks": "_descending_ranks"}[fault]
    plain = getattr(gt, name)
    if fault == "cross_block":
        def plant(m):
            return np.zeros_like(m)
    else:
        def plant(values):
            return plain(-values)
    setattr(gt, name, plant)
    obs._columns.clear()
    try:
        yield
    finally:
        setattr(gt, name, plain)
        obs._columns.clear()


@pytest.mark.parametrize("fault", ["cross_block", "ascending_ranks"])
def test_planted_fault_fails_the_comparison(models, fault):
    mj, mt, pts = models("frozen_visual_ruwe_rv")
    _hold(mj, mt, pts)
    with planted_fault(fault, mt.system.observations[0]), \
            pytest.raises(AssertionError, match="disagree"):
        _hold(mj, mt, pts)


# ---------------------------------------------------------------------------
# the slice end to end

def test_injected_model_initializes_and_fits(models):
    """The injected catalog's frozen-epoch model through `initialize` (small
    sizes) and a short ChEES fit (8 chains, 30 + 30): finite draws, the
    mass within 5 sd of the injected 40 Mjup, and the Laplace mode's
    ln_post within 1e-3 of the JAX package's at that point. Neither
    package's mode is converged along the IAD jitter, whose posterior is
    flat towards its lower bound, so the modes' positions are not
    compared."""
    mj, mt, _ = models("frozen_visual_ruwe_rv")
    mode = mt.initialize(torch.Generator().manual_seed(0), n_prior_samples=2000,
                         n_multistart=32, n_opt_steps=100, n_draws=200, verbosity=0)
    lp_t = float(mt.ln_post(mode[None])[0])
    lp_j = float(mj.ln_post(jnp.asarray(mode.numpy())))
    assert abs(lp_t - lp_j) <= 1e-3
    chain = ot.octofit(mt, chains=8, adaptation=30, iterations=30, verbosity=0,
                       generator=torch.Generator().manual_seed(1))
    x = np.stack([chain[n] for n in mt.parameter_names], axis=-1)
    assert np.all(np.isfinite(x))
    mass = x[..., mt.parameter_names.index("b_mass")].ravel()
    assert abs(mass.mean() - 40.0) <= 5 * max(mass.std(), 1e-6)
