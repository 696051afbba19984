"""The port's absolute-astrometry stack against the JAX package, in float64
on the CPU.

Both packages read the same synthetic files: the Java-Tool IAD and GOST
scan law of tests/test_astrom.py, which `chip_smoke.write_synth_iad` and
`chip_smoke.synth_gost_csv` re-implement for the card (checked here to
write the same bytes). Held to the JAX functions: the IAD parser and the
corruption correction, `load_gost_csv`, the 4/5-parameter fits (values and
gradients, with and without weights and per-scan sigma), the Hippacentre,
the likelihoods of `HipparcosIADObs`, `HGCAObs` (Visual and AbsoluteVisual,
with `missed_transits`) and `GaiaDR4AstromObs` (both branches, detrend on
and off) through the ln_post and gradient of models that hold them, at 16
points shared through `interop.load_jax_state` (ln_post within 1e-9 of
max(|ln_post|, 1), each point's gradient within 1e-7 of its largest entry,
plus 16 times what one ulp of the propagated degrees moves them by on
AbsoluteVisual{KepOrbit}: `chip_smoke.hold_values_and_gradients`), that
comparison failing on the Hipparcos model with a planted fault, a rejected
IAD row beside a zero-mass companion (a finite gradient, equal to JAX's),
`generate_from_params` at the truth, the Hessian through the fits under
`torch.func`, and a short CPU fit of the HGCA model (8 chains). Each JAX
model is built once (building one compiles its ln_post and gradient) and
evaluated by those compiled functions, one point at a time.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octofitter_tpu as oc
import octofitter_tpu_torch as ot
from octofitter_tpu import astrom as ja
from octofitter_tpu.model.generate import generate_from_params as generate_j
from octofitter_tpu_torch import astrom as ta
from octofitter_tpu_torch.interop import load_jax_state

import chip_smoke
import test_astrom
from test_torch_orbit_bases import (hold_against_jax, jax_ln_post_and_grad, planted_fault,
                                    shared_prior_draws)

VALUE_TOL, GRAD_TOL = chip_smoke.ABS_VALUE_TOL, chip_smoke.ABS_GRAD_TOL
N_ORBITS = 30    # the IAD of the CPU tests: 60 abscissae
N_GOST = 40


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("astrom")
    return {"iad_file": chip_smoke.write_synth_iad(str(d / "iad.d"), n_orbits=N_ORBITS),
            "gost_file": chip_smoke.synth_gost_csv(d, n=N_GOST), "dir": d}


def test_synthetic_writers_match_the_jax_tests(tmp_path):
    """The smoke's writers make the bytes of tests/test_astrom.py's."""
    for n in (N_ORBITS, chip_smoke.HIP_ORBITS):
        a = chip_smoke.write_synth_iad(str(tmp_path / f"a{n}.d"), n_orbits=n)
        b = test_astrom.write_synth_iad(str(tmp_path / f"b{n}.d"), n_orbits=n)
        assert filecmp.cmp(a, b, shallow=False)
    (tmp_path / "x").mkdir()
    (tmp_path / "y").mkdir()
    a = chip_smoke.synth_gost_csv(tmp_path / "x", n=N_GOST)
    b = test_astrom.synth_gost_csv(str(tmp_path / "y"), n=N_GOST)
    assert filecmp.cmp(a, b, shallow=False)


# ---------------------------------------------------------------------------
# host-side pieces (numpy)

CORRUPT_TABLE = dict(
    iorb=np.array([1, 1, 2, 2, 3, 3, 3, 3]),
    sres_renorm=np.array([1.0, 1.1, 1.2, 1.3, 2.0, 1.5, 1.55, 2.0]),
    epoch_yrs=np.linspace(-1, 1, 8),
    parf=np.array([0.1, -0.3, 0.5, 0.2, -0.6, 0.4, 0.0, 0.3]),
    cosphi=np.cos(np.arange(8.0)),
    sinphi=np.sin(np.arange(8.0)),
    res=np.array([0.5, -1.0, 2.0, 0.3, -0.4, 1.1, -0.2, 0.7]),
    sres=np.ones(8),
    reject=np.zeros(8, bool),
)


def _tables_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


# tests/test_astrom.py:244-262's table as it stands (a zero residual
# everywhere, so every choice of rows scores alike), then with scan
# columns and residuals that make the correction's choice matter
JAX_TEST_TABLE = dict(CORRUPT_TABLE, parf=np.zeros(8), cosphi=np.ones(8), sinphi=np.zeros(8),
                      res=np.zeros(8))


@pytest.mark.parametrize("table", [JAX_TEST_TABLE, CORRUPT_TABLE], ids=["jax_test", "varied"])
def test_parse_iad_and_corruption_correction_match_jax(files, table):
    hip_t, tab_t = ta.parse_iad_file(files["iad_file"])
    hip_j, tab_j = ja.parse_iad_file(files["iad_file"])
    assert hip_t == hip_j or all(
        (np.isnan(hip_t[k]) and np.isnan(hip_j[k])) or hip_t[k] == hip_j[k] for k in hip_j)
    _tables_equal(tab_t, tab_j)
    # three duplicated trailing rows
    assert ta.detect_corruption(table) == ja.detect_corruption(table) == 3
    out_t, fixed_t = ta.correct_iad_corruption(dict(table))
    out_j, fixed_j = ja.correct_iad_corruption(dict(table))
    assert fixed_t and fixed_j
    _tables_equal(out_t, out_j)
    clean = dict(table, sres_renorm=np.array([1.0, 1.1, 1.2, 1.3, 2.0, 1.5, 1.55, 1.9]))
    assert ta.detect_corruption(clean) == ja.detect_corruption(clean) == 0
    # the whole constructor: renormalization, ephemeris, catalog sky path
    obs_t = ta.HipparcosIADObs(iad_file=files["iad_file"])
    obs_j = ja.HipparcosIADObs(iad_file=files["iad_file"])
    _tables_equal(obs_t.table, obs_j.table)
    assert np.array_equal(obs_t.A_prepared_5, obs_j.A_prepared_5)


def test_load_gost_csv_matches_jax(files):
    _tables_equal(ta.load_gost_csv(files["gost_file"]), ja.load_gost_csv(files["gost_file"]))
    g_t = ta.GaiaCatalogFitObs(gaia_sol=chip_smoke.GAIA_SOL, scanlaw=files["gost_file"])
    g_j = ja.GaiaCatalogFitObs(gaia_sol=chip_smoke.GAIA_SOL, scanlaw=files["gost_file"])
    _tables_equal(g_t.table, g_j.table)
    assert np.allclose(g_t.catalog_cov, g_j.catalog_cov, rtol=0, atol=0)
    assert np.array_equal(g_t.A_prepared_5, g_j.A_prepared_5)


# ---------------------------------------------------------------------------
# the fits

def _scans(n=30, seed=0):
    return test_astrom._synth_scans(n=n, seed=seed)


@pytest.mark.parametrize("weights", [None, "shared", "per_chain"])
@pytest.mark.parametrize("sigma", [None, "scalar", "per_scan"])
def test_fit_5param_matches_jax(weights, sigma):
    """Values (with chi2) and the gradient of a weighted sum of the five
    parameters with respect to dalpha and ddelta, at 3 chains."""
    t = _scans()
    n, C = len(t["epoch"]), 3
    A = ta.prepare_A_5param(t["epoch"], t["cosphi"], t["sinphi"],
                            t["parallaxFactorAlongScan"], 56500.0, 56400.0)
    rng = np.random.default_rng(1)
    da, dd = rng.standard_normal((C, n)), rng.standard_normal((C, n))
    res = rng.standard_normal(n)
    sig = {None: None, "scalar": 1.7, "per_scan": rng.uniform(0.5, 2.0, n)}[sigma]
    w = {None: None, "shared": (rng.uniform(size=n) > 0.2).astype(float),
         "per_chain": (rng.uniform(size=(C, n)) > 0.2) * 2.0}[weights]
    coef = np.array([1.0, -2.0, 0.5, 3.0, -1.5])

    def jax_one(da_, dd_, w_):
        out = ja.fit_5param(A, jnp.asarray(t["cosphi"]), jnp.asarray(t["sinphi"]), da_, dd_,
                            residuals=jnp.asarray(res), sigma=sig, include_chi2=True,
                            weights=w_)
        return jnp.stack(out["parameters"]), out["chi_squared_astro"]

    def jax_loss(da_, dd_, w_):
        return jnp.dot(jax_one(da_, dd_, w_)[0], coef)

    w_axis = 0 if weights == "per_chain" else None
    w_j = None if w is None else jnp.asarray(w)
    p_j, chi_j = jax.vmap(jax_one, in_axes=(0, 0, w_axis))(jnp.asarray(da), jnp.asarray(dd), w_j)
    g_j = jax.vmap(jax.grad(jax_loss, argnums=(0, 1)), in_axes=(0, 0, w_axis))(
        jnp.asarray(da), jnp.asarray(dd), w_j)

    da_t = torch.as_tensor(da).requires_grad_(True)
    dd_t = torch.as_tensor(dd).requires_grad_(True)
    out = ta.fit_5param(A, t["cosphi"], t["sinphi"], da_t, dd_t, residuals=torch.as_tensor(res),
                        sigma=sig, include_chi2=True, weights=w)
    p_t = torch.stack(out["parameters"], dim=-1)
    (p_t @ torch.as_tensor(coef)).sum().backward()
    assert _rel(p_t.detach().numpy(), np.asarray(p_j)) <= 1e-10
    assert _rel(out["chi_squared_astro"].detach().numpy(), chi_j) <= 1e-10
    assert _rel(da_t.grad.numpy(), g_j[0]) <= 1e-10
    assert _rel(dd_t.grad.numpy(), g_j[1]) <= 1e-10


@pytest.mark.parametrize("sigma", [False, True])
def test_fit_4param_and_pinv_match_jax(sigma):
    t = _scans(n=25, seed=3)
    n = len(t["epoch"])
    A4 = ta.prepare_A_4param(t["epoch"], t["cosphi"], t["sinphi"], 56500.0, 56500.0)
    A5 = ta.prepare_A_5param(t["epoch"], t["cosphi"], t["sinphi"],
                             t["parallaxFactorAlongScan"], 56500.0, 56500.0)
    rng = np.random.default_rng(2)
    da, dd = rng.standard_normal((4, n)), rng.standard_normal((4, n))
    sig = rng.uniform(0.5, 2.0, n) if sigma else None
    p_j = jax.vmap(lambda a, b: jnp.stack(ja.fit_4param(
        A4, jnp.asarray(t["cosphi"]), jnp.asarray(t["sinphi"]), a, b, sigma=sig)["parameters"]))(
        jnp.asarray(da), jnp.asarray(dd))
    p_t = torch.stack(ta.fit_4param(A4, t["cosphi"], t["sinphi"], torch.as_tensor(da),
                                    torch.as_tensor(dd), sigma=sig)["parameters"], dim=-1)
    assert _rel(p_t.numpy(), np.asarray(p_j)) <= 1e-10
    pinv = np.linalg.pinv(A5)
    q_j = jax.vmap(lambda a, b: jnp.stack(ja.fit_5param_pinv(
        pinv, jnp.asarray(t["cosphi"]), jnp.asarray(t["sinphi"]), a, b)["parameters"]))(
        jnp.asarray(da), jnp.asarray(dd))
    q_t = torch.stack(ta.fit_5param_pinv(pinv, t["cosphi"], t["sinphi"], torch.as_tensor(da),
                                         torch.as_tensor(dd))["parameters"], dim=-1)
    assert _rel(q_t.numpy(), np.asarray(q_j)) <= 1e-10


def test_hippacentre_combined_matches_jax():
    """Two companions over 3 chains: a luminous one and a zero-mass one
    (which contributes exactly nothing), against the JAX package's
    one-chain function vmapped."""
    t = _scans(n=20, seed=4)
    rng = np.random.default_rng(5)
    a = np.stack([rng.uniform(0.02, 0.1, 3), rng.uniform(3.0, 9.0, 3)])   # AU
    masses = np.stack([rng.uniform(1e-3, 5e-3, 3), np.zeros(3)])
    flux = np.stack([rng.uniform(0.0, 0.3, 3), rng.uniform(0.0, 0.3, 3)])
    base = dict(e=0.1, i=0.5, omega=1.0, Omega=2.0, tp=56000.0, M=1.0, plx=50.0)

    def jax_one(a_, m_, f_):
        sols = [oc.orbitsolve(oc.VisualOrbit.from_params(a=a_[k], **base), jnp.asarray(t["epoch"]))
                for k in range(2)]
        return jnp.stack(ja.hippacentre_combined(
            jnp.asarray(t["cosphi"]), jnp.asarray(t["sinphi"]), sols, [m_[0], m_[1]],
            [f_[0], f_[1]]))

    out_j = jax.vmap(jax_one)(jnp.asarray(a.T), jnp.asarray(masses.T), jnp.asarray(flux.T))
    sols = [ot.orbitsolve(ot.VisualOrbit.from_params(a=torch.as_tensor(a[k]), device="cpu",
                                                     **base), t["epoch"]) for k in range(2)]
    out_t = torch.stack(ta.hippacentre_combined(
        torch.as_tensor(t["cosphi"]), torch.as_tensor(t["sinphi"]), sols,
        [torch.as_tensor(m) for m in masses], [torch.as_tensor(f) for f in flux]))
    assert _rel(out_t.numpy(), np.moveaxis(np.asarray(out_j), 0, 1)) <= 1e-12


# ---------------------------------------------------------------------------
# the likelihoods, at 16 points shared by the two packages

def _shared_points(mj, mt, n=16, near=None, seed=3):
    """`n` unconstrained points: half near `near` (natural space) where
    given, the rest prior draws, set on the port model by load_jax_state."""
    draws = shared_prior_draws(mj, n, seed)
    if near is not None:
        n_near = n // 2
        rng = np.random.default_rng(seed)
        base = np.asarray(mj.link(jnp.asarray(near)))
        draws[:n_near] = base + 1e-3 * rng.standard_normal((n_near, len(base)))
    load_jax_state(mt, parameter_names=mj.parameter_names, starting_points=draws,
                   laplace_sigma=np.eye(mj.D))
    return mt.starting_points


def _hold_ln_post(mj, mt, pts, min_finite=8):
    """ln_post and its gradient with respect to the unconstrained points
    `pts`, in both packages (the JAX model's own compiled function at each
    point), held by `chip_smoke.hold_values_and_gradients` with the port's
    `ulp_sensitivity` (zero off AbsoluteVisual{KepOrbit})."""
    vj, gj = jax_ln_post_and_grad(mj, pts)
    dv, dg = chip_smoke.ulp_sensitivity(mt.ln_post_and_grad, pts)
    vt, gt = mt.ln_post_and_grad(pts)
    fin = torch.isfinite(vt)
    assert int(fin.sum()) >= min_finite
    assert bool(torch.isfinite(gt[fin]).all())
    chip_smoke.hold_values_and_gradients("ln_post", vt, gt, vj, gj, dv, dg)
    return vt.numpy(), gt.numpy()


HIP_NEAR = [1.75, 5.0, 50.0, -5.0, 10.0, 0.0, 0.0, 10.0, 0.1, 1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 1.0]


@pytest.fixture(scope="module")
def hip_models(files):
    """The Hipparcos mass model in both packages, its 16 shared points, the
    JAX package's ln_post and gradient there, and what one ulp of the
    propagated degrees moves the port's by."""
    data = {"iad_file": files["iad_file"], "astrom": chip_smoke.HIP_ASTROM}
    mj = chip_smoke.build_hip_mass_model(oc, data, jnp)
    mt = chip_smoke.build_hip_mass_model(ot, data, torch, device="cpu")
    pts = _shared_points(mj, mt, near=HIP_NEAR)
    vj, gj = jax_ln_post_and_grad(mj, pts)
    dv, dg = chip_smoke.ulp_sensitivity(mt.ln_post_and_grad, pts)
    return mj, mt, pts, (vj, gj, dv, dg)


def test_hipparcos_ln_like_matches_jax(hip_models):
    mj, mt, pts, ref = hip_models
    assert int(torch.isfinite(ref[0]).sum()) >= 8
    hold_against_jax(mt, pts, *ref)
    # each scan's value, and a subset of the scans
    obs_t, obs_j = mt.system.observations[0], mj.system.observations[0]
    nt_t = mt.arr2nt(mt.invlink(pts))
    orbits_t = mt.construct_orbits(nt_t)
    sols_t = tuple(ot.orbitsolve(o, obs_t.epochs) for o in orbits_t)
    ctx_t = ot.model.SystemObservationContext(theta_system=nt_t, theta_obs=ot.Params(),
                                              orbits=orbits_t, solutions=sols_t, epoch_start=0)

    def pointwise_j(th):
        nt = mj.arr2nt(mj.invlink(th))
        orbits = mj.construct_orbits(nt)
        sols = tuple(oc.orbitsolve(o, jnp.asarray(obs_j.epochs)) for o in orbits)
        ctx = oc.model.SystemObservationContext(theta_system=nt, theta_obs=oc.Params(),
                                                orbits=orbits, solutions=sols, epoch_start=0)
        return obs_j.pointwise_ln_like(ctx)

    pw_j = np.asarray(jax.jit(jax.vmap(pointwise_j))(jnp.asarray(pts.numpy())))
    with torch.no_grad():
        pw_t = obs_t.pointwise_ln_like(ctx_t).numpy()
    # one scan's value is O(1) and its model position (ra2 - radeg) x 3.6e6
    # mas carries ~3e-8 mas per ulp of the degrees, where the two packages'
    # arcsin and atan2 may differ: 1e-7 of max(|value|, 1) per scan
    assert _rel(pw_t, pw_j) <= 1e-7
    idx = np.arange(0, len(obs_t.epochs), 3)
    sub = obs_t.likeobj_from_epoch_subset(idx)
    sols_s = tuple(ot.orbitsolve(o, sub.epochs) for o in orbits_t)
    ctx_s = ot.model.SystemObservationContext(theta_system=nt_t, theta_obs=ot.Params(),
                                              orbits=orbits_t, solutions=sols_s, epoch_start=0)
    with torch.no_grad():
        assert _rel(sub.ln_like(ctx_s).numpy(), pw_t[:, idx].sum(-1)) <= 1e-12


@pytest.mark.parametrize("fault", ["light_travel", "rv"])
def test_planted_fault_fails_the_hipparcos_comparison(hip_models, fault):
    """The comparison that holds AbsoluteVisual models, with its allowance
    of 16 times what one ulp of the propagated degrees moves ln_post and
    its gradient, rejects the Hipparcos mass model (c Eri's radial velocity
    of 12.6 km/s) when its light-travel term or its radial velocity is
    dropped. The model's chains share that radial velocity, so they share
    their emission epochs: the pairing of each chain with its own is held
    in tests/test_torch_orbit_bases.py."""
    mj, mt, pts, ref = hip_models
    with planted_fault(fault), pytest.raises(AssertionError, match="disagree"):
        hold_against_jax(mt, pts, *ref)


@pytest.fixture(scope="module")
def hgca_data(tmp_path_factory):
    """The HGCA data of the CPU tests: the smoke's recipe (the catalog row
    generated by the port at the truth) at N_ORBITS and N_GOST."""
    return chip_smoke.hgca_data(ot, tmp_path_factory.mktemp("hgca"), N_ORBITS, N_GOST)


@pytest.fixture(scope="module")
def hgca_models(hgca_data):
    """The HGCA model in both packages by (basis, missed transits), each
    built once. The declination epochs and the nonlinear terms are moved
    off their defaults, so that both take part."""
    data = dict(hgca_data, hgca=dict(hgca_data["hgca"], epoch_dec_hip=1991.31,
                                     epoch_dec_gaia=2016.1, nonlinear_dpmra=0.02,
                                     nonlinear_dpmdec=-0.01))
    cache = {}

    def get(basis="Visual{KepOrbit}", missed=None):
        key = (basis, None if missed is None else tuple(missed))
        if key not in cache:
            cache[key] = (chip_smoke.build_hgca_model(oc, data, basis, missed),
                          chip_smoke.build_hgca_model(ot, data, basis, missed, device="cpu"))
        return cache[key]

    return get


@pytest.mark.parametrize("basis", ["Visual{KepOrbit}", chip_smoke.ABSOLUTE])
@pytest.mark.parametrize("missed", [None, [3.0, 17.0]], ids=["all_transits", "missed"])
def test_hgca_ln_like_matches_jax(hgca_models, basis, missed):
    """Both branches (the AbsoluteVisual one propagates the barycentre to the
    channel epochs); `missed_transits` zeroes two Gaia scans."""
    mj, mt = hgca_models(basis, missed)
    pts = _shared_points(mj, mt, near=chip_smoke.hgca_truth(mt))
    _hold_ln_post(mj, mt, pts)


def test_hgca_duplicated_missed_transit_is_minus_inf(hgca_data):
    mt = chip_smoke.build_hgca_model(ot, hgca_data, missed_transits=[5.0, 5.0], device="cpu")
    lp = mt.ln_post(mt.link(mt.tensor([chip_smoke.hgca_truth(mt)])))
    assert float(lp) == -np.inf


def test_hgca_generate_matches_jax(hgca_models):
    """`generate_from_params` at the truth writes the JAX package's catalog
    row."""
    mj, mt = hgca_models()
    truth = chip_smoke.hgca_truth(mt)
    row_j = generate_j(mj, mj.arr2nt(jnp.asarray(truth))).observations[0].hgca
    row_t = ot.generate_from_params(mt, mt.arr2nt(mt.tensor(truth))).observations[0].hgca
    assert sorted(row_j) == sorted(row_t)
    for k in row_j:
        assert abs(row_t[k] - row_j[k]) <= 1e-9 * max(abs(row_j[k]), 1.0), k


def _small_hgca_model(pkg, files, row, **model_kw):
    """tests/test_astrom.py:hgca_linfit_model's model (pmra, pmdec, b_mass;
    include_iad=False) over the CPU tests' files, with either package."""
    d = pkg.distributions
    hgca = pkg.HGCAObs(hgca=row, hip_like=pkg.HipparcosIADObs(iad_file=files["iad_file"]),
                       gaia_like=pkg.GaiaCatalogFitObs(gaia_sol=chip_smoke.GAIA_SOL,
                                                       scanlaw=files["gost_file"]),
                       include_iad=False)
    b = pkg.Planet(name="b", basis="Visual{KepOrbit}",
                   variables=dict(a=6.0, e=0.1, i=0.6, omega=1.0, Omega=2.0, tp=50000.0,
                                  mass=d.Uniform(0.0, 100.0)))
    system = pkg.System(name="hgcalinfit",
                        variables=dict(M=1.1, plx=50.0, pmra=d.Normal(0.0, 100.0),
                                       pmdec=d.Normal(0.0, 100.0)),
                        companions=[b], observations=[hgca])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


SMALL_TRUTH = [-5.0, 10.0, 30.0]


@pytest.fixture(scope="module")
def small_hgca(files):
    """The small HGCA model in the port, its catalog generated at 30 Mjup."""
    model = _small_hgca_model(ot, files, chip_smoke._hgca_row_template(), device="cpu")
    truth = model.arr2nt(model.tensor(SMALL_TRUTH))
    row = ot.generate_from_params(model, truth).observations[0].hgca
    return row, _small_hgca_model(ot, files, row, device="cpu")


def test_hgca_laplace_hessian_matches_jax(files, small_hgca):
    """The Laplace step's Hessian (the QR factorizations and triangular
    solves of the fits under `torch.func`) matches `jax.hessian`."""
    row, mt = small_hgca
    mj = _small_hgca_model(oc, files, row)
    x = np.asarray(mj.link(jnp.asarray(SMALL_TRUTH))) + 0.01
    H_t = torch.func.hessian(lambda th: mt.ln_post(th[None, :], fused=False)[0])(
        torch.as_tensor(x)).numpy()
    H_j = np.asarray(jax.jit(jax.hessian(mj.ln_post))(jnp.asarray(x)))
    assert np.max(np.abs(H_t - H_j)) <= 1e-7 * np.abs(H_j).max()


@pytest.fixture(scope="module")
def dr4_table():
    """The DR4 scans at 50 epochs with one outlier flagged, centroids made
    by the port at the truth."""
    tab = chip_smoke.dr4_table(n=50)
    tab["outlier_flag"] = (np.arange(50) == 7).astype(float)
    model = chip_smoke.build_dr4_model(ot, tab, device="cpu")
    truth = model.arr2nt(model.tensor([chip_smoke.DR4_TRUTH[n] for n in model.parameter_names]))
    return dict(ot.generate_from_params(model, truth).observations[0].table)


@pytest.mark.parametrize("basis", ["Visual{KepOrbit}", chip_smoke.ABSOLUTE])
@pytest.mark.parametrize("detrend", [False, True], ids=["plain", "detrended"])
def test_dr4_ln_like_matches_jax(dr4_table, basis, detrend):
    mj = chip_smoke.build_dr4_model(oc, dr4_table, basis, detrend)
    mt = chip_smoke.build_dr4_model(ot, dr4_table, basis, detrend, device="cpu")
    truth = [chip_smoke.DR4_TRUTH[n] for n in mt.parameter_names]
    pts = _shared_points(mj, mt, near=truth)
    _hold_ln_post(mj, mt, pts)


def test_dr4_generate_matches_jax(dr4_table):
    """The JAX package's `generate_from_params` at the truth writes the
    centroids the port wrote (tests/test_astrom.py:390-437's round trip)."""
    tab = {k: v for k, v in dr4_table.items() if k not in ("x", "y", "z")}
    mj = chip_smoke.build_dr4_model(oc, tab)
    truth = [chip_smoke.DR4_TRUTH[n] for n in mj.parameter_names]
    new_j = generate_j(mj, mj.arr2nt(jnp.asarray(truth))).observations[0].table
    assert _rel(dr4_table["centroid_pos_al"], new_j["centroid_pos_al"]) <= 1e-12
    mt = chip_smoke.build_dr4_model(ot, tab, device="cpu")
    ll = mt.ln_like_nt(mt.arr2nt(mt.tensor([truth, [truth[0], 30.0]])))
    assert float(ll[0]) > float(ll[1])


def test_rejected_row_and_zero_mass_companion_give_a_finite_gradient(tmp_path):
    """An IAD scan with sres <= 0 is rejected (masked after the log) and a
    second companion has mass 0: the gradient is finite and equals JAX's."""
    path = chip_smoke.write_synth_iad(str(tmp_path / "iad.d"), n_orbits=10)
    lines = open(path).read().splitlines()
    parts = lines[-5].split()
    parts[-1] = "-1.50"
    lines[-5] = " ".join(parts)
    open(path, "w").write("\n".join(lines))

    def build(pkg, **kw):
        d = pkg.distributions
        hip = pkg.HipparcosIADObs(iad_file=path)
        orbit = dict(e=0.1, i=0.5, omega=1.0, Omega=2.0, tp=48000.0)
        b = pkg.Planet(name="b", basis=chip_smoke.ABSOLUTE,
                       variables=dict(orbit, a=d.Uniform(2.0, 5.0), mass=d.Uniform(0.0, 50.0)))
        c = pkg.Planet(name="c", basis=chip_smoke.ABSOLUTE,
                       variables=dict(orbit, a=d.Uniform(6.0, 9.0), mass=0.0))
        system = pkg.System(
            name="rejected", companions=[b, c], observations=[hip],
            variables=dict(M=1.0, plx=d.Uniform(45.0, 55.0), pmra=d.Normal(-5.0, 1.0),
                           pmdec=d.Normal(10.0, 1.0), ra=chip_smoke.HIP_SOL["radeg"],
                           dec=chip_smoke.HIP_SOL["dedeg"], rv=0.0,
                           ref_epoch=pkg.constants.HIPPARCOS_EPOCH_MJD))
        return pkg.LogDensityModel(system, verbosity=0, **kw), hip

    mj, _ = build(oc)
    mt, hip_t = build(ot, device="cpu")
    assert hip_t.table["reject"].sum() == 1
    pts = _shared_points(mj, mt)
    _, gt = _hold_ln_post(mj, mt, pts, min_finite=16)
    assert np.all(np.isfinite(gt))


def test_hgca_short_cpu_fit_recovers_the_mass(small_hgca):
    """tests/test_astrom.py:368-387 in the port: the small HGCA model, its
    catalog generated at 30 Mjup, refit from the truth by NUTS with 8
    chains (30 + 30, max_depth 3: D = 3 and a near-Gaussian posterior);
    the posterior mean of b_mass within 4 sd of the truth."""
    _, model = small_hgca
    start = model.link(model.tensor(SMALL_TRUTH)).expand(8, -1)
    chain = ot.octofit(model, sampler="nuts", chains=8, adaptation=30, iterations=30,
                       max_depth=3, verbosity=0, starting_points=start,
                       generator=torch.Generator().manual_seed(0))
    mass = np.asarray(chain["b_mass"]).ravel()
    pull = (mass.mean() - 30.0) / max(mass.std(), 1e-9)
    assert abs(pull) < 4, f"mass {mass.mean():.2f} +- {mass.std():.2f}"
