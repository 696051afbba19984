"""The port's direct-image, interferometry and transit likelihoods against the
JAX package, in float64 on the CPU.

Five models are built once in each package: examples/05's image,
interferometry (from its OIFITS file) and transit fits
(`chip_smoke.build_*_model` on `chip_smoke.ex05_data`), the smoke's
likelihood-map and GRAVITY models, and an image model made here to reach
every gate (three epochs in two image shapes, a contrast curve that is
zero over a band of radii, a contrast map that ends inside the image's
reach, the platescale and northangle nuisances, an inner massive
companion). Each is held to JAX's ln_post and gradient at shared prior
draws within 1e-10 relative: -inf rows alike (a zero sigma, a point off a
contrast map, a GRAVITY covariance that is not positive definite) and
with finite gradients in the port, points off the image or the map at
their fill values. Then the pieces: `interp_image_centered` against
`map_coordinates` (NaN outside, gradients, a stack of images),
`contrast_curve`, `fiber_coupling_fraction`, `_kernel_phase_basis`,
`load_oifits` and `cp_indices`, `transit_depth` for both limb-darkening
laws at grazing, full, no-overlap, b < r and b = 0 geometry (values and
gradients; finite gradients in float32 too), light-curve generation with
one numpy rng, and the planted faults that the smoke's gates reject.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.ndimage import map_coordinates

import octofitter_tpu as oc
import octofitter_tpu_torch as ot
from octofitter_tpu.images import utils_interp as interp_j
from octofitter_tpu.interferometry import gravity as grav_j
from octofitter_tpu.transits import likelihoods as tr_j
from octofitter_tpu_torch.images import utils_interp as interp_t
from octofitter_tpu_torch.interferometry import gravity as grav_t
from octofitter_tpu_torch.transits import likelihoods as tr_t

import chip_smoke
from test_oifits import _synth_oifits
from test_torch_orbit_bases import jax_ln_post_and_grad, shared_prior_draws

REL = 1e-10


def _gate_image_data():
    """Three epochs: two 41 x 41 images with contrast curves of different
    lengths (the first zero for radii 10-15 px), one 31 x 31 image with a
    21 x 21 contrast map."""
    rng = np.random.default_rng(4)
    zero_band = (np.array([0.0, 5.0, 10.0, 15.0, 20.0, 25.0]),
                 np.array([0.5, 0.5, 0.0, 0.0, 0.3, 0.3]))
    curve = (np.linspace(0.0, 28.0, 8), np.linspace(0.8, 0.2, 8))
    return [dict(image=rng.standard_normal((41, 41)), epoch=57000.0, platescale=10.0,
                 contrast=zero_band),
            dict(image=rng.standard_normal((31, 31)), epoch=57400.0, platescale=12.0,
                 contrastmap=rng.uniform(0.2, 1.0, (21, 21))),
            dict(image=rng.standard_normal((41, 41)), epoch=57800.0, platescale=10.0,
                 contrast=curve)]


def build_gate_image_model(pkg, rows, **model_kw):
    d = pkg.distributions
    images = pkg.ImageObs(rows, name="imgs", variables=dict(
        flux=d.Uniform(0.0, 5.0), platescale=d.Uniform(0.98, 1.02),
        northangle=d.Uniform(-0.05, 0.05)))
    b = pkg.Planet(name="b", basis="Visual{KepOrbit}", observations=[images],
                   variables=dict(a=d.Uniform(2.0, 8.0), e=d.Uniform(0.0, 0.3), i=0.5,
                                  omega=1.0, Omega=2.0, tp=57000.0))
    c = pkg.Planet(name="c", basis="Visual{KepOrbit}",
                   variables=dict(a=1.0, e=0.0, i=0.5, omega=0.0, Omega=2.0, tp=56900.0,
                                  mass=d.Uniform(1.0, 30.0)))
    system = pkg.System(name="gates", variables=dict(M=1.2, plx=50.0), companions=[b, c])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


@pytest.fixture(scope="module")
def ex05(tmp_path_factory):
    return chip_smoke.ex05_data(ot, tmp_path_factory.mktemp("ex05"))


MODELS = ("image", "interferometry", "transit", "likelihood map", "GRAVITY", "image gates")


@pytest.fixture(scope="module")
def models(ex05):
    """Each model in both packages (JAX's built once for the module)."""
    builds = {"image": (chip_smoke.build_image_model, ex05["image"]),
              "interferometry": (chip_smoke.build_interferometry_model, ex05["oifits"]),
              "transit": (chip_smoke.build_transit_model, ex05["lightcurve"]),
              "likelihood map": (chip_smoke.build_llmap_model, chip_smoke.llmap_data(ot)),
              "GRAVITY": (chip_smoke.build_gravity_model, chip_smoke.gravity_data(ot)),
              "image gates": (build_gate_image_model, _gate_image_data())}
    return {label: (build(oc, arg), build(ot, arg, device="cpu"))
            for label, (build, arg) in builds.items()}


def _hold(vt, gt, vj, gj):
    """Port against JAX: the same rows finite, values within REL of
    max(|v|, 1), each finite row's gradient within REL of its largest
    entry; every port gradient finite."""
    fin = torch.isfinite(vj)
    assert torch.equal(fin, torch.isfinite(vt))
    scale = vj.abs().clamp(min=1.0)
    assert bool(((vt - vj).abs() <= REL * scale)[fin].all()), float(((vt - vj).abs() / scale)[fin].max())
    gscale = gj.abs().amax(-1, keepdim=True).clamp(min=1.0)
    assert bool(((gt - gj).abs() <= REL * gscale)[fin].all())
    assert bool(torch.isfinite(gt).all())
    assert bool((gt[~fin] == 0).all())


@pytest.mark.parametrize("label", MODELS)
def test_model_matches_jax(models, label):
    """ln_post and its gradient at 12 shared prior draws."""
    mj, mt = models[label]
    pts = torch.as_tensor(shared_prior_draws(mj, 12, 11))
    vj, gj = jax_ln_post_and_grad(mj, pts)
    vt, gt = mt.ln_post_and_grad(pts)
    _hold(vt, gt, vj, gj)
    n_inf = int((~torch.isfinite(vt)).sum())
    if label == "GRAVITY":  # kp_Cy > 1 with a small jitter: not positive definite
        assert 0 < n_inf < len(vt)
    elif label != "image gates":
        assert n_inf == 0
    if label == "likelihood map":  # positions off the map take the fill value
        assert bool((vt < -1e4 + 100).any()) and bool((vt > -100).any())


def _contexts(mj, mt, pts, i_planet):
    """Both packages' contexts of planet i's first observation at the
    points `pts` (JAX's a function of one point, to vmap)."""
    nt_t = mt.arr2nt(mt.invlink(pts))
    orbits = mt.construct_orbits(nt_t)
    name = mt.system.planets[i_planet].name
    obs_name = mt.system.planets[i_planet].observations[0].normalized_name
    ctx_t = ot.model.PlanetObservationContext(
        theta_system=nt_t, theta_planet=nt_t.planets[name],
        theta_obs=nt_t.planets[name].observations[obs_name], orbits=orbits,
        solutions=tuple(ot.orbitsolve(o, mt._epochs_t) for o in orbits), i_planet=i_planet,
        epoch_start=0, batch_shape=(len(pts),))

    def ctx_j(th):
        nt = mj.arr2nt(mj.invlink(th))
        orbits_j = mj.construct_orbits(nt)
        return oc.model.PlanetObservationContext(
            theta_system=nt, theta_planet=nt.planets[name],
            theta_obs=nt.planets[name].observations[obs_name], orbits=orbits_j,
            solutions=tuple(oc.orbitsolve(o, jnp.asarray(mj._all_epochs)) for o in orbits_j),
            i_planet=i_planet, epoch_start=0)

    return ctx_j, ctx_t


def test_image_gates_pointwise_match_jax(models):
    """Each epoch's value at 64 shared prior draws: -inf where the radius
    falls in the zero band of the first curve and where the position
    leaves the contrast map, finite elsewhere (off the image the flux reads
    0); the epochs of the two image shapes in their stacks, back in epoch
    order; an epoch subset holds its epochs' columns."""
    mj, mt = models["image gates"]
    pts = torch.as_tensor(shared_prior_draws(mj, 64, 12))
    ctx_j, ctx_t = _contexts(mj, mt, pts, 0)
    obs_j, obs_t = mj.system.planets[0].observations[0], mt.system.planets[0].observations[0]
    want = np.asarray(jax.jit(jax.vmap(lambda th: obs_j.pointwise_ln_like(ctx_j(th))))(
        jnp.asarray(pts.numpy())))
    got = obs_t.pointwise_ln_like(ctx_t).numpy()
    assert got.shape == (64, 3)
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    fin = np.isfinite(got)
    assert (~fin[:, 0]).any() and (~fin[:, 1]).any() and fin[:, 2].all() and fin.any(axis=0).all()
    sub_t = obs_t.likeobj_from_epoch_subset([1, 2])
    ctx_t.epoch_start = 1
    np.testing.assert_allclose(sub_t.pointwise_ln_like(ctx_t).numpy(), got[:, 1:], rtol=1e-14)


def test_interp_image_centered_matches_map_coordinates():
    """Values inside (off pixel boundaries, and at the edges) and NaN
    outside, with gradients in both coordinates; a stack of two images read
    at once."""
    rng = np.random.default_rng(0)
    image = rng.standard_normal((9, 12))
    x = np.concatenate([rng.uniform(-5.4, 5.4, 30), [-5.5, 5.5, 0.0, 6.1, -7.0, 0.3]])
    y = np.concatenate([rng.uniform(-3.9, 3.9, 30), [-4.0, 4.0, 4.5, 0.0, 0.0, -4.2]])
    want = np.asarray(interp_j.interp_image_centered(jnp.asarray(image), jnp.asarray(x),
                                                     jnp.asarray(y)))
    inside = np.asarray(map_coordinates(jnp.asarray(image), [jnp.asarray(y + 4.0),
                                                             jnp.asarray(x + 5.5)],
                                        order=1, mode="nearest"))
    xt = torch.as_tensor(x).requires_grad_(True)
    yt = torch.as_tensor(y).requires_grad_(True)
    got = interp_t.interp_image_centered(torch.as_tensor(image), xt, yt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-13, atol=1e-15,
                               equal_nan=True)
    np.testing.assert_allclose(got.detach().numpy()[:32], inside[:32], rtol=1e-13, atol=1e-15)
    assert np.isnan(got.detach().numpy()[-3:]).all()
    g_j = jax.vmap(jax.grad(lambda a, b: interp_j.interp_image_centered(jnp.asarray(image), a, b),
                            argnums=(0, 1)))(jnp.asarray(x[:30]), jnp.asarray(y[:30]))
    gx, gy = torch.autograd.grad(torch.where(torch.isfinite(got), got, 0.0).sum(), (xt, yt))
    np.testing.assert_allclose(gx[:30].numpy(), np.asarray(g_j[0]), rtol=1e-12)
    np.testing.assert_allclose(gy[:30].numpy(), np.asarray(g_j[1]), rtol=1e-12)
    assert bool((gx[-3:] == 0).all()) and bool((gy[-3:] == 0).all())
    # a stack: image g read at x[..., g]
    stack = np.stack([image, rng.standard_normal((9, 12))])
    xs, ys = x[:30].reshape(15, 2), y[:30].reshape(15, 2)
    got_s = interp_t.interp_image_centered(torch.as_tensor(stack), torch.as_tensor(xs),
                                           torch.as_tensor(ys)).numpy()
    for g in range(2):
        want_g = interp_j.interp_image_centered(jnp.asarray(stack[g]), jnp.asarray(xs[:, g]),
                                                jnp.asarray(ys[:, g]))
        np.testing.assert_allclose(got_s[:, g], np.asarray(want_g), rtol=1e-13, atol=1e-15)


def test_contrast_curve_matches_jax():
    from octofitter_tpu.images import contrast_curve as curve_j

    image = np.random.default_rng(1).standard_normal((33, 41))
    image[3, 4] = np.nan
    for step in (2.0, 3.5):
        r_t, s_t = ot.images.contrast_curve(image, step)
        r_j, s_j = curve_j(image, step)
        np.testing.assert_array_equal(r_t, r_j)
        np.testing.assert_array_equal(s_t, s_j)


def test_fiber_coupling_and_kernel_phase_basis_match_jax():
    theta = np.array([0.0, 5.0, 20.0, 37.5, 60.0, 100.0])
    for lam in (2.0e-6, 2.2e-6):
        c_t = grav_t.fiber_coupling_fraction(theta, lam, n_grid=200)
        c_j = grav_j.fiber_coupling_fraction(theta, lam, n_grid=200)
        np.testing.assert_allclose(c_t, c_j, rtol=1e-10)
    assert c_t[0] > 0.95 and np.all(np.diff(c_t) < 0)
    for n_wave in (1, 4, 14):
        P_t, P_j = grav_t._kernel_phase_basis(n_wave), grav_j._kernel_phase_basis(n_wave)
        assert P_t.shape == P_j.shape and P_t.shape[1] == 4 * n_wave
        np.testing.assert_array_equal(P_t, P_j)


@pytest.mark.parametrize("zero_cp_err", [False, True])
def test_load_oifits_and_cp_indices_match_jax(tmp_path, zero_cp_err):
    from octofitter_tpu.interferometry import cp_indices as cp_indices_j
    from octofitter_tpu.interferometry import load_oifits as load_j
    from octofitter_tpu_torch.interferometry import cp_indices, load_oifits

    path = str(tmp_path / "synth.oifits")
    _synth_oifits(path, n_wave=4, zero_cp_err=zero_cp_err)
    for kw in ({}, dict(epoch=59001.0, wavelength_min_meters=1.6e-6, use_vis2=False)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            row_t = load_oifits(path, **kw)
        assert len(caught) == int(zero_cp_err)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            row_j = load_j(path, **kw)
        assert row_t.keys() == row_j.keys()
        for k in row_j:
            np.testing.assert_array_equal(np.asarray(row_t[k]), np.asarray(row_j[k]))
    vis2_index = np.array([[1, 2], [1, 3], [2, 3], [1, 2], [1, 3], [2, 3]])
    cp_index = np.array([[1, 2, 3], [1, 2, 3]])
    for a, b in zip(cp_indices(vis2_index, cp_index), cp_indices_j(vis2_index, cp_index)):
        np.testing.assert_array_equal(a, b)
    assert [list(a) for a in cp_indices(vis2_index, cp_index)] == [[0, 3], [2, 5], [1, 4]]


GEOMETRIES = {"b = 0": (0.0, 0.1), "b < r": (0.05, 0.1), "full": (0.5, 0.1),
              "grazing": (1.02, 0.1), "no overlap": (1.2, 0.1)}
LAWS = {"quad": (0.4, 0.25), "nonlinear": (0.5, 0.1, 0.2, -0.1)}


@pytest.mark.parametrize("law", LAWS)
def test_transit_depth_matches_jax(law):
    """Values and gradients in b, r and the coefficients at each geometry,
    float64; the JAX package's quadrature counts the fully covered disk
    twice for 0 < b < r, and the port with it."""
    cls_j = tr_j.QuadLimbDark if law == "quad" else tr_j.NonlinearLimbDark
    cls_t = tr_t.QuadLimbDark if law == "quad" else tr_t.NonlinearLimbDark
    u = LAWS[law]

    def depth_j(b, r, u):
        return tr_j.transit_depth(cls_j(*u), b, r, True)

    grad_j = jax.jit(jax.grad(depth_j, argnums=(0, 1, 2)))
    for label, (b, r) in GEOMETRIES.items():
        want = float(depth_j(jnp.asarray(b), jnp.asarray(r), jnp.asarray(u)))
        gb_j, gr_j, gu_j = grad_j(jnp.asarray(b), jnp.asarray(r), jnp.asarray(u))
        bt = torch.tensor(b, dtype=torch.float64, requires_grad=True)
        rt = torch.tensor(r, dtype=torch.float64, requires_grad=True)
        ut = torch.tensor(u, dtype=torch.float64, requires_grad=True)
        got = tr_t.transit_depth(cls_t(*ut.unbind()), bt, rt, True)
        gb, gr, gu = torch.autograd.grad(got, (bt, rt, ut))
        assert abs(float(got.detach()) - want) <= 1e-14, label
        np.testing.assert_allclose([float(gb), float(gr)], [float(gb_j), float(gr_j)],
                                   rtol=REL, atol=1e-13, err_msg=label)
        np.testing.assert_allclose(gu.numpy(), np.asarray(gu_j), rtol=REL, atol=1e-13,
                                   err_msg=label)
        if label == "no overlap":
            assert float(got.detach()) == 1.0
    # behind the star nothing is occulted
    assert float(tr_t.transit_depth(cls_t(*u), torch.tensor([0.3], dtype=torch.float64), 0.1,
                                    [False])[0]) == 1.0


def test_transit_gradient_is_finite_in_float32():
    """The float32 guard on arccos's edge keeps every gradient finite at
    each geometry (b = 0 included), both laws."""
    b = torch.tensor([g[0] for g in GEOMETRIES.values()], requires_grad=True)
    r = torch.tensor(0.1, requires_grad=True)
    for law, u in LAWS.items():
        cls = tr_t.QuadLimbDark if law == "quad" else tr_t.NonlinearLimbDark
        depth = tr_t.transit_depth(cls(*u), b, r, torch.ones(len(b), dtype=torch.bool))
        gb, gr = torch.autograd.grad(depth.sum(), (b, r))
        assert depth.dtype == torch.float32
        assert bool(torch.isfinite(gb).all()) and bool(torch.isfinite(gr)), law
        np.testing.assert_allclose(
            depth.detach().numpy(),
            tr_t.transit_depth(cls(*u), b.detach().double(), 0.1, torch.ones(len(b), dtype=torch.bool)).numpy(),
            atol=2e-6)


def test_light_curve_generation_matches_jax(models):
    """examples/05's light curve generated in both packages at r = 0.1 with
    numpy's seed 1 (the smoke's data come from the port's)."""
    from octofitter_tpu.model.generate import generate_from_params as generate_j

    mj, mt = models["transit"]
    nat = np.array([0.1])
    sys_j = generate_j(mj, mj.arr2nt(jnp.asarray(nat)), add_noise=True,
                       rng=np.random.default_rng(1))
    sys_t = ot.generate_from_params(mt, mt.arr2nt(mt.tensor(nat)), add_noise=True,
                                    rng=np.random.default_rng(1))
    tab_j = sys_j.planets[0].observations[0].table
    tab_t = sys_t.planets[0].observations[0].table
    for k in tab_j:
        np.testing.assert_allclose(tab_t[k], tab_j[k], rtol=1e-12, atol=1e-14)
    sub = sys_t.planets[0].observations[0].likeobj_from_epoch_subset(np.arange(10))
    assert isinstance(sub, ot.LightCurveObs) and len(sub.table["epoch"]) == 10


@pytest.mark.parametrize("fault", ["image_ra_sign", "cp_sign"])
def test_planted_faults_move_the_likelihood(models, fault):
    """The smoke's planted faults change the port's ln_post at the truth
    (what its fits' gates then reject), and leave nothing planted after."""
    label = "image" if fault == "image_ra_sign" else "interferometry"
    _, mt = models[label]
    nat = mt.tensor([[12.0, 3.0]] if label == "image" else [[12.0, 0.02]])
    before = mt.ln_post(mt.link(nat))
    with chip_smoke.ex05_planted_fault(fault):
        during = mt.ln_post(mt.link(nat))
    assert float(before - during) > 5.0
    assert torch.equal(mt.ln_post(mt.link(nat)), before)
