"""The port's package-level API and model leftovers, and the repairs of its
entry points, on the CPU in float64.

The names of tests/test_api_surface.py's `APPENDIX_A` that the port
exports are listed here, each asserted; the list grows with each slice.
`describe`, `savechain` / `loadchain`, `starting_points_chain`,
`generate_from_params` and the chain tools (`chain_to_flat`,
`mcmcchain2result`, `construct_elements`) are held to the JAX package on
the headline model (`chip_smoke.build_model`, both packages, one table).
Then the two repairs: the orbit entry points default to the GPU (and
raise where there is none), and a per-epoch parameter of shape (rows, T)
reaches the likelihood as JAX's (T,) vector does.
"""

import ast
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octofitter_tpu as oc
import octofitter_tpu_torch as ot
from octofitter_tpu.chains import flatten_params_batch as flatten_j
from octofitter_tpu.model import chain_tools as chain_tools_j
from octofitter_tpu.model.initialization import starting_points_chain as spc_j
from octofitter_tpu_torch.chains import flatten_params_batch
from octofitter_tpu_torch.likelihoods.utils import per_epoch
from octofitter_tpu_torch.model import chain_tools as chain_tools_t
from octofitter_tpu_torch.model.initialization import starting_points_chain as spc_t

import chip_smoke

# The names of APPENDIX_A that the port exports (27 before the discrete
# slice, which added the next 8; the RV-GP slice added the RV archive
# loaders and radvel_posterior, the next 7; the absolute-astrometry slice
# the next 6; the G23H slice the next 11: G23H, the observable and
# stability priors, photometry and the Sonora interpolators; the images,
# interferometry and transits slice the next 12, the evidence and validation
# slice the next 13; the last slice the 6 of the plots and Orbitize! I/O).
PORTED = [
    "Planet", "System", "UniformCircular", "Sine", "KDEDist", "theta_at_epoch_to_tperi",
    "ofti_linear_solve", "likelihoodname", "PlanetRelAstromObs", "PlanetRelAstromLikelihood",
    "HGCAInstantaneousObs", "HGCAInstantaneousLikelihood", "StarAbsoluteRVObs",
    "StarAbsoluteRVLikelihood", "MarginalizedStarAbsoluteRVObs",
    "MarginalizedStarAbsoluteRVLikelihood", "PlanetRelativeRVObs", "PlanetRelativeRVLikelihood",
    "StarAbsoluteRVMarginLikelihood", "octofit", "octofit_pigeons", "octofit_rejection",
    "LogDensityModel", "Chains", "gaia_plx", "mjd2jd", "jd2mjd",
    "drawfrompriors", "sample_priors", "initialize", "startingpoints", "generate_from_params",
    "describe", "savechain", "loadchain", "HARPS_RVBank_rvs", "HARPS_DR1_rvs", "HIRES_rvs",
    "Lick_rvs", "CES_lc_rvs", "CES_vlc_rvs", "radvel_posterior",
    "HGCAObs", "HGCALikelihood", "HipparcosIADObs", "HipparcosIADLikelihood",
    "GaiaDR4AstromObs", "GaiaDR4Astrom",
    "G23HObs", "G23HLikelihood", "ObsPriorAstromONeil2019", "PlanetOrderPrior",
    "NonCrossingPrior", "LimitClosestApproachAUPrior", "HillStabilityPrior", "PhotometryObs",
    "PhotometryLikelihood", "sonora_photometry_interpolator", "sonora_cooling_interpolator",
    "ImageObs", "ImageLikelihood", "LogLikelihoodMapObs", "LogLikelihoodMap",
    "InterferometryObs", "InterferometryLikelihood", "AbstractInterferometryObs",
    "AbstractInterferometryLikelihood", "GRAVITYWideKPObs", "GRAVITYWideKPLikelihood",
    "LightCurveObs", "LightCurveLikelihood",
    "dysample", "prior_only_model", "CompletenessJob", "CompletenessResult", "CompletenessMap",
    "completeness_jobs", "run_completeness_trial", "assemble_completeness", "completeness_map",
    "query_nss", "nss_to_starting_point", "initialize_from_nss", "nss_to_model_chain",
    "loadhdf5", "savehdf5", "Whereistheplanet_search", "Whereistheplanet_astrom",
    "octoplot", "octocorner",
]


@functools.cache
def appendix_a():
    """APPENDIX_A as tests/test_api_surface.py lists it."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_api_surface.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "APPENDIX_A":
            return ast.literal_eval(node.value)
    raise LookupError("APPENDIX_A not found")


@pytest.mark.parametrize("name", PORTED)
def test_appendix_a_name_is_exported(name):
    assert name in appendix_a()
    assert hasattr(ot, name), name


def test_all_of_appendix_a_is_ported():
    assert sorted(PORTED) == sorted(appendix_a()) and len(PORTED) == 90


def test_every_public_name_of_the_jax_package_is_in_the_port():
    """No list of exceptions: the port has each public top-level name of
    `octofitter_tpu` (functions, classes and submodules alike)."""
    public = [n for n in dir(oc) if not n.startswith("_")]
    assert len(public) > 100
    assert [n for n in public if not hasattr(ot, n)] == []


@pytest.mark.parametrize("module", ["parallel", "utils", "plots"])
def test_subpackage_exports_match_jax(module):
    """`parallel` (the nine names of the JAX package's), `utils`
    (`profile_trace`, `timing_probe`) and `plots` (19)."""
    import importlib

    want = importlib.import_module(f"octofitter_tpu.{module}").__all__
    got = importlib.import_module(f"octofitter_tpu_torch.{module}")
    assert got.__all__ == want
    assert all(callable(getattr(got, name)) for name in want)


@pytest.fixture(scope="module")
def headline():
    """The headline model in both packages, and 6 points near its truth."""
    table = chip_smoke.bench_table(ot)
    mj = chip_smoke.build_model(oc, table)
    mt = chip_smoke.build_model(ot, table, device="cpu")
    pts = chip_smoke.headline_points(ot, mt)[:6]
    return mj, mt, pts


def _chains(n_chains=3, n_draws=40, seed=0):
    rng = np.random.default_rng(seed)
    data = {"a": rng.standard_normal((n_chains, n_draws)),
            "b": 2.0 * rng.standard_normal((n_chains, n_draws)) + 1.0}
    internals = {"logpost": rng.standard_normal((n_chains, n_draws))}
    return data, internals


def test_describe_matches_jax():
    data, internals = _chains()
    s_t, q_t = ot.describe(ot.Chains(data, internals, {"sampler": "test"}))
    s_j, q_j = oc.describe(oc.Chains(data, internals, {"sampler": "test"}))
    assert list(s_t.index) == list(s_j.index) == ["a", "b"]
    assert list(q_t.columns) == list(q_j.columns)
    for col in ("mean", "std", "mcse", "ess_bulk", "ess_tail", "rhat"):
        np.testing.assert_allclose(s_t[col].to_numpy(float), s_j[col].to_numpy(float), rtol=1e-10)
    np.testing.assert_allclose(q_t.to_numpy(float), q_j.to_numpy(float), rtol=1e-12)


def test_savechain_loadchain_round_trip(tmp_path):
    """The port's writer and reader keep draws, internals, shape and
    metadata; the JAX package reads the port's file alike."""
    data, internals = _chains(2, 25, seed=1)
    info = {"sampler": "chees_vectorized", "sampling_time_s": 1.5, "n_grad_evals": 42}
    path = tmp_path / "chain.fits"
    ot.savechain(path, ot.Chains(data, internals, info), run="test")
    back = ot.loadchain(path)
    jax_back = oc.loadchain(path)
    for k, v in data.items():
        np.testing.assert_array_equal(back[k], v)
        np.testing.assert_array_equal(jax_back[k], v)
    np.testing.assert_array_equal(back.internals["logpost"], internals["logpost"])
    assert (back.n_chains, back.n_draws) == (2, 25)
    assert back.info["sampler"] == "chees_vectorized" and back.info["run"] == "test"
    assert back.info["n_grad_evals"] == 42


def test_starting_points_chain_matches_jax(headline):
    """The init chain of 6 set starting points: every column (derived ones
    included) and the log posterior, against the JAX package's."""
    mj, mt, pts = headline
    nat = mt.invlink(pts)
    mt.startingpoints(nat)
    mj.startingpoints(jnp.asarray(nat.numpy()))
    try:
        ch_t, ch_j = spc_t(mt), spc_j(mj)
    finally:
        mt.starting_points = mj.starting_points = None
    assert ch_t.info["sampler"] == "initialize"
    assert sorted(ch_t.names) == sorted(ch_j.names)
    assert "b_tp" in ch_t.names and ch_t["b_a"].shape == (1, 6)
    for k in ch_t.names:
        np.testing.assert_allclose(ch_t[k], np.asarray(ch_j[k]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ch_t.internals["logpost"], np.asarray(ch_j.internals["logpost"]),
                               rtol=1e-10)


def test_initialize_returns_the_init_chain():
    """Package-level `initialize` runs the pipeline and returns the
    starting-point chain, with a marginalized discrete column drawn per
    point; `drawfrompriors`, `sample_priors` and `startingpoints` delegate."""
    table = chip_smoke.calibration_table(ot)
    m = chip_smoke.build_calibration_model(ot, table, device="cpu")
    gen = torch.Generator().manual_seed(0)
    chain = ot.initialize(m, gen, n_prior_samples=2000, n_multistart=8, n_opt_steps=20,
                          n_draws=20, verbosity=0)
    assert chain.info["sampler"] == "initialize"
    assert set(np.unique(chain["b_simdata_cal"])) <= {0.0, 1.0}
    assert chain["b_a"].shape == (1, len(m.starting_points))
    assert ot.sample_priors(m, gen, 5).shape == (5, m.D)
    nt = ot.drawfrompriors(m, gen)
    assert float(nt.planets["b"].observations["simdata"]["cal"]) in (0.0, 1.0)
    assert m.get_starting_point().shape == (m.D,)
    ot.startingpoints(m, m.invlink(m.starting_points[:3]))
    assert m.starting_points.shape == (3, m.D)


def test_generate_from_params_matches_jax(headline):
    """Synthetic data from one parameter set, with noise from one numpy
    seed: the port's table is the JAX package's."""
    mj, mt, pts = headline
    nt_t = mt.arr2nt(mt.invlink(pts[0]))
    nt_j = mj.arr2nt(mj.invlink(jnp.asarray(pts[0].numpy())))
    for add_noise in (False, True):
        sys_t = ot.generate_from_params(mt, nt_t, rng=np.random.default_rng(3), add_noise=add_noise)
        sys_j = oc.generate_from_params(mj, nt_j, rng=np.random.default_rng(3), add_noise=add_noise)
        tab_t = sys_t.planets[0].observations[0].table
        tab_j = sys_j.planets[0].observations[0].table
        # the port's table also keeps the zero "cor" column it adds on reading
        assert sys_t.name == sys_j.name and set(tab_j) <= set(tab_t)
        for k in tab_j:
            np.testing.assert_allclose(tab_t[k], np.asarray(tab_j[k]), rtol=1e-10, atol=1e-10)
    # the generated system builds a model again
    assert ot.LogDensityModel(sys_t, verbosity=0, device="cpu").D == mt.D


def test_chain_tools_match_jax(headline):
    """chain_to_flat, mcmcchain2result and construct_elements on a chain of
    the 6 points, against the JAX package's on the same Chains."""
    mj, mt, pts = headline
    nat = mt.invlink(pts).numpy()
    data = {n: nat[:, i].reshape(2, 3) for i, n in enumerate(mt.parameter_names)}
    chain = ot.Chains(data)
    flat = chain_tools_t.chain_to_flat(mt, chain)
    np.testing.assert_array_equal(flat, chain_tools_j.chain_to_flat(mj, chain))
    np.testing.assert_array_equal(flat, nat)
    idx = [0, 2, 5]
    res_t = flatten_params_batch(chain_tools_t.mcmcchain2result(mt, chain, idx))
    res_j = flatten_j(chain_tools_j.mcmcchain2result(mj, chain, idx))
    assert set(res_t) == set(res_j)
    for k in res_t:
        np.testing.assert_allclose(res_t[k], np.asarray(res_j[k]), rtol=1e-12, atol=1e-12)
    el_t = chain_tools_t.construct_elements(mt, chain, "b", idx)
    el_j = chain_tools_j.construct_elements(mj, chain, "b", idx)
    assert type(el_t).__name__ == type(el_j).__name__ == "VisualOrbit"
    for f in dataclasses.fields(el_t):
        got = getattr(el_t, f.name)
        assert got.shape == (3,)
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(el_j, f.name)), rtol=1e-12)


# --------------------------------------------------------------------------
# The repairs
# --------------------------------------------------------------------------

def test_default_device_of_the_orbit_entry_points_is_the_gpu():
    """Orbit elements made from numbers and a Kepler solve of numbers go to
    the GPU unless the caller says otherwise; where there is none they
    raise, and never carry on on the CPU by themselves. A tensor argument
    keeps its device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    kw = dict(chip_smoke.TRUE)
    for make in (lambda: ot.VisualOrbit.from_params(**kw),
                 lambda: ot.KepOrbit.from_params(**{k: v for k, v in kw.items() if k != "plx"}),
                 lambda: ot.ThieleInnesOrbit.from_params(e=0.2, A=1.0, B=2.0, F=3.0, G=4.0,
                                                         tp=57000.0, M=1.2, plx=50.0),
                 lambda: ot.RadialVelocityOrbit.from_params(a=7.0, e=0.2, omega=1.0,
                                                            tp=57000.0, M=1.2),
                 lambda: ot.AbsoluteVisualOrbit.from_params(**kw, ra=68.0, dec=-51.0,
                                                            pmra=0.0, pmdec=0.0,
                                                            ref_epoch=57000.0),
                 lambda: ot.orbits.CartesianOrbit.from_params(x=1.0, y=1.0, z=1.0, vx=0.0,
                                                              vy=0.0, vz=0.0, M=1.0, plx=50.0),
                 lambda: ot.orbits.FixedPositionOrbit.from_params(x=1.0, y=1.0, plx=50.0),
                 lambda: ot.orbits.HyperbolicOrbit.from_params(a=-5.0, e=1.5, i=0.5, omega=0.7,
                                                               Omega=1.2, tp=57000.0, M=1.3,
                                                               plx=40.0),
                 lambda: ot.kepler_solver(0.5, 0.1),
                 lambda: ot.orbits.kepler_solver_hyperbolic(0.5, 1.5)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.build_model(ot, chip_smoke.bench_table(ot))

    orbit = ot.VisualOrbit.from_params(**kw, device="cpu")
    assert orbit.a.device.type == "cpu" and orbit.a.dtype == torch.float64
    E = ot.kepler_solver(0.5, 0.1, device="cpu")
    assert abs(float(E - 0.1 * torch.sin(E)) - 0.5) < 1e-14
    kept = ot.VisualOrbit.from_params(**dict(kw, a=torch.tensor(7.0)))
    assert kept.e.device.type == "cpu"
    assert ot.kepler_solver(torch.tensor([0.5]), 0.1).shape == (1,)


# every basis string of the JAX package's `_BASIS_MAP`, with one orbit's
# elements (numbers, on the CPU)
BASIS_ELEMENTS = {
    "KepOrbit": dict(a=7.0, e=0.2, i=0.6, omega=1.0, Omega=2.0, tp=57000.0, M=1.2),
    "Visual{KepOrbit}": dict(chip_smoke.TRUE),
    "VisualOrbit": dict(chip_smoke.TRUE),
    "AbsoluteVisual{KepOrbit}": dict(chip_smoke.TRUE, ra=68.0, dec=-51.0, pmra=-5.0,
                                     pmdec=10.0, ref_epoch=57000.0),
    "AbsoluteVisualOrbit": dict(chip_smoke.TRUE, ra=68.0, dec=-51.0, pmra=-5.0, pmdec=10.0,
                                ref_epoch=57000.0, rv=1e4),
    "ThieleInnesOrbit": dict(e=0.2, A=1.0, B=2.0, F=3.0, G=4.0, tp=57000.0, M=1.2, plx=50.0),
    "RadialVelocityOrbit": dict(a=7.0, e=0.2, omega=1.0, tp=57000.0, M=1.2),
    "CartesianOrbit": dict(x=3.0, y=1.0, z=0.5, vx=-0.002, vy=0.005, vz=0.001, M=1.2,
                           tref=57000.0, plx=50.0),
    "FixedPosition": dict(sep=500.0, pa=0.8, plx=50.0),
    "Visual{FixedPosition}": dict(x=3.0, y=-2.0, plx=50.0),
    "HyperbolicOrbit": dict(a=-5.0, e=1.5, i=0.5, omega=0.7, Omega=1.2, tp=57000.0, M=1.3,
                            plx=40.0),
    "Hyperbolic{KepOrbit}": dict(a=-5.0, e=1.5, i=0.5, omega=0.7, Omega=1.2, tp=57000.0,
                                 M=1.3, plx=40.0),
}


@pytest.mark.parametrize("basis", sorted(BASIS_ELEMENTS))
def test_basis_strings_resolve_and_solve(basis):
    """Each basis string resolves to the class of the JAX package's name,
    and `orbitsolve` solves its elements (no TypeError) with every field
    finite (a KepOrbit's sky fields, a RadialVelocityOrbit's sky ones
    excepted: NaN by convention) and of the epochs' shape."""
    from octofitter_tpu.model.variables import resolve_basis as resolve_j
    from octofitter_tpu_torch.model.variables import resolve_basis

    cls = resolve_basis(basis)
    assert cls.__name__ == resolve_j(basis).__name__
    sol = ot.orbitsolve(cls.from_params(device="cpu", **BASIS_ELEMENTS[basis]),
                        np.linspace(56000.0, 58000.0, 5))
    assert sol.EA.shape == (5,)
    sky = ("raoff_mas", "decoff_mas", "pmra_masyr", "pmdec_masyr")
    nan_fields = {"KepOrbit": sky, "RadialVelocityOrbit": sky + ("posx", "posy", "vx", "vy")}
    for f in dataclasses.fields(sol):
        value = getattr(sol, f.name)
        if isinstance(value, torch.Tensor) and f.name not in nan_fields.get(basis, ()):
            assert bool(torch.isfinite(value).all()), (basis, f.name)


def test_per_epoch_tells_rows_from_epochs():
    ctx = ot.model.PlanetObservationContext(
        theta_system=ot.Params(), theta_planet=ot.Params(), theta_obs=ot.Params(), orbits=(),
        solutions=(), i_planet=0, epoch_start=0, batch_shape=(3,))
    assert per_epoch(torch.zeros(3), ctx).shape == (3, 1)
    assert per_epoch(torch.zeros(3, 12), ctx).shape == (3, 12)
    assert per_epoch(torch.tensor(1.0), ctx).shape == (1,)
    assert per_epoch(2.0, ctx) == 2.0


def _per_epoch_jitter_model(pkg, table, **kw):
    """The headline model with one jitter per epoch: a (rows, T) parameter."""
    n = len(table["epoch"])
    variables = dict(jit=pkg.IIDVector(pkg.distributions.LogUniform(0.1, 10.0), n),
                     jitter=lambda s, pl, o: o.jit)
    return chip_smoke.build_model(pkg, table, astrom_variables=variables, **kw)


def test_per_epoch_jitter_matches_jax():
    """A jitter of shape (rows, T) gives JAX's ln_post and gradient at 1e-10,
    where an unsqueezed (rows, T, 1) jitter would broadcast to (rows, T, T)."""
    table = chip_smoke.bench_table(ot)
    mj = _per_epoch_jitter_model(oc, table)
    mt = _per_epoch_jitter_model(ot, table, device="cpu")
    assert mt.parameter_names == mj.parameter_names and mt.D == 23
    nat = mt.sample_priors(torch.Generator().manual_seed(4), 8)
    pts = mt.link(nat).numpy()
    lp_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(mj._ln_post_py)))(jnp.asarray(pts))
    lp_t, g_t = mt.ln_post_and_grad(torch.as_tensor(pts))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-10, atol=0)
    scale = np.abs(np.asarray(g_j)).max(axis=1, keepdims=True)
    assert (np.abs(g_t.numpy() - np.asarray(g_j)) <= 1e-10 * scale).all()
