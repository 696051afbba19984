"""The port's `analysis` package against the JAX package, on the CPU in
float64.

`pointwise_like` on one chain of 200 draws of the headline model
(`chip_smoke.build_model`) in both packages, its row sums and its chunks;
`psis_loo` on one log-likelihood matrix with a column whose Pareto k is at
least 0.7; the model generators (`prior_only_model` both ways, k-fold,
per epoch) by counts, epochs, D and ln_post; completeness jobs, their
assembly and a trial's simulated data (examples/11's model,
`chip_smoke.build_completeness_model`, on a synthetic scan law) from one
theta and one numpy seed; and a short `calibrate` on examples/10's model.
Every JAX model is built once, in threads started with the module.
"""

import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octofitter_tpu as oc
from octofitter_tpu import analysis as ja
from octofitter_tpu.analysis import completeness as jcomp
from octofitter_tpu.model.generate import generate_from_params as generate_j

import octofitter_tpu_torch as ot
from octofitter_tpu_torch import analysis as ta
from octofitter_tpu_torch.analysis import completeness as tcomp

import chip_smoke

TABLE = chip_smoke.bench_table(ot)
N_DRAWS = 200
SCANS = 40
GOST_DIR = tempfile.TemporaryDirectory()
GOST = chip_smoke.synth_gost_csv(GOST_DIR.name, n=SCANS, seed=33)
# a completeness job's seed and injection (examples/11's --fast corner)
JOB = jcomp.completeness_jobs(masses=[20.0], separations=[5.0], n_trials=1, seed=4)[0]


def _chain(model_t):
    """N_DRAWS natural-space draws near the headline truth as a (2, 100)
    chain of named arrays."""
    pts = chip_smoke.headline_points(ot, model_t, N_DRAWS)
    pts = pts + 0.05 * torch.randn(pts.shape, generator=torch.Generator().manual_seed(1),
                                   dtype=torch.float64)
    nat = model_t.invlink(pts).numpy()
    return {n: nat[:, k].reshape(2, -1) for k, n in enumerate(model_t.parameter_names)}


def _ln_post_j(model_j, theta):
    return np.array([float(model_j.ln_post(jnp.asarray(th))) for th in theta])


def _generators_j(mj, theta):
    """The JAX package's derived systems: counts, epochs, and ln_post at
    `theta` of the prior-only models, the k-fold system and the first and
    last per-epoch systems."""
    out = {}
    for exclude_all in (False, True):
        m = oc.LogDensityModel(ja.prior_only_model(mj, exclude_all), verbosity=0)
        out[("prior_only", exclude_all)] = (m.D, _ln_post_j(m, theta))
    folds = ja.generate_kfold_systems(mj.system)
    out["kfold"] = [(m.D, _ln_post_j(m, theta))
                    for m in (oc.LogDensityModel(s, verbosity=0) for s in folds)]
    systems, epochs = ja.generate_system_per_epoch(mj.system)
    out["per_epoch"] = (len(systems), epochs, {
        i: (lambda m: (m.D, _ln_post_j(m, theta)))(oc.LogDensityModel(systems[i], verbosity=0))
        for i in (0, len(systems) - 1)})
    return out


def _headline_j():
    mj = chip_smoke.build_model(oc, TABLE)
    mt = chip_smoke.build_model(ot, TABLE, device="cpu")
    chain = _chain(mt)
    LL, epochs = ja.pointwise_like(mj, chain)
    theta = mt.link(mt.sample_priors(torch.Generator().manual_seed(2), 16)).numpy()
    return {"chain": chain, "LL": LL, "epochs": epochs, "theta": theta,
            "generators": _generators_j(mj, theta)}


def _completeness_j():
    mj = chip_smoke.build_completeness_model(oc, GOST)
    theta = np.asarray(mj.sample_priors(jax.random.PRNGKey(JOB.seed)))
    theta = jcomp._apply_overrides(mj, theta, {"b_mass": JOB.mass, "b_a": JOB.separation})
    system = generate_j(mj, mj.arr2nt(jnp.asarray(theta)), rng=np.random.default_rng(JOB.seed),
                        add_noise=True)
    return {"theta": theta, "table": dict(system.observations[0].table)}


_POOL = ThreadPoolExecutor(2)
_HEADLINE = _POOL.submit(_headline_j)
_COMPLETENESS = _POOL.submit(_completeness_j)


@pytest.fixture(scope="module")
def headline():
    return _HEADLINE.result(), chip_smoke.build_model(ot, TABLE, device="cpu")


def test_pointwise_like_matches_jax(headline):
    """The (200, 12) matrix equals JAX's within 1e-10 with the same epochs;
    each row sums to the draw's ln_like less the prior-only model's (the
    UnitLengthPrior terms, which carry no data); chunks of 64 draws (the
    last of 8) give the same matrix."""
    ref, mt = headline
    LL, epochs = ta.pointwise_like(mt, ref["chain"])
    assert LL.shape == (N_DRAWS, mt.n_epochs) and LL.dtype == np.float64
    np.testing.assert_allclose(LL, ref["LL"], rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(epochs, ref["epochs"])
    flat = torch.as_tensor(np.stack([ref["chain"][n].reshape(-1) for n in mt.parameter_names], -1))
    blank = ot.LogDensityModel(ta.prior_only_model(mt), verbosity=0, device="cpu")
    with torch.no_grad():
        data = mt.ln_like_nt(mt.arr2nt(flat)) - blank.ln_like_nt(blank.arr2nt(flat))
    np.testing.assert_allclose(LL.sum(axis=1), data.numpy(), rtol=1e-10)
    LL_chunked, _ = ta.pointwise_like(mt, ref["chain"], chunk_size=64)
    np.testing.assert_allclose(LL_chunked, LL, rtol=1e-14, atol=1e-14)


def test_psis_loo_matches_jax():
    """elpd_loo, p_loo, the pointwise elpd and every Pareto k equal JAX's to
    1e-12 on a (400, 6) matrix whose first column's importance ratios
    exp(-LL) are uniform, which the estimator (Zhang and Stephens's k, the
    negative of the tail index) scores k >= 0.7, left unsmoothed; the other
    columns are Gaussian."""
    rng = np.random.default_rng(7)
    LL = -0.5 * rng.standard_normal((400, 6)) ** 2 - 1.0
    LL[:, 0] = -np.log(rng.uniform(size=400))
    out_t, out_j = ta.psis_loo(LL), ja.psis_loo(LL)
    assert out_t["pareto_k"][0] >= 0.7 and (out_t["pareto_k"][1:] < 0.7).all()
    for key in ("elpd_loo", "p_loo", "elpd_pointwise", "pareto_k"):
        np.testing.assert_allclose(out_t[key], out_j[key], rtol=1e-12, atol=0)


def test_model_generators_match_jax(headline):
    """prior_only_model (both ways), generate_kfold_systems and
    generate_system_per_epoch: the same counts, epochs and D as the JAX
    package's, and ln_post at 16 draws within 1e-10 (the per-epoch systems
    at the first and last epoch); `exclude_all` drops the UniformCircular
    pseudo-likelihoods too."""
    ref, mt = headline
    gen_j, theta = ref["generators"], torch.as_tensor(ref["theta"])

    def port(system):
        m = ot.LogDensityModel(system, verbosity=0, device="cpu")
        with torch.no_grad():
            return m.D, m.ln_post(theta).numpy()

    for exclude_all in (False, True):
        D, lp = port(ta.prior_only_model(mt, exclude_all))
        D_j, lp_j = gen_j[("prior_only", exclude_all)]
        assert D == D_j == mt.D
        np.testing.assert_allclose(lp, lp_j, rtol=1e-10)
    folds = ta.generate_kfold_systems(mt.system)
    assert len(folds) == len(gen_j["kfold"]) == 1
    for system, (D_j, lp_j) in zip(folds, gen_j["kfold"]):
        D, lp = port(system)
        assert D == D_j
        np.testing.assert_allclose(lp, lp_j, rtol=1e-10)
    systems, epochs = ta.generate_system_per_epoch(mt.system)
    n_j, epochs_j, rows_j = gen_j["per_epoch"]
    assert len(systems) == n_j == mt.n_epochs
    np.testing.assert_array_equal(epochs, epochs_j)
    for i, system in enumerate(systems):
        D, lp = port(system)
        assert D == mt.D
        if i in rows_j:
            assert D == rows_j[i][0]
            np.testing.assert_allclose(lp, rows_j[i][1], rtol=1e-10)


def test_completeness_jobs_and_assembly_match_jax():
    """The jobs for one seed are identical, and so is the map assembled from
    the same results by the same criterion."""
    kw = dict(masses=[1.0, 5.0, 20.0], separations=[0.5, 2.0], n_trials=3, seed=11)
    jobs_t, jobs_j = tcomp.completeness_jobs(**kw), jcomp.completeness_jobs(**kw)
    assert [tuple(vars(j).values()) for j in jobs_t] == [tuple(vars(j).values()) for j in jobs_j]
    rng = np.random.default_rng(3)
    chains = [{"b_mass": rng.lognormal(np.log(j.mass), 1.0, 50)} for j in jobs_t]

    def detected(chain, theta_true):
        return np.median(chain["b_mass"]) > theta_true

    maps = [comp.assemble_completeness(
        [comp.CompletenessResult(j, c, j.mass) for j, c in zip(jobs, chains)], detected,
        masses=kw["masses"], separations=kw["separations"])
        for comp, jobs in ((tcomp, jobs_t), (jcomp, jobs_j))]
    for field in ("masses", "separations", "completeness", "n_detected", "n_total"):
        np.testing.assert_array_equal(getattr(maps[0], field), getattr(maps[1], field))


def test_completeness_trial_data_match_jax():
    """A trial's simulated scan-law data (examples/11's model) from the JAX
    package's prior draw with the injection and numpy's default_rng(seed)
    equal JAX's `generate_from_params` within 1e-10 mas; the trial starts
    its fit from 8 copies of the truth, a tensor on the model's device."""
    ref = _COMPLETENESS.result()
    mt = chip_smoke.build_completeness_model(ot, GOST, device="cpu")
    sim, theta_nt = tcomp._simulated_model(mt, ref["theta"], JOB.seed, True)
    table = sim.system.observations[0].table
    np.testing.assert_allclose(table["centroid_pos_al"], ref["table"]["centroid_pos_al"],
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(table["epoch"], ref["table"]["epoch"])
    assert float(theta_nt.planets["b"].mass) == JOB.mass

    starts = []
    res = tcomp.run_completeness_trial(
        JOB, mt, lambda m: starts.append(m.starting_points) or "chain",
        inject=lambda m, s: {"b_mass": m, "b_a": s})
    assert res.chain == "chain" and float(res.theta_true.planets["b"].a) == JOB.separation
    (pts,) = starts
    assert isinstance(pts, torch.Tensor) and pts.shape == (8, mt.D) and pts.device == mt.device
    assert torch.equal(pts[0], pts[7]) and bool(torch.isfinite(pts).all())


def test_calibrate_ranks_and_ks():
    """Three SBC trials on examples/10's model (4 chains, 30 + 30, at the
    truth): ranks in [0, 1], the KS distance of JAX's formula, three
    different truths and finite draws."""
    model = chip_smoke.build_ex10_model(ot, chip_smoke.ex10_table(ot), device="cpu")
    res = ta.calibrate(model, 3, seed=5, init_at_truth=True, verbosity=0,
                       sampler_kwargs=dict(chains=4, adaptation=30, iterations=30))
    assert set(res) == set(model.parameter_names)
    for r in res.values():
        ranks = r["ranks"]
        assert ranks.shape == (3,) and ((ranks >= 0) & (ranks <= 1)).all()
        ks = np.max(np.abs(np.sort(ranks) - np.arange(1, 4) / 3))
        assert r["ks_distance"] == ks
        assert len(set(r["truths"].tolist())) == 3 and r["finite"].all()
