"""The port's parallel tempering against the JAX package, on the CPU in
float64.

Deterministic pieces are compared as numbers: the DEO swap and the rung
coefficients exactly, the stacked step-size and trajectory-length
adaptation, the `UserLikelihood` / `DirectLL` terms and the annealed value
and gradient of the partial-arc model (`bench.py:build_model(56800,
57400)`) to rounding. The sampler is checked against the conjugate
Normal-Normal model's analytic posterior and evidence, with the JAX
package's tolerances (tests/test_tempering.py), for both explorers and the
variational leg; a checkpointed run must resume bit-identically; and both
packages run one recording round of the partial-arc fit from the same JAX
checkpoint, compared by posterior statistics.
"""

import math
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octofitter_tpu as oc
from octofitter_tpu import distributions as jdist
from octofitter_tpu.samplers import chees as jchees
from octofitter_tpu.samplers import nuts as jnuts
from octofitter_tpu.samplers import tempering as jpt

import octofitter_tpu_torch as ot
from octofitter_tpu_torch import distributions as tdist
from octofitter_tpu_torch.samplers import chees as tchees
from octofitter_tpu_torch.samplers import nuts as tnuts
from octofitter_tpu_torch.samplers import tempering as tpt

import chip_smoke

LOGZ_TRUE = -0.5 * (1.0 / 1.25) - 0.5 * math.log(2 * math.pi * 1.25)


def _conjugate(pkg, dist, **model_kw):
    """Prior x ~ N(0, 1), one observation y = 1 ~ N(x, 0.5): posterior
    N(0.8, 0.2), evidence N(1; 0, sqrt(1.25))."""
    obs = pkg.UserLikelihood(dist.Normal(1.0, 0.5), "x", name="obs1")
    system = pkg.System(name="conjugate", variables=dict(x=dist.Normal(0.0, 1.0)),
                        observations=[obs])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def _toy(pkg, dist, **model_kw):
    """tests/test_checkpoint.py's model: a DirectLL Gaussian in (x, y)."""
    system = pkg.System(
        name="ckpt",
        variables=dict(
            x=dist.Normal(0.0, 3.0),
            y=dist.Normal(0.0, 3.0),
            ll=lambda s: -0.5 * ((s.x - 1.0) ** 2 + (s.y + 0.5) ** 2) / 0.3**2,
        ),
        companions=[],
        observations=[pkg.DirectLL("ll")],
    )
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


# --------------------------------------------------------------------------
# deterministic pieces
# --------------------------------------------------------------------------

def test_deo_swap_matches_jax_exactly():
    """Random accept masks, overlapping pairs included, with labels: the
    gather gives the JAX package's roll-based result to the bit."""
    rng = np.random.default_rng(0)
    W, NT, D = 5, 7, 3
    for _ in range(4):
        theta = rng.standard_normal((W, NT, D))
        ll = rng.standard_normal((W, NT))
        accept = rng.random((W, NT - 1)) < 0.5
        labels = np.stack([rng.permutation(NT) for _ in range(W)])
        out_j = jpt.apply_deo_swap(jnp.asarray(theta), jnp.asarray(ll), jnp.asarray(accept),
                                   labels=jnp.asarray(labels))
        out_t = tpt.apply_deo_swap(torch.as_tensor(theta), torch.as_tensor(ll),
                                   torch.as_tensor(accept), labels=torch.as_tensor(labels))
        for a, b in zip(out_j, out_t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        no_labels = tpt.apply_deo_swap(torch.as_tensor(theta), torch.as_tensor(ll),
                                       torch.as_tensor(accept))
        assert len(no_labels) == 3


@pytest.mark.parametrize("n_var, q_active", [(0, False), (5, False), (5, True)])
def test_rung_coeffs_match_jax_exactly(n_var, q_active):
    bf = np.linspace(0.0, 1.0, 6)
    bv = np.linspace(1.0, 0.0, n_var) if n_var else np.zeros((0,))
    np.testing.assert_array_equal(tpt._rung_coeffs(bf, bv, q_active),
                                  jpt._rung_coeffs(bf, bv, q_active))


def test_stacked_adaptation_matches_jax():
    """Dual averaging and Adam with one entry per rung (numpy arrays)
    against the JAX package's on (NT,) arrays, over 20 steps; each entry of
    the stacked update equals the one-step-size update on that entry."""
    rng = np.random.default_rng(1)
    eps = rng.uniform(0.01, 0.5, 6)
    da_t, da_j = tnuts.da_init(eps), jnuts.da_init(jnp.asarray(eps))
    ad_t = tchees.AdamState(*(np.zeros(6) for _ in range(3)))
    ad_j = jchees.AdamState(*(jnp.zeros(6) for _ in range(3)))
    scalar = [tnuts.da_init(float(e)) for e in eps]
    for _ in range(20):
        alpha, g = rng.random(6), rng.standard_normal(6)
        da_t, da_j = tnuts.da_update(da_t, alpha, 0.8), jnuts.da_update(da_j, jnp.asarray(alpha), 0.8)
        (ad_t, d_t), (ad_j, d_j) = tchees._adam_step(ad_t, g), jchees._adam_step(ad_j, jnp.asarray(g))
        scalar = [tnuts.da_update(s, float(a), 0.8) for s, a in zip(scalar, alpha)]
        np.testing.assert_allclose(d_t, np.asarray(d_j), rtol=1e-13)
    for leaf_t, leaf_j in zip(da_t + ad_t, da_j + ad_j):
        np.testing.assert_allclose(leaf_t, np.asarray(leaf_j), rtol=1e-13, atol=1e-300)
    np.testing.assert_allclose(da_t.log_eps, [s.log_eps for s in scalar], rtol=1e-14)
    assert all(type(s.log_eps) is float for s in scalar)


def test_user_terms_ln_post_match_jax():
    """`UserLikelihood` (the conjugate model) and `DirectLL` (the toy model)
    in `ln_post` and its gradient, at 1e-12."""
    rng = np.random.default_rng(2)
    for build in (_conjugate, _toy):
        mj, mt = build(oc, jdist), build(ot, tdist, device="cpu")
        theta = rng.standard_normal((16, mt.D)) * 2.0
        lp_j = np.asarray(jax.vmap(mj.ln_post)(jnp.asarray(theta)))
        g_j = np.asarray(jax.vmap(jax.grad(mj.ln_post))(jnp.asarray(theta)))
        lp_t, g_t = mt.ln_post_and_grad(theta)
        np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=1e-12)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-12, atol=1e-12)


PA_KW = dict(n_chains=8, n_chains_variational=8, n_walkers=16, explorer="chees",
             explorer_n_leapfrog=16, verbosity=0)
PA_TUNING_ROUNDS = 4


def _jax_partial_arc_model():
    """`bench.py:build_model(56800, 57400)`, built here (importing the
    bench would set a process-wide JAX compilation cache): the headline
    model's 12 epochs on a 600-day arc of the 4400-day orbit."""
    from octofitter_tpu.orbits import VisualOrbit, decoff, orbitsolve, raoff

    n = 12
    rng = np.random.default_rng(0)
    epochs = np.linspace(56800.0, 57400.0, n)
    sol = orbitsolve(VisualOrbit.from_params(**chip_smoke.TRUE), jnp.asarray(epochs))
    astrom = oc.PlanetRelAstromObs(
        dict(epoch=epochs,
             ra=np.asarray(raoff(sol)) + rng.standard_normal(n) * 2.0,
             dec=np.asarray(decoff(sol)) + rng.standard_normal(n) * 2.0,
             σ_ra=np.full(n, 2.0), σ_dec=np.full(n, 2.0)),
        name="simdata",
    )
    b = oc.Planet(
        name="b", basis="Visual{KepOrbit}",
        variables=dict(
            a=jdist.Uniform(0.001, 100.0), e=jdist.Uniform(0.0, 0.99), i=jdist.Sine(),
            omega=oc.UniformCircular(), Omega=oc.UniformCircular(), theta=oc.UniformCircular(),
            tp=lambda s, p: oc.theta_at_epoch_to_tperi(
                p.theta, 57000.0, M=s.M, e=p.e, a=p.a, i=p.i, omega=p.omega, Omega=p.Omega),
        ),
        observations=[astrom],
    )
    system = oc.System(
        name="bench_partial_arc",
        variables=dict(M=jdist.truncated(jdist.Normal(1.2, 0.1), lower=0.1),
                       plx=jdist.truncated(jdist.Normal(50.0, 0.02), lower=0.1)),
        companions=[b],
    )
    return oc.LogDensityModel(system, verbosity=0)


def _jax_partial_arc_run(mj, ck):
    """The JAX partial-arc fit of the slice test: prior starts, tuned for
    PA_TUNING_ROUNDS rounds with a checkpoint after each, then one
    recording round."""
    return jpt.octofit_pigeons(mj, key=jax.random.PRNGKey(0), n_rounds=PA_TUNING_ROUNDS + 1,
                               checkpoint=ck, **PA_KW)


@pytest.fixture(scope="module", autouse=True)
def partial_arc(tmp_path_factory):
    """The JAX partial-arc model, and the JAX run of the slice test started at once in a thread (mostly
    XLA compiling and running, which releases the GIL), so that it overlaps
    the port-only tests before it."""
    ck = str(tmp_path_factory.mktemp("pt") / "pa.npz")
    with ThreadPoolExecutor(1) as pool:
        model_j = pool.submit(_jax_partial_arc_model)
        run_j = pool.submit(lambda: _jax_partial_arc_run(model_j.result(), ck))
        yield dict(model_j=model_j, run_j=run_j, ck=ck)


def _port_partial_arc_model(mj):
    """The port's partial-arc model on the JAX model's table."""
    table = {k: np.asarray(v) for k, v in mj.system.planets[0].observations[0].table.items()}
    return chip_smoke.build_model(ot, table, device="cpu")


def test_unported_options_raise():
    m = _conjugate(ot, tdist, device="cpu")
    # Gibbs-within-HMC samples discrete priors, of which this model has none
    with pytest.raises(ValueError, match="discrete priors"):
        ot.octofit(m, sampler="gibbs", verbosity=0)
    with pytest.raises(ValueError, match="n_chains_variational"):
        ot.octofit_pigeons(m, explorer="chees", n_chains_variational=1, verbosity=0)


# --------------------------------------------------------------------------
# the sampler on analytic targets
# --------------------------------------------------------------------------

@pytest.mark.parametrize("explorer, kw, mean_tol, logz_tol", [
    ("chees", dict(n_rounds=7, n_walkers=32), 0.05, 0.25),
    ("hmc", dict(n_rounds=6, n_walkers=32, explorer_n_leapfrog=8), 0.05, 0.2),
    ("nuts", dict(n_rounds=6, n_walkers=32, explorer_max_depth=5), 0.05, 0.25),
])
def test_conjugate_posterior_and_evidence(explorer, kw, mean_tol, logz_tol):
    """tests/test_tempering.py's conjugate checks, with its tolerances."""
    m = _conjugate(ot, tdist, device="cpu")
    chain, info = ot.octofit_pigeons(m, generator=torch.Generator().manual_seed(0),
                                     n_chains=8, explorer=explorer, verbosity=0, **kw)
    x = chain.flat("x")
    assert abs(x.mean() - 0.8) < mean_tol
    assert abs(x.var() - 0.2) < 0.05
    assert abs(info["logevidence"] - LOGZ_TRUE) < logz_tol, info["logevidence"]
    assert info["n_round_trips"] > 10
    assert np.all(info["trajectory_length"] > 0)
    assert info["n_sweeps"] == 2 ** (kw["n_rounds"] + 1) - 2


def test_variational_leg():
    """tests/test_tempering.py::test_pt_variational_leg with the ChEES
    explorer: posterior, evidence, the tuned Gaussian reference, and its
    leg's barrier far below the prior leg's."""
    m = _conjugate(ot, tdist, device="cpu")
    chain, info = ot.octofit_pigeons(
        m, generator=torch.Generator().manual_seed(0), n_rounds=8, n_chains=8,
        n_chains_variational=8, n_walkers=16, explorer="chees", verbosity=0)
    x = chain.flat("x")
    assert x.shape == (2 * 16 * 256,)
    assert abs(x.mean() - 0.8) < 0.06
    assert abs(x.var() - 0.2) < 0.05
    assert abs(info["logevidence"] - LOGZ_TRUE) < 0.25
    assert abs(info["variational_mean"][0] - 0.8) < 0.1
    assert abs(info["variational_std"][0] - math.sqrt(0.2)) < 0.1
    assert info["global_barrier_variational"] < 0.2
    assert info["global_barrier_variational"] < info["global_barrier"]


def test_checkpoint_resume_bit_identical(tmp_path, monkeypatch):
    """tests/test_checkpoint.py's check: a run checkpointed at round 3 and
    resumed to 6 rounds matches an uninterrupted 6-round run exactly. The
    resumed run turns its draws into `Chains` in batches of 100 rows."""
    kw = dict(n_chains=6, n_walkers=8, n_rounds=6, explorer="chees", verbosity=0)

    def gen():
        return torch.Generator().manual_seed(7)

    chain_full, info_full = ot.octofit_pigeons(_toy(ot, tdist, device="cpu"), generator=gen(), **kw)
    ck = os.path.join(tmp_path, "pt_ckpt.npz")
    ot.octofit_pigeons(_toy(ot, tdist, device="cpu"), generator=gen(),
                       **{**kw, "n_rounds": 3, "checkpoint": ck})
    assert os.path.exists(ck)
    monkeypatch.setattr(tpt, "_POST_CHUNK", 100)
    chain_res, info_res = ot.octofit_pigeons(_toy(ot, tdist, device="cpu"), generator=gen(),
                                             **{**kw, "resume": ck})
    for name in ("x", "y"):
        np.testing.assert_array_equal(chain_full[name], chain_res[name])
    np.testing.assert_allclose(chain_full["ll"], chain_res["ll"], rtol=1e-14)
    assert info_full["logevidence"] == info_res["logevidence"]
    np.testing.assert_array_equal(info_full["betas"], info_res["betas"])
    np.testing.assert_array_equal(info_full["trajectory_length"], info_res["trajectory_length"])
    assert info_full["n_round_trips"] == info_res["n_round_trips"]
    with pytest.raises(ValueError, match="already completed"):
        ot.octofit_pigeons(_toy(ot, tdist, device="cpu"), **{**kw, "n_rounds": 2, "resume": ck})


def test_annealed_value_and_grad_match_jax(partial_arc):
    """The annealed value, log-likelihood and gradient over a (W, NT) batch
    of the partial-arc model, every rung with its own coefficients (a
    fixed and an active variational leg), against JAX `_make_annealed_vg`
    vmapped over the batch: 1e-10 relative. Walker 0 sits at a point whose
    ll is -inf (omega's (x, y) at the origin, where the unit-length term
    is log 0): a rung with ll-coefficient 0 must give the prior's finite
    gradient (its own 0 * NaN kept out), rungs with a non-zero one -inf."""
    mj = partial_arc["model_j"].result(timeout=600)
    mt = _port_partial_arc_model(mj)
    W, D = 4, mt.D
    coeffs = tpt._rung_coeffs(np.linspace(0, 1, 4), np.linspace(1, 0, 4), True)  # (8, 3)
    NT = len(coeffs)
    rng = np.random.default_rng(3)
    truth = chip_smoke.headline_points(ot, mt)[0].numpy()
    theta = truth + 0.3 * rng.standard_normal((W, NT, D))
    ix, iy = mt.parameter_names.index("b_omegax"), mt.parameter_names.index("b_omegay")
    theta[0, :, ix] = theta[0, :, iy] = 0.0
    qm, qls = rng.standard_normal(D) * 0.1, rng.standard_normal(D) * 0.2 - 1.0

    vg_j = jax.jit(jax.vmap(jax.vmap(jpt._make_annealed_vg(mj), in_axes=(0, 0, None, None)),
                            in_axes=(0, None, None, None)))
    (val_j, ll_j), g_j = vg_j(jnp.asarray(theta), jnp.asarray(coeffs), jnp.asarray(qm),
                              jnp.asarray(qls))
    val_j, ll_j, g_j = np.asarray(val_j), np.asarray(ll_j), np.asarray(g_j)
    val_t, ll_t, g_t = tpt._make_annealed_vg(mt)(
        torch.as_tensor(theta.reshape(-1, D)), torch.as_tensor(np.tile(coeffs, (W, 1))),
        torch.as_tensor(qm), torch.as_tensor(qls))
    val_t, ll_t, g_t = (x.numpy().reshape(s) for x, s in
                        ((val_t, (W, NT)), (ll_t, (W, NT)), (g_t, (W, NT, D))))

    np.testing.assert_allclose(val_t[1:], val_j[1:], rtol=1e-10)
    np.testing.assert_allclose(ll_t[1:], ll_j[1:], rtol=1e-10)
    np.testing.assert_allclose(g_t[1:], g_j[1:], rtol=1e-10, atol=1e-10 * np.abs(g_j[1:]).max())

    # the trap: ll = -inf on walker 0 at every rung
    assert np.all(ll_t[0] == -np.inf) and np.all(ll_j[0] == -np.inf)
    off = coeffs[:, 1] == 0  # the prior rung and the Gaussian reference's
    assert off.sum() == 2
    np.testing.assert_array_equal(val_t[0, ~off], -np.inf)
    # what those rungs' value and gradient must be: the JAX package's
    # prior and Gaussian terms alone, combined with the rungs' coefficients
    lp_prior = jax.vmap(mj.ln_prior_transformed)
    lq = jax.vmap(lambda t: jpt._gauss_logpdf(t, jnp.asarray(qm), jnp.asarray(qls)))
    th0 = jnp.asarray(theta[0, off])
    c = coeffs[off]
    want_val = c[:, 0] * np.asarray(lp_prior(th0)) + c[:, 2] * np.asarray(lq(th0))
    want_g = (c[:, 0, None] * np.asarray(jax.vmap(jax.grad(mj.ln_prior_transformed))(th0))
              + c[:, 2, None] * np.asarray(jax.vmap(jax.grad(
                  lambda t: jpt._gauss_logpdf(t, jnp.asarray(qm), jnp.asarray(qls))))(th0)))
    assert np.all(np.isfinite(g_t[0, off]))
    np.testing.assert_allclose(val_t[0, off], want_val, rtol=1e-10)
    np.testing.assert_allclose(g_t[0, off], want_g, rtol=1e-10, atol=1e-12)


# --------------------------------------------------------------------------
# the slice: one recording round of the partial-arc fit in both packages
# --------------------------------------------------------------------------

def test_partial_arc_recording_round_matches_jax(partial_arc):
    """A JAX partial-arc run (prior starts, 16 walkers, 8 + 8 rungs, ChEES
    capped at 16 leapfrog steps) tunes for 4 rounds, checkpointing, and
    records round 5; its recording round is bit-identical to a resume from
    the round-4 checkpoint (tests/test_checkpoint.py), so one call stands
    for both. The port resumes from that checkpoint through
    `interop.load_jax_pt_checkpoint` and records round 5 too. Then:
    - both sampled with the same schedule (`info["betas"]` equal);
    - the ridge is covered in both (tests/test_tempering.py's bound:
      q5(b_a) < 12 and q95(b_a) > 25);
    - each JAX quantile of b_a (5, 50, 95%) falls at the same probability
      in the port's draws within 4 Monte-Carlo standard errors,
      sqrt(p (1 - p) (1 / ESS_port + 1 / ESS_jax)) with the bulk ESS;
    - the log-evidence agrees within 4 sqrt(2) of the port's standard
      error (`info["logevidence_se"]`, from the spread of 8 walker groups'
      estimates; the JAX run's is taken to be the same): the short tuning
      leaves a barrier near 7 on 8 rungs, so this error is large."""
    from octofitter_tpu_torch.interop import load_jax_pt_checkpoint

    chain_j, info_j = partial_arc["run_j"].result(timeout=600)
    mt, ck = _port_partial_arc_model(partial_arc["model_j"].result()), partial_arc["ck"]
    state = load_jax_pt_checkpoint(ck, torch.Generator().manual_seed(1))
    with np.load(ck) as z:
        assert int(z["next_round"]) == PA_TUNING_ROUNDS
        np.testing.assert_array_equal(state["theta"], z["theta"])
        np.testing.assert_array_equal(state["da"].log_eps, z["da"][:, 0])
        np.testing.assert_array_equal(state["adam"].v, z["adam"][:, 1])
    chain_t, info_t = ot.octofit_pigeons(mt, generator=torch.Generator(), resume=state,
                                         n_rounds=PA_TUNING_ROUNDS + 1, **PA_KW)

    np.testing.assert_array_equal(info_t["betas"], info_j["betas"])
    np.testing.assert_array_equal(info_t["betas_variational"], info_j["betas_variational"])
    a_t, a_j = chain_t["b_a"], chain_j["b_a"]
    assert a_t.shape == a_j.shape == (32, 32)
    for a in (a_t, a_j):
        q5, q95 = np.quantile(a.reshape(-1), [0.05, 0.95])
        assert q5 < 12.0 and q95 > 25.0, (q5, q95)
    ess_t, ess_j = ot.ess_rhat(a_t)[0], ot.ess_rhat(a_j)[0]
    for p in (0.05, 0.5, 0.95):
        q_j = np.quantile(a_j.reshape(-1), p)
        p_t = np.mean(a_t.reshape(-1) <= q_j)
        tol = 4 * math.sqrt(p * (1 - p) * (1 / ess_t + 1 / ess_j))
        assert abs(p_t - p) < tol, (p, p_t, tol)
    assert np.isfinite(info_t["logevidence"]) and np.isfinite(info_j["logevidence"])
    d_logz = abs(info_t["logevidence"] - info_j["logevidence"])
    assert d_logz < 4 * math.sqrt(2) * info_t["logevidence_se"], (
        info_t["logevidence"], info_j["logevidence"], info_t["logevidence_se"])
