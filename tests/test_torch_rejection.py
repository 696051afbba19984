"""The port's rejection sampler and OFTI linear solve against the JAX
package, on the CPU in float64.

`ofti_linear_solve` is deterministic and is held to the JAX function as
numbers: values and gradients, the gradient running through the Kepler
solve's implicit backward. Rejection draws are IID, so a KS test is exact:
the port's draws are held to the conjugate model's analytic posterior, and
on the OFTI model of `examples/09_ofti_rejection.py` to the JAX package's
draws by a two-sample test. The superset-and-refilter bookkeeping is held
to one accept over all the batches at once.
"""

import importlib.util
import math
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from octofitter_tpu.model.parameterizations import ofti_linear_solve as ofti_j
from octofitter_tpu.samplers.driver import octofit_rejection as rejection_j

import octofitter_tpu_torch as ot
from octofitter_tpu_torch import distributions as tdist

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example09():
    spec = importlib.util.spec_from_file_location(
        "ex09", os.path.join(REPO, "examples", "09_ofti_rejection.py"))
    ex09 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex09)
    return ex09


REDUCED = dict(num_samples=2000, batch_size=100_000, max_batches=20, verbosity=0)


@pytest.fixture(scope="module", autouse=True)
def ofti():
    """The example's JAX model and data, the port's model on the same data,
    and the JAX rejection run at the reduced size, started at once in a
    thread (mostly XLA compiling, which releases the GIL) so that it
    overlaps the port-only tests."""
    ex09 = _example09()
    mj, data = ex09.build_model()
    mt = chip_smoke.build_ofti_model(ot, data, device="cpu")
    with ThreadPoolExecutor(1) as pool:
        run_j = pool.submit(rejection_j, mj, key=jax.random.PRNGKey(3), **REDUCED)
        yield dict(mj=mj, mt=mt, data=data, run_j=run_j)


def _params(n, seed):
    """n nonlinear parameter sets from the example's priors."""
    rng = np.random.default_rng(seed)
    e = rng.uniform(0.0, 0.99, n)
    a = np.exp(rng.uniform(0.0, math.log(100.0), n))
    M = np.clip(rng.normal(1.2, 0.1, n), 0.1, None)
    tp = 50000.0 + rng.uniform(0.0, 1.0, n) * np.sqrt(a**3 / M) * 365.25
    plx = rng.normal(50.0, 0.5, n)
    return e, a, tp, M, plx


def test_ofti_linear_solve_matches_jax(ofti):
    """256 parameter sets: the Thiele-Innes means and the marginal
    log-likelihood to 1e-10 relative, and the gradient of the marginal
    log-likelihood with respect to (e, a, tp, M, plx) to 1e-9 relative."""
    d = ofti["data"]
    args = (d["epochs"], d["ra"], d["dec"], d["s_ra"], d["s_dec"], d["cor"], 1000.0)
    params = _params(256, seed=0)

    def lml_j(*p):
        return ofti_j(*args, *p)["log_marginal_likelihood"]

    out_j = jax.jit(jax.vmap(lambda *p: ofti_j(*args, *p)))(*map(jnp.asarray, params))
    grad_j = jax.jit(jax.vmap(jax.grad(lml_j, argnums=(0, 1, 2, 3, 4))))(*map(jnp.asarray, params))

    leaves = [torch.as_tensor(p).requires_grad_(True) for p in params]
    out_t = ot.ofti_linear_solve(*args, *leaves)
    # the marginal likelihood does not depend on plx: its gradient is 0
    grad_t = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, torch.autograd.grad(
        out_t["log_marginal_likelihood"].sum(), leaves, allow_unused=True))]
    for k in ("A", "B", "F", "G", "log_marginal_likelihood"):
        ref = np.asarray(out_j[k])
        got = out_t[k].detach().numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10 * np.abs(ref).max(), err_msg=k)
    for name, g_t, g_j in zip(("e", "a", "tp", "M", "plx"), grad_t, grad_j):
        ref = np.asarray(g_j)
        np.testing.assert_allclose(g_t.numpy(), ref, rtol=1e-9, atol=1e-9 * np.abs(ref).max(),
                                   err_msg=name)
    # one set without a batch axis, in Python floats, as a user calls it
    one = ot.ofti_linear_solve(*args, *(float(p[0]) for p in params), device="cpu")
    assert one["A"].shape == () and abs(float(one["A"]) - float(out_j["A"][0])) < 1e-9 * (
        1 + abs(float(out_j["A"][0])))


def test_ofti_default_device_is_the_gpu(ofti):
    """Inputs that are not tensors go to the GPU unless the caller asks for
    the CPU; with no CUDA device that raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    d = ofti["data"]
    args = (d["epochs"], d["ra"], d["dec"], d["s_ra"], d["s_dec"], d["cor"], 1000.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ot.ofti_linear_solve(*args, 0.3, 10.0, 50000.0, 1.2, 50.0)


def test_parameterizations_match_jax():
    """The position-angle parameterizations at 64 random orbits, 1e-10."""
    rng = np.random.default_rng(1)
    n = 64
    p = dict(M=rng.uniform(0.5, 2.0, n), e=rng.uniform(0.0, 0.9, n), i=rng.uniform(0.1, 3.0, n),
             Omega=rng.uniform(-3.0, 3.0, n), omega=rng.uniform(-3.0, 3.0, n),
             plx=rng.uniform(10.0, 100.0, n))
    theta, om_theta = rng.uniform(-3.0, 3.0, n), rng.uniform(-3.0, 3.0, n)
    a, sep = rng.uniform(1.0, 50.0, n), rng.uniform(50.0, 2000.0, n)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp_ = {k: torch.as_tensor(v) for k, v in p.items()}
    from octofitter_tpu.model import parameterizations as jparam

    ref = jparam.theta_omegatheta_at_epoch_to_omega_tperi(
        jnp.asarray(theta), jnp.asarray(om_theta), 57000.0, a=jnp.asarray(a), **jp)
    got = ot.model.theta_omegatheta_at_epoch_to_omega_tperi(
        torch.as_tensor(theta), torch.as_tensor(om_theta), 57000.0, a=torch.as_tensor(a), **tp_)
    ref_sep = jparam.theta_sep_at_epoch_to_tperi_sma(
        jnp.asarray(theta), jnp.asarray(sep), 57000.0, **jp)
    got_sep = ot.model.theta_sep_at_epoch_to_tperi_sma(
        torch.as_tensor(theta), torch.as_tensor(sep), 57000.0, **tp_)
    for g, r in zip(got + got_sep, ref + ref_sep):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-9)


def _conjugate(pkg, dist, **model_kw):
    """tests/test_rejection.py's model: prior x ~ N(0, 1), one observation
    y = 1 ~ N(x, 0.5); posterior N(0.8, sqrt(0.2))."""
    obs = pkg.UserLikelihood(dist.Normal(1.0, 0.5), "x", name="obs1")
    system = pkg.System(name="conjugate_rej", variables=dict(x=dist.Normal(0.0, 1.0)),
                        observations=[obs])
    return pkg.LogDensityModel(system, verbosity=0, **model_kw)


def test_rejection_matches_analytic_posterior():
    """tests/test_rejection.py::test_rejection_matches_analytic_posterior
    with its sizes and bounds: KS against the analytic cdf."""
    m = _conjugate(ot, tdist, device="cpu")
    chain = ot.octofit_rejection(m, generator=torch.Generator().manual_seed(0), num_samples=4000,
                                 batch_size=20_000, verbosity=0)
    x = chain.flat("x")
    assert len(x) == 4000
    post_mean, post_sd = 0.8, math.sqrt(0.2)
    assert abs(x.mean() - post_mean) < 4 * post_sd / math.sqrt(len(x))
    assert abs(x.std() - post_sd) < 0.03
    ks = sps.kstest(x, lambda q: sps.norm.cdf(q, post_mean, post_sd))
    assert ks.pvalue > 1e-3, ks
    assert "loglike" in chain.internals and "logpost" in chain.internals
    np.testing.assert_allclose(chain.internals["loglike"][0],
                               sps.norm.logpdf(1.0, x, 0.5), rtol=1e-12)
    assert chain.info["acceptance_fraction"] > 0.01 and chain.info["sampler"] == "rejection"


def test_rejection_refilters_to_one_global_accept():
    """A likelihood 2 x on x ~ N(0, 1), in batches of 100 draws: the running
    maximum moves with every new record of x, six times in this seeded run
    of 88 batches. The accepted draws must be exactly those that one accept
    over all the batches drawn, against their global maximum, keeps (the
    first num_samples of them), and the run must stop at the first batch
    at which that count reaches num_samples. The generator is replayed to
    rebuild every batch's draws and uniforms."""
    system = ot.System(name="ramp", variables=dict(x=tdist.Normal(0.0, 1.0),
                                                   ll=lambda s: 2.0 * s.x),
                       observations=[ot.DirectLL("ll")])
    m = ot.LogDensityModel(system, verbosity=0, device="cpu")
    kw = dict(num_samples=40, batch_size=100, max_batches=200, verbosity=0)
    chain = ot.octofit_rejection(m, generator=torch.Generator().manual_seed(4), **kw)
    n_batches = chain.info["n_batches"]

    gen = torch.Generator().manual_seed(4)
    xs, us, maxes, counts = [], [], [], []
    for _ in range(kw["max_batches"]):
        xs.append(m.sample_priors(gen, kw["batch_size"])[:, 0])
        us.append(torch.rand((kw["batch_size"],), generator=gen, dtype=torch.float64))
        x_all, u_all = torch.cat(xs), torch.cat(us)
        maxes.append(float(2.0 * x_all.max()))
        counts.append(int((u_all < torch.exp(2.0 * x_all - maxes[-1])).sum()))
    moves = sum(b > a for a, b in zip(maxes, maxes[1:n_batches]))
    assert moves >= 3, maxes[:n_batches]
    assert n_batches == next(i + 1 for i, c in enumerate(counts) if c >= kw["num_samples"])
    x_all, u_all = torch.cat(xs[:n_batches]), torch.cat(us[:n_batches])
    keep = u_all < torch.exp(2.0 * x_all - maxes[n_batches - 1])
    np.testing.assert_array_equal(chain.flat("x"), x_all[keep][: kw["num_samples"]].numpy())
    assert chain.info["acceptance_fraction"] == kw["num_samples"] / (n_batches * kw["batch_size"])
    assert chain.info["n_accepted"] == int(keep.sum()) >= kw["num_samples"]
    assert chain.info["n_drawn"] == n_batches * kw["batch_size"]


def test_rejection_maximum_skips_infinite_likelihoods():
    """The running maximum is taken over finite log-likelihoods, as the
    JAX package takes it: a draw with ll = +inf is accepted and does not
    make every finite draw's acceptance exp(ll - inf) = 0."""
    system = ot.System(name="spike", variables=dict(
        x=tdist.Uniform(0.0, 1.0),
        ll=lambda s: torch.where(s.x > 0.99, torch.inf, 0.0)),
        observations=[ot.DirectLL("ll")])
    m = ot.LogDensityModel(system, verbosity=0, device="cpu")
    chain = ot.octofit_rejection(m, generator=torch.Generator().manual_seed(0), num_samples=500,
                                 batch_size=1000, max_batches=2, verbosity=0)
    # ll = 0 is the finite maximum, so every draw is accepted
    assert chain.info["n_accepted"] == chain.info["n_drawn"] == 1000
    x = chain.flat("x")
    assert len(x) == 500 and (x <= 0.99).sum() > 450


def test_rejection_on_ofti_model_matches_jax(ofti):
    """The example's model at a reduced size (batches of 100,000, 2,000
    draws) in both packages: a two-sample KS test on e, a and plx."""
    chain_t = ot.octofit_rejection(ofti["mt"], generator=torch.Generator().manual_seed(3), **REDUCED)
    chain_j = ofti["run_j"].result(timeout=600)
    for name in ("e", "a", "plx"):
        x_t, x_j = chain_t.flat(name), chain_j.flat(name)
        assert len(x_t) == len(x_j) == REDUCED["num_samples"]
        ks = sps.ks_2samp(x_t, x_j)
        assert ks.pvalue > 1e-3, (name, ks)
    # derived tp and the Thiele-Innes marginal likelihood come along
    assert np.isfinite(chain_t.flat("tp")).all()
    np.testing.assert_allclose(chain_t.internals["loglike"][0], chain_t.flat("ll"), rtol=1e-12)
    frac_t, frac_j = chain_t.info["acceptance_fraction"], chain_j.info["acceptance_fraction"]
    assert 0.5 < frac_t / frac_j < 2.0, (frac_t, frac_j)


def test_chip_smoke_ofti_data_follows_the_example(ofti):
    """`chip_smoke.ofti_data` (the port's orbitsolve, numpy seed 42) makes
    the example's data."""
    mine = chip_smoke.ofti_data(ot)
    for k, v in ofti["data"].items():
        np.testing.assert_allclose(mine[k], np.asarray(v), rtol=1e-12, atol=1e-9, err_msg=k)
