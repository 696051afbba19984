"""The port's other orbit bases against the JAX package, in float64 on the CPU.

`AbsoluteVisual{KepOrbit}` (barycentric propagation, each chain's Kepler
solve at its own emission epochs), `CartesianOrbit` (with
`cartesian_to_campbell`), `Visual{FixedPosition}` and
`Hyperbolic{KepOrbit}`: every field of each basis's `OrbitSolution` (and
the AbsoluteVisual `compensated` block) at 1e-12 of max(|value|, 1), the
emission epochs at 1e-9 d, for C >= 3 chains whose parallax, proper
motion and radial velocity differ (the JAX side is its one-orbit solve
vmapped over the chains). Then the relative-astrometry model on each basis
(`chip_smoke.build_basis_model`, both packages, one table) at 16 shared
unconstrained points: ln_post within 1e-9 of max(|ln_post|, 1) and each
point's gradient within 1e-7 of its largest entry; on AbsoluteVisual that
comparison failing with each planted fault of the propagation (no
light-travel term, no radial velocity, a chain paired with another's
emission epochs); and the Laplace step's Hessian through the composed
AbsoluteVisual solve against `jax.hessian`. Each JAX model is built once.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octofitter_tpu as oc
import octofitter_tpu_torch as ot
from octofitter_tpu.orbits import absolute_visual as jav
from octofitter_tpu.orbits import extra_bases as jxb
from octofitter_tpu_torch.interop import load_jax_state
from octofitter_tpu_torch.model.initialization import laplace
from octofitter_tpu_torch.orbits import absolute_visual as tav
from octofitter_tpu_torch.orbits import extra_bases as txb

import chip_smoke

FIELD_TOL, T_EM_TOL = 1e-12, 1e-9
VALUE_TOL, GRAD_TOL = chip_smoke.ABS_VALUE_TOL, chip_smoke.ABS_GRAD_TOL
FIELDS = ("EA", "nu", "r", "posx", "posy", "posz", "vx", "vy", "vz", "raoff_mas",
          "decoff_mas", "pmra_masyr", "pmdec_masyr", "radvel_ms")
EPOCHS = np.linspace(47000.0, 58500.0, 9)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def _hold_solution(sol_t, sol_j, fields=FIELDS):
    for name in fields:
        a, b = getattr(sol_t, name).numpy(), np.asarray(getattr(sol_j, name))
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert _rel(a, b) <= FIELD_TOL, (name, _rel(a, b))


def _solve_jax(cls, elems: dict, t):
    """The JAX package's one-orbit solve vmapped over the chains."""
    def one(kw):
        return oc.orbitsolve(cls(**kw), jnp.asarray(t))

    return jax.vmap(one)({k: jnp.asarray(v) for k, v in elems.items()})


def _tensors(elems: dict):
    return {k: torch.as_tensor(v, dtype=torch.float64) for k, v in elems.items()}


ABS_ELEMS = dict(
    a=np.array([3.0, 7.0, 12.0, 30.0]), e=np.array([0.0, 0.2, 0.6, 0.95]),
    i=np.array([0.1, 0.6, 1.5, 2.9]), omega=np.array([0.3, 1.0, 4.0, 6.0]),
    Omega=np.array([2.0, 0.5, 3.0, 5.5]), tp=np.array([48000.0, 50000.0, 57000.0, 40000.0]),
    M=np.array([1.0, 1.2, 0.4, 2.5]), plx=np.array([50.0, 3.0, 400.0, 120.0]),
    ra=np.array([68.0, 0.001, 359.99, 180.0]), dec=np.array([-51.0, 89.0, -10.0, 0.0]),
    rv=np.array([0.0, 9e4, -3e5, 2e4]), pmra=np.array([-5.0, 300.0, -4000.0, 0.0]),
    pmdec=np.array([10.0, -200.0, 3000.0, 50.0]),
    ref_epoch=np.array([48348.5625, 57388.5, 51544.5, 57000.0]),
)


@pytest.mark.parametrize("t", [EPOCHS, np.array(50123.25)], ids=["epochs", "one_epoch"])
def test_absolute_visual_matches_jax(t):
    """Per-chain emission epochs: every chain's Kepler solve runs at its
    own t_em (C, T), which the repaired `_per_epoch` pairs with each
    chain's elements as (C, 1), never as (C, C, T)."""
    sol_j = _solve_jax(jav.AbsoluteVisualOrbit, ABS_ELEMS, t)
    elem = tav.AbsoluteVisualOrbit(**_tensors(ABS_ELEMS))
    sol_t = ot.orbitsolve(elem, t)
    assert sol_t.EA.shape == (4,) + np.shape(t)
    _hold_solution(sol_t, sol_j)
    for f in dataclasses.fields(tav.Compensated):
        a = getattr(sol_t.compensated, f.name).numpy()
        b = np.asarray(getattr(sol_j.compensated, f.name))
        if f.name == "t_em_days":
            assert np.max(np.abs(a - b)) <= T_EM_TOL
        else:
            assert _rel(a, b) <= FIELD_TOL, f.name
    # the chains' emission epochs differ from one another, and from t
    t_em = sol_t.compensated.t_em_days.numpy()
    assert np.all(np.abs(t_em[1:] - t_em[:1]) > 1e-3)


def test_absolute_visual_shared_astrometry_and_from_params():
    """Constants (0-d) beside per-chain elements: `from_params` on the
    CPU (rv defaults to 0), propagation shared by the chains, each orbit
    solved at the shared emission epochs."""
    kw = dict(a=torch.tensor([3.0, 5.0, 8.0], dtype=torch.float64), e=0.3, i=0.7, omega=1.0,
              Omega=2.0, tp=48000.0, M=1.1, plx=50.0, ra=68.0, dec=-51.0, pmra=-5.0,
              pmdec=10.0, ref_epoch=48348.5625)
    elem = tav.AbsoluteVisualOrbit.from_params(device="cpu", **kw)
    assert float(elem.rv) == 0.0
    sol_t = ot.orbitsolve(elem, EPOCHS)
    assert sol_t.EA.shape == (3, len(EPOCHS))
    assert sol_t.compensated.t_em_days.shape == (len(EPOCHS),)
    elems = {k: np.broadcast_to(np.asarray(v, np.float64), (3,)) for k, v in kw.items()}
    elems["rv"] = np.zeros(3)
    sol_j = _solve_jax(jav.AbsoluteVisualOrbit, elems, EPOCHS)
    _hold_solution(sol_t, sol_j)
    if not torch.cuda.is_available():
        # numbers alone go to the GPU by default, which must then exist
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tav.AbsoluteVisualOrbit.from_params(**{k: 1.0 for k in kw})


CART_ELEMS = dict(
    x=np.array([3.0, -1.0, 0.5]), y=np.array([1.0, 4.0, -2.0]), z=np.array([0.5, -2.0, 1.0]),
    vx=np.array([-0.002, 0.004, 0.001]), vy=np.array([0.005, 0.0, -0.006]),
    vz=np.array([0.001, 0.002, 0.003]), M=np.array([1.0, 1.5, 2.0]),
    tref=np.array([57000.0, 57388.5, 50000.0]), plx=np.array([50.0, 20.0, 80.0]),
)


def test_cartesian_matches_jax():
    sol_j = _solve_jax(jxb.CartesianOrbit, CART_ELEMS, EPOCHS)
    elem = txb.CartesianOrbit(**_tensors(CART_ELEMS))
    _hold_solution(ot.orbitsolve(elem, EPOCHS), sol_j)
    camp_j = jax.vmap(lambda kw: jxb.cartesian_to_campbell(jxb.CartesianOrbit(**kw)))(
        {k: jnp.asarray(v) for k, v in CART_ELEMS.items()})
    for a, b in zip(txb.cartesian_to_campbell(elem), camp_j):
        assert _rel(a.numpy(), b) <= FIELD_TOL
    tref = txb.CartesianOrbit.from_params(device="cpu", **{
        k: v for k, v in CART_ELEMS.items() if k != "tref"}).tref
    assert float(tref) == 57388.5


@pytest.mark.parametrize("how", ["xy", "radec", "seppa"])
def test_fixed_position_matches_jax(how):
    kw = {"xy": dict(x=np.array([1.0, -2.0, 3.0]), y=np.array([0.5, 0.0, -4.0])),
          "radec": dict(ra=np.array([100.0, -20.0, 3.0]), dec=np.array([5.0, 60.0, -40.0])),
          "seppa": dict(sep=np.array([500.0, 20.0, 3000.0]), pa=np.array([0.8, -2.0, 3.1]))}[how]
    kw = dict(kw, plx=np.array([50.0, 10.0, 80.0]), z=np.array([0.0, 1.0, -2.0]))

    def one(k):
        return oc.orbitsolve(jxb.FixedPositionOrbit.from_params(**k), jnp.asarray(EPOCHS))

    sol_j = jax.vmap(one)({k: jnp.asarray(v) for k, v in kw.items()})
    elem = txb.FixedPositionOrbit.from_params(device="cpu", **_tensors(kw))
    _hold_solution(ot.orbitsolve(elem, EPOCHS), sol_j)
    assert float(ot.orbits.semimajoraxis(elem)) == 0.0


HYP_ELEMS = dict(a=np.array([-5.0, 3.0, -20.0]), e=np.array([1.5, 1.05, 3.0]),
                 i=np.array([0.5, 1.2, 2.5]), omega=np.array([0.7, 3.0, 5.0]),
                 Omega=np.array([1.2, 0.1, 4.0]), tp=np.array([57000.0, 56000.0, 58000.0]),
                 M=np.array([1.3, 0.8, 2.0]), plx=np.array([40.0, 10.0, 100.0]))


def test_hyperbolic_matches_jax():
    t = np.linspace(56000.0, 58000.0, 9)
    sol_j = _solve_jax(jxb.HyperbolicOrbit, HYP_ELEMS, t)
    elems = _tensors(HYP_ELEMS)
    elems["e"].requires_grad_(True)
    sol_t = ot.orbitsolve(txb.HyperbolicOrbit(**elems), t)
    _hold_solution(
        type(sol_t)(**{f.name: (getattr(sol_t, f.name).detach() if f.name in FIELDS
                                else getattr(sol_t, f.name))
                       for f in dataclasses.fields(sol_t)}), sol_j)
    # the gradient through the hyperbolic solve's implicit derivative
    (g_t,) = torch.autograd.grad(sol_t.raoff_mas.sum(), elems["e"])

    def total(e):
        kw = {k: jnp.asarray(v) for k, v in HYP_ELEMS.items()}
        kw["e"] = e
        return jax.vmap(lambda k: oc.orbitsolve(jxb.HyperbolicOrbit(**k), jnp.asarray(t)).raoff_mas)(
            kw).sum()

    g_j = jax.grad(total)(jnp.asarray(HYP_ELEMS["e"]))
    assert _rel(g_t.numpy(), g_j) <= 1e-10


@pytest.mark.parametrize("cls, elems", [(tav.AbsoluteVisualOrbit, ABS_ELEMS),
                                        (txb.CartesianOrbit, CART_ELEMS),
                                        (txb.HyperbolicOrbit, HYP_ELEMS)],
                         ids=["absolute", "cartesian", "hyperbolic"])
def test_fused_flag_takes_the_composed_path(cls, elems):
    """These bases have no fused kernel: `orbitsolve(..., fused=True)` (the
    default) solves them by the composed path, as `fused=False` does."""
    elem = cls(**_tensors(elems))
    a = ot.orbitsolve(elem, EPOCHS, fused=True)
    b = ot.orbitsolve(elem, EPOCHS, fused=False)
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@functools.lru_cache(maxsize=None)
def _models(basis):
    """The relative-astrometry model on `basis` in both packages, built
    once per module (a JAX model compiles its ln_post and gradient when it
    is built), and 16 unconstrained prior draws of the JAX model, carried
    to the port's by interop."""
    table = chip_smoke.bench_table(ot)
    mj = chip_smoke.build_basis_model(oc, basis, table)
    mt = chip_smoke.build_basis_model(ot, basis, table, device="cpu")
    pts = shared_prior_draws(mj, 16, seed=4)
    load_jax_state(mt, parameter_names=mj.parameter_names, starting_points=pts,
                   laplace_sigma=np.eye(mj.D))
    return mj, mt


def shared_prior_draws(mj, n, seed):
    """`n` unconstrained prior draws of the JAX model `mj`, one at a time
    (the shapes its construction already compiled)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return np.stack([np.asarray(mj.link(mj.sample_priors(k))) for k in keys])


def jax_ln_post_and_grad(mj, pts):
    """The JAX model's own compiled ln_post_and_grad at each row of `pts`
    (a CPU tensor), as CPU tensors (n,) and (n, D)."""
    out = [mj.ln_post_and_grad(jnp.asarray(p)) for p in pts.numpy()]
    return (torch.tensor([float(v) for v, _ in out], dtype=torch.float64),
            torch.as_tensor(np.stack([np.asarray(g) for _, g in out])))


@pytest.fixture(scope="module", params=chip_smoke.OTHER_BASES)
def basis_models(request):
    return (request.param, *_models(request.param))


def test_basis_model_matches_jax(basis_models):
    """ln_post and its gradient of the headline's relative astrometry on
    each basis, at the 16 shared points."""
    basis, mj, mt = basis_models
    pts = mt.starting_points
    vj, gj = (x.numpy() for x in jax_ln_post_and_grad(mj, pts))
    vt, gt = mt.ln_post_and_grad(pts)
    vt, gt = vt.numpy(), gt.numpy()
    fin = np.isfinite(vj)
    assert np.array_equal(fin, np.isfinite(vt)), basis
    assert fin.sum() >= 8, basis
    assert np.max(np.abs(vt - vj)[fin] / np.maximum(np.abs(vj[fin]), 1.0)) <= VALUE_TOL
    err_g = np.abs(gt - gj).max(-1) / np.maximum(np.abs(gj).max(-1), 1.0)
    assert np.max(err_g[fin]) <= GRAD_TOL, basis


@contextlib.contextmanager
def planted_fault(fault):
    """Within the block the port's AbsoluteVisual propagation carries one
    fault: "light_travel" solves every orbit at the observation epochs
    (t_em = t), "rv" propagates the barycentre with no radial velocity,
    "epoch_pairing" gives each chain its neighbour's emission epochs."""
    plain = tav.propagate_astrometry

    def propagate(elem, t):
        if fault == "rv":
            return plain(dataclasses.replace(elem, rv=torch.zeros_like(elem.rv)), t)
        comp = plain(elem, t)
        if fault == "light_travel":
            t_em = torch.as_tensor(t, dtype=comp.t_em_days.dtype).expand_as(comp.t_em_days)
        else:
            t_em = comp.t_em_days.roll(1, dims=0)
        return dataclasses.replace(comp, t_em_days=t_em)

    tav.propagate_astrometry = propagate
    try:
        yield
    finally:
        tav.propagate_astrometry = plain


def hold_against_jax(mt, pts, vj, gj, dv, dg):
    """The port's ln_post and gradient at `pts` against the JAX package's
    (`vj`, `gj`) by the comparison the card's paths use,
    `chip_smoke.hold_values_and_gradients`, with the allowance for one ulp
    of the propagated degrees (`dv`, `dg`)."""
    vt, gt = mt.ln_post_and_grad(pts)
    return chip_smoke.hold_values_and_gradients("port vs JAX", vt, gt, vj, gj, dv, dg)


@pytest.mark.parametrize("fault", ["light_travel", "rv", "epoch_pairing"])
def test_planted_absolute_visual_fault_fails_the_comparison(fault):
    """The AbsoluteVisual relative-astrometry model (each chain with its
    own parallax, proper motion and radial velocity, so each its own
    emission epochs) passes the comparison, and fails it with each
    planted fault."""
    mj, mt = _models(chip_smoke.ABSOLUTE)
    pts = mt.starting_points
    vj, gj = jax_ln_post_and_grad(mj, pts)
    dv, dg = chip_smoke.ulp_sensitivity(mt.ln_post_and_grad, pts)
    hold_against_jax(mt, pts, vj, gj, dv, dg)
    with planted_fault(fault), pytest.raises(AssertionError, match="disagree"):
        hold_against_jax(mt, pts, vj, gj, dv, dg)


def test_absolute_visual_laplace_hessian_matches_jax():
    """The Laplace step's `torch.func.hessian` runs through the composed
    AbsoluteVisual solve (`kepler_solver`'s jvp and vmap rules with a chain
    axis of 1) and matches `jax.hessian` of the JAX model."""
    mj, mt = _models(chip_smoke.ABSOLUTE)
    x = np.asarray(mj.link(mj.sample_priors(jax.random.PRNGKey(9))))
    H_t = torch.func.hessian(lambda th: mt.ln_post(th[None, :], fused=False)[0])(
        torch.as_tensor(x)).numpy()
    H_j = np.asarray(jax.jit(jax.hessian(mj.ln_post))(jnp.asarray(x)))
    assert np.max(np.abs(H_t - H_j)) <= 1e-7 * max(np.abs(H_j).max(), 1.0)
    sigma, _ = laplace(mt, x)
    assert np.all(np.isfinite(sigma))
