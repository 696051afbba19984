"""The port's fused orbit solve against its composed path and the JAX package.

`orbitsolve(..., fused=True)` goes through the `_OrbitSolve` Function: on
the CPU, where these tests run, its forward is the composed torch code and
its backward is `_orbit_solve_backward_plain`, the line-by-line plain
version of the CUDA backward kernel's hand adjoint. The tests hold that
adjoint against autograd through the composed path and against `jax.vjp`
of the JAX package's `orbitsolve`, in float64 on inputs made with numpy.
The test marked `cuda` holds the kernels against the plain versions on a
GPU:

    python -m pytest --noconftest -q tests/test_torch_orbit_solve.py -m cuda
"""

import math

import numpy as np
import pytest
import torch

import octofitter_tpu_torch as ot
from octofitter_tpu_torch.orbits import elements as E
from octofitter_tpu_torch.orbits.kernels import orbit_solve as osk

FIELDS = ("EA", "nu", "r", "posx", "posy", "posz", "vx", "vy", "vz", "raoff_mas",
          "decoff_mas", "pmra_masyr", "pmdec_masyr", "radvel_ms")
ROWS = ("a", "e", "i", "omega", "Omega", "tp", "M", "plx")
EPOCHS = np.linspace(55000.0, 59500.0, 12)
# one chain per edge: circular, nearly parabolic, an epoch at periastron, face-on
EDGES = {"e=0": ("e", 0.0), "e=0.99": ("e", 0.99), "t=tp": ("tp", EPOCHS[5]), "i=0": ("i", 0.0)}


def _elements(n=24, seed=0):
    """(8, n) elements from the ranges of tests/test_torch_model.py, the
    first four chains carrying the edges."""
    rng = np.random.default_rng(seed)
    els = dict(
        a=rng.uniform(1, 30, n), e=rng.uniform(0, 0.95, n), i=rng.uniform(0.1, 3.0, n),
        omega=rng.uniform(-3, 3, n), Omega=rng.uniform(-3, 3, n),
        tp=rng.uniform(50000, 60000, n), M=rng.uniform(0.5, 2.0, n),
        plx=rng.uniform(10, 100, n),
    )
    for k, (name, value) in enumerate(EDGES.values()):
        els[name][k] = value
    return np.stack([els[name] for name in ROWS])


def _cotangent(shape, seed=1, only=None):
    g = np.random.default_rng(seed).standard_normal(shape)
    if only is not None:
        mask = np.zeros((len(FIELDS), 1, 1))
        mask[FIELDS.index(only)] = 1.0
        g = g * mask
    return g


def _solve(elems, fused, basis="VisualOrbit", epochs=EPOCHS):
    """Fields (14, B, T) and the leaf (8, B) or (7, B) they came from."""
    n_rows = 8 if basis == "VisualOrbit" else 7
    leaf = torch.as_tensor(elems[:n_rows]).clone().requires_grad_(True)
    sol = ot.orbitsolve(getattr(ot.orbits, basis)(*leaf), epochs, fused=fused)
    return [getattr(sol, name) for name in FIELDS], leaf


def _vjp(elems, g, fused, fields=FIELDS, **kw):
    out, leaf = _solve(elems, fused, **kw)
    picked = torch.stack([out[FIELDS.index(name)] for name in fields])
    g = torch.as_tensor(g[[FIELDS.index(name) for name in fields]])
    (grad,) = torch.autograd.grad(picked, leaf, g)
    return grad.numpy()


def _assert_close_rows(got, ref, rtol):
    """Entry by entry, relative to the entry or to its row's median
    magnitude, whichever is larger (a gradient entry is a sum over epochs
    of terms that cancel, so a small entry carries its row's rounding)."""
    scale = np.maximum(np.abs(ref), np.median(np.abs(ref), axis=-1, keepdims=True))
    assert (np.abs(got - ref) <= rtol * scale).all(), np.abs(got - ref).max()


def test_fused_forward_matches_composed():
    # the CPU forward of the Function is the composed code itself: 1e-12
    # of each field's largest magnitude
    elems = _elements()
    fused = [f.detach() for f in _solve(elems, True)[0]]
    composed = [c.detach() for c in _solve(elems, False)[0]]
    for name, f, c in zip(FIELDS, fused, composed):
        assert f.shape == c.shape == (elems.shape[1], len(EPOCHS)), name
        assert float((f - c).abs().max()) <= 1e-12 * float(c.abs().max()), name


@pytest.mark.parametrize("only", [None, *FIELDS], ids=["all", *FIELDS])
def test_backward_plain_matches_autograd(only):
    """The hand adjoint against autograd through the composed path, for a
    random cotangent on all 14 fields and on each field alone: both are
    the same float64 calculus in another order, 1e-10 relative."""
    elems = _elements()
    g = _cotangent((len(FIELDS), elems.shape[1], len(EPOCHS)), only=only)
    _assert_close_rows(_vjp(elems, g, True), _vjp(elems, g, False), 1e-10)


@pytest.fixture(scope="module")
def jax_solution():
    """The JAX package's fields (14, B, T) and its vjp for `_elements()`."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import octofitter_tpu as oc

    def one(vals):
        sol = oc.orbitsolve(oc.orbits.VisualOrbit(**dict(zip(ROWS, vals))), jnp.asarray(EPOCHS))
        return jnp.stack([getattr(sol, name) for name in FIELDS])

    solve = jax.vmap(one, in_axes=1, out_axes=1)
    elems = _elements()
    g = _cotangent((len(FIELDS), elems.shape[1], len(EPOCHS)))
    out, pullback = jax.vjp(jax.jit(solve), jnp.asarray(elems))
    return elems, g, np.asarray(out), np.asarray(pullback(jnp.asarray(g))[0])


def test_fused_fields_match_jax(jax_solution):
    # 1e-10 of each field's largest magnitude (measured near 1e-15)
    elems, _, out_j, _ = jax_solution
    fused, _ = _solve(elems, True)
    for name, f, ref in zip(FIELDS, fused, out_j):
        assert np.abs(f.detach().numpy() - ref).max() <= 1e-10 * np.abs(ref).max(), name


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
def test_vjp_matches_jax(jax_solution, fused):
    elems, g, _, grad_j = jax_solution
    _assert_close_rows(_vjp(elems, g, fused), grad_j, 1e-10)


@pytest.mark.parametrize("edge", list(EDGES))
def test_edges(edge):
    """One chain at each edge: finite fields and gradients, the fused path
    equal to the composed one. At e = 0 the derivative of sqrt(1 - e^2) is
    0, and atan2's singular point X = Y = 0 needs e = 1, so it is not
    reached at E = 0 or pi either."""
    k = list(EDGES).index(edge)
    elems = _elements()[:, k:k + 1]
    g = _cotangent((len(FIELDS), 1, len(EPOCHS)), seed=2)
    fused = [f.detach() for f in _solve(elems, True)[0]]
    composed = [c.detach() for c in _solve(elems, False)[0]]
    for name, f, c in zip(FIELDS, fused, composed):
        assert torch.isfinite(f).all(), name
        assert float((f - c).abs().max()) <= 1e-12 * max(float(c.abs().max()), 1.0), name
    got, ref = _vjp(elems, g, True), _vjp(elems, g, False)
    assert np.isfinite(got).all()
    assert (np.abs(got - ref) <= 1e-10 * np.maximum(np.abs(ref), 1.0)).all()


def test_keporbit_keeps_nan_sky_fields():
    """A KepOrbit has no parallax: the four sky fields are NaN on both
    paths, the others are not, and their gradient (the fused backward
    leaves the sky fields out) equals the composed path's."""
    elems = _elements()
    sky = ("raoff_mas", "decoff_mas", "pmra_masyr", "pmdec_masyr")
    rest = tuple(name for name in FIELDS if name not in sky)
    for fused in (True, False):
        out, _ = _solve(elems, fused, basis="KepOrbit")
        for name, f in zip(FIELDS, out):
            assert bool(torch.isnan(f).all()) == (name in sky), (fused, name)
    g = _cotangent((len(FIELDS), elems.shape[1], len(EPOCHS)), seed=3)
    got = _vjp(elems, g, True, fields=rest, basis="KepOrbit")
    assert got.shape == (7, elems.shape[1]) and np.isfinite(got).all()
    _assert_close_rows(got, _vjp(elems, g, False, fields=rest, basis="KepOrbit"), 1e-10)


def test_broadcast_and_epoch_shapes():
    """0-d elements beside per-chain ones and a 2-d epoch array: the fused
    path broadcasts and reshapes as the composed one does."""
    elems = _elements(5)
    epochs = EPOCHS.reshape(3, 4)
    kw = {name: torch.as_tensor(row) for name, row in zip(ROWS, elems)}
    kw["M"], kw["plx"] = torch.tensor(1.2, dtype=torch.float64), torch.tensor(50.0, dtype=torch.float64)
    fused = ot.orbitsolve(ot.VisualOrbit(**kw), epochs, fused=True)
    composed = ot.orbitsolve(ot.VisualOrbit(**kw), epochs, fused=False)
    assert fused.raoff_mas.shape == composed.raoff_mas.shape == (5, 3, 4)
    np.testing.assert_allclose(fused.raoff_mas.numpy(), composed.raoff_mas.numpy(), rtol=0, atol=1e-9)
    one = ot.orbitsolve(ot.VisualOrbit.from_params(**{n: float(r[0]) for n, r in zip(ROWS, elems)},
                                                   device="cpu"),
                        EPOCHS, fused=True)
    assert one.raoff_mas.shape == (12,)


def test_second_derivative_through_fused_raises():
    elems = _elements(4)
    out, leaf = _solve(elems, True)
    (grad,) = torch.autograd.grad(out[9].sum(), leaf, create_graph=True)
    # the backward runs without a graph, so nothing is left to differentiate
    with pytest.raises(RuntimeError, match="does not require grad"):
        torch.autograd.grad(grad.sum(), leaf)

    def raoff_sum(x):
        return ot.orbitsolve(ot.VisualOrbit(*x), EPOCHS, fused=True).raoff_mas.sum()

    with pytest.raises(RuntimeError):
        torch.func.hessian(raoff_sum)(torch.as_tensor(elems[:, 0]))
    # the composed path has second derivatives
    H = torch.func.hessian(
        lambda x: ot.orbitsolve(ot.VisualOrbit(*x), EPOCHS, fused=False).raoff_mas.sum()
    )(torch.as_tensor(elems[:, 0]))
    assert H.shape == (8, 8) and torch.isfinite(H).all()


def test_fused_rejects_epoch_gradients_and_other_devices():
    elems = torch.as_tensor(_elements(4))
    t = torch.as_tensor(EPOCHS).requires_grad_(True)
    with pytest.raises(ValueError, match="epochs"):
        ot.orbitsolve(ot.VisualOrbit(*elems), t, fused=True)
    with pytest.raises(ValueError, match="CUDA"):
        osk.orbit_solve_forward_cuda(elems, torch.as_tensor(EPOCHS))
    with pytest.raises(ValueError, match="CUDA"):
        osk.orbit_solve_backward_cuda(elems, torch.as_tensor(EPOCHS), elems, elems, True)
    meta = torch.zeros((8, 4), device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="no fused kernel for device"):
        E._OrbitSolve.apply(meta, torch.zeros(4, device="meta", dtype=torch.float64), True)


@pytest.fixture(scope="module")
def bench_model():
    from test_torch_model import bench_table, build_bench

    model = build_bench(ot, bench_table(), device="cpu")
    theta = model.link(model.sample_priors(torch.Generator().manual_seed(7), 16))
    return model, theta


def test_ln_post_and_grad_fused_matches_composed(bench_model):
    """The headline model's batched value and gradient through the fused
    Function (what `ln_post_and_grad` runs) and through the composed path:
    1e-10 relative, gradients relative to each draw's largest entry."""
    model, theta = bench_model
    lp_f, g_f = model.ln_post_and_grad(theta)
    th = theta.detach().requires_grad_(True)
    lp_c = model.ln_post(th, fused=False)
    (g_c,) = torch.autograd.grad(lp_c.sum(), th)
    assert torch.isfinite(lp_f).all()
    np.testing.assert_allclose(lp_f.numpy(), lp_c.detach().numpy(), rtol=1e-10, atol=0)
    scale = g_c.abs().amax(dim=1, keepdim=True)
    assert bool(((g_f - g_c).abs() <= 1e-10 * scale).all())
    with torch.no_grad():
        np.testing.assert_allclose(model.ln_post(theta).numpy(), lp_f.numpy(),
                                   rtol=0, atol=0)


def test_hessian_of_ln_post_takes_the_composed_path(bench_model):
    """`torch.func.hessian` of `ln_post(..., fused=False)` works as before,
    the default fused path under it raises, and the Hessian's rows are the derivative of the fused gradient: central
    differences at step 1e-5 agree to 1e-6 of the largest entry."""
    model, theta = bench_model
    x = theta[0]
    H = torch.func.hessian(lambda th: model.ln_post(th[None, :], fused=False)[0])(x)
    assert H.shape == (model.D, model.D) and torch.isfinite(H).all()
    with pytest.raises(RuntimeError):
        torch.func.hessian(lambda th: model.ln_post(th[None, :])[0])(x)
    h = 1e-5
    steps = torch.eye(model.D, dtype=torch.float64) * h
    _, g = model.ln_post_and_grad(torch.cat([x + steps, x - steps]))
    H_fd = (g[: model.D] - g[model.D:]) / (2 * h)
    H_fd = 0.5 * (H_fd + H_fd.T)
    assert float((H - H_fd).abs().max()) <= 1e-6 * float(H.abs().max())


@pytest.mark.cuda
def test_kernels_match_plain_on_gpu():
    """Both kernels against their plain versions on the card in float64
    (1e-10 of each field's and each row's largest magnitude), through
    `orbitsolve` so that the launch counters are checked too; the backward
    twice, bitwise equal. The shapes reach the packed and the
    element-by-element forward, and backward groups of 1, 8, 16 and 32
    lanes, the last with more epochs than lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for n_chains, n_epochs in ((64, 12), (7, 5), (4, 1), (5, 70)):
        elems = _elements(n_chains)
        epochs = np.linspace(55000.0, 59500.0, n_epochs)
        g = torch.as_tensor(_cotangent((len(FIELDS), n_chains, n_epochs)), device="cuda")
        results = {}
        for fused in (True, False):
            leaf = torch.as_tensor(elems, device="cuda").requires_grad_(True)
            before = (osk.launches_fwd, osk.launches_bwd)
            sol = ot.orbitsolve(ot.VisualOrbit(*leaf), epochs, fused=fused)
            out = torch.stack([getattr(sol, name) for name in FIELDS])
            (grad,) = torch.autograd.grad(out, leaf, g, retain_graph=True)
            (again,) = torch.autograd.grad(out, leaf, g)
            torch.cuda.synchronize()
            assert torch.equal(grad, again)
            n_launched = (osk.launches_fwd - before[0], osk.launches_bwd - before[1])
            assert n_launched == ((1, 2) if fused else (0, 0))
            results[fused] = (out.detach(), grad)
        (out_f, g_f), (out_c, g_c) = results[True], results[False]
        for k, name in enumerate(FIELDS):
            err = (out_f[k] - out_c[k]).abs()
            if name == "nu":  # an angle: compare modulo 2 pi
                err = (torch.remainder(err + math.pi, 2 * math.pi) - math.pi).abs()
            assert float(err.max()) <= 1e-10 * float(out_c[k].abs().max()), (n_epochs, name)
        assert bool(((g_f - g_c).abs().amax(dim=1) <= 1e-10 * g_c.abs().amax(dim=1)).all()), n_epochs


@pytest.mark.cuda
@pytest.mark.parametrize("n_chains, n_epochs", [(1024, 6), (150, 12), (65536, 12), (16, 70)])
def test_forward_without_grad_at_evidence_shapes_on_gpu(n_chains, n_epochs):
    """The shapes nested sampling's walkers ((1024, 6), (150, 12)),
    `pointwise_like`'s chunks ((65536, 12)) and the completeness fits
    ((16, 70)) give the fused forward, under `no_grad` as those paths run
    it: one forward launch, no backward, every field within 1e-10 of its
    largest magnitude of the composed path in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    elems = torch.as_tensor(_elements(n_chains, seed=n_chains), device="cuda")
    epochs = np.linspace(56000.0, 58000.0, n_epochs)
    with torch.no_grad():
        before = (osk.launches_fwd, osk.launches_bwd)
        sol_f = ot.orbitsolve(ot.VisualOrbit(*elems), epochs)
        torch.cuda.synchronize()
        assert (osk.launches_fwd - before[0], osk.launches_bwd - before[1]) == (1, 0)
        sol_c = ot.orbitsolve(ot.VisualOrbit(*elems), epochs, fused=False)
    for name in FIELDS:
        err = (getattr(sol_f, name) - getattr(sol_c, name)).abs()
        if name == "nu":  # an angle: compare modulo 2 pi
            err = (torch.remainder(err + math.pi, 2 * math.pi) - math.pi).abs()
        assert float(err.max()) <= 1e-10 * float(getattr(sol_c, name).abs().max()), name
