"""The port's Kepler solve against the JAX package, and import hygiene.

Inputs are made with numpy (fixed seeds) and handed to both packages;
everything runs in float64 on the CPU, where the port's `kepler_solver`
runs the kernel's plain twin. JAX is imported inside the fixture, so
this file also imports on a machine without JAX, where only the test
marked `cuda` (kernel vs twin on the GPU) is meant to run:

    python -m pytest --noconftest -q tests/test_torch_kepler.py -m cuda
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from octofitter_tpu_torch.orbits import kepler_solver, kepler_solver_hyperbolic
from octofitter_tpu_torch.orbits.kepler import _markley
from octofitter_tpu_torch.orbits.kernels.kepler import kepler_solve_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# M = 0, +-pi, +-2pi, small and |M| >> 2 pi, at e = 0, 0.5, 0.99
EDGE_M = np.array([0.0, np.pi, -np.pi, 2 * np.pi, -2 * np.pi, 1e-9, 100.0,
                   -100.0, 1000.0, -1000.0, 999.0 * np.pi])
EDGE_E = np.array([0.0, 0.5, 0.99])


@pytest.fixture(scope="module")
def jref():
    """The JAX package's solvers (float64, CPU, as tests/conftest.py sets).
    The elliptic solver is jitted: run eagerly, JAX compiles each of its
    ops anew for every input shape."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from octofitter_tpu.orbits import kepler_solver as jk
    from octofitter_tpu.orbits import kepler_solver_hyperbolic as jkh
    from octofitter_tpu.orbits.pallas_kepler import kepler_solver_pallas

    assert jax.config.jax_enable_x64
    return types.SimpleNamespace(jax=jax, jnp=jnp, kepler=jax.jit(jk), hyperbolic=jkh,
                                 pallas=kepler_solver_pallas)


def _edges():
    gM, ge = np.meshgrid(EDGE_M, EDGE_E, indexing="ij")
    return gM.ravel(), ge.ravel()


@pytest.mark.parametrize("e", [0.0, 0.1, 0.5, 0.9, 0.99, 0.999])
def test_kepler_matches_jnp_dense_grid(jref, e):
    # the grid of tests/test_kepler.py; both solvers run the same float64
    # arithmetic, so they agree to a few ulps: 1e-12 absolute
    M = np.linspace(-20, 20, 2001)
    E_ref = np.asarray(jref.kepler(jref.jnp.asarray(M), jref.jnp.full_like(M, e)))
    E = kepler_solver(torch.as_tensor(M), torch.full((M.size,), e, dtype=torch.float64))
    np.testing.assert_allclose(E.numpy(), E_ref, rtol=0, atol=1e-12)


def test_kepler_matches_jnp_edges(jref):
    # 1e-12 absolute, as above; |M| <= 1000 keeps an ulp of E below 2e-13
    M, e = _edges()
    E_ref = np.asarray(jref.kepler(jref.jnp.asarray(M), jref.jnp.asarray(e)))
    E = kepler_solver(torch.as_tensor(M), torch.as_tensor(e)).numpy()
    np.testing.assert_allclose(E, E_ref, rtol=0, atol=1e-12)
    resid = E - e * np.sin(E) - M
    assert np.abs(resid).max() < 1e-12


def test_kepler_matches_pallas_kernel_interpret(jref):
    """Directly against the TPU kernel, run by the Pallas interpreter as
    tests/test_kepler.py runs it; 5e-7 is that test's bound."""
    rng = np.random.default_rng(0)
    M = np.concatenate([rng.uniform(-10, 10, 1000), _edges()[0]])
    e = np.concatenate([rng.uniform(0.0, 0.95, 1000), _edges()[1]])
    E_pl = np.asarray(jref.pallas(jref.jnp.asarray(M), jref.jnp.asarray(e)))
    E = kepler_solver(torch.as_tensor(M), torch.as_tensor(e)).numpy()
    np.testing.assert_allclose(E, E_pl, rtol=0, atol=5e-7)


def test_kepler_broadcasts_like_jnp(jref):
    rng = np.random.default_rng(1)
    M = rng.uniform(-30, 30, (7, 12))
    e = rng.uniform(0.0, 0.99, (7, 1))
    E_ref = np.asarray(jref.kepler(jref.jnp.asarray(M), jref.jnp.asarray(e)))
    E = kepler_solver(torch.as_tensor(M), torch.as_tensor(e))
    assert E.shape == (7, 12)
    np.testing.assert_allclose(E.numpy(), E_ref, rtol=0, atol=1e-12)


def test_kepler_gradients_match_jax(jref):
    """Implicit-derivative backward vs jax.grad of the custom-JVP solver;
    both evaluate the same closed form at the same E: 1e-10 absolute."""
    jax, jnp = jref.jax, jref.jnp
    rng = np.random.default_rng(2)
    M = np.concatenate([rng.uniform(-20, 20, 200), _edges()[0]])
    e = np.concatenate([rng.uniform(0.0, 0.99, 200), _edges()[1]])
    gM_ref, ge_ref = jax.jit(jax.vmap(jax.grad(jref.kepler, argnums=(0, 1))))(
        jnp.asarray(M), jnp.asarray(e)
    )
    Mt = torch.as_tensor(M).requires_grad_(True)
    et = torch.as_tensor(e).requires_grad_(True)
    gM, ge = torch.autograd.grad(kepler_solver(Mt, et).sum(), (Mt, et))
    np.testing.assert_allclose(gM.numpy(), np.asarray(gM_ref), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ge.numpy(), np.asarray(ge_ref), rtol=0, atol=1e-10)


def test_kepler_gradcheck():
    """Backward and double backward (the Laplace Hessian needs both)
    against finite differences."""
    rng = np.random.default_rng(3)
    M = torch.as_tensor(rng.uniform(-8, 8, 12)).requires_grad_(True)
    e = torch.as_tensor(rng.uniform(0.05, 0.9, 12)).requires_grad_(True)
    assert torch.autograd.gradcheck(kepler_solver, (M, e))
    assert torch.autograd.gradgradcheck(kepler_solver, (M, e))


def test_kepler_forward_mode_and_vmap():
    """The jvp and vmap rules that torch.func.hessian uses agree with the
    reverse-mode Jacobian."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(np.concatenate([rng.uniform(-8, 8, 5), rng.uniform(0, 0.9, 5)]))
    f = lambda v: kepler_solver(v[:5], v[5:])  # noqa: E731
    J_fwd = torch.func.jacfwd(f)(x)
    J_rev = torch.func.jacrev(f)(x)
    np.testing.assert_allclose(J_fwd.numpy(), J_rev.numpy(), rtol=0, atol=1e-13)
    batched = torch.func.vmap(f)(torch.stack([x, x.flip(0) * 0.5]))
    np.testing.assert_allclose(batched[0].numpy(), f(x).numpy(), rtol=0, atol=0)


def test_hyperbolic_matches_jax(jref):
    # 30 Newton steps in both packages: 1e-10 absolute on H and its gradient
    jax, jnp = jref.jax, jref.jnp
    M = np.linspace(-10, 10, 101)
    solve = jax.jit(jref.hyperbolic)
    grad = jax.jit(jax.vmap(jax.grad(jref.hyperbolic)))
    for e in (1.1, 2.0, 5.0):
        H_ref = np.asarray(solve(jnp.asarray(M), jnp.full_like(M, e)))
        Mt = torch.as_tensor(M).requires_grad_(True)
        H = kepler_solver_hyperbolic(Mt, torch.full((M.size,), e, dtype=torch.float64))
        np.testing.assert_allclose(H.detach().numpy(), H_ref, rtol=0, atol=1e-10)
        (gM,) = torch.autograd.grad(H.sum(), Mt)
        gM_ref = grad(jnp.asarray(M), jnp.full_like(M, e))
        np.testing.assert_allclose(gM.numpy(), np.asarray(gM_ref), rtol=0, atol=1e-10)


def test_port_imports_without_jax():
    code = (
        "import octofitter_tpu_torch, sys; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]; "
        "assert not bad, bad; "
        "assert not any(m == 'octofitter_tpu' or m.startswith('octofitter_tpu.') "
        "for m in sys.modules)"
    )
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO if not path else REPO + os.pathsep + path)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_request_without_gpu_raises():
    """A GPU that is asked for and missing is an error, never a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    import octofitter_tpu_torch as ot

    system = ot.System(name="s", variables=dict(M=ot.distributions.Normal(1.0, 0.1)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ot.LogDensityModel(system, verbosity=0, device="cuda")


def test_kernel_wrapper_has_no_cpu_path():
    M = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        kepler_solve_cuda(M, M)
    with pytest.raises(ValueError, match="no kernel for device"):
        kepler_solver(torch.zeros(3, device="meta"), torch.zeros(3, device="meta"))


@pytest.mark.cuda
def test_kernel_matches_twin_on_gpu():
    """The CUDA kernel against its plain twin on the card; tolerances as in
    chip_smoke.py (absolute on E, growing with |M|/50 past |M| = 50)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from octofitter_tpu_torch.orbits.kernels import kepler as kk

    rng = np.random.default_rng(0)
    M = np.concatenate([rng.uniform(-50, 50, 100_000), _edges()[0]])
    e = np.concatenate([rng.uniform(0.0, 0.99, 100_000), _edges()[1]])
    scale = np.maximum(np.abs(M) / 50.0, 1.0)
    for dtype, tol in ((torch.float32, 5e-6), (torch.float64, 1e-12)):
        Mt = torch.as_tensor(M, dtype=dtype, device="cuda")
        et = torch.as_tensor(e, dtype=dtype, device="cuda")
        before = kk.launches
        E_k = kepler_solver(Mt, et)
        assert kk.launches == before + 1
        E_t = _markley(Mt, et)
        torch.cuda.synchronize()
        err = (E_k.double() - E_t.double()).abs().cpu().numpy() / scale
        assert err.max() <= tol, (dtype, err.max())
        # a view that starts one element in is not 16-byte aligned: the
        # kernel then goes element by element, to the same bits
        E_off = kepler_solver(Mt[1:], et[1:])
        torch.cuda.synchronize()
        assert torch.equal(E_off, E_k[1:])
        # the Laplace step's call: a (1, 12) mean anomaly and one
        # eccentricity expanded over the epochs, made contiguous on the way
        E_row = kepler_solver(Mt[:12][None, :], et[:1, None])
        assert kk.launch_shapes.get((1, 12), 0) >= 1
        assert torch.equal(E_row[0], kepler_solver(Mt[:12], et[:1].repeat(12)))
        assert float((E_row - _markley(Mt[:12][None, :], et[:1, None])).abs().max()) <= tol


@pytest.mark.cuda
def test_kernel_matches_twin_at_the_absolute_visual_shape():
    """The AbsoluteVisual{KepOrbit} solve on the card (the Hipparcos path's
    4096 chains x 134 epochs, float64): each chain's emission epochs (C, T)
    and its eccentricity expanded over them reach the kernel in one launch,
    whose E is held to the plain twin at those inputs (1e-12, growing with
    |M|/50 past |M| = 50, as in chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import octofitter_tpu_torch as ot
    from octofitter_tpu_torch.orbits.kernels import kepler as kk

    C, T = 4096, 134
    rng = np.random.default_rng(3)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64, device="cuda")  # noqa: E731
    elem = ot.AbsoluteVisualOrbit(
        a=as_t(rng.uniform(2.0, 30.0, C)), e=as_t(rng.uniform(0.0, 0.99, C)),
        i=as_t(rng.uniform(0.0, np.pi, C)), omega=as_t(rng.uniform(0, 2 * np.pi, C)),
        Omega=as_t(rng.uniform(0, 2 * np.pi, C)), tp=as_t(rng.uniform(47000, 58000, C)),
        M=as_t(rng.uniform(0.5, 2.0, C)), plx=as_t(rng.uniform(10.0, 100.0, C)),
        ra=as_t(68.0), dec=as_t(-51.0), rv=as_t(rng.uniform(-3e4, 3e4, C)),
        pmra=as_t(rng.uniform(-100, 100, C)), pmdec=as_t(rng.uniform(-100, 100, C)),
        ref_epoch=as_t(48348.5625))
    epochs = np.sort(rng.uniform(47500.0, 58500.0, T))
    before = kk.launches
    sol = ot.orbitsolve(elem, epochs)
    torch.cuda.synchronize()
    assert kk.launches == before + 1 and kk.launch_shapes.get((C, T), 0) >= 1
    t_em = sol.compensated.t_em_days
    n = 2 * np.pi / (torch.sqrt(elem.a**3 / elem.M) * ot.constants.KEPLER_YEAR_DAYS)
    MA = n[:, None] * (t_em - elem.tp[:, None])
    E_t = _markley(MA, elem.e[:, None].expand(C, T))
    scale = (MA.abs() / 50.0).clamp(min=1.0)
    assert float(((sol.EA - E_t).abs() / scale).max()) <= 1e-12
