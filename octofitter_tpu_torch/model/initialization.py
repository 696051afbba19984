"""Model initialization: starting points and posterior mode finding.

PyTorch port of `octofitter_tpu/model/initialization.py`. Four stages:

  1. a batched prior search (tens of thousands of IID draws scored in
     one call);
  2. a multistart Adam ascent in unconstrained space: one
     `torch.optim.Adam` over the (n_multistart, D) tensor of starts. Adam
     is elementwise, so this is n_multistart independent optimizations;
     `CosineAnnealingLR(eta_min=0.1*0.01)` matches the JAX package's
     `optax.cosine_decay_schedule(0.1, n, alpha=0.01)`; its gradients
     come through the fused orbit solve;
  3. a host-side scipy L-BFGS-B polish of the best candidate behind a
     torch value-and-grad;
  4. a Laplace approximation at the mode (`torch.func.hessian` of the
     composed `ln_post`, since the fused orbit solve has first
     derivatives only; the eigenvalues are clipped positive): draws from
     N(mode, H^{-1}) become the starting points and H^{-1} seeds the dense
     metric.
"""

from __future__ import annotations

import numpy as np
import torch


def _multistart_adam(model, starts, n_opt_steps):
    """Maximize ln_post from every row of `starts`; return each row's best
    point and its log posterior. Non-finite gradients are zeroed and
    non-finite updates dropped, as in the JAX package."""
    theta = starts.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=0.1)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(
        opt, T_max=n_opt_steps, eta_min=0.1 * 0.01
    )
    best_theta = starts.detach().clone()
    best_lp = torch.full(starts.shape[:1], -torch.inf, dtype=starts.dtype, device=starts.device)
    for _ in range(n_opt_steps):
        lp = model.ln_post(theta)
        (g,) = torch.autograd.grad(-lp.sum(), theta)
        with torch.no_grad():
            lp = lp.detach()
            better = torch.isfinite(lp) & (lp > best_lp)
            best_theta = torch.where(better[:, None], theta, best_theta)
            best_lp = torch.where(better, lp, best_lp)
            theta_old = theta.detach().clone()
            theta.grad = torch.where(torch.isfinite(g), g, 0.0)
            opt.step()
            theta.copy_(torch.where(torch.isfinite(theta), theta, theta_old))
        sched.step()
    return best_theta, best_lp


def laplace(model, theta_star):
    """H^{-1} of -ln_post at `theta_star` (a (D,) float64 numpy array), and
    its square root L (sigma = L L^T), with the Hessian's eigenvalues
    clipped positive. Both are float64 numpy arrays."""
    # evaluated with a chain axis of 1: under forward-mode AD a 0-d
    # parameter combined with a Python scalar promotes a float32 tangent
    # to float64, which then clashes with the float32 primal
    H = torch.func.hessian(lambda th: -model.ln_post(th[None, :], fused=False)[0])(
        model.tensor(theta_star))
    H = H.detach().cpu().numpy().astype(np.float64)
    H = 0.5 * (H + H.T)
    evals, evecs = np.linalg.eigh(H)
    floor = max(1e-8, np.abs(evals).max() * 1e-10)
    evals = np.clip(evals, floor, None)
    sigma = (evecs / evals) @ evecs.T  # H^{-1}
    return sigma, evecs @ np.diag(1.0 / np.sqrt(evals))


def initialize(
    model,
    generator: torch.Generator | None = None,
    *,
    guess: dict | None = None,
    n_prior_samples: int | None = None,
    n_multistart: int | None = None,
    n_opt_steps: int | None = None,
    n_draws: int | None = None,
    verbosity: int = 1,
):
    """Find the posterior mode and populate `model.starting_points`.

    Unset sizes resolve from the typed config (OCTOFITTER_INIT_* env
    overrides). guess: optional {flat_parameter_name: natural-space
    value}; every multistart point is pinned to the guessed values
    before optimization.

    Returns the mode (unconstrained space, a tensor on the model's
    device). Sets `model.starting_points` ((n, D) tensor, unconstrained)
    and `model.laplace_sigma` ((D, D) tensor).
    """
    from ..config import get_config

    cfg = get_config()
    n_prior_samples = cfg.init_prior_samples if n_prior_samples is None else n_prior_samples
    n_multistart = cfg.init_multistart if n_multistart is None else n_multistart
    n_opt_steps = cfg.init_opt_steps if n_opt_steps is None else n_opt_steps
    n_draws = cfg.init_draws if n_draws is None else n_draws
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)

    # ---- stage 1: batched prior search ---------------------------------
    n_top = min(n_multistart // 2, 4096)
    top_pts, top_lps = model.prior_search(generator, n_prior_samples, n_top)
    rand_pts = model.link(model.sample_priors(generator, n_multistart - n_top))
    starts = torch.cat([top_pts, rand_pts], dim=0)
    if guess:
        names = list(model.parameter_names)
        unknown = [k for k in guess if k not in names]
        if unknown:
            raise KeyError(
                f"unknown guess parameter(s) {unknown}; valid names: {names}"
            )
        g_idx = torch.as_tensor([names.index(k) for k in guess], device=model.device)
        nat = model.invlink(starts)
        nat[:, g_idx] = model.tensor([float(v) for v in guess.values()])
        starts = model.link(nat)
    if verbosity >= 2:
        print(f"initialize: prior search best logpost {float(top_lps[0]):.2f}")

    # ---- stage 2: multistart Adam ascent --------------------------------
    cand_pts, cand_lps = _multistart_adam(model, starts, n_opt_steps)
    cand_lps = torch.where(torch.isnan(cand_lps), -torch.inf, cand_lps)
    best_i = int(torch.argmax(cand_lps))
    best_lp = float(cand_lps[best_i])
    theta_star = cand_pts[best_i].cpu().numpy().astype(np.float64)
    if verbosity >= 2:
        print(f"initialize: multistart best logpost {best_lp:.2f}")

    # ---- stage 3: host-side L-BFGS polish --------------------------------
    from scipy.optimize import minimize

    def fun(x):
        lp, g = model.ln_post_and_grad(x)
        v = -float(lp)
        g = -g.cpu().numpy().astype(np.float64)
        if not np.isfinite(v):
            return 1e100, np.zeros_like(g)
        return v, np.where(np.isfinite(g), g, 0.0)

    # one point at a time: on the CPU, torch's worker threads and the BLAS
    # threads that scipy's L-BFGS wakes spin against each other (an
    # evaluation of the G23H model took 80 ms so against 13 ms alone)
    threads = torch.get_num_threads()
    if model.device.type == "cpu":
        torch.set_num_threads(1)
    try:
        res = minimize(fun, theta_star, jac=True, method="L-BFGS-B",
                       options=dict(maxiter=500))
    finally:
        torch.set_num_threads(threads)
    if np.isfinite(res.fun) and -res.fun >= best_lp:
        theta_star = res.x
    theta_star_t = model.tensor(theta_star)
    with torch.no_grad():
        lp_star = float(model.ln_post(theta_star_t))
    if verbosity >= 1:
        print(f"initialize: mode logpost {lp_star:.2f}")

    # ---- stage 4: Laplace approximation ----------------------------------
    sigma, L = laplace(model, theta_star)
    z = torch.randn((4 * n_draws, len(theta_star)), generator=generator,
                    dtype=torch.float64, device=generator.device).cpu().numpy()
    draws = theta_star[None, :] + z @ L.T
    with torch.no_grad():
        lps = model.ln_post(draws).cpu().numpy()
    good = np.isfinite(lps) & (lps > lp_star - 200.0)
    draws = draws[good][:n_draws]
    if len(draws) < 10:
        # fall back to the mode itself, slightly jittered
        draws = theta_star[None, :] + 1e-4 * z[:n_draws] @ L.T
    if verbosity >= 2:
        print(f"initialize: kept {len(draws)} Laplace draws as starting points")

    model.starting_points = model.tensor(draws)
    model.laplace_sigma = model.tensor(sigma)
    return theta_star_t


def starting_points_chain(model, generator: torch.Generator | None = None):
    """`model.starting_points` as a 1-chain `Chains` with every derived
    quantity resolved: the init chain the reference's `initialize!`
    returns (`initialization.jl:184-344`), to check data entry before
    sampling. Marginalized discrete variables are drawn per point from
    their conditional (generator: seeded 0 unless given)."""
    from ..chains import Chains, flatten_params_batch
    from ..distributions import categorical

    if model.starting_points is None:
        raise ValueError("run initialize() first")
    draws = model.starting_points
    n = draws.shape[0]
    with torch.no_grad():
        disc = None
        if model.discrete_names:
            if generator is None:
                generator = torch.Generator(device=model.device).manual_seed(0)
            disc = model._disc_combos[categorical(model.discrete_conditional_logits(draws),
                                                  generator)]
        nts = model.arr2nt(model.invlink(draws), disc)
        lp = model.ln_post(draws).cpu().numpy().reshape(1, -1)

    data = {}
    for k, v in flatten_params_batch(nts).items():
        if v.ndim == 0 or v.shape[0] != n:  # a constant: the same for every point
            v = np.broadcast_to(v, (n,) + v.shape)
        v2 = v.reshape(1, n, -1)
        if v.ndim == 1:
            data[k] = v2[..., 0]
        else:
            for j in range(v2.shape[-1]):
                data[f"{k}_{j + 1}"] = v2[..., j]
    return Chains(
        data,
        {"logpost": lp},
        {
            "sampler": "initialize",
            "model_name": model.system.name,
            "parameter_names": model.parameter_names,
        },
    )
