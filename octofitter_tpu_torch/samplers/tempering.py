"""Non-reversible parallel tempering.

PyTorch port of `octofitter_tpu/samplers/tempering.py`: deterministic
even/odd (DEO) replica exchange between a prior reference and the
posterior target, with an optional variational leg whose Gaussian
reference is moment-matched to the target, round-based schedule
adaptation from swap rejection rates (Syed et al. 2021), round-trip
accounting, stepping-stone log-evidence and round checkpoints.

The whole ladder is one batch: states are (n_walkers, n_rungs, D) on the
model's device, and the explorer steps all W * NT chains at once, each
rung with its own step size, diagonal metric and (for ChEES) trajectory
length; the NUTS explorer grows every chain's tree in one lockstep batch.
A sweep reads one small array from the device, the rungs' mean
acceptance and ChEES gradients, from which the host adapts the step sizes
and trajectory lengths (elementwise dual averaging and Adam over the
rungs) and sets the next sweep's leapfrog counts. Swap statistics, metric
moments and round-trip counts stay on the device until a round ends.

Annealed density of a rung, in unconstrained space, a combination of the
components (ln_prior_t, ln_like, log q) with per-rung coefficients:
    fixed leg          (1, beta, 0)           prior ... target
    variational leg    (beta, beta, 1 - beta) target ... N(q_mean, q_std)
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from ..chains import Chains, flatten_params_batch
from .chees import AdamState, _adam_step, _chees_transition_rungs, halton_sequence
from .hmc import hmc_step
from .nuts import DualAveragingState, chain_metric, da_init, da_update, nuts_step
from .shard import Shard

# rows per batch of the final pass that turns recorded draws into Chains
_POST_CHUNK = 2**17


def apply_deo_swap(theta, ll, accept_swap, labels=None):
    """Apply one deterministic-even-odd swap pass to the ladder.

    theta (W, NT, D), ll (W, NT); accept_swap is the per-pair accept mask
    (W, NT - 1). Each rung takes its right neighbour (its own pair
    accepted), else its left neighbour (the previous pair accepted), else
    stays: a gather along the rung axis. Returns (theta, ll, idx) with idx
    the applied index map; with a replica-label array, (theta, ll, idx,
    labels), the labels carried the same way."""
    W, NT = ll.shape
    pad = torch.zeros((W, 1), dtype=torch.bool, device=ll.device)
    swap_right = torch.cat([accept_swap, pad], dim=1)  # pair j
    swap_left = torch.cat([pad, accept_swap], dim=1)   # pair j - 1
    base = torch.arange(NT, device=ll.device).expand(W, NT)
    idx = torch.where(swap_right, base + 1, torch.where(swap_left, base - 1, base))
    theta = torch.gather(theta, 1, idx[:, :, None].expand_as(theta))
    ll = torch.gather(ll, 1, idx)
    if labels is None:
        return theta, ll, idx
    return theta, ll, idx, torch.gather(labels, 1, idx)


def _gauss_logpdf(theta_t, q_mean, q_log_std):
    """log N(theta_t; q_mean, diag(exp(q_log_std))^2): (..., D) -> (...)."""
    z = (theta_t - q_mean) * torch.exp(-q_log_std)
    return (
        -0.5 * torch.sum(z * z, dim=-1)
        - torch.sum(q_log_std)
        - 0.5 * theta_t.shape[-1] * math.log(2 * math.pi)
    )


def _make_annealed_vg(model):
    """Value, log-likelihood and gradient of the per-rung annealed density.

    vg(theta_t (C, D), coeffs (C, 3), q_mean (D,), q_log_std (D,)) ->
    (value (C,), ll (C,), grad (C, D)), one autograd pass over the batch.
    A row whose coefficient of a component is 0 gets no term from it, and
    no gradient either: the component is evaluated there on a detached
    copy of the row, so a non-finite component (ll = -inf on the prior
    rung) cannot send 0 * NaN back into the row's gradient."""

    def vg(theta_t, coeffs, q_mean, q_log_std):
        theta_t = model.tensor(theta_t).detach().requires_grad_(True)
        use = coeffs != 0
        with torch.enable_grad():
            def row_input(k):
                return torch.where(use[:, k, None], theta_t, theta_t.detach())

            lp_prior = model.ln_prior_transformed(row_input(0))
            ll = model.ln_like_nt(model.arr2nt(model.invlink(row_input(1))))
            ll = torch.where(torch.isfinite(ll), ll, -torch.inf)
            lq = _gauss_logpdf(row_input(2), q_mean, q_log_std)
            value = (torch.where(use[:, 0], coeffs[:, 0] * lp_prior, 0.0)
                     + torch.where(use[:, 1], coeffs[:, 1] * ll, 0.0)
                     + torch.where(use[:, 2], coeffs[:, 2] * lq, 0.0))
            (grad,) = torch.autograd.grad(value.sum(), theta_t)
        return value.detach(), ll.detach(), grad

    return vg


def _components(model, theta_t, q_mean, q_log_std):
    """Per-row density components (ln_prior_t, ll, log q): (C, D) -> (C, 3)."""
    with torch.no_grad():
        lp = model.ln_prior_transformed(theta_t)
        ll = model.ln_like_nt(model.arr2nt(model.invlink(theta_t)))
        ll = torch.where(torch.isnan(ll), -torch.inf, ll)
        lq = _gauss_logpdf(theta_t, q_mean, q_log_std)
    return torch.stack([lp, ll, lq], dim=-1)


def _rung_coeffs(betas_fix, betas_var, q_active: bool):
    """(N_tot, 3) density coefficients over (ln_prior, ll, log q)."""
    bf = np.asarray(betas_fix)
    c_fix = np.stack([np.ones_like(bf), bf, np.zeros_like(bf)], axis=-1)
    bv = np.asarray(betas_var)
    if bv.size == 0:
        return c_fix
    if q_active:
        c_var = np.stack([bv, bv, 1.0 - bv], axis=-1)
    else:
        # before the first tuning round the variational leg anneals to
        # the prior too (mirror of the fixed leg)
        c_var = np.stack([np.ones_like(bv), bv, np.zeros_like(bv)], axis=-1)
    return np.concatenate([c_fix, c_var], axis=0)


def _pt_save_checkpoint(path, state: dict):
    """Round-boundary checkpoint of every loop-carried quantity, so that a
    resumed run is bit-identical to an uninterrupted one. The keys are the
    JAX package's, with the torch generator's state (`generator_state`)
    where it saves its key."""
    np.savez(
        path,
        theta=state["theta"].cpu().numpy(),
        betas=np.asarray(state["betas"]),
        betas_var=np.asarray(state["betas_var"]),
        eps=np.exp(state["da"].log_eps),
        sigma_diag=np.asarray(state["sigma_diag"]),
        labels=np.asarray(state["labels"]),
        direction=np.asarray(state["direction"]),
        n_round_trips=state["n_round_trips"],
        sweep_counter=state["sweep_counter"],
        next_round=state["next_round"],
        da=np.stack([np.asarray(leaf, dtype=float) for leaf in state["da"]], axis=1),
        log_T=np.asarray(state["log_T"]),
        adam=np.stack([np.asarray(leaf, dtype=float) for leaf in state["adam"]], axis=1),
        q_mean=np.asarray(state["q_mean"]),
        q_log_std=np.asarray(state["q_log_std"]),
        q_active=bool(state["q_active"]),
        generator_state=state["generator"].get_state().numpy(),
    )


def pt_state_from_npz(z) -> dict:
    """The resume state held in a loaded checkpoint (`np.load` of a file of
    either package): every key but the random state, as numpy arrays and
    host numbers."""
    da_arr = np.asarray(z["da"], dtype=np.float64)     # (NT, 5)
    adam_arr = np.asarray(z["adam"], dtype=np.float64)  # (NT, 3)
    return dict(
        theta=np.asarray(z["theta"]),
        betas=np.asarray(z["betas"], dtype=np.float64),
        betas_var=np.asarray(z["betas_var"], dtype=np.float64),
        sigma_diag=np.asarray(z["sigma_diag"], dtype=np.float64),
        labels=np.asarray(z["labels"]),
        direction=np.asarray(z["direction"]),
        n_round_trips=int(z["n_round_trips"]),
        sweep_counter=int(z["sweep_counter"]),
        next_round=int(z["next_round"]),
        da=DualAveragingState(*(da_arr[:, i].copy() for i in range(5))),
        log_T=np.asarray(z["log_T"], dtype=np.float64),
        adam=AdamState(*(adam_arr[:, i].copy() for i in range(3))),
        q_mean=np.asarray(z["q_mean"], dtype=np.float64),
        q_log_std=np.asarray(z["q_log_std"], dtype=np.float64),
        q_active=bool(z["q_active"]),
    )


def _pt_load_checkpoint(path) -> dict:
    with np.load(path) as z:
        state = pt_state_from_npz(z)
        state["generator_state"] = torch.from_numpy(np.asarray(z["generator_state"]).copy())
    return state


def _stepping_stone(lls, betas):
    """Stepping-stone log-evidence from loglikes (S, W, N) at the fixed
    leg's rungs `betas` (N,)."""
    log_z = 0.0
    for i in range(len(betas) - 1):
        x = (betas[i + 1] - betas[i]) * lls[:, :, i].reshape(-1)
        x = x[np.isfinite(x)]
        if len(x):
            mx = x.max()
            log_z += mx + np.log(np.mean(np.exp(x - mx)))
    return log_z


def _post_columns(model, flat_t):
    """Named columns (n,) of every scalar variable, log prior and log
    likelihood of the draws `flat_t` (n, D), in batches of _POST_CHUNK rows."""
    cols, lps, lls = {}, [], []
    with torch.no_grad():
        for start in range(0, len(flat_t), _POST_CHUNK):
            part = flat_t[start:start + _POST_CHUNK]
            n = len(part)
            nts = model.arr2nt(model.invlink(part))
            lps.append(model.ln_prior_transformed(part).cpu().numpy())
            lls.append(model.ln_like_nt(nts).cpu().numpy())
            for k, v in flatten_params_batch(nts).items():
                if v.ndim == 0:  # a constant: the same for every draw
                    v = np.broadcast_to(v, (n,))
                if v.ndim == 1:
                    cols.setdefault(k, []).append(v)
    return ({k: np.concatenate(v) for k, v in cols.items()},
            np.concatenate(lps), np.concatenate(lls))


def _slot_directions(labels, direction):
    """The replica-indexed directions (W, NT) of a checkpoint as the
    direction of the replica at each rung slot."""
    return np.take_along_axis(np.asarray(direction), np.asarray(labels), axis=1)


def _replica_directions(labels, slot_direction):
    """The inverse of `_slot_directions`."""
    out = np.empty_like(slot_direction)
    np.put_along_axis(out, np.asarray(labels), slot_direction, axis=1)
    return out


def _with_neighbour_rungs(shard, rungs_lo, rungs_hi, *xs):
    """Each of xs (W_l, NT_l, ...) with the left neighbour rank's last rung
    before its rungs and the right neighbour's first rung after them, where
    they exist (`rungs_lo` / `rungs_hi`: this rank's first rung is not the
    ladder's first / its last is not the ladder's last): the edge rungs,
    all-gathered over the rung axis in one float and one integer pack.
    With the rung axis whole, xs as they are."""
    if shard.axes[1].group is None:
        return xs
    i = shard.axes[1].index
    out = list(xs)
    for floating in (True, False):
        sel = [j for j, x in enumerate(xs) if torch.is_floating_point(x) == floating]
        lead = xs[sel[0]].shape[0]
        edges = torch.cat([torch.stack([xs[j][:, 0], xs[j][:, -1]], dim=1).reshape(lead, 2, -1)
                           for j in sel], dim=2)  # (W_l, 2, sum of trailing sizes)
        parts = shard.stack_gather(edges, 1)      # (rung ranks, W_l, 2, ...)
        lo = 0
        for j in sel:
            x = xs[j]
            w = max(1, math.prod(x.shape[2:]))
            cols = [x]
            if rungs_lo:
                cols.insert(0, parts[i - 1, :, 1, lo:lo + w].reshape((lead, 1) + x.shape[2:]))
            if rungs_hi:
                cols.append(parts[i + 1, :, 0, lo:lo + w].reshape((lead, 1) + x.shape[2:]))
            out[j] = torch.cat(cols, dim=1)
            lo += w
    return tuple(out)


def octofit_pigeons(
    model,
    *,
    generator: torch.Generator | None = None,
    n_rounds: int = 10,
    n_chains: int = 16,
    n_chains_variational: int = 0,
    variational_first_tuning_round: int = 5,
    n_walkers: int = 32,
    explorer: str = "nuts",
    explorer_max_depth: int = 8,
    explorer_n_leapfrog: int = 64,
    target_accept: float = 0.8,
    verbosity: int = 1,
    checkpoint: str | None = None,
    resume=None,
    mesh=None,
):
    """Parallel-tempered sampling; returns (Chains, pt_info dict).

    The JAX package's signature and defaults, with a `torch.Generator` on
    the model's device in place of its key (default: seed 0). n_chains
    rungs between prior and posterior, rounds double in length; n_walkers
    independent ladders run as one batch.

    n_chains_variational > 0 adds the stabilized-variational-PT leg
    (Surjanovic et al. 2022): `prior <-> target | target <-> N(m, s)`,
    with the diagonal Gaussian moment-matched to the target rungs at the
    end of every round from `variational_first_tuning_round` on. The two
    target rungs swap always; draws are recorded from both.

    checkpoint: path; after every non-final round the full state is saved
    there (npz), after the final one to "<checkpoint>.final.npz". resume:
    the path of such a file, or a state dict (`interop.load_jax_pt_
    checkpoint` makes one from a JAX checkpoint); the run continues
    mid-schedule, bit-identical to an uninterrupted run with the same
    n_rounds and device.

    explorer: "nuts" (the default: one multinomial-NUTS transition of every
    walker at every rung, trees of depth up to explorer_max_depth),
    "chees" (per-rung shared-trajectory ChEES-HMC, the W walkers of a rung
    sharing one Halton-jittered trajectory whose length each rung adapts
    by Adam) or "hmc" (jittered-trajectory HMC with up to
    explorer_n_leapfrog steps). Each rung has its own step size and
    diagonal metric. A model with discrete priors raises
    NotImplementedError: the JAX package's tempering evaluates the model
    without discrete values, so it has no such path to port.

    mesh: a `torch.distributed.device_mesh.DeviceMesh` (`parallel.
    global_mesh`, `parallel.chain_mesh`) that spreads the ladder over the
    ranks of a process group: its first axis shards the walkers, an
    optional second axis the rungs; sizes that do not divide raise. Every
    rank calls this with the same arguments and a generator in the same
    state, and draws the whole ladder's random numbers, keeping its block,
    so that the run replays mesh=None. Explorer transitions stay on each
    rank; what sums over walkers (a rung's acceptance, ChEES criterion and
    moments, the swap counts) is all-reduced over the walker axis, a NUTS
    tree's exit over every rank; a swap pass exchanges only each rank's
    edge rungs (state, components, labels, directions) with its rung-axis
    neighbours. Checkpoints hold the gathered ladder, written by rank 0,
    and every rank resumes from the file. The returned Chains and info,
    built from gathered values, are the same on every rank (seconds are
    the slowest rank's). A one-rank mesh runs the code of mesh=None and
    gives its bits.

    Besides the JAX package's info keys, info holds "logevidence_se" (the
    standard error of the log-evidence that the spread of the estimates of
    up to 8 disjoint walker groups gives), and for the rounds this call
    ran: "n_grad_evals" (batched annealed value-and-gradient evaluations;
    under a mesh the rank with the most), "rank_grad_evals" (each rank's,
    walker-major over the mesh), "n_sweeps", "rounds" (per round its
    sweeps, seconds, the longest and median per-rung leapfrog count over
    its sweeps, barriers, and round trips so far) and "collectives" (this
    rank's collective calls and the bytes it handed in).
    """
    if explorer not in ("nuts", "chees", "hmc"):
        raise ValueError(f"unknown explorer {explorer!r}")
    if model.discrete_names:
        raise NotImplementedError(
            "octofit_pigeons on a model with discrete priors "
            f"({model.discrete_names}) is not supported: parallel tempering "
            "does not marginalize or Gibbs-sample discrete variables; use octofit"
        )
    if n_chains_variational == 1:
        # a single variational rung would be a recorded target rung
        # whose state is IID-refreshed from the reference every sweep
        raise ValueError(
            "n_chains_variational must be 0 or >= 2 (a 1-rung "
            "variational leg would record raw reference draws)"
        )
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    D = model.D
    W, N, Nv = n_walkers, n_chains, n_chains_variational
    NT = N + Nv  # total rungs in the (possibly extended) ladder
    dev, dtype = model.device, model.dtype
    # the ladder's (walkers, rungs) grid; this rank holds walkers wb and
    # rungs [r0, r1), the whole grid without a mesh
    shard = (Shard.whole((W, NT)) if mesh is None
             else Shard.from_mesh(mesh, (W, NT), ("n_walkers", "total rungs"), dev))
    Wl, NTl = shard.local_grid
    wb, rb = shard.blocks
    r0, r1 = rb.start, rb.stop
    C = Wl * NTl
    # global rungs [g0, g1): this rank's with its neighbours' edge rungs
    g0, g1 = r0 - (r0 > 0), r1 + (r1 < NT)
    n_own = r1 - r0 - (r1 == NT)  # the swap pairs (j, j + 1) with j on this rank
    writes_checkpoints = mesh is None or torch.distributed.get_rank() == 0
    annealed_vg = _make_annealed_vg(model)

    def host_tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    def prior_draws():
        # every walker's, this rank's block kept
        return model.link(shard.draw(lambda n: model.sample_priors(generator, n), axes=(0,)))

    # --- initial states: the model's starting points when initialized,
    # prior draws otherwise; the prior rung is IID-refreshed every sweep
    pts = model.starting_points
    if pts is not None:
        idx0 = shard.randint(generator, 0, len(pts))
        theta = pts[idx0.to(pts.device)].reshape(Wl, NTl, D)
    else:
        theta = model.link(shard.draw(lambda n: model.sample_priors(generator, n))).reshape(
            Wl, NTl, D)

    # per-leg annealing schedules (host side); rung order is
    # [prior ... target | target ... variational reference]
    betas_fix = np.linspace(0.0, 1.0, N)
    betas_var = np.linspace(1.0, 0.0, Nv) if Nv else np.zeros((0,))
    q_mean = np.zeros(D)
    q_log_std = np.zeros(D)
    q_active = False

    # per-rung explorer adaptation (host, elementwise over rungs); the
    # Laplace covariance from initialization seeds the diagonal metric
    eps0 = np.full(NT, 0.05)
    if model.laplace_sigma is not None:
        sd0 = np.clip(np.diag(model.laplace_sigma.cpu().double().numpy()), 1e-6, None)
        sigma_diag = np.tile(sd0[None, :], (NT, 1))
    else:
        sigma_diag = np.ones((NT, D))

    # replica labels at each rung slot, and each replica's direction
    labels = np.tile(np.arange(NT), (W, 1))
    direction = np.zeros((W, NT), int)
    direction[:, 0] = 1
    direction[:, -1] = -1

    t_start = time.perf_counter()
    da = da_init(eps0)
    adam = AdamState(np.zeros(NT), np.zeros(NT), np.zeros(NT))
    log_T = np.full(NT, math.log(16.0 * eps0[0]))
    # Halton jitter for the shared trajectory, indexed by the global sweep
    # counter so a resumed run is bit-identical
    halton = halton_sequence(2 ** (n_rounds + 1))
    sweep_counter = 0
    start_round = 0
    n_round_trips = 0

    if resume is not None:
        st = resume if isinstance(resume, dict) else _pt_load_checkpoint(os.fspath(resume))
        if tuple(st["theta"].shape) != (W, NT, D):
            raise ValueError(
                f"checkpoint shape {tuple(st['theta'].shape)} does not match "
                f"(n_walkers={W}, n_rungs={NT}, D={D})"
            )
        theta = model.tensor(st["theta"])[wb, rb]
        betas_fix, betas_var = st["betas"], st["betas_var"]
        sigma_diag = st["sigma_diag"]
        labels, direction = st["labels"], st["direction"]
        n_round_trips = st["n_round_trips"]
        sweep_counter = st["sweep_counter"]
        da, adam, log_T = st["da"], st["adam"], st["log_T"]
        q_mean, q_log_std, q_active = st["q_mean"], st["q_log_std"], st["q_active"]
        generator.set_state(st["generator_state"])
        start_round = st["next_round"]
        if start_round >= n_rounds:
            raise ValueError(
                f"checkpoint has already completed {start_round} rounds; "
                f"pass n_rounds > {start_round} to escalate the run"
            )
        if verbosity >= 1:
            print(f"octofit_pigeons: resumed at round {start_round + 1}")

    # on the device, a replica's direction is kept at the rung slot it
    # occupies and moves with it through the swaps
    direction = _slot_directions(labels, direction)
    labels = torch.as_tensor(np.asarray(labels)[wb, rb], dtype=torch.int64, device=dev)
    direction = torch.as_tensor(direction[wb, rb], dtype=torch.int64, device=dev)
    targets = [N - 1, N] if Nv else [N - 1]  # the recorded rungs

    rec_theta, rec_ll = [], []
    rounds_info = []
    rejection = np.zeros(NT - 1)
    barrier = barrier_var = None
    n_grad_evals = rank_grad_evals = 0
    log_T_record = log_T
    for rnd in range(start_round, n_rounds):
        t_round = time.perf_counter()
        n_sweeps = 2 ** (rnd + 1)
        record = rnd == n_rounds - 1
        coeffs = _rung_coeffs(betas_fix, betas_var, q_active)
        coeff_rows = host_tensor(coeffs[rb]).repeat(Wl, 1)
        dc = host_tensor((coeffs[1:] - coeffs[:-1])[g0:g1 - 1])  # this rank's pairs, (g1 - g0 - 1, 3)
        qm, qls = host_tensor(q_mean), host_tensor(q_log_std)
        sigma_t = host_tensor(sigma_diag[rb])

        def vg_batch(Theta):
            value, _, grad = annealed_vg(Theta, coeff_rows, qm, qls)
            return value, grad

        # per-round accumulators: moments for the explorer metric (partial
        # sums over this rank's walkers), accepted swaps of this rank's
        # pairs, swap attempts, completed round trips
        s1 = torch.zeros((NTl, D), dtype=dtype, device=dev)
        s2 = torch.zeros((NTl, D), dtype=dtype, device=dev)
        swaps = torch.zeros((NTl,), dtype=dtype, device=dev)
        trips = torch.zeros((), dtype=torch.int64, device=dev)
        att = np.zeros(NT - 1)
        # the recording round samples with FROZEN tuning while the
        # adaptation keeps updating in the background, so the
        # "<checkpoint>.final.npz" continuation state is adapted too
        eps_frozen, log_T_frozen = np.exp(da.log_eps), log_T
        if record:
            log_T_record = log_T_frozen
        L_round, acc_round = [], []

        for _ in range(n_sweeps):
            i0 = sweep_counter % 2
            u = float(halton[sweep_counter % len(halton)])
            eps_used = eps_frozen if record else np.exp(da.log_eps)
            log_T_used = log_T_frozen if record else log_T

            # --- explore: one transition of every chain of the ladder
            Theta = theta.reshape(C, D)
            lp, grad = vg_batch(Theta)
            if explorer == "chees":
                L = np.clip(np.ceil(u * np.exp(log_T_used) / eps_used), 1,
                            explorer_n_leapfrog).astype(np.int64)
                Theta, alpha, g_logT = _chees_transition_rungs(
                    vg_batch, Theta, lp, grad, generator, host_tensor(eps_used[rb]),
                    sigma_t, L[rb], u, NTl, shard)
                n_grad_evals += 1 + int(L.max())
                rank_grad_evals += 1 + int(L[rb].max())
            else:
                eps_rows = host_tensor(eps_used[rb]).repeat(Wl)
                metric_rows = chain_metric(sigma_t.repeat(Wl, 1))
                if explorer == "hmc":
                    L = np.full(NT, explorer_n_leapfrog)
                    Theta, _, _, stats = hmc_step(vg_batch, Theta, lp, grad, generator, eps_rows,
                                                  metric_rows, explorer_n_leapfrog, shard=shard)
                    n = explorer_n_leapfrog
                else:
                    Theta, _, _, stats, n = nuts_step(vg_batch, Theta, lp, grad, generator,
                                                      eps_rows, metric_rows, explorer_max_depth,
                                                      shard=shard)
                    # each rung's longest tree, read below with the acceptance
                    L = shard.max(stats.n_steps.reshape(Wl, NTl).amax(dim=0))
                n_grad_evals += 1 + n
                rank_grad_evals += 1 + n
                alpha, g_logT = stats.acceptance_rate, torch.zeros_like(lp[:NTl])
            theta = Theta.reshape(Wl, NTl, D)

            # --- regenerate the reference rungs IID: rung 0 from the
            # prior, the far end from the Gaussian reference once active
            prior = prior_draws()
            if r0 == 0:
                theta[:, 0, :] = prior
            if Nv:
                if q_active:
                    far = qm + torch.exp(qls) * shard.randn(generator, (D,), dtype, axes=(0,))
                else:
                    far = prior_draws()
                if r1 == NT:
                    theta[:, NTl - 1, :] = far

            F = _components(model, theta.reshape(C, D), qm, qls).reshape(Wl, NTl, 3)

            # --- one deterministic even/odd swap pass over the ladder;
            # log alpha = (c_{i+1} - c_i) . (F_i - F_{i+1}); the
            # target|target pair has dc = 0, so it always accepts. A pair
            # across two ranks is decided on both from the same numbers.
            th_x, F_x, lab_x, dir_x = _with_neighbour_rungs(
                shard, r0 > 0, r1 < NT, theta, F, labels, direction)
            active = (np.arange(g0, g1 - 1) % 2) == i0
            dF = F_x[:, :-1, :] - F_x[:, 1:, :]
            log_alpha = torch.where(dc != 0, dc * dF, 0.0).sum(-1)  # (W_l, g1 - g0 - 1)
            u_sw = shard.rand(generator, (NT - 1,), dtype, axes=(0,))[:, g0:g1 - 1]
            active_t = torch.as_tensor(active, device=dev)
            accept_swap = active_t[None, :] & (torch.log(u_sw) < log_alpha)
            th_x, ll_x, idx, lab_x = apply_deo_swap(th_x, F_x[:, :, 1], accept_swap, lab_x)
            dir_x = torch.gather(dir_x, 1, idx)
            k = r0 - g0
            theta, ll, labels, direction = (x[:, k:k + NTl] for x in (th_x, ll_x, lab_x, dir_x))

            # --- accumulators and round trips: the replica at the top
            # slot turns down; one at the bottom slot that is descending
            # completes a trip and turns up
            s1 += theta.sum(dim=0)
            s2 += (theta * theta).sum(dim=0)
            att += (np.arange(NT - 1) % 2) == i0
            swaps[:n_own] += accept_swap[:, k:k + n_own].sum(dim=0).to(dtype)
            if r1 == NT:
                top = direction[:, NTl - 1]
                direction[:, NTl - 1] = torch.where(top == 1, -1, top)
            if r0 == 0:
                completed = direction[:, 0] == -1
                trips = trips + completed.sum()
                direction[:, 0] = torch.where(completed, 1, direction[:, 0])

            if record:
                # the target rung(s): the fixed leg's at N - 1, and the
                # variational leg's at N when present
                rec_theta.append(torch.stack(
                    [theta[:, t - r0] if r0 <= t < r1 else theta.new_zeros((Wl, D))
                     for t in targets], dim=1))
                rec_ll.append(ll)

            # --- explorer adaptation, elementwise over rungs, from the
            # one read of this sweep
            rows = [shard.sum(alpha.reshape(Wl, NTl).sum(dim=0)) / W, g_logT.to(dtype)]
            if explorer == "nuts":
                rows.append(L.to(dtype))
            read = shard.gather(torch.stack(rows), 1, dim=1).cpu().double().numpy()
            acc_mean, g_logT_h = read[0], read[1]
            if explorer == "nuts":
                L = read[2].astype(np.int64)
            L_round.append(L)
            acc_round.append(acc_mean)
            da = da_update(da, acc_mean, target_accept)
            if explorer == "chees":
                adam, dlt = _adam_step(adam, g_logT_h, 0.025)
                log_T = np.clip(log_T + dlt, da.log_eps,
                                da.log_eps + math.log(float(explorer_n_leapfrog)))
            sweep_counter += 1

        # ---- between rounds: read the round's accumulators once, then
        # adapt the schedule, the explorer metric and the reference
        s1 = shard.gather(shard.sum(s1), 1).cpu().double().numpy()
        s2 = shard.gather(shard.sum(s2), 1).cpu().double().numpy()
        swaps = shard.gather(shard.sum(swaps), 1)[:NT - 1].cpu().double().numpy()
        n_round_trips += int(shard.sum_all(trips))
        s_count = n_sweeps * W
        rej_round = att - swaps / W
        r = np.where(att > 0, rej_round / np.maximum(att, 1), 0.0)
        r = np.clip(r, 1e-4, 1 - 1e-4)
        rejection = r
        # per-leg communication barriers (the boundary pair N - 1 is the
        # deterministic target|target swap and belongs to neither leg)
        r_fix = r[: N - 1]
        lam = np.concatenate([[0.0], np.cumsum(r_fix)])
        barrier = lam[-1]
        if Nv:
            r_var = r[N:]
            barrier_var = np.concatenate([[0.0], np.cumsum(r_var)])[-1]
        if record:
            # the schedule the recording round sampled with: reported in
            # info and used by the evidence estimator
            betas_report = np.asarray(betas_fix).copy()
            betas_var_report = np.asarray(betas_var).copy()
        # Syed et al. schedule update per leg: equalize rejection (after
        # the recording round too, for the continuation state)
        targets_b = np.linspace(0, lam[-1], N)
        new_b = np.interp(targets_b, lam, betas_fix)
        new_b[0], new_b[-1] = 0.0, 1.0
        betas_fix = np.sort(new_b)
        if Nv:
            # the variational leg runs beta 1 -> 0; adapt in ascending coords
            asc = betas_var[::-1]
            lam_asc = np.concatenate([[0.0], np.cumsum(r_var[::-1])])
            targets_v = np.linspace(0, lam_asc[-1], Nv)
            new_v = np.interp(targets_v, lam_asc, asc)
            new_v[0], new_v[-1] = 0.0, 1.0
            betas_var = np.sort(new_v)[::-1].copy()
        # diagonal metric per rung from the (sweeps x walkers) spread
        if s_count > 4:
            with np.errstate(invalid="ignore", over="ignore"):
                mean = s1 / s_count
                var = s2 / s_count - mean**2
            # extreme unconstrained prior draws on the reference rung can
            # overflow the moment sums (float32): fall back to a unit-ish
            # metric there instead of NaN scales
            var = np.nan_to_num(var, nan=1.0, posinf=1e6, neginf=1.0)
            var = np.clip(var, 1e-6, None)
            shrink = s_count / (s_count + 5.0)
            sigma_diag = shrink * var + 1e-3 * (1 - shrink)
        # moment-match the Gaussian reference to the target rungs
        if Nv and rnd + 1 >= variational_first_tuning_round and s_count > 4:
            rows = [N - 1, N]
            m = s1[rows].sum(0) / (len(rows) * s_count)
            v = s2[rows].sum(0) / (len(rows) * s_count) - m**2
            v = np.clip(v, 1e-8, None)
            q_mean = m
            q_log_std = 0.5 * np.log(v)
            q_active = True

        L_round = np.stack(L_round)
        seconds = shard.max_all(torch.tensor(time.perf_counter() - t_round, dtype=torch.float64,
                                             device=dev))
        rounds_info.append(dict(
            round=rnd + 1, sweeps=n_sweeps, seconds=float(seconds),
            L_longest=int(L_round.max()), L_median=float(np.median(L_round)),
            acceptance=np.mean(acc_round, axis=0),
            barrier=float(barrier),
            barrier_variational=float(barrier_var) if Nv else None,
            round_trips=n_round_trips,
        ))
        if verbosity >= 2:
            extra = f", var barrier {barrier_var:.2f}" if Nv else ""
            print(
                f"PT round {rnd + 1}/{n_rounds}: {n_sweeps} sweeps in "
                f"{rounds_info[-1]['seconds']:.2f} s, leapfrog steps longest "
                f"{int(L_round.max())} / median {float(np.median(L_round)):g}, "
                f"barrier {barrier:.2f}{extra}, round trips {n_round_trips}"
            )

        if checkpoint is not None:
            labels_all = shard.gather_all(labels, (0, 1)).cpu().numpy()
            state = dict(
                theta=shard.gather_all(theta, (0, 1)), labels=labels_all,
                direction=_replica_directions(
                    labels_all, shard.gather_all(direction, (0, 1)).cpu().numpy()),
                betas=betas_fix, betas_var=betas_var, sigma_diag=sigma_diag,
                n_round_trips=n_round_trips, sweep_counter=sweep_counter,
                next_round=rnd + 1, da=da, log_T=log_T, adam=adam,
                q_mean=q_mean, q_log_std=q_log_std, q_active=q_active, generator=generator,
            )
            if writes_checkpoints:
                _pt_save_checkpoint(checkpoint + ".final.npz" if record else checkpoint, state)

    if theta.is_cuda:
        torch.cuda.synchronize(theta.device)
    t_total = float(shard.max_all(torch.tensor(time.perf_counter() - t_start,
                                               dtype=torch.float64, device=dev)))

    # ------------------------------------------------------------------
    # stepping-stone log evidence from the recording round's loglikes on
    # the FIXED (prior-referenced) leg; the variational leg's reference is
    # not normalized against the prior
    lls = shard.gather_all(torch.stack(rec_ll), (1, 2)).cpu().double().numpy()  # (S, W, NT)
    log_z = _stepping_stone(lls[:, :, :N], betas_report)
    groups = np.array_split(np.arange(W), min(W, 8))
    group_z = [_stepping_stone(lls[:, g, :N], betas_report) for g in groups]
    log_z_se = np.std(group_z, ddof=1) / math.sqrt(len(groups)) if W > 1 else np.nan

    # ------------------------------------------------------------------
    # the target rungs' draws: each from the rank that holds its rung
    rec = torch.stack(rec_theta)                                  # (S, W_l, targets, D)
    parts = shard.stack_gather(rec, 1)                            # (rung ranks, ...)
    rec = torch.stack([parts[t // NTl, :, :, j] for j, t in enumerate(targets)], dim=2)
    rec = shard.gather(rec, 0, dim=1)                             # (S, W, targets, D)
    S = rec.shape[0]
    samples = rec.permute(2, 1, 0, 3).reshape(len(targets) * W, S, D)
    Wn = samples.shape[0]
    cols, lp, ll = _post_columns(model, samples.reshape(-1, D))
    data = {k: v.reshape(Wn, S) for k, v in cols.items()}
    internals = {
        "logprior": lp.reshape(Wn, S),
        "loglike": ll.reshape(Wn, S),
        "logpost": (lp + ll).reshape(Wn, S),
    }
    rank_evals = shard.gather_all(torch.tensor([[rank_grad_evals]], device=dev), (0, 1))
    info = {
        "sampler": "pt_deo",
        "explorer": explorer,
        "trajectory_length": np.exp(log_T_record),
        "model_name": model.system.name,
        "logevidence": float(log_z),
        "logevidence_se": float(log_z_se),
        "global_barrier": float(barrier),
        "n_round_trips": n_round_trips,
        "betas": betas_report,
        "swap_rejection": rejection,
        "sampling_time_s": t_total,
        "n_grad_evals": n_grad_evals,
        "rank_grad_evals": rank_evals.reshape(-1).tolist(),
        "n_sweeps": sum(r["sweeps"] for r in rounds_info),
        "rounds": rounds_info,
        "collectives": shard.stats,
    }
    if Nv:
        info["betas_variational"] = betas_var_report
        info["global_barrier_variational"] = (
            float(barrier_var) if barrier_var is not None else np.nan
        )
        info["variational_mean"] = np.asarray(q_mean)
        info["variational_std"] = np.exp(np.asarray(q_log_std))
    if verbosity >= 1:
        print(
            f"octofit_pigeons: {n_rounds} rounds, barrier {barrier:.2f}, "
            f"{n_round_trips} round trips, log-evidence {log_z:.2f} "
            f"({t_total:.1f}s on {dev})"
        )
    return Chains(data, internals, info), info
