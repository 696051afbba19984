"""LogDensityModel: the single object all samplers consume.

PyTorch port of `octofitter_tpu/model/logdensity.py`:

    theta_t (unconstrained, flat; shape (C, D) for C chains, or (D,))
      -> invlink (per-prior bijectors, grouped by class)
      -> arr2nt (structured Params; derived vars evaluated inline)
      -> ln_prior (with change-of-variables corrections)
      -> ln_like (orbits constructed, Kepler solved at ALL epochs of all
                  chains in one call, every observation's log-likelihood
                  summed over its epochs)

The chain axis is written out: `ln_post(Theta)` maps (C, D) to (C,), and
`ln_post_and_grad` takes the gradient of `ln_post(Theta).sum()`, which
gives each chain its own gradient because chains are independent.
-inf gating is branch-free (`torch.where`). Every tensor the model makes
carries the model's `device` and `dtype`.

Discrete priors (`DiscreteUniform`, `Categorical`) are not part of theta.
Where the product of their domains has at most `MAX_DISC_COMBOS`
combinations, `ln_post` marginalizes them: every chain's likelihood is
evaluated at every combination, over C x K rows, and summed by logsumexp
with the combinations' prior weights; the rows are taken in chunks sized
from free device memory, each recomputed in the backward pass
(`torch.utils.checkpoint`), so that only the (C, K) log-likelihoods are
kept. Above the cap the model is in the Gibbs mode: `ln_post_given_disc`
conditions on each chain's discrete values and `gibbs_update_disc`
redraws them (`samplers/gibbs.py`).

`ln_post(theta_t, fused=...)` chooses how the orbits are solved
(`orbits.orbitsolve`): the fused orbit-solve Function, first derivatives
only (the default, so `ln_post_and_grad`, `prior_search` and the multistart
optimizer run it), or with `fused=False` composed torch ops, differentiable
to any order, which the Laplace step's `torch.func.hessian` asks for. The
likelihoods see the same choice in their context's `fused`: the celerite
Gaussian process runs its CUDA kernel pair only where it is true.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..distributions import categorical
from ..orbits import orbitsolve
from .params import Params
from .variables import PlanetObservationContext, System, SystemObservationContext


# The most combinations of discrete values that ln_post marginalizes; a
# model with more is in the Gibbs mode.
MAX_DISC_COMBOS = 4096
# Bytes of device memory one row (one chain at one discrete combination)
# of a marginalized value-and-gradient evaluation takes per epoch, in
# float32: the fused forward's 14 fields, the likelihood's temporaries and
# their gradients. chip_smoke.py's cap case reads 194 on an NVIDIA H100
# 80GB HBM3 (relative astrometry, 12 epochs); rounded up.
_BYTES_PER_ROW_EPOCH = 256


def _stack_field(values, device, dtype):
    return torch.as_tensor(np.asarray(values, dtype=np.float64), dtype=dtype, device=device)


def _stack_group(objs, device, dtype):
    """One instance of a dataclass whose fields hold the fields of `objs`
    stacked into tensors (one entry per parameter)."""
    cls = type(objs[0])
    fields = [f.name for f in dataclasses.fields(cls)]
    return cls(**{f: _stack_field([getattr(o, f) for o in objs], device, dtype) for f in fields})


class LogDensityModel:
    """Posterior log-density with link/invlink, arr2nt, prior sampler.

    Attributes mirroring the reference (`logdensitymodel.jl:5-24`):
      D, ln_post(theta_t), ln_post_and_grad(theta_t), link, invlink,
      arr2nt, sample_priors, starting_points.

    device: where the model's tensors live and its kernels run. The
    default is the GPU; with no CUDA device the constructor raises, and a
    caller who wants the CPU says `device="cpu"`.
    dtype: float64 by default. Epochs are MJD near 5e4 d, where one float32
    step is 4e-3 d, and the parity tests against the reference run in
    float64; the H100 runs float64 at half its float32 rate and this path
    is bound by launches, not arithmetic. `dtype=torch.float32` is the
    caller's choice for throughput at many chains, as the benchmark makes.
    """

    def __init__(self, system: System, verbosity: int = 1, *,
                 device="cuda", dtype=torch.float64):
        self.device = torch.device(device)
        self.dtype = dtype
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"LogDensityModel was asked for device {self.device!s}, but "
                "no CUDA device is available"
            )
        self.system = system
        self.verbosity = verbosity

        # ------------------------------------------------------------------
        # 1. Flat prior list, ordering contract of `_list_priors`
        #    (`variables.jl:691-737`): system, system-obs, then per planet:
        #    planet priors, planet-obs priors.
        # ------------------------------------------------------------------
        entries = []  # (path, name, dist, bijector)

        def add_prior_specs(specs, path):
            for s in specs:
                if s.kind == "prior":
                    entries.append((path, s.name, s.value, s.value.bijector()))

        add_prior_specs(system.var_specs, ("sys",))
        for obs in system.observations:
            add_prior_specs(obs.var_specs, ("sysobs", obs.normalized_name))
        for planet in system.planets:
            add_prior_specs(planet.var_specs, ("planet", planet.name))
            for obs in planet.observations:
                add_prior_specs(
                    obs.var_specs, ("planetobs", planet.name, obs.normalized_name)
                )

        # Discrete priors are detected and kept out of theta: marginalized
        # when their domains' product is small, else sampled by Gibbs
        # updates (the reference switches to gradient-free sampling,
        # `logdensitymodel.jl:38-41`)
        cont = [e for e in entries if not getattr(e[2], "discrete", False)]
        disc = [e for e in entries if getattr(e[2], "discrete", False)]
        self._prior_entries = cont
        self._discrete_entries = disc
        self.D = len(cont)
        if self.D == 0:
            raise ValueError("Model has no free continuous (prior) parameters")

        def _flat_name(path, name):
            if path[0] == "sys":
                return name
            if path[0] in ("sysobs", "planet"):
                return f"{path[1]}_{name}"
            return f"{path[1]}_{path[2]}_{name}"

        # Flat parameter names using the chain naming contract
        # (`sampling.jl:551-635`): var, obs_var, planet_var, planet_obs_var.
        self.parameter_names = [_flat_name(path, name) for path, name, _, _ in cont]
        self.discrete_names = [_flat_name(path, name) for path, name, _, _ in disc]

        self.discrete_mode = None
        self._disc_combos = None  # (K, n_disc) in the marginalized mode
        self._disc_logw = None    # (K,) their log prior weights
        self._disc_domains = None  # one numpy array per discrete variable
        if disc:
            self._disc_domains = [np.asarray(e[2].domain(), float) for e in disc]
            K = int(np.prod([len(d) for d in self._disc_domains]))
            if K > MAX_DISC_COMBOS:
                # too many combinations to marginalize: ln_post conditions
                # on the first domain values; sample with
                # octofit(sampler="gibbs") (Gibbs-within-HMC)
                self.discrete_mode = "gibbs"
            else:
                self.discrete_mode = "marginalize"
                grids = np.meshgrid(*self._disc_domains, indexing="ij")
                combos = torch.as_tensor(np.stack([g.reshape(-1) for g in grids], axis=-1))
                logw = sum(e[2].logpmf(combos[:, j]) for j, e in enumerate(disc))
                self._disc_combos = self.tensor(combos)
                self._disc_logw = self.tensor(logw)

        # ------------------------------------------------------------------
        # 2. Epoch gathering with per-obs start indices (`system.jl:35-54`):
        #    system observations first, then per-planet observations.
        # ------------------------------------------------------------------
        all_epochs = []
        start_map = {}
        j = 0
        for obs in system.observations:
            ep = obs.epochs
            if ep is not None:
                start_map[id(obs)] = j
                j += len(ep)
                all_epochs.append(ep)
        for planet in system.planets:
            for obs in planet.observations:
                ep = obs.epochs
                if ep is not None:
                    start_map[id(obs)] = j
                    j += len(ep)
                    all_epochs.append(ep)
        self._epoch_start = start_map
        self._all_epochs = np.concatenate(all_epochs) if all_epochs else np.zeros((0,))
        self.n_epochs = len(self._all_epochs)
        self._epochs_t = torch.as_tensor(self._all_epochs, dtype=dtype, device=self.device)

        # ------------------------------------------------------------------
        # 3. Build the functions
        # ------------------------------------------------------------------
        self.arr2nt = self._make_arr2nt()
        self.link = self._make_link()
        self.invlink = self._make_invlink()
        self.ln_prior = self._make_ln_prior()
        self.ln_prior_transformed = self._make_ln_prior_transformed()
        self.ln_like_nt = self._make_ln_like()

        self.starting_points = None  # (n, D) unconstrained, set by initialize()
        self.laplace_sigma = None    # (D, D) H^{-1} at the mode, set by initialize()

        # probe once, like the reference's fail-fast + @showtime
        # (`logdensitymodel.jl:90-92,159-187`)
        gen = torch.Generator(device=self.device).manual_seed(0)
        theta0_t = self.link(self.sample_priors(gen))
        t0 = time.perf_counter()
        lp0, g = self.ln_post_and_grad(theta0_t)
        lp0 = float(lp0)
        t_probe = time.perf_counter() - t0
        if verbosity >= 2:
            print(
                f"LogDensityModel {system.name}: D={self.D}, "
                f"epochs={self.n_epochs}, ln_post(theta0)={lp0:.3f} "
                f"(value and gradient {t_probe:.3f}s, {self.device}, {self.dtype})"
            )
        if not np.isfinite(lp0) and verbosity >= 1:
            print(
                f"warning: ln_post at a prior draw is {lp0}; "
                "check your model specification"
            )

    # ----------------------------------------------------------------------
    def tensor(self, x) -> torch.Tensor:
        """`x` as a tensor of the model's dtype on the model's device."""
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def ln_post(self, theta_t, *, fused=True):
        """Log posterior in unconstrained space: (..., D) -> (...),
        discrete variables marginalized (or, in the Gibbs mode, at the
        first value of each one's domain).

        fused: solve the orbits with the fused Function (`orbitsolve`),
        which gives first derivatives only; `fused=False` for a second
        derivative or a `torch.func` transform."""
        theta_t = self.tensor(theta_t)
        if self.discrete_mode == "gibbs":
            disc0 = self.tensor([d[0] for d in self._disc_domains])
            return self.ln_post_given_disc(theta_t, disc0.expand(theta_t.shape[:-1] + disc0.shape),
                                           fused=fused)
        finite_in = torch.isfinite(theta_t).all(dim=-1)
        theta = self.invlink(theta_t)
        lp = self.ln_prior(theta) + self._ln_abs_det_jacobian(theta_t)
        if self.discrete_mode == "marginalize":
            ll = torch.logsumexp(self._disc_logw + self._combo_lls(theta, fused=fused), dim=-1)
        else:
            ll = self.ln_like_nt(self.arr2nt(theta), fused=fused)
        lpost = lp + ll
        return torch.where(finite_in & torch.isfinite(lpost), lpost, -torch.inf)

    def _value_and_grad(self, fn, theta_t):
        theta_t = self.tensor(theta_t).detach().requires_grad_(True)
        with torch.enable_grad():
            lp = fn(theta_t)
            (g,) = torch.autograd.grad(lp.sum(), theta_t)
        return lp.detach(), g

    def ln_post_and_grad(self, theta_t):
        """(ln_post(theta_t), its gradient); a leading chain axis gives
        each chain its own gradient. Solves the orbits with the fused
        Function."""
        return self._value_and_grad(self.ln_post, theta_t)

    def ln_post_given_disc(self, theta_t, disc, *, fused=True):
        """Log posterior conditional on the discrete values `disc`:
        theta_t (..., D) and disc (..., n_disc) -> (...)."""
        theta_t = self.tensor(theta_t)
        disc = self.tensor(disc)
        finite_in = torch.isfinite(theta_t).all(dim=-1)
        theta = self.invlink(theta_t)
        lp = self.ln_prior(theta) + self._ln_abs_det_jacobian(theta_t) + self.disc_logpmf(disc)
        lpost = lp + self.ln_like_nt(self.arr2nt(theta, disc), fused=fused)
        return torch.where(finite_in & torch.isfinite(lpost), lpost, -torch.inf)

    def ln_post_given_disc_and_grad(self, theta_t, disc):
        """(ln_post_given_disc(theta_t, disc), its gradient in theta_t)."""
        return self._value_and_grad(lambda th: self.ln_post_given_disc(th, disc), theta_t)

    # -- discrete variables ------------------------------------------------
    def _rows_ll(self, theta, disc, fused=True):
        """Log-likelihood of every row pair: theta (C, D) natural-space
        points and disc (k, n_disc) discrete values -> (C, k), over C k rows
        (theta repeated by expand + reshape, whose backward is a sum, not
        an index scatter). NaN becomes -inf."""
        C, k = theta.shape[0], disc.shape[0]
        rows = theta[:, None, :].expand(C, k, self.D).reshape(C * k, self.D)
        disc_rows = disc[None].expand((C,) + disc.shape).reshape(C * k, disc.shape[-1])
        ll = self.ln_like_nt(self.arr2nt(rows, disc_rows), fused=fused)
        ll = torch.broadcast_to(self.tensor(ll), (C * k,)).reshape(C, k)
        return torch.where(torch.isnan(ll), -torch.inf, ll)

    def _combo_chunk(self, n_theta: int) -> int:
        """How many discrete combinations one pass takes for n_theta
        points: as many rows as fit in a quarter of the free device memory
        at `_BYTES_PER_ROW_EPOCH` (twice that in float64; on the CPU, in
        4 GiB)."""
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
        else:
            free = 16 * 2**30
        per_row = _BYTES_PER_ROW_EPOCH * max(self.n_epochs, 1) * (self.dtype.itemsize // 4)
        return max(1, int(free // 4 // per_row) // max(n_theta, 1))

    def _combo_lls(self, theta, *, fused=True):
        """The log-likelihood of every discrete combination at natural-space
        theta (..., D): (..., K), NaN as -inf. The combinations go in
        chunks of `_combo_chunk`; with more than one chunk and a gradient
        to take, each chunk is recomputed in the backward pass
        (`torch.utils.checkpoint`) rather than kept. `fused=False` (the
        Hessian's `torch.func` path, which checkpointing does not compose
        with) takes all K at once."""
        batch = theta.shape[:-1]
        flat = theta.reshape(-1, self.D)
        K = self._disc_combos.shape[0]
        chunk = self._combo_chunk(flat.shape[0]) if fused else K
        if chunk >= K:
            lls = self._rows_ll(flat, self._disc_combos, fused)
        else:
            keep_graph = torch.is_grad_enabled() and flat.requires_grad
            parts = []
            for k0 in range(0, K, chunk):
                combos = self._disc_combos[k0: k0 + chunk]
                if keep_graph:
                    parts.append(checkpoint(self._rows_ll, flat, combos, use_reentrant=False,
                                            preserve_rng_state=False))
                else:
                    parts.append(self._rows_ll(flat, combos))
            lls = torch.cat(parts, dim=-1)
        return lls.reshape(batch + (K,))

    def discrete_conditional_logits(self, theta_t):
        """Unnormalized log P(discrete combination | theta_t), the prior
        weight plus the log-likelihood of each: (..., D) -> (..., K). Draw
        from it (`distributions.categorical`) to recover the discrete
        variables per posterior draw."""
        if self._disc_combos is None:
            raise ValueError("model has no discrete variables")
        return self._disc_logw + self._combo_lls(self.invlink(self.tensor(theta_t)))

    def disc_logpmf(self, disc):
        """Sum of the discrete priors' log pmf at the values disc
        (..., n_disc) -> (...)."""
        if not self._discrete_entries:
            return self.tensor(0.0)
        disc = self.tensor(disc)
        return sum(e[2].logpmf(disc[..., j]) for j, e in enumerate(self._discrete_entries))

    def sample_disc_priors(self, generator: torch.Generator, n: int | None = None):
        """IID draws of the discrete variables from their priors, shape
        (n_disc,) or (n, n_disc)."""
        shape = () if n is None else (n,)
        return self.tensor(torch.stack(
            [e[2].sample(generator, shape, self.dtype) for e in self._discrete_entries], dim=-1))

    def gibbs_update_disc(self, theta_t, disc, generator: torch.Generator | None = None,
                          noise=None):
        """One systematic-scan Gibbs sweep over the discrete variables of
        every chain given its continuous state: theta_t (C, D), disc
        (C, n_disc) (or (D,) and (n_disc,)). Variable j is redrawn from its
        full conditional over its own domain only, so a sweep costs the
        SUM of the domain sizes: one likelihood evaluation, without
        gradient, over C |dom_j| rows per variable. The draw is the
        Gumbel-max argmax(logits + g), g from `generator` unless noise[j]
        (C, |dom_j|) gives them. Returns the new disc."""
        theta = self.invlink(self.tensor(theta_t))
        disc = self.tensor(disc).clone()
        single = theta.ndim == 1
        if single:
            theta, disc = theta[None], disc[None]
        C = theta.shape[0]
        for j, e in enumerate(self._discrete_entries):
            dom = self.tensor(self._disc_domains[j])
            m = len(dom)
            rows = theta[:, None, :].expand(C, m, self.D).reshape(C * m, self.D)
            disc_rows = disc[:, None, :].repeat(1, m, 1)
            disc_rows[:, :, j] = dom
            with torch.no_grad():
                ll = self.ln_like_nt(self.arr2nt(rows, disc_rows.reshape(C * m, -1)))
            ll = torch.broadcast_to(self.tensor(ll), (C * m,)).reshape(C, m)
            logits = e[2].logpmf(dom) + ll
            logits = torch.where(torch.isnan(logits), -torch.inf, logits)
            i = categorical(logits, generator, None if noise is None else noise[j])
            disc[:, j] = dom[i]
        return disc[0] if single else disc

    def drawfrompriors(self, generator: torch.Generator):
        """Structured prior draw (`drawfrompriors`, `variables.jl:1507`),
        the discrete variables drawn from their prior weights."""
        if self._disc_combos is not None:
            i = categorical(self._disc_logw, generator)
            return self.arr2nt(self.sample_priors(generator), self._disc_combos[i])
        return self.arr2nt(self.sample_priors(generator))

    # ----------------------------------------------------------------------
    def _make_arr2nt(self):
        system = self.system
        n_disc = len(self._discrete_entries)

        def eval_specs(specs, take, outer_scopes):
            d = {}
            for s in specs:
                if s.kind == "prior":
                    d[s.name] = take(s)
                elif s.kind == "constant":
                    d[s.name] = self.tensor(s.value)
                else:
                    d[s.name] = s.value(*outer_scopes, Params(d))
            return d

        def arr2nt(theta, disc=None):
            theta = self.tensor(theta)
            if n_disc and disc is None:
                raise ValueError(
                    "this model has discrete variables "
                    f"({self.discrete_names}); arr2nt needs their values "
                    "as a second argument"
                )
            it = iter(range(self.D))
            it_d = iter(range(n_disc))
            if n_disc:
                disc = self.tensor(disc)

            def take(spec):
                if getattr(spec.value, "discrete", False):
                    return disc[..., next(it_d)]
                return theta[..., next(it)]

            sys_d = eval_specs(system.var_specs, take, ())
            sys_ns = Params(sys_d)

            sysobs_d = {}
            for obs in system.observations:
                sysobs_d[obs.normalized_name] = Params(
                    eval_specs(obs.var_specs, take, (sys_ns,))
                )

            planets_d = {}
            for planet in system.planets:
                pl_d = eval_specs(planet.var_specs, take, (sys_ns,))
                pl_ns = Params(pl_d)
                plobs_d = {}
                for obs in planet.observations:
                    plobs_d[obs.normalized_name] = Params(
                        eval_specs(obs.var_specs, take, (sys_ns, pl_ns))
                    )
                pl_d = dict(pl_d)
                pl_d["observations"] = Params(plobs_d)
                planets_d[planet.name] = Params(pl_d)

            out = dict(sys_d)
            out["planets"] = Params(planets_d)
            out["observations"] = Params(sysobs_d)
            return Params(out)

        return arr2nt

    # -- grouped (vectorized) prior/bijector machinery --------------------
    # Parameters are grouped by distribution/bijector class and evaluated
    # as a handful of stacked tensor ops per class, not D scalar ones.

    def _dist_groups(self):
        if not hasattr(self, "_dist_groups_cache"):
            groups = {}
            singles = []
            for i, (_, _, dist, _) in enumerate(self._prior_entries):
                # group only classes that are THEMSELVES dataclasses of this
                # package's distributions module: stacking rebuilds instances
                # from their fields
                if (
                    "__dataclass_fields__" in type(dist).__dict__
                    and type(dist).__module__.endswith("distributions")
                ):
                    groups.setdefault(type(dist), []).append(i)
                else:
                    singles.append(i)
            out = []
            for idxs in groups.values():
                stacked = _stack_group(
                    [self._prior_entries[j][2] for j in idxs], self.device, self.dtype
                )
                out.append((torch.as_tensor(idxs, device=self.device), stacked))
            self._dist_groups_cache = (out, singles)
        return self._dist_groups_cache

    def _bij_groups(self):
        if not hasattr(self, "_bij_groups_cache"):
            groups = {}
            for i, (_, _, _, bij) in enumerate(self._prior_entries):
                groups.setdefault(type(bij), []).append(i)
            out = []
            for idxs in groups.values():
                stacked = _stack_group(
                    [self._prior_entries[j][3] for j in idxs], self.device, self.dtype
                )
                out.append((torch.as_tensor(idxs, device=self.device), stacked))
            # permutation restoring original ordering after concatenation
            order = np.concatenate([np.asarray(idxs.cpu()) for idxs, _ in out])
            perm = torch.as_tensor(np.argsort(order), device=self.device)
            self._bij_groups_cache = (out, perm)
        return self._bij_groups_cache

    def _make_link(self):
        groups, perm = self._bij_groups()

        def link(theta):
            theta = self.tensor(theta)
            parts = [bij.forward(theta[..., idx]) for idx, bij in groups]
            return torch.cat(parts, dim=-1)[..., perm]

        return link

    def _make_invlink(self):
        groups, perm = self._bij_groups()

        def invlink(theta_t):
            theta_t = self.tensor(theta_t)
            parts = [bij.inverse(theta_t[..., idx]) for idx, bij in groups]
            return torch.cat(parts, dim=-1)[..., perm]

        return invlink

    def _make_ln_prior(self):
        groups, singles = self._dist_groups()
        dists = [e[2] for e in self._prior_entries]

        def ln_prior(theta):
            theta = self.tensor(theta)
            lp = torch.zeros(theta.shape[:-1], dtype=theta.dtype, device=theta.device)
            for idx, dist in groups:
                lp = lp + torch.sum(dist.logpdf(theta[..., idx]), dim=-1)
            for i in singles:
                lp = lp + dists[i].logpdf(theta[..., i])
            return lp

        return ln_prior

    def _ln_abs_det_jacobian(self, theta_t):
        """log|dx/dy| of invlink at theta_t, summed over parameters."""
        bgroups, _ = self._bij_groups()
        lp = 0.0
        for idx, bij in bgroups:
            lp = lp + torch.sum(bij.logabsdet_inverse(theta_t[..., idx]), dim=-1)
        return lp

    def _make_ln_prior_transformed(self):
        def ln_prior_t(theta_t):
            # logpdf(x) + log|dx/dy| summed over parameters
            # (Bijectors.jl `logpdf_with_trans`, `variables.jl:1205-1369`)
            theta_t = self.tensor(theta_t)
            return self.ln_prior(self.invlink(theta_t)) + self._ln_abs_det_jacobian(theta_t)

        return ln_prior_t

    # ----------------------------------------------------------------------
    def construct_orbits(self, theta_nt):
        """Build orbit elements for every planet from structured params
        (reference planet construction, `system.jl:116-118`)."""
        sys_kw = {
            k: v
            for k, v in theta_nt.items()
            if k not in ("planets", "observations")
        }
        orbits = []
        for planet in self.system.planets:
            pl = theta_nt.planets[planet.name]
            kw = dict(sys_kw)
            kw.update({k: v for k, v in pl.items() if k != "observations"})
            orbits.append(planet.basis.from_params(**kw))
        return tuple(orbits)

    def _row_shape(self, theta_nt) -> tuple:
        """The rows' shape of a structured parameter set: that of its first
        prior, which arr2nt took from theta[..., 0]."""
        path, name = self._prior_entries[0][:2]
        scope = theta_nt
        if path[0] == "sysobs":
            scope = theta_nt.observations[path[1]]
        elif path[0] == "planet":
            scope = theta_nt.planets[path[1]]
        elif path[0] == "planetobs":
            scope = theta_nt.planets[path[1]].observations[path[2]]
        return tuple(scope[name].shape)

    def _make_ln_like(self):
        system = self.system
        epochs = self._epochs_t
        start_map = self._epoch_start

        def ln_like_nt(theta_nt, *, fused=True):
            rows = self._row_shape(theta_nt)
            orbits = self.construct_orbits(theta_nt)
            if len(epochs) and len(orbits):
                sols = tuple(orbitsolve(o, epochs, fused=fused) for o in orbits)
            else:
                sols = tuple(None for _ in orbits)

            ll = 0.0
            # planet-attached observations (`system.jl:81-115`)
            for i_planet, planet in enumerate(system.planets):
                theta_planet = theta_nt.planets[planet.name]
                for obs in planet.observations:
                    theta_obs = theta_planet.observations.get(
                        obs.normalized_name, Params()
                    )
                    ctx = PlanetObservationContext(
                        theta_system=theta_nt,
                        theta_planet=theta_planet,
                        theta_obs=theta_obs,
                        orbits=orbits,
                        solutions=sols,
                        i_planet=i_planet,
                        epoch_start=start_map.get(id(obs), 0),
                        batch_shape=rows,
                        fused=fused,
                    )
                    ll = ll + obs.ln_like(ctx)
            # system-attached observations (`system.jl:180-204`)
            for obs in system.observations:
                theta_obs = theta_nt.observations.get(obs.normalized_name, Params())
                ctx = SystemObservationContext(
                    theta_system=theta_nt,
                    theta_obs=theta_obs,
                    orbits=orbits,
                    solutions=sols,
                    epoch_start=start_map.get(id(obs), 0),
                    batch_shape=rows,
                    fused=fused,
                )
                ll = ll + obs.ln_like(ctx)
            return ll

        return ln_like_nt

    # ----------------------------------------------------------------------
    def sample_priors(self, generator: torch.Generator, n: int | None = None):
        """IID draws from the priors, flat natural space, shape (D,) or
        (n, D) (`make_prior_sampler`, `variables.jl:1372`); grouped by
        distribution class so a model draws in a few vector ops."""
        groups, singles = self._dist_groups()
        dists = [e[2] for e in self._prior_entries]
        parts = []
        order = []
        for idx, dist in groups:
            k = len(idx)
            shape = (k,) if n is None else (n, k)
            parts.append(dist.sample(generator, shape, self.dtype))
            order.append(idx.cpu().numpy())
        for i in singles:
            shape = (1,) if n is None else (n, 1)
            parts.append(dists[i].sample(generator, shape, self.dtype))
            order.append(np.asarray([i]))
        perm = torch.as_tensor(np.argsort(np.concatenate(order)), device=self.device)
        return self.tensor(torch.cat(parts, dim=-1)[..., perm])

    # ----------------------------------------------------------------------
    def initialize(self, generator: torch.Generator | None = None, **kwargs):
        """Run the initialization pipeline (prior search -> multistart
        optimization -> L-BFGS -> Laplace draws); see
        model/initialization.py (reference `initialize!`,
        `initialization.jl:184`)."""
        from .initialization import initialize as _init

        return _init(self, generator, **kwargs)

    def startingpoints(self, points):
        """Manually set starting points (natural-space flat draws), like
        the reference `startingpoints!` (`initialization.jl:344`)."""
        pts = self.tensor(points)
        if pts.ndim == 1:
            pts = pts[None, :]
        self.starting_points = self.link(pts)
        return self

    def get_starting_point(self, generator: torch.Generator | None = None):
        """One starting point (unconstrained, (D,)), initializing first if
        needed (`get_starting_point!!`, `initialization.jl:85-93`): the
        first, or with a generator a random one."""
        if self.starting_points is None:
            self.initialize(generator)
        pts = self.starting_points
        i = 0 if generator is None else int(
            torch.randint(len(pts), (), generator=generator, device=generator.device))
        return pts[i]

    # ----------------------------------------------------------------------
    def prior_search(self, generator: torch.Generator, n_samples: int = 10_000,
                     n_keep: int = 1000):
        """Vectorized prior search for starting points: draw n_samples IID
        from the priors, evaluate the posterior density in one batched
        call, keep the best n_keep (finite) draws.
        Returns (theta_t_points [n_keep, D], logposts [n_keep])."""
        draws_t = self.link(self.sample_priors(generator, n_samples))
        with torch.no_grad():
            lps = self.ln_post(draws_t)
        lps = torch.where(torch.isnan(lps), -torch.inf, lps)
        keep = torch.argsort(-lps)[:n_keep]
        return draws_t[keep], lps[keep]
