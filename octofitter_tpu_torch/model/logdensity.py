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

`ln_post(theta_t, fused=...)` chooses how the orbits are solved
(`orbits.orbitsolve`): the fused orbit-solve Function, first derivatives
only (the default, so `ln_post_and_grad`, `prior_search` and the multistart
optimizer run it), or with `fused=False` composed torch ops, differentiable
to any order, which the Laplace step's `torch.func.hessian` asks for.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..orbits import orbitsolve
from .params import Params
from .variables import PlanetObservationContext, System, SystemObservationContext


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

        if any(getattr(e[2], "discrete", False) for e in entries):
            raise NotImplementedError(
                "discrete priors (marginalization and the Gibbs mode) are "
                "not ported to octofitter_tpu_torch yet"
            )
        self._prior_entries = entries
        self.D = len(entries)
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
        self.parameter_names = [_flat_name(path, name) for path, name, _, _ in entries]

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
        """Log posterior in unconstrained space: (..., D) -> (...).

        fused: solve the orbits with the fused Function (`orbitsolve`),
        which gives first derivatives only; `fused=False` for a second
        derivative or a `torch.func` transform."""
        theta_t = self.tensor(theta_t)
        finite_in = torch.isfinite(theta_t).all(dim=-1)
        theta = self.invlink(theta_t)
        lp = self.ln_prior(theta) + self._ln_abs_det_jacobian(theta_t)
        ll = self.ln_like_nt(self.arr2nt(theta), fused=fused)
        lpost = lp + ll
        return torch.where(finite_in & torch.isfinite(lpost), lpost, -torch.inf)

    def ln_post_and_grad(self, theta_t):
        """(ln_post(theta_t), its gradient); a leading chain axis gives
        each chain its own gradient. Solves the orbits with the fused
        Function."""
        theta_t = self.tensor(theta_t).detach().requires_grad_(True)
        with torch.enable_grad():
            lp = self.ln_post(theta_t)
            (g,) = torch.autograd.grad(lp.sum(), theta_t)
        return lp.detach(), g

    # ----------------------------------------------------------------------
    def _make_arr2nt(self):
        system = self.system

        def eval_specs(specs, take, outer_scopes):
            d = {}
            for s in specs:
                if s.kind == "prior":
                    d[s.name] = take()
                elif s.kind == "constant":
                    d[s.name] = self.tensor(s.value)
                else:
                    d[s.name] = s.value(*outer_scopes, Params(d))
            return d

        def arr2nt(theta):
            theta = self.tensor(theta)
            it = iter(range(self.D))

            def take():
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

    def _make_ln_like(self):
        system = self.system
        epochs = self._epochs_t
        start_map = self._epoch_start

        def ln_like_nt(theta_nt, *, fused=True):
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
