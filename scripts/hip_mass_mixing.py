#!/usr/bin/env python3
"""How the tutorial's Hipparcos mass fit mixes, in the JAX package or the port.

    python3 scripts/hip_mass_mixing.py --package jax|port [--device cpu|cuda]
        [--chains 256] [--adaptation 300] [--iterations 150] [--opt-steps N]
        [--out FILE]

The model is `chip_smoke.build_hip_mass_model` (`docs/hipparcos.md:140-200`:
AbsoluteVisual{KepOrbit}, the synthetic 120-abscissa IAD and c Eri's 14
relative-astrometry epochs, D = 16) built with the chosen package, float64.
It is initialized as `chip_smoke.py`'s mass fit is (the tutorial's guess,
`--opt-steps` multistart Adam steps, default the smoke's INIT_OPT_STEPS),
then sampled by the package's ChEES (`octofit`, its default). The script
prints the seconds, the split-R-hat and the ESS per draw of every
parameter (the same numpy diagnostics in both packages), the catalog
pulls of plx, pmra and pmdec (`docs/hipparcos.md:102-113`), and the
strongest correlations of the Laplace covariance at the mode; `--out`
writes the same lines to FILE. Seeds: the data from numpy seed 0, the
initialization and the sampling from seeds 0 and 1. It gates nothing.

`--package jax` runs on the CPU (the JAX package is the reference and
does not run on the card); `--package port` runs the PyTorch port, on the
card unless `--device cpu`. At 256 chains each run takes minutes on a CPU.
"""
import argparse
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _fit_jax(args):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import octofitter_tpu as oc
    from octofitter_tpu.chains import ess_rhat_batch

    import chip_smoke as cs

    with tempfile.TemporaryDirectory() as directory:
        model = cs.build_hip_mass_model(oc, cs.hip_data(directory), jnp)
        t0 = time.perf_counter()
        oc.initialize(model, key=jax.random.PRNGKey(0), guess=cs.HIP_GUESS,
                      n_opt_steps=args.opt_steps, verbosity=0)
        t_init = time.perf_counter() - t0
        t0 = time.perf_counter()
        chain = oc.octofit(model, key=jax.random.PRNGKey(1), chains=args.chains,
                           adaptation=args.adaptation, iterations=args.iterations, verbosity=0)
        t_sampling = time.perf_counter() - t0
    return model, chain, np.asarray(model.laplace_sigma), ess_rhat_batch, t_init, t_sampling, "CPU"


def _fit_port(args):
    import torch

    import chip_smoke as cs
    import octofitter_tpu_torch as ot
    from octofitter_tpu_torch.chains import ess_rhat_batch

    device = args.device
    with tempfile.TemporaryDirectory() as directory:
        model = cs.build_hip_mass_model(ot, cs.hip_data(directory), torch, device=device,
                                        dtype=torch.float64)
        gen = torch.Generator(device=device).manual_seed(0)
        t0 = time.perf_counter()
        model.initialize(gen, guess=cs.HIP_GUESS, n_opt_steps=args.opt_steps, verbosity=0)
        t_init = time.perf_counter() - t0
        gen = torch.Generator(device=device).manual_seed(1)
        t0 = time.perf_counter()
        chain = ot.octofit(model, chains=args.chains, adaptation=args.adaptation,
                           iterations=args.iterations, generator=gen, verbosity=0)
        t_sampling = time.perf_counter() - t0
    where = torch.cuda.get_device_name(0) if device == "cuda" else "CPU"
    sigma = model.laplace_sigma.detach().cpu().numpy()
    return model, chain, sigma, ess_rhat_batch, t_init, t_sampling, where


def main() -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="the port's device (the JAX package runs on the CPU)")
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--adaptation", type=int, default=300)
    ap.add_argument("--iterations", type=int, default=150)
    ap.add_argument("--opt-steps", type=int, default=cs.INIT_OPT_STEPS)
    ap.add_argument("--out", default=None, help="also write the report to this file")
    args = ap.parse_args()

    lines: list[str] = []

    def say(msg):
        print(msg, flush=True)
        lines.append(msg)

    fit = _fit_jax if args.package == "jax" else _fit_port
    model, chain, sigma, ess_rhat_batch, t_init, t_sampling, where = fit(args)
    names = list(model.parameter_names)
    x = np.stack([np.asarray(chain[n]) for n in names], axis=-1)
    ess, rhat = ess_rhat_batch(x)
    name = "JAX package" if args.package == "jax" else "PyTorch port"
    say(f"{name}, ChEES, {args.chains} chains x ({args.adaptation} + {args.iterations}), "
        f"{args.opt_steps} Adam steps, float64, {where}: init {t_init:.1f} s, "
        f"sampling {t_sampling:.1f} s")
    k = int(np.argmax(np.where(np.isnan(rhat), -np.inf, rhat)))
    say(f"  max split-R-hat {float(rhat[k]):.4f} on {names[k]}, "
        f"min ESS per draw {float(np.nanmin(ess, initial=np.inf)) / x[..., 0].size:.4f}")
    for n, r, e in zip(names, rhat, ess):
        say(f"  {n:20s} split-R-hat {float(r):.3f}  ESS per draw {float(e) / x[..., 0].size:.4f}")
    for key, cat_key, err_key in (("plx", "plx", "e_plx"), ("pmra", "pm_ra", "e_pmra"),
                                  ("pmdec", "pm_de", "e_pmde")):
        post = x[..., names.index(key)].ravel()
        cat, cat_err = cs.HIP_SOL[cat_key], 0.5  # write_synth_iad's catalog errors
        pull = (float(post.mean()) - cat) / math.hypot(float(post.std()), cat_err)
        say(f"  catalog test {key}: posterior {post.mean():.4f} +- {post.std():.4f}, "
            f"catalog {cat} +- {cat_err}, pull {pull:+.3f}")
    mass = x[..., names.index("M_sec")].ravel()
    say(f"  companion mass 90% interval {np.percentile(mass, 5):.3f} - "
        f"{np.percentile(mass, 95):.3f} Mjup")
    sd = np.sqrt(np.diag(sigma))
    corr = sigma / np.outer(sd, sd)
    iu = np.triu_indices(len(sd), 1)
    order = np.argsort(-np.abs(corr[iu]))[:6]
    say("strongest correlations of the Laplace covariance at the mode (unconstrained):")
    for k in order:
        i, j = iu[0][k], iu[1][k]
        say(f"  {names[i]} / {names[j]}: {corr[i, j]:+.4f}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
