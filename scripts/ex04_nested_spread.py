#!/usr/bin/env python3
"""How far apart nested-sampling runs land on examples/04's models, in the
JAX package or the port.

    python3 scripts/ex04_nested_spread.py --package jax|port [--device cpu|cuda]
        [--model eccentric|circular] [--seeds 0,1,2] [--n-live 600] [--steps 20]
        [--chees CHAINS] [--out FILE]

The models are `chip_smoke.build_ex04_model` on `chip_smoke.ex04_table`
(examples/04_evidence_pt_nested.py: 12 epochs at 1 mas over 2,000 days of
a ~29-year orbit; D = 11 eccentric, 10 circular), float64. For each seed
the package's `octofit_nested` runs at `--n-live` live points and
`--steps` walker steps (the example's 600 and the default 20) and the
script prints logZ, the information H, the iterations, the largest
log-likelihood among the dead points, the median, standard deviation and
5-95% range of b_a, and the seconds. `--chees C` also fits the model by
the package's ChEES `octofit` (C chains, 300 + 300) and prints the same
b_a numbers, the largest log-likelihood and the max split-R-hat, as a
reference posterior. The JAX package runs on the CPU; the port on the card
unless `--device cpu`. Seeds are JAX PRNG keys or torch generator seeds.
It gates nothing.
"""
import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _summary(label, chain, seconds, extra=""):
    v = np.asarray(chain["b_a"]).reshape(-1)
    q05, q95 = np.quantile(v, [0.05, 0.95])
    return (f"{label}: {extra}max loglike {float(np.max(chain.internals['loglike'])):.4f}, b_a "
            f"median {np.median(v):.4f} sd {v.std():.4f} q05-q95 [{q05:.4f}, {q95:.4f}], "
            f"{seconds:.1f} s")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--package", choices=("jax", "port"), required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--model", choices=("eccentric", "circular"), default="eccentric")
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--n-live", type=int, default=600)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--chees", type=int, default=0)
    p.add_argument("--out")
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]

    import octofitter_tpu_torch as ot

    import chip_smoke as cs

    table = cs.ex04_table(ot)
    eccentric = args.model == "eccentric"
    lines = []
    if args.package == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import octofitter_tpu as oc
        from octofitter_tpu.chains import ess_rhat_batch
        from octofitter_tpu.samplers.nested import octofit_nested

        model = cs.build_ex04_model(oc, table, eccentric)

        def nested(seed):
            return octofit_nested(model, key=jax.random.PRNGKey(seed), n_live=args.n_live,
                                  n_mcmc_steps=args.steps, verbosity=0)

        def chees(chains):
            return oc.octofit(model, key=jax.random.PRNGKey(0), chains=chains, adaptation=300,
                              iterations=300, verbosity=0)
    else:
        import torch

        from octofitter_tpu_torch.chains import ess_rhat_batch

        model = cs.build_ex04_model(ot, table, eccentric, device=args.device)

        def nested(seed):
            gen = torch.Generator(device=model.device).manual_seed(seed)
            return ot.samplers.octofit_nested(model, generator=gen, n_live=args.n_live,
                                              n_mcmc_steps=args.steps, verbosity=0)

        def chees(chains):
            gen = torch.Generator(device=model.device).manual_seed(0)
            return ot.octofit(model, generator=gen, chains=chains, adaptation=300,
                              iterations=300, verbosity=0)

    for seed in seeds:
        t0 = time.perf_counter()
        chain, info = nested(seed)
        lines.append(_summary(
            f"{args.package} {args.model} nested seed {seed}", chain, time.perf_counter() - t0,
            f"logZ {info['logz']:.4f}, {info['n_iterations']} iterations, "
            + (f"H {info['information']:.3f}, " if "information" in info else "")))
        print(lines[-1], flush=True)
    if args.chees:
        t0 = time.perf_counter()
        chain = chees(args.chees)
        x = np.stack([np.asarray(chain[n]) for n in model.parameter_names], axis=-1)
        rhat = float(np.nanmax(ess_rhat_batch(x)[1]))
        lines.append(_summary(f"{args.package} {args.model} ChEES {args.chees} chains, 300 + 300",
                              chain, time.perf_counter() - t0, f"max split-R-hat {rhat:.4f}, "))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
