#!/usr/bin/env python3
"""How the headline fit mixes from the Gaia NSS warm start, in the port.

    python3 scripts/nss_warm_start.py [--device cpu|cuda] [--model theta|tp]
        [--chains 512] [--adaptation 100,200,300] [--iterations 100] [--out FILE]

The row is `chip_smoke.nss_row` (the headline truth as a Gaia DR3 two-body
solution). The model is the headline model (`chip_smoke.build_model`,
float32) with its position angle theta at MJD 57000 (`--model theta`, the
row cannot map it) or with the periastron epoch free in its place
(`--model tp`, prior `chip_smoke.NSS_TP_PRIOR`). `initialize_from_nss`
sets the starting points (their ln_post range is printed), then for each
adaptation length `octofit` runs from them without `initialize` (ChEES,
generator seed 34) and the script prints the gradient evaluations, the
seconds, the split-R-hat of every parameter and b_a's median and standard
deviation. On the card unless `--device cpu`; it gates nothing.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--model", choices=("theta", "tp"), default="tp")
    p.add_argument("--chains", type=int, default=512)
    p.add_argument("--adaptation", default="100,200,300")
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--out")
    args = p.parse_args()

    import torch

    import octofitter_tpu_torch as ot

    import chip_smoke as cs

    torch.set_num_threads(2)
    tp = None if args.model == "theta" else ot.distributions.Uniform(*cs.NSS_TP_PRIOR)
    row = cs.nss_row(ot)
    lines = []
    for adaptation in (int(a) for a in args.adaptation.split(",")):
        model = cs.build_model(ot, cs.bench_table(ot), device=args.device, dtype=torch.float32,
                               tp=tp)
        ot.initialize_from_nss(model, row, verbosity=0)
        with torch.no_grad():
            lp = model.ln_post(model.starting_points).cpu().numpy()
        gen = torch.Generator(device=model.device).manual_seed(34)
        chain = ot.octofit(model, chains=args.chains, adaptation=adaptation,
                           iterations=args.iterations, generator=gen, verbosity=0)
        names = model.parameter_names
        x = np.stack([chain[n] for n in names], axis=-1)
        rhat = ot.ess_rhat_batch(x)[1]
        v = chain.flat("b_a")
        lines.append(
            f"{args.model}, {args.chains} chains, {adaptation} + {args.iterations} on "
            f"{model.device}: starting ln_post {lp.min():.1f} to {lp.max():.1f}; "
            f"{chain.info['n_grad_evals']} gradient evaluations in "
            f"{chain.info['sampling_time_s']:.2f} s; max split-R-hat {np.nanmax(rhat):.4f} "
            f"{dict(zip(names, np.round(rhat, 4).tolist()))}; b_a median {np.median(v):.5f} "
            f"sd {v.std():.5f}")
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
