#!/usr/bin/env python3
"""How many chains and adaptation steps `chip_smoke.py`'s NUTS phase
needs, on one NVIDIA GPU.

    python3 scripts/nuts_chains_probe.py [--configs 16:100:50,32:100:50,16:150:50]

Builds the kernels, builds the headline model in float32 on the card as
`chip_smoke.py`'s main path does and initializes it with the same
generator (seed 0), then, for each configuration chains:adaptation:draws,
runs `octofit(sampler="nuts", max_depth=8)` with the NUTS phase's
generator (seed 1), so a configuration that the smoke also runs draws the
smoke's samples. For each it prints the wall time, the batched gradient
evaluations and the time of one, the evaluations per adaptation and per
sampling transition, the mean leaves per chain and tree depth, and the
device diagnostics' max split-R-hat and min ESS. It gates nothing.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="16:100:50,32:100:50,16:150:50",
                    help="comma-separated chains:adaptation:draws")
    configs = [tuple(int(v) for v in c.split(":")) for c in ap.parse_args().configs.split(",")]

    cs.device_phase()
    import octofitter_tpu_torch as ot
    from octofitter_tpu_torch.orbits.kernels import kepler as kk
    from octofitter_tpu_torch.orbits.kernels import orbit_solve as osk

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_phase([kk.SOURCE, osk.SOURCE])
    model = cs.build_model(ot, cs.bench_table(ot), device="cuda", dtype=torch.float32)
    model.initialize(torch.Generator(device="cuda").manual_seed(0), verbosity=1)
    for chains, adaptation, draws in configs:
        gen = torch.Generator(device="cuda").manual_seed(1)
        t0 = time.perf_counter()
        chain = ot.octofit(model, sampler="nuts", chains=chains, adaptation=adaptation,
                           iterations=draws, max_depth=cs.NUTS_MAX_DEPTH, generator=gen,
                           verbosity=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_evals, t_s = chain.info["n_grad_evals"], chain.info["sampling_time_s"]
        te = chain.info["transition_evals"]
        x = np.stack([chain[n] for n in model.parameter_names], axis=-1)
        ess, rhat = ot.ess_rhat_batch_device(x)
        cs.log(f"C={chains} {adaptation}+{draws}: {wall:.1f} s, evals {n_evals}, "
               f"{t_s / n_evals * 1e6:.0f} us/eval, adapt {te[:adaptation].mean():.1f}, "
               f"sampling {te[adaptation:].mean():.1f} per transition, leaves/chain "
               f"{chain.internals['n_steps'].mean():.1f}, depth "
               f"{chain.internals['tree_depth'].mean():.2f}, rhat {np.nanmax(rhat):.4f}, "
               f"min ess {np.nanmin(ess):.0f}, finite {bool(np.isfinite(x).all())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
