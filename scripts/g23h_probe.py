#!/usr/bin/env python3
"""The G23H and observable-prior phases of `chip_smoke.py` alone, on one NVIDIA GPU.

    python3 scripts/g23h_probe.py [--fit A:S] [--pt-rounds R] [--pt-leapfrog L]
    python3 scripts/g23h_probe.py --example-fit A:S

Builds the three kernel libraries, then runs the smoke's `g23h_phases`
with its gates: examples/06's model evaluated on Visual{KepOrbit} and
AbsoluteVisual{KepOrbit} against the CPU, the injection-recovery fit (A
adaptation + S draws of `--fit`, default the smoke's), examples/06 through
`octofit_pigeons` (`--pt-rounds` rounds of at most `--pt-leapfrog` steps,
default the smoke's), the observable priors with photometry, and the
kernels held to their plain versions at the shapes those paths launched
them with. Prints the phases' entries of the smoke's `kernels` line as one
JSON object. Exits 1 if a gate failed. With `--example-fit A:S` it runs
instead examples/06's model (D = 98, marginalized epochs) through
`initialize` and ChEES at 4096 chains, A adaptation + S draws, float32,
with the gates of the smoke's `fit_phase` but R-hat's (printed), and the
run's peak device memory: the dense metric and the initialization at
that dimension.
"""
import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fit", default=f"{cs.G23H_ADAPTATION}:{cs.G23H_ITERATIONS}",
                        help="the injection fit's adaptation:draws")
    parser.add_argument("--pt-rounds", type=int, default=cs.G23H_PT_ROUNDS)
    parser.add_argument("--pt-leapfrog", type=int,
                        default=cs.G23H_PT_KWARGS["explorer_n_leapfrog"])
    parser.add_argument("--example-fit", default=None,
                        help="adaptation:draws of a ChEES fit of examples/06's model instead")
    args = parser.parse_args()
    cs.G23H_ADAPTATION, cs.G23H_ITERATIONS = (int(v) for v in args.fit.split(":"))
    cs.G23H_PT_ROUNDS = args.pt_rounds
    cs.G23H_PT_KWARGS["explorer_n_leapfrog"] = args.pt_leapfrog

    t_start = time.perf_counter()
    cs.device_phase()
    import octofitter_tpu_torch as ot
    from octofitter_tpu_torch.orbits import elements
    from octofitter_tpu_torch.orbits import kepler as kepler_mod
    from octofitter_tpu_torch.orbits.kernels import kepler as kk
    from octofitter_tpu_torch.orbits.kernels import orbit_solve as osk
    from octofitter_tpu_torch.rv import celerite_cuda as cc

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_phase([kk.SOURCE, osk.SOURCE, cc.SOURCE])
    if args.example_fit:
        import tempfile

        adaptation, draws = (int(v) for v in args.example_fit.split(":"))
        with tempfile.TemporaryDirectory() as directory:
            model = cs.build_g23h_example_model(ot, cs.g23h_data(directory), device="cuda",
                                                dtype=torch.float32)
            cs.fit_phase(ot, kk, osk, model, f"examples/06 by ChEES ({adaptation} + {draws})",
                         cs.CHAINS, adaptation, draws,
                         init_kwargs={"n_opt_steps": cs.G23H_OPT_STEPS}, rhat_gate=False)
        cs.log(f"g23h probe: {time.perf_counter() - t_start:.2f} s")
        return 0
    try:
        res = cs.g23h_phases(ot, kk, osk, elements, kepler_mod)
    except AssertionError:
        cs.log(f"g23h probe FAILED:\n{traceback.format_exc()}")
        return 1
    kernels = [{"name": n} for n in ("kepler_solve", "orbit_solve_fwd", "orbit_solve_bwd",
                                     "celerite_fwd", "celerite_bwd")]
    cs.g23h_kernel_keys(kernels, res)
    print(json.dumps({"kernels": kernels}), flush=True)
    cs.log(f"g23h probe: {time.perf_counter() - t_start:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
