#!/usr/bin/env python3
"""Phase 36 of `chip_smoke.py` (the plots' arrays on the card) alone, on
one NVIDIA GPU.

    python3 scripts/plots_probe.py [--main A:S]

Builds the three kernel libraries, fits the headline model at the smoke's
CHAINS for A adaptation steps and S draws (`--main`, default the smoke's;
phase 5 with its gates), then runs phase 36 with its gates: every panel on
the card and on the CPU, the marks' summary, the native reader, and the
forward and Kepler kernels against their plain versions at the shapes the
panels launched them with. Prints the phase's entries of the smoke's
`kernels` line as one JSON object. Exits 1 if a gate failed.
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
    parser.add_argument("--main", default=f"{cs.ADAPTATION}:{cs.ITERATIONS}",
                        help="the headline fit's adaptation:draws")
    args = parser.parse_args()
    adaptation, iterations = (int(v) for v in args.main.split(":"))

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
    try:
        main_res = cs.main_path_phase(ot, kk, osk, cs.CHAINS, adaptation, iterations)
        res = cs.plots_phase(ot, kk, osk, elements, kepler_mod, main_res)
    except AssertionError:
        cs.log(f"plots probe FAILED:\n{traceback.format_exc()}")
        return 1
    kernels = [{"name": n} for n in cs.KERNEL_NAMES]
    cs.plots_kernel_keys(kernels, res)
    print(json.dumps({"kernels": kernels}), flush=True)
    cs.log(f"plots probe: {time.perf_counter() - t_start:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
