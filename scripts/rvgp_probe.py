#!/usr/bin/env python3
"""The RV-GP phase of `chip_smoke.py` alone, on one NVIDIA GPU.

    python3 scripts/rvgp_probe.py [--fit A:S,A:S,...] [--fit-only]

Builds the three kernel libraries, then runs the smoke's `rvgp_phase`
(`examples/03_rv_gp.py`'s model, 80 epochs, SHOTerm GP) once per A
adaptation + S draws of `--fit` (default: the smoke's), with the smoke's
gates. The first run also makes the phase's checks (the float32 model
against a float64 CPU model, the evaluation through the celerite kernel
pair and through the plain recursion, the Laplace step, the pair against
its plain version at its shapes, the associative and dense checks) unless
`--fit-only`. A run that fails its gates prints the failure and the probe
goes on to the next. Exits 1 if any run failed.
"""
import argparse
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
    parser.add_argument("--fit", default=f"{cs.RVGP_ADAPTATION}:{cs.RVGP_ITERATIONS}",
                        help="fit sizes, adaptation:draws, comma-separated")
    parser.add_argument("--fit-only", action="store_true",
                        help="skip the phase's checks and run the fits alone")
    args = parser.parse_args()
    configs = [tuple(int(v) for v in c.split(":")) for c in args.fit.split(",")]

    t_start = time.perf_counter()
    cs.device_phase()
    import octofitter_tpu_torch as ot
    from octofitter_tpu_torch.orbits.kernels import kepler as kk
    from octofitter_tpu_torch.orbits.kernels import orbit_solve as osk
    from octofitter_tpu_torch.rv import celerite_cuda as cc

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_phase([kk.SOURCE, osk.SOURCE, cc.SOURCE])
    failed = []
    for k, (adaptation, iterations) in enumerate(configs):
        label = f"rv-gp {adaptation} + {iterations}"
        try:
            cs.rvgp_phase(ot, kk, osk, adaptation, iterations,
                          checks=k == 0 and not args.fit_only)
        except AssertionError:
            cs.log(f"{label} FAILED:\n{traceback.format_exc()}")
            failed.append(label)
    cs.log(f"rvgp probe: {time.perf_counter() - t_start:.2f} s; failed: {failed or 'none'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
