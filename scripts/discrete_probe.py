#!/usr/bin/env python3
"""The discrete-prior phases of `chip_smoke.py` alone, on one NVIDIA GPU.

    python3 scripts/discrete_probe.py [--gibbs A:S,A:S,...] [--no-kernels]

Builds the kernels, then runs the smoke's calibration fit (marginalized,
K = 2) with the Kepler kernel held to its twin at the shapes its Laplace
step launched it with, the outlier fit (Gibbs-within-HMC, K = 2^13) from
the calibration fit's starting points once per A adaptation + S draws of
`--gibbs` (default: the smoke's), the cap case (K = 4096) and, unless
`--no-kernels`, the fused pair at the discrete paths' shapes. Each phase
prints what the smoke prints; a phase that fails its gates prints the
failure and the probe goes on to the next. Exits 1 if any phase failed.
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
    parser.add_argument("--gibbs", default=f"{cs.GIBBS_ADAPTATION}:{cs.GIBBS_ITERATIONS}",
                        help="outlier-fit sizes, adaptation:draws, comma-separated")
    parser.add_argument("--no-kernels", action="store_true",
                        help="skip the fused pair at the discrete shapes")
    args = parser.parse_args()
    configs = [tuple(int(v) for v in c.split(":")) for c in args.gibbs.split(",")]

    t_start = time.perf_counter()
    cs.device_phase()
    import octofitter_tpu_torch as ot
    from octofitter_tpu_torch.orbits import elements
    from octofitter_tpu_torch.orbits import kepler as kepler_mod
    from octofitter_tpu_torch.orbits.kernels import kepler as kk
    from octofitter_tpu_torch.orbits.kernels import orbit_solve as osk

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_phase([kk.SOURCE, osk.SOURCE])
    failed = []

    def run(label, fn):
        try:
            return fn()
        except AssertionError:
            cs.log(f"{label} FAILED:\n{traceback.format_exc()}")
            failed.append(label)
            return None

    cal = run("calibration", lambda: cs.calibration_phase(ot, kk, osk))
    if cal is not None:
        run("kepler at the calibration shapes",
            lambda: cs.kepler_path_phase(kk, kepler_mod, cal["kepler_shapes"]))
        for adaptation, iterations in configs:
            run(f"outlier {adaptation}:{iterations}",
                lambda: cs.outlier_phase(ot, kk, osk, cal["model"], adaptation, iterations))
    run("cap", lambda: cs.cap_phase(ot, kk, osk))
    if not args.no_kernels:
        run("discrete kernels", lambda: cs.discrete_kernel_phase(osk, elements))
    cs.log(f"discrete probe: {time.perf_counter() - t_start:.1f} s; failed: {failed or 'none'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
