#!/usr/bin/env python3
"""The absolute-astrometry phases of `chip_smoke.py` alone, on one NVIDIA GPU.

    python3 scripts/astrom_probe.py [--hip-line A:S] [--hip A:S] [--hgca A:S]

Builds the three kernel libraries, then runs the smoke's
`absolute_astrometry_phases` with its gates: the other orbit bases, the
Hipparcos catalog fit (A adaptation + S draws of `--hip-line`, default the
smoke's) and mass fit (`--hip`), the HGCA linear-fit fit (`--hgca`), the
Gaia DR4 evaluations and
the kernels held to their plain versions at the shapes those paths
launched them with. Prints the phases' entries of the smoke's `kernels`
line as one JSON object. Exits 1 if a gate failed.
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
    parser.add_argument("--hip-line",
                        default=f"{cs.HIP_LINE_ADAPTATION}:{cs.HIP_LINE_ITERATIONS}",
                        help="the Hipparcos catalog fit's adaptation:draws")
    parser.add_argument("--hip", default=f"{cs.HIP_ADAPTATION}:{cs.HIP_ITERATIONS}",
                        help="the Hipparcos mass fit's adaptation:draws")
    parser.add_argument("--hgca", default=f"{cs.HGCA_ADAPTATION}:{cs.HGCA_ITERATIONS}",
                        help="the HGCA fit's adaptation:draws")
    args = parser.parse_args()
    cs.HIP_LINE_ADAPTATION, cs.HIP_LINE_ITERATIONS = (int(v) for v in args.hip_line.split(":"))
    cs.HIP_ADAPTATION, cs.HIP_ITERATIONS = (int(v) for v in args.hip.split(":"))
    cs.HGCA_ADAPTATION, cs.HGCA_ITERATIONS = (int(v) for v in args.hgca.split(":"))

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
        res = cs.absolute_astrometry_phases(ot, kk, osk, elements, kepler_mod)
    except AssertionError:
        cs.log(f"astrom probe FAILED:\n{traceback.format_exc()}")
        return 1
    kernels = [{"name": n} for n in ("kepler_solve", "orbit_solve_fwd", "orbit_solve_bwd",
                                     "celerite_fwd", "celerite_bwd")]
    cs.absolute_kernel_keys(kernels, res)
    print(json.dumps({"kernels": kernels}), flush=True)
    cs.log(f"astrom probe: {time.perf_counter() - t_start:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
