#!/usr/bin/env python3
"""The examples/05 phases of `chip_smoke.py` alone, on one NVIDIA GPU.

    python3 scripts/ex05_probe.py [--fit A:S] [--only image,interferometry,transit]
                                  [--no-eval]

Builds the three kernel libraries, then runs the smoke's `ex05_phases`
with its gates: examples/05's image, interferometry (OIFITS) and transit
fits through `octofit` (A adaptation + S draws of `--fit`, default the
smoke's; `--only` picks fits), each with its recovery gates and planted
faults, the likelihood-map and GRAVITY evaluations against the CPU
(skipped with `--no-eval`), and the kernels held to their plain versions
at the shapes those paths launched them with (the fits' Laplace shapes
of the fits that ran). Prints the phases' entries
of the smoke's `kernels` line as one JSON object. Exits 1 if a gate
failed.
"""
import argparse
import json
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fit", default=f"{cs.EX05_ADAPTATION}:{cs.EX05_ITERATIONS}",
                        help="the fits' adaptation:draws")
    parser.add_argument("--only", default=",".join(cs.EX05_FITS))
    parser.add_argument("--no-eval", action="store_true")
    args = parser.parse_args()
    cs.EX05_ADAPTATION, cs.EX05_ITERATIONS = (int(v) for v in args.fit.split(":"))
    only = args.only.split(",")

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
    fits = {"image": (cs.build_image_model, "image", None),
                "interferometry": (cs.build_interferometry_model, "oifits", "oifits"),
                "transit": (cs.build_transit_model, "lightcurve", None)}
    try:
        res = {}
        with tempfile.TemporaryDirectory() as directory:
            data = cs.ex05_data(ot, directory)
            for label in only:
                build, key, oifits = fits[label]
                res[label] = cs.ex05_fit_phase(ot, kk, osk, label, build, data[key],
                                               oifits=data[oifits] if oifits else None)
        if not args.no_eval:
            res["eval"] = cs.ex05_evaluation_phase(ot, kk, osk)
        cs.ex05_kernel_step(kk, osk, elements, kepler_mod, res)
    except AssertionError:
        cs.log(f"ex05 probe FAILED:\n{traceback.format_exc()}")
        return 1
    kernels = [{"name": n} for n in ("kepler_solve", "orbit_solve_fwd", "orbit_solve_bwd",
                                     "celerite_fwd", "celerite_bwd")]
    cs.ex05_kernel_keys(kernels, res)
    print(json.dumps({"kernels": kernels}), flush=True)
    cs.log(f"ex05 probe: {time.perf_counter() - t_start:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
