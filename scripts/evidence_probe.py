#!/usr/bin/env python3
"""The evidence and validation phases of `chip_smoke.py` (30-34) alone, on
one NVIDIA GPU.

    python3 scripts/evidence_probe.py [--main A:S] [--only 30,31,32,33,34]

Builds the three kernel libraries, then runs the smoke's phases with their
gates, one after another in this process: nested sampling on examples/10
against its grid (30) and on examples/04's models (31), cross-validation
on the chain of a headline fit of A adaptation steps and S draws at the
smoke's CHAINS (`--main`, default the smoke's; 32), SBC and the
completeness map (33), the NSS warm start (34); then the fused pair held
to its plain versions at the shapes those phases launched it with (the
headline's (CHAINS, 12) too, for the NSS fit). `--only` picks phases; the
kernel step needs all of them. Prints the phases' entries of the smoke's
`kernels` line as one JSON object. Exits 1 if a gate failed.
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
    parser.add_argument("--main", default=f"{cs.ADAPTATION}:{cs.ITERATIONS}",
                        help="the headline fit's adaptation:draws for phase 32")
    parser.add_argument("--only", default="30,31,32,33,34")
    args = parser.parse_args()
    adaptation, iterations = (int(v) for v in args.main.split(":"))
    only = set(args.only.split(","))

    t_start = time.perf_counter()
    cs.device_phase()
    import octofitter_tpu_torch as ot
    from octofitter_tpu_torch.orbits import elements
    from octofitter_tpu_torch.orbits.kernels import kepler as kk
    from octofitter_tpu_torch.orbits.kernels import orbit_solve as osk
    from octofitter_tpu_torch.rv import celerite_cuda as cc

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_phase([kk.SOURCE, osk.SOURCE, cc.SOURCE])
    res = {"evidence": {}, "validation": {}}
    try:
        if "30" in only:
            res["evidence"]["nested"] = cs.nested_evidence_phase(ot, kk, osk)
        if "31" in only:
            res["evidence"]["ex04"] = cs.ex04_nested_phase(ot, kk, osk)
        if "32" in only:
            main = cs.main_path_phase(ot, kk, osk, cs.CHAINS, adaptation, iterations)
            res["cv"] = cs.cv_phase(ot, kk, osk, main)
        if "33" in only:
            res["validation"]["sbc"] = cs.sbc_phase(ot, kk, osk)
            with tempfile.TemporaryDirectory() as directory:
                res["validation"]["completeness"] = cs.completeness_phase(ot, kk, osk, directory)
        if "34" in only:
            res["evidence"]["nss"] = cs.nss_phase(ot, kk, osk)
        if only != {"30", "31", "32", "33", "34"}:
            cs.log(f"evidence probe: {time.perf_counter() - t_start:.2f} s (no kernel step)")
            return 0
        cs.evidence_kernel_step(osk, elements, res)
        shape = f"({cs.CHAINS}, {cs.N_EPOCHS})"
        ores = cs.orbit_shapes_phase(osk, elements, (
            (shape, cs.CHAINS, cs.N_EPOCHS, None, cs.HEADLINE_GRID),), (torch.float32,))
    except AssertionError:
        cs.log(f"evidence probe FAILED:\n{traceback.format_exc()}")
        return 1
    kernels = [{"name": n} for n in ("kepler_solve", "orbit_solve_fwd", "orbit_solve_bwd",
                                     "celerite_fwd", "celerite_bwd")]
    cs.evidence_kernel_keys(kernels, res, ores)
    print(json.dumps({"kernels": kernels}), flush=True)
    cs.log(f"evidence probe: {time.perf_counter() - t_start:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
