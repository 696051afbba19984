#!/usr/bin/env python3
"""The port's main path with no mesh, timed for two checkouts on one NVIDIA GPU.

    python3 scripts/main_path_ab.py OLD_ROOT NEW_ROOT [--out chiprun_out/main_path_ab.json]

OLD_ROOT and NEW_ROOT are checkouts of this repository (for instance the
parent commit unpacked by `git archive` into the ignored `_archive/`, and
the repository itself). The script runs them in the order OLD, NEW, NEW,
OLD, each in a process of its own that imports that root's package and
`chip_smoke.py`:

- the kernels are built from that root's sources (`build_phase`);
- the headline fit of `chip_smoke.py` phase 1 (`main_path_phase`: 4096
  chains, ChEES 200 + 100, float32, its gates included);
- the partial-arc parallel-tempering fit of phase 10: `initialize`, then
  `octofit_pigeons` with `PA_KWARGS` for `PT_ROUNDS` rounds, float32, no
  mesh.

Each run prints one line `AB {json}`: seconds per gradient evaluation of
the headline, seconds per sweep and per evaluation of the ladder, max
split-R-hat of both, and the ladder's log-evidence. The parent prints the
card's name and power limit and writes every run to `--out`. A run that
fails makes the script fail.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def one(root: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs

    cs.device_phase()
    import octofitter_tpu_torch as ot
    from octofitter_tpu_torch.orbits.kernels import kepler as kk
    from octofitter_tpu_torch.orbits.kernels import orbit_solve as osk

    assert ot.__file__.startswith(os.path.abspath(root)), ot.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.build_phase([kk.SOURCE, osk.SOURCE])
    head = cs.main_path_phase(ot, kk, osk, cs.CHAINS, cs.ADAPTATION, cs.ITERATIONS)

    model = cs.build_model(ot, cs.bench_table(ot, *cs.PA_SPAN), name="bench_partial_arc",
                           device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model.initialize(gen, verbosity=0)
    torch.cuda.synchronize()
    chain, info = ot.octofit_pigeons(model, generator=gen, n_rounds=cs.PT_ROUNDS, verbosity=0,
                                     **cs.PA_KWARGS)
    torch.cuda.synchronize()
    x = np.stack([chain[n] for n in model.parameter_names], axis=-1)
    _, rhat = ot.ess_rhat_batch_device(x)
    out = dict(
        root=root,
        headline_s=head["t_sampling"], headline_evals=head["n_evals"],
        headline_s_per_eval=head["t_sampling"] / head["n_evals"],
        headline_rhat_max=float(np.nanmax(head["rhat"])),
        pt_s=info["sampling_time_s"], pt_sweeps=info["n_sweeps"], pt_evals=info["n_grad_evals"],
        pt_s_per_sweep=info["sampling_time_s"] / info["n_sweeps"],
        pt_s_per_eval=info["sampling_time_s"] / info["n_grad_evals"],
        pt_rhat_max=float(np.nanmax(rhat)), pt_logz=float(info["logevidence"]),
    )
    print("AB " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new", nargs="?")
    ap.add_argument("--one", action="store_true", help="run OLD alone in this process")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "main_path_ab.json"))
    args = ap.parse_args()
    if args.one:
        one(os.path.abspath(args.old))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"nvidia-smi name, power.limit: {smi}", flush=True)
    runs = []
    for label, root in (("old", args.old), ("new", args.new), ("new", args.new), ("old", args.old)):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                           capture_output=True, text=True)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("AB ")]
        if p.returncode != 0 or not lines:
            print(p.stdout[-4000:], p.stderr[-4000:], sep="\n")
            raise SystemExit(f"main_path_ab: the {label} run failed (exit code {p.returncode})")
        run = dict(json.loads(lines[-1][3:]), label=label, process_s=time.perf_counter() - t0)
        print(json.dumps(run), flush=True)
        runs.append(run)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, runs=runs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
