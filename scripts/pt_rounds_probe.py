#!/usr/bin/env python3
"""How many parallel-tempering rounds the partial-arc path needs, on one
NVIDIA GPU.

    python3 scripts/pt_rounds_probe.py

Builds the kernels, holds the fused pair to its plain version at every
shape of `chip_smoke.py`'s orbit-solve phase, initializes the partial-arc
model as `chip_smoke.py` does, then runs `octofit_pigeons` with the
bench's ladder for 5 rounds and escalates the finished run to 6 and 7
rounds from its "<checkpoint>.final.npz" continuation state (stopping
when 900 s have passed). For each stage it prints the per-round sweeps,
seconds and leapfrog counts, the evaluations and time per evaluation,
round trips, log-evidence, barriers, b_a quantiles, max R-hat, min ESS,
swap rejections and trajectory lengths, and raises on nothing. An
escalated round continues from the shadow-adapted state of the previous
stage's recording round, so its tuning is not that of a straight run of
as many rounds. Checkpoints go to a temporary directory.
"""
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

T0 = time.perf_counter()
name, smi = cs.device_phase()
import octofitter_tpu_torch as ot  # noqa: E402
from octofitter_tpu_torch.orbits import elements  # noqa: E402
from octofitter_tpu_torch.orbits import kepler as kepler_mod  # noqa: E402
from octofitter_tpu_torch.orbits.kernels import kepler as kk  # noqa: E402
from octofitter_tpu_torch.orbits.kernels import orbit_solve as osk  # noqa: E402
torch.backends.cuda.matmul.allow_tf32 = False
cs.build_phase([kk.SOURCE, osk.SOURCE])
t = time.perf_counter()
cs.orbit_phase(osk, elements, cs.CHAINS)
cs.log(f"orbit phase {time.perf_counter() - t:.1f} s")
table = cs.bench_table(ot, *cs.PA_SPAN)
model = cs.build_model(ot, table, name="bench_partial_arc", device="cuda", dtype=torch.float32)
ref = cs.build_model(ot, table, name="bench_partial_arc", device="cpu", dtype=torch.float64)
cs.reference_phase("partial arc", model, ref, cs.headline_points(ot, ref))
gen = torch.Generator(device="cuda").manual_seed(0)
kk.launches = osk.launches_fwd = osk.launches_bwd = 0
kk.launch_shapes.clear()
t = time.perf_counter()
model.initialize(gen, verbosity=1)
torch.cuda.synchronize()
cs.log(f"init {time.perf_counter() - t:.2f} s; launches {kk.launches} {osk.launches_fwd} "
       f"{osk.launches_bwd} {dict(kk.launch_shapes)}")
cs.kepler_path_phase(kk, kepler_mod, dict(kk.launch_shapes))
ck_dir = tempfile.TemporaryDirectory()
ck = str(Path(ck_dir.name) / "pt_probe_ck.npz")
resume = None
for n_rounds in (5, 6, 7):
    if time.perf_counter() - T0 > 900:
        cs.log(f"stop before {n_rounds} rounds: {time.perf_counter() - T0:.0f} s elapsed")
        break
    torch.cuda.reset_peak_memory_stats()
    f0, b0 = osk.launches_fwd, osk.launches_bwd
    t = time.perf_counter()
    chain, info = ot.octofit_pigeons(model, generator=gen, n_rounds=n_rounds, verbosity=2,
                                     checkpoint=ck, resume=resume, **cs.PA_KWARGS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    resume = ck + ".final.npz"
    x = np.stack([chain[n] for n in model.parameter_names], -1)
    ess, rhat = ot.ess_rhat_batch_device(x)
    q = np.quantile(chain["b_a"].reshape(-1), [0.05, 0.5, 0.95])
    cs.log(f"== {n_rounds} rounds: wall {dt:.1f} s, sampling {info['sampling_time_s']:.1f} s, evals {info['n_grad_evals']}, "
           f"sweeps {info['n_sweeps']}, {info['sampling_time_s'] / info['n_grad_evals'] * 1e6:.0f} us/eval; "
           f"launches fwd {osk.launches_fwd - f0} bwd {osk.launches_bwd - b0}; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    cs.log(f"   round trips {info['n_round_trips']}, logZ {info['logevidence']:.3f} se {info['logevidence_se']:.3f}, barriers {info['global_barrier']:.3f} / {info['global_barrier_variational']:.3f}, "
           f"b_a q5/50/95 {q}, max R-hat {np.nanmax(rhat):.4f}, min ESS {np.nanmin(ess):.1f}, finite {np.isfinite(x).all()}")
    cs.log(f"   swap rejection {np.round(info['swap_rejection'], 4).tolist()}")
    cs.log(f"   T {np.round(info['trajectory_length'], 4).tolist()}")
ck_dir.cleanup()
cs.log(f"total {time.perf_counter() - T0:.1f} s")
