#!/usr/bin/env python3
"""Profile the PyTorch port's sampling step on one NVIDIA GPU.

    python3 scripts/profile_port_step.py [--model headline|joint|partial_arc]

Builds a model of `chip_smoke.py` in float32 on the GPU (the headline
relative-astrometry fit, the joint astrometry + HGCA + marginalized-RV
fit of `examples/02_joint_astrom_pma_rv.py`, 70 epochs, or the partial-arc
model sampled by parallel tempering), initializes it, then, for the first
two:

1. times one batched `ln_post_and_grad` (forward + backward over all
   chains) with CUDA events, against its forward alone;
2. profiles 20 such evaluations through the fused orbit-solve kernels
   and 20 through the composed path (`ln_post(..., fused=False)` and
   autograd), and prints each path's device operations and device time
   per evaluation;
3. runs 20 ChEES transitions at 4096 chains under `torch.profiler` and prints the
   device time by kernel, the Kepler kernel's share, and the device's
   busy share of the profiled wall time. The profiler slows the host
   several-fold, so that share is a lower bound; the device time per
   evaluation against step 1's unprofiled time gives the busy share of
   an unprofiled run.

For the partial arc, with the bench's ladder (4096 walkers x (8 + 8)
rungs = 65,536 chains), the same for one batched annealed value-and-
gradient evaluation of every chain (`samplers/tempering.py`) against its
forward alone (the components pass), and then two rounds (6 sweeps) of
`octofit_pigeons` under `torch.profiler`.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CHAINS, STEPS = 4096, 20


ACTS = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def cuda_ms(fn, n=50):
    """ms per call of `fn` by CUDA events and by the host clock."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n, (time.perf_counter() - t0) / n * 1e3


def device_rows(prof):
    """The profile's device-side rows (kernels, copies) and the name of
    their self-time attribute."""
    events = list(prof.key_averages())
    key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA], key


def profile_partial_arc(chip_smoke, ot) -> int:
    from octofitter_tpu_torch.samplers import tempering

    table = chip_smoke.bench_table(ot, *chip_smoke.PA_SPAN)
    model = chip_smoke.build_model(ot, table, name="bench_partial_arc", device="cuda",
                                   dtype=torch.float32)
    kw = chip_smoke.PA_KWARGS
    W, N, Nv = kw["n_walkers"], kw["n_chains"], kw["n_chains_variational"]
    C = W * (N + Nv)
    print(f"model: partial_arc, D = {model.D}, {model.n_epochs} epochs, {C} chains "
          f"({W} walkers x {N} + {Nv} rungs), on {torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model.initialize(gen, verbosity=0, n_prior_samples=20_000, n_multistart=256,
                     n_opt_steps=300)
    pts = model.starting_points
    Theta = pts[torch.randint(len(pts), (C,), generator=gen, device="cuda")]
    coeffs = tempering._rung_coeffs(torch.linspace(0, 1, N).numpy(),
                                    torch.linspace(1, 0, Nv).numpy(), False)
    rows = model.tensor(coeffs).repeat(W, 1)
    qm = qls = torch.zeros(model.D, device="cuda")
    vg = tempering._make_annealed_vg(model)

    def annealed():
        return vg(Theta, rows, qm, qls)

    def components():
        return tempering._components(model, Theta, qm, qls)

    fwd_dev, fwd_host = cuda_ms(components)
    vg_dev, vg_host = cuda_ms(annealed)
    print(f"components pass (forward): {fwd_dev:.3f} ms (events), {fwd_host:.3f} ms host")
    print(f"annealed value and gradient: {vg_dev:.3f} ms (events), {vg_host:.3f} ms host")
    with torch.profiler.profile(activities=ACTS) as prof:
        for _ in range(STEPS):
            annealed()
        torch.cuda.synchronize()
    rows_p, key = device_rows(prof)
    dev_ms = sum(getattr(e, key) for e in rows_p) / 1e3
    n_ops = sum(e.count for e in rows_p if getattr(e, key) > 0)
    orbit_ms = sum(getattr(e, key) for e in rows_p if "orbit_" in e.key) / 1e3
    print(f"annealed evaluation, profiled x{STEPS}: {n_ops / STEPS:.0f} device ops, "
          f"{dev_ms / STEPS:.3f} ms device time, of which the fused kernels "
          f"{orbit_ms / STEPS * 1e3:.1f} us; unprofiled busy share {100 * dev_ms / STEPS / vg_dev:.1f}%")

    ot.octofit_pigeons(model, generator=gen, n_rounds=1, verbosity=0, **kw)  # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=ACTS) as prof:
        _, info = ot.octofit_pigeons(model, generator=gen, n_rounds=2, verbosity=0, **kw)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events, key = device_rows(prof)
    total_dev = sum(getattr(e, key) for e in events) / 1e3
    n_evals = info["n_grad_evals"]
    print(f"profiled 2 rounds ({info['n_sweeps']} sweeps, {n_evals} annealed evaluations): "
          f"wall {wall_ms:.1f} ms, device busy {total_dev:.1f} ms "
          f"({100 * total_dev / wall_ms:.1f}% busy); per evaluation, sweep overhead included: "
          f"device {total_dev / n_evals:.3f} ms")
    print(prof.key_averages().table(sort_by=key, row_limit=25))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("headline", "joint", "partial_arc"), default="headline")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port_step: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import octofitter_tpu_torch as ot
    from octofitter_tpu_torch.samplers.chees import _chees_transition
    from octofitter_tpu_torch.samplers.nuts import metric_from_sigma

    if args.model == "headline":
        model = chip_smoke.build_model(ot, chip_smoke.bench_table(ot), device="cuda",
                                       dtype=torch.float32)
    elif args.model == "partial_arc":
        return profile_partial_arc(chip_smoke, ot)
    else:
        model = chip_smoke.build_joint_model(ot, chip_smoke.joint_data(ot), device="cuda",
                                             dtype=torch.float32)
    print(f"model: {args.model}, D = {model.D}, {model.n_epochs} epochs, {CHAINS} chains, "
          f"on {torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model.initialize(gen, verbosity=0, n_prior_samples=20_000, n_multistart=256,
                     n_opt_steps=300)
    pts = model.starting_points
    Theta = pts[torch.randint(len(pts), (CHAINS,), generator=gen, device="cuda")]

    with torch.no_grad():
        fwd_dev, fwd_host = cuda_ms(lambda: model.ln_post(Theta))
    vg_dev, vg_host = cuda_ms(lambda: model.ln_post_and_grad(Theta))
    print(f"ln_post forward: {fwd_dev:.3f} ms (events), {fwd_host:.3f} ms host")
    print(f"ln_post_and_grad: {vg_dev:.3f} ms (events), {vg_host:.3f} ms host "
          f"({CHAINS} chains)")

    def composed(theta):
        return chip_smoke.composed_ln_post_and_grad(model, theta)

    for label, fn in (("fused", model.ln_post_and_grad), ("composed", composed)):
        fn(Theta)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=ACTS) as prof:
            for _ in range(STEPS):
                fn(Theta)
            torch.cuda.synchronize()
        rows, key = device_rows(prof)
        dev_ms = sum(getattr(e, key) for e in rows) / 1e3
        n_ops = sum(e.count for e in rows if getattr(e, key) > 0)
        orbit_ms = sum(getattr(e, key) for e in rows
                       if "orbit_" in e.key or "kepler" in e.key.lower()) / 1e3
        print(f"{label} evaluation, profiled x{STEPS}: {n_ops / STEPS:.0f} device ops, "
              f"{dev_ms / STEPS:.3f} ms device time, of which the hand-written kernels "
              f"{orbit_ms / STEPS * 1e3:.1f} us")

    lp, Grad = model.ln_post_and_grad(Theta)
    metric = metric_from_sigma(model.laplace_sigma)
    eps, T = 0.3, 1.2
    for _ in range(3):  # warm up
        Theta, lp, Grad, _, _, _ = _chees_transition(
            model.ln_post_and_grad, Theta, lp, Grad, gen, eps, T, 0.5, metric, 1024)
    torch.cuda.synchronize()
    n_evals = 0
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=ACTS) as prof:
        for k in range(STEPS):
            u = (k + 1) / (STEPS + 1)
            Theta, lp, Grad, _, g, L = _chees_transition(
                model.ln_post_and_grad, Theta, lp, Grad, gen, eps, T, u, metric, 1024)
            n_evals += L
            float(g)  # the per-step scalar read the sampler makes
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events, key = device_rows(prof)

    def dev_us(e):
        return getattr(e, key)

    total_dev = sum(dev_us(e) for e in events) / 1e3
    kepler = sum(dev_us(e) for e in events
                 if "orbit_" in e.key or "kepler" in e.key.lower()) / 1e3
    n_kernels = sum(e.count for e in events if dev_us(e) > 0)
    print(f"profiled {STEPS} transitions, {n_evals} batched gradient evals: "
          f"wall {wall_ms:.1f} ms, device busy {total_dev:.1f} ms "
          f"({100 * total_dev / wall_ms:.1f}% busy, {100 - 100 * total_dev / wall_ms:.1f}% idle)")
    print(f"  per batched eval: wall {wall_ms / n_evals:.3f} ms, device {total_dev / n_evals:.3f} ms, "
          f"{n_kernels / n_evals:.0f} device ops")
    print(f"  hand-written kernels: {kepler:.3f} ms device ({100 * kepler / max(total_dev, 1e-9):.2f}% of device time)")
    print(f"  unprofiled: device {total_dev / n_evals:.3f} ms of a {vg_dev:.3f} ms evaluation "
          f"({100 * total_dev / n_evals / vg_dev:.1f}% busy)")
    print(prof.key_averages().table(sort_by=key, row_limit=25))
    return 0


if __name__ == "__main__":
    sys.exit(main())
