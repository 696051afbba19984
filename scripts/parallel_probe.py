#!/usr/bin/env python3
"""Phase 35 of `chip_smoke.py` (the ladder and the chains across
processes) alone, on one NVIDIA GPU, after a probe of the collectives
that the gloo backend takes on CUDA tensors.

    python3 scripts/parallel_probe.py [--skip-phase]

First two ranks that share the card join a gloo group and try each
collective the port's `parallel/` uses (all_reduce SUM and MAX in
float32, float64, int32 and int64, and all_gather) on CUDA tensors, each
checked against the expected result: the log names each as taken or
refused (the error's first line). Then,
unless `--skip-phase`, it builds the three kernel libraries, initializes
the headline and the partial-arc models and runs phase 35 with its
gates, then the
fused pair at the ranks' shapes, and prints the phase's entries of the
smoke's `kernels` line as one JSON object. Exits 1 if a gate failed.
"""
import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

RANKS = 2


def _probe_rank(rank, init, queue) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, world_size=RANKS, rank=rank,
                            timeout=timedelta(seconds=120))
    dev = torch.device("cuda", 0)
    results = {}

    def attempt(name, fn):
        try:
            ok = bool(fn())
            results[name] = "taken" if ok else "wrong result"
        except Exception as e:  # the backend's refusal is what is probed
            results[name] = "refused: " + str(e).splitlines()[0][:160]

    for dtype in (torch.float32, torch.float64, torch.int32, torch.int64):
        for op in ("SUM", "MAX"):
            def reduce(dtype=dtype, op=op):
                x = torch.full((5,), rank + 1, dtype=dtype, device=dev)
                dist.all_reduce(x, op=getattr(dist.ReduceOp, op))
                want = 3 if op == "SUM" else 2
                return bool((x == want).all())
            attempt(f"all_reduce {op} {str(dtype).removeprefix('torch.')}", reduce)

    def gather():
        x = torch.full((3,), float(rank), device=dev)
        parts = [torch.empty_like(x) for _ in range(RANKS)]
        dist.all_gather(parts, x)
        return all(bool((p == r).all()) for r, p in enumerate(parts))

    attempt("all_gather", gather)
    queue.put((rank, results))
    dist.barrier()
    dist.destroy_process_group()


def probe_collectives() -> dict:
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as directory:
        init = f"file://{os.path.join(directory, 'store')}"
        procs = [ctx.Process(target=_probe_rank, args=(r, init, queue)) for r in range(RANKS)]
        for p in procs:
            p.start()
        out = dict(queue.get(timeout=300) for _ in procs)
        for p in procs:
            p.join(timeout=60)
    for name, verdict in out[0].items():
        cs.log(f"gloo on CUDA tensors, {name}: {verdict} (rank 1: {out[1][name]})")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--skip-phase", action="store_true")
    args = parser.parse_args()

    t_start = time.perf_counter()
    cs.device_phase()
    probe_collectives()
    if args.skip_phase:
        return 0
    import octofitter_tpu_torch as ot
    from octofitter_tpu_torch.orbits import elements
    from octofitter_tpu_torch.orbits.kernels import kepler as kk
    from octofitter_tpu_torch.orbits.kernels import orbit_solve as osk
    from octofitter_tpu_torch.rv import celerite_cuda as cc

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_phase([kk.SOURCE, osk.SOURCE, cc.SOURCE])
    try:
        model = cs.build_model(ot, cs.bench_table(ot), device="cuda", dtype=torch.float32)
        t0 = time.perf_counter()
        model.initialize(torch.Generator(device="cuda").manual_seed(0), verbosity=0)
        cs.log(f"headline initialize {time.perf_counter() - t0:.2f} s")
        state = {"starting_points": model.starting_points.cpu(),
                 "laplace_sigma": model.laplace_sigma.cpu()}
        pa = cs.build_model(ot, cs.bench_table(ot, *cs.PA_SPAN), name="bench_partial_arc",
                            device="cuda", dtype=torch.float32)
        pa.initialize(torch.Generator(device="cuda").manual_seed(0), verbosity=0)
        with tempfile.TemporaryDirectory() as directory:
            state["pa_init"] = os.path.join(directory, "pa_init.pt")
            cs.save_init(pa, state["pa_init"])
            res = cs._portable(cs.parallel_phase(ot, kk, osk, state))
        cs.parallel_kernel_step(osk, elements, res)
        kernels = [{"name": n} for n in ("kepler_solve", "orbit_solve_fwd", "orbit_solve_bwd")]
        cs.parallel_kernel_keys(kernels, res)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    cs.log(f"parallel probe: {time.perf_counter() - t_start:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
