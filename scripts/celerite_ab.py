#!/usr/bin/env python3
"""Time the celerite kernel pair against the design it replaced, on one GPU.

    python3 scripts/celerite_ab.py --parent PATH [--chunks 4,8,16,32,64]
        [--out FILE]

PATH is a `celerite.cu` of the design that saved an (n, F, B) array for the
backward (`celerite_fwd_f32(a, b, c, d, t, y, var, ll, save, J, B, n,
stream)`, `celerite_bwd_f32(a, b, c, d, t, save, ll, gll, ga, gb, gc, gd,
gy, gvar, J, B, n, stream)`), for example `git show
3f6eeb5:octofitter_tpu_torch/rv/csrc/celerite.cu` put in a git-ignored
directory. It is built like this package's sources.

At each of `chip_smoke.CEL_SHAPES`, in float32 on the smoke's inputs: both
pairs held to each other (ll and gradients), then timed in turns (earlier,
current, current, earlier) by CUDA events over back-to-back launches, and
each kernel's own device time per launch read from `torch.profiler`'s CUDA
kernel events, beside the bound (`chip_smoke.celerite_bound`). The plain
version's and the dense library route's times on the same inputs are
`chip_smoke.py`'s celerite phase: run both in one call to set them side
by side. Then the current pair at every shape, in float32 and float64, at
every chunk length in --chunks that fits (the chunk tables of
`celerite_cuda` set for that run), with each kernel's tile rows, shared
memory and resident blocks per SM. Prints one line per measurement and,
with --out, writes everything there as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _parent_pair(path: Path):
    """(fwd, bwd) of the earlier source, as Python callables on tensors."""
    from octofitter_tpu_torch.orbits.kernels.build import build
    from octofitter_tpu_torch.rv.celerite_cuda import checkpoint_words

    lib_path, nvcc_log = build(path)
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas (earlier): {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.celerite_fwd_f32.argtypes = [ptr] * 9 + [i32, i64, i64, ptr]
    lib.celerite_bwd_f32.argtypes = [ptr] * 14 + [i32, i64, i64, ptr]

    def fwd(coefs, t, y, var):
        B, J = coefs[0].shape
        ll = torch.empty(B, dtype=y.dtype, device=y.device)
        # the earlier design's per-epoch record had as many words as one
        # checkpoint: D, z, W, f and the packed P
        saved = torch.empty((t.shape[0], checkpoint_words(J), B), dtype=y.dtype, device=y.device)
        err = lib.celerite_fwd_f32(*(x.data_ptr() for x in (*coefs, t, y, var, ll, saved)), J, B,
                                   t.shape[0], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier forward failed with CUDA error {err}")
        return ll, saved

    def bwd(coefs, t, saved, ll, gll):
        B, J = coefs[0].shape
        grads = [torch.empty_like(coefs[0]) for _ in range(4)]
        grads += [torch.empty((B, t.shape[0]), dtype=ll.dtype, device=ll.device) for _ in range(2)]
        err = lib.celerite_bwd_f32(*(x.data_ptr() for x in (*coefs, t, saved, ll, gll, *grads)), J,
                                   B, t.shape[0], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier backward failed with CUDA error {err}")
        return grads

    return fwd, bwd


def parent_rows(cc, pfwd, pbwd) -> dict:
    """The earlier pair against the current one at every CEL_SHAPES shape."""
    f32 = torch.float32
    out = {}
    for B, n, J in cs.CEL_SHAPES:
        label = cs._cel_label(B, n, J)
        coefs, t, y, var, gll = cs._cel_inputs(B, n, J, f32)
        ll_n, ck = cc.celerite_forward_cuda(*coefs, t, y, var, save=True)
        g_n = cc.celerite_backward_cuda(*coefs, t, y, var, ck, ll_n, gll)
        ll_p, saved = pfwd(coefs, t, y, var)
        g_p = pbwd(coefs, t, saved, ll_p, gll)
        if not torch.equal(torch.isfinite(ll_p), torch.isfinite(ll_n)):
            raise AssertionError(f"{label}: the two pairs' -inf rows differ")
        ll_err, g_err, _ = cs._cel_check(label, f32, (ll_n, g_n), (ll_p, g_p))
        fns = {"parent_fwd": lambda: pfwd(coefs, t, y, var),
               "fwd": lambda: cc.celerite_forward_cuda(*coefs, t, y, var, save=True),
               "parent_bwd": lambda: pbwd(coefs, t, saved, ll_p, gll),
               "bwd": lambda: cc.celerite_backward_cuda(*coefs, t, y, var, ck, ll_n, gll)}
        times = {k: [] for k in fns}
        for part in ("fwd", "bwd"):
            for key in (f"parent_{part}", part, part, f"parent_{part}"):
                times[key].append(cs._time_ms(fns[key], 50))
        dev = {"parent": cs._kernel_device_us(lambda: (fns["parent_fwd"](), fns["parent_bwd"]())),
               "new": cs._kernel_device_us(lambda: (fns["fwd"](), fns["bwd"]()))}
        row = {"B": B, "n": n, "J": J, "ll_diff": ll_err, "grad_diff": g_err, "runs": times,
               "device_us": dev}
        for part in ("fwd", "bwd"):
            bnd = cs.celerite_bound(B, n, J, part)
            row[part], row[f"parent_{part}"] = min(times[part]), min(times[f"parent_{part}"])
            row[f"bound_{part}"], row[f"bound_by_{part}"] = bnd
            print(f"{label} {part}: current {row[part]:.4f} ms (device "
                  f"{dev['new'].get(part, float('nan')):.2f} us), earlier "
                  f"{row[f'parent_{part}']:.4f} ms (device "
                  f"{dev['parent'].get(part, float('nan')):.2f} us), bound {bnd[0]:.5f} "
                  f"({bnd[1]}); runs {times[f'parent_{part}'][0]:.4f} {times[part][0]:.4f} "
                  f"{times[part][1]:.4f} {times[f'parent_{part}'][1]:.4f}", flush=True)
        print(f"{label}: the pairs differ by ll {ll_err:.3e}, gradient {g_err:.3e}", flush=True)
        out[label] = row
        del saved, ck
        torch.cuda.empty_cache()
    return out


def chunk_rows(cc, chunks) -> dict:
    """The current pair at every shape, dtype and chunk length, with that
    length set in both of `celerite_cuda`'s chunk tables for the run."""
    out = {}
    tables = (cc._CHUNK, cc._CHUNK_MANY)
    for dtype in (torch.float32, torch.float64):
        for B, n, J in cs.CEL_SHAPES:
            kept = [table[dtype][J] for table in tables]
            label = f"{cs._cel_label(B, n, J)} {str(dtype)[6:]}"
            coefs, t, y, var, gll = cs._cel_inputs(B, n, J, dtype)
            default = cc.chunk_epochs(J, dtype, B)
            for chunk in chunks:
                if (chunk * torch.finfo(dtype).bits // 8) % 16:
                    continue
                cc._CHUNK[dtype][J] = cc._CHUNK_MANY[dtype][J] = chunk
                try:
                    occ = {p: cc.occupancy(B, J, dtype, p == "bwd") for p in ("fwd", "bwd")}
                except RuntimeError as e:  # more shared memory than a block may have
                    print(f"{label} C={chunk}: does not launch ({e})", flush=True)
                    continue
                ll, ck = cc.celerite_forward_cuda(*coefs, t, y, var, True)
                ev = {"fwd": cs._time_ms(lambda: cc.celerite_forward_cuda(*coefs, t, y, var, True),
                                         50),
                      "bwd": cs._time_ms(lambda: cc.celerite_backward_cuda(*coefs, t, y, var, ck,
                                                                           ll, gll), 50)}
                dev = cs._kernel_device_us(lambda: cc.celerite_backward_cuda(
                    *coefs, t, y, var, cc.celerite_forward_cuda(*coefs, t, y, var, True)[1], ll,
                    gll))
                out[f"{label} C={chunk}"] = {"ms": ev, "device_us": dev, "occupancy": occ,
                                             "default": chunk == default}
                print(f"{label} C={chunk}{' (default)' if chunk == default else ''}: " + ", ".join(
                    f"{p} {ev[p]:.4f} ms ({dev.get(p, float('nan')):.2f} us; "
                    f"{occ[p]['rows_per_block']} rows, {occ[p]['smem_bytes']} B, "
                    f"{occ[p]['blocks_per_sm']} blocks/SM)" for p in ("fwd", "bwd")), flush=True)
            for table, c in zip(tables, kept):
                table[dtype][J] = c
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--chunks", default="4,8,16,32,64")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    name, smi = cs.device_phase()
    from octofitter_tpu_torch.rv import celerite_cuda as cc

    cs.build_phase([cc.SOURCE])
    res = {"device": name, "nvidia_smi": smi, "shapes": parent_rows(cc, *_parent_pair(args.parent))}
    res["chunks"] = chunk_rows(cc, [int(c) for c in args.chunks.split(",")])
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
        print(f"wrote {args.out}")
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
