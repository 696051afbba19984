"""Tracing and timing hooks.

PyTorch port of `octofitter_tpu/utils/profiling.py`: `profile_trace`
records a `torch.profiler` trace of a block (host operators, and the
card's kernels where the build supports CUDA) and writes it as a Chrome
trace (open it in Perfetto or chrome://tracing); `timing_probe` times a
callable's first call apart from its steady state.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Record a `torch.profiler` trace of the block into `log_dir`, as
    `trace_rank<r>_pid<p>.json` (r the `torch.distributed` rank, 0 outside
    a process group), written when the block ends, also by an exception.
    Records CPU operators, and CUDA kernels when this build of torch
    supports them. Yields the profiler.

    Usage:
        with profile_trace("/tmp/prof"):
            chain = octofit(model, ...)
    """
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    os.makedirs(log_dir, exist_ok=True)
    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    path = os.path.join(log_dir, f"trace_rank{rank}_pid{os.getpid()}.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(path)


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timing_probe(fn, *args, n_iter: int = 10):
    """First-call and steady-state timing of `fn(*args)`.

    Returns dict(compile_s, exec_s, per_iter_s): compile_s is the first
    call (eager torch has no compile step; the first call pays for lazy
    set-up: kernel libraries built or loaded, allocator growth), exec_s
    the n_iter calls after it and per_iter_s their mean. The device is
    synchronized before and after each timed span."""
    _synchronize()
    t0 = time.perf_counter()
    fn(*args)
    _synchronize()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_iter):
        fn(*args)
    _synchronize()
    exec_s = time.perf_counter() - t0
    return {
        "compile_s": compile_s,
        "exec_s": exec_s,
        "per_iter_s": exec_s / n_iter,
    }
