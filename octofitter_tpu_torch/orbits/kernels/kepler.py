"""ctypes wrapper of the hand-written CUDA Kepler kernel (`csrc/kepler.cu`).

`kepler_solve_cuda(M, e)` launches the kernel on PyTorch's current
stream for CUDA tensors and raises for anything else: it has no CPU path
and no fallback. Its plain PyTorch twin is `orbits/kepler.py:_markley`,
which `kepler_solver` calls for CPU tensors.

`launches` counts the kernel's launches in this process; a run resets it
to 0 and reads it afterwards to show that its path went through the
kernel. `launch_shapes` counts the same launches by the shape of M, so
that a run can hold the kernel against its twin at the shapes its path
really gave it; a run clears it where it resets `launches`.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "kepler.cu"
launches = 0
launch_shapes: dict[tuple, int] = {}

_ENTRY = {torch.float32: "kepler_solve_f32", torch.float64: "kepler_solve_f64"}


@functools.cache
def _entry_points() -> dict:
    lib = load_library(SOURCE)
    out = {}
    for dtype, name in _ENTRY.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[dtype] = fn
    return out


def kepler_solve_cuda(M: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Solve E - e sin E = M elementwise on the GPU.

    M and e: contiguous CUDA tensors of one shape, float32 or float64,
    on one device. Returns E with M's shape and dtype."""
    global launches
    if M.device.type != "cuda" or e.device != M.device:
        raise ValueError(
            f"kepler_solve_cuda needs M and e on one CUDA device, got "
            f"{M.device} and {e.device}"
        )
    if M.dtype not in _ENTRY or e.dtype != M.dtype:
        raise TypeError(f"kepler_solve_cuda takes float32 or float64, got {M.dtype}, {e.dtype}")
    if M.shape != e.shape:
        raise ValueError(f"shape mismatch {tuple(M.shape)} vs {tuple(e.shape)}")
    if not (M.is_contiguous() and e.is_contiguous()):
        raise ValueError("kepler_solve_cuda needs contiguous tensors")
    fn = _entry_points()[M.dtype]
    E = torch.empty_like(M)
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        err = fn(M.data_ptr(), e.data_ptr(), E.data_ptr(), M.numel(), stream)
    if err != 0:
        raise RuntimeError(f"Kepler kernel launch failed with CUDA error {err}")
    launches += 1
    launch_shapes[tuple(M.shape)] = launch_shapes.get(tuple(M.shape), 0) + 1
    return E
