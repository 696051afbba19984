"""ctypes wrappers of the fused orbit-solve CUDA kernels (`csrc/orbit_solve.cu`).

`orbit_solve_forward_cuda(elems, t)` turns Campbell elements of B chains
(rows a, e, i, omega, Omega, tp, M, plx of an (8, B) tensor) and T epochs
into every `OrbitSolution` field, an (14, B, T) tensor, in one launch;
`orbit_solve_backward_cuda` turns a cotangent of that tensor into the
gradient with respect to the elements, (8, B), in one launch. Both run on
PyTorch's current stream for CUDA tensors and raise for anything else:
they have no CPU path and no fallback. Their plain PyTorch versions are
`orbits/elements.py:_kep_visual_fields` and `_orbit_solve_backward_plain`,
which `orbitsolve` runs for CPU tensors.

`launches_fwd` and `launches_bwd` count each kernel's launches in this
process; a run resets them to 0 and reads them afterwards to show that
its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ...constants import AUDAY_TO_MS, JULIAN_YEAR_DAYS, KEPLER_YEAR_DAYS
from .build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "orbit_solve.cu"
N_ELEMS, N_FIELDS = 8, 14
launches_fwd = 0
launches_bwd = 0

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_UNITS = (KEPLER_YEAR_DAYS, JULIAN_YEAR_DAYS, AUDAY_TO_MS)
_UNIT_TYPES = [ctypes.c_double] * 3


@functools.cache
def _entry_points() -> dict:
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    out = {}
    for dtype, suffix in _SUFFIX.items():
        fwd = getattr(lib, f"orbit_solve_fwd_{suffix}")
        fwd.argtypes = [ptr, ptr, ptr, i64, i64, *_UNIT_TYPES, ptr]
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"orbit_solve_bwd_{suffix}")
        bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, ctypes.c_int, *_UNIT_TYPES, ptr]
        bwd.restype = ctypes.c_int
        out[dtype] = (fwd, bwd)
    return out


def _check(name, x, like, shape):
    """`x` must be a contiguous tensor of `shape` on `like`'s CUDA device
    with `like`'s dtype."""
    if x.device != like.device or x.dtype != like.dtype:
        raise ValueError(
            f"orbit_solve: {name} is {x.dtype} on {x.device}, expected "
            f"{like.dtype} on {like.device}"
        )
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"orbit_solve: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"orbit_solve: {name} is not contiguous")


def _check_inputs(elems, t):
    if elems.device.type != "cuda":
        raise ValueError(f"orbit_solve needs CUDA tensors, got elems on {elems.device}")
    if elems.dtype not in _SUFFIX:
        raise TypeError(f"orbit_solve takes float32 or float64, got {elems.dtype}")
    if elems.ndim != 2 or elems.shape[0] != N_ELEMS:
        raise ValueError(f"orbit_solve: elems has shape {tuple(elems.shape)}, expected (8, B)")
    if t.ndim != 1:
        raise ValueError(f"orbit_solve: t has shape {tuple(t.shape)}, expected (T,)")
    _check("elems", elems, elems, elems.shape)
    _check("t", t, elems, t.shape)
    return elems.shape[1], t.shape[0]


def orbit_solve_forward_cuda(elems: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Every solution field of B orbits at T epochs on the GPU.

    elems: contiguous (8, B) CUDA tensor, float32 or float64; t: contiguous
    (T,) tensor of the same dtype and device. Returns a (14, B, T) tensor."""
    global launches_fwd
    B, T = _check_inputs(elems, t)
    fwd, _ = _entry_points()[elems.dtype]
    out = torch.empty((N_FIELDS, B, T), dtype=elems.dtype, device=elems.device)
    with torch.cuda.device(elems.device):
        stream = torch.cuda.current_stream(elems.device).cuda_stream
        err = fwd(elems.data_ptr(), t.data_ptr(), out.data_ptr(), B, T, *_UNITS, stream)
    if err != 0:
        raise RuntimeError(f"orbit_solve forward launch failed with CUDA error {err}")
    launches_fwd += 1
    return out


def orbit_solve_backward_cuda(elems: torch.Tensor, t: torch.Tensor, EA: torch.Tensor,
                              g: torch.Tensor, has_plx: bool) -> torch.Tensor:
    """Gradient with respect to `elems` of sum(g * forward(elems, t)).

    EA: the forward's field 0, contiguous (B, T); g: contiguous (14, B, T).
    With `has_plx` false (the plx row is NaN) the four sky fields do not
    contribute. Returns an (8, B) tensor. Sums over epochs in a fixed order:
    the same inputs give the same bits."""
    global launches_bwd
    B, T = _check_inputs(elems, t)
    _check("EA", EA, elems, (B, T))
    _check("g", g, elems, (N_FIELDS, B, T))
    _, bwd = _entry_points()[elems.dtype]
    gelems = torch.empty((N_ELEMS, B), dtype=elems.dtype, device=elems.device)
    with torch.cuda.device(elems.device):
        stream = torch.cuda.current_stream(elems.device).cuda_stream
        err = bwd(elems.data_ptr(), t.data_ptr(), EA.data_ptr(), g.data_ptr(),
                  gelems.data_ptr(), B, T, int(bool(has_plx)), *_UNITS, stream)
    if err != 0:
        raise RuntimeError(f"orbit_solve backward launch failed with CUDA error {err}")
    launches_bwd += 1
    return gelems
