"""ctypes wrappers of the celerite CUDA kernels (`csrc/celerite.cu`), and
the autograd Function that joins them.

`celerite_loglike_cuda(a, b, c, d, t, y, var)` gives the celerite
log-likelihood of B rows in one forward launch and, in the backward pass,
its gradients with respect to a, b, c, d, y and var in one backward launch.
Both run on PyTorch's current stream for CUDA tensors and raise for
anything else: they have no CPU path and no fallback. Their plain PyTorch
version is `celerite.py:_celerite_plain`, which `celerite_loglike` runs for
CPU tensors.

`launches_fwd` and `launches_bwd` count each kernel's launches in this
process, and `launch_shapes` the forward's by (B, n, J); a run resets them
to 0 and reads them afterwards to show that its path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from ..orbits.kernels.build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "celerite.cu"
MAX_TERMS = 4  # J of the kernel's instantiations: 1 to 4 terms
launches_fwd = 0
launches_bwd = 0
launch_shapes: dict[tuple, int] = {}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@functools.cache
def _entry_points() -> dict:
    lib = load_library(SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    out = {}
    for dtype, suffix in _SUFFIX.items():
        fwd = getattr(lib, f"celerite_fwd_{suffix}")
        fwd.argtypes = [ptr] * 9 + [ctypes.c_int, i64, i64, ptr]
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"celerite_bwd_{suffix}")
        bwd.argtypes = [ptr] * 14 + [ctypes.c_int, i64, i64, ptr]
        bwd.restype = ctypes.c_int
        out[dtype] = (fwd, bwd)
    return out


def saved_fields(J: int) -> int:
    """Values the forward saves per epoch and row: D, z, W (2J), f (2J)
    and the packed symmetric P (2J (2J + 1) / 2)."""
    m = 2 * J
    return 2 + 2 * m + m * (m + 1) // 2


def _check(name, x, like, shape):
    if x.device != like.device or x.dtype != like.dtype:
        raise ValueError(f"celerite: {name} is {x.dtype} on {x.device}, expected "
                         f"{like.dtype} on {like.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"celerite: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"celerite: {name} is not contiguous")


def _check_inputs(a, b, c, d, t):
    if a.device.type != "cuda":
        raise ValueError(f"the celerite kernels need CUDA tensors, got a on {a.device}")
    if a.dtype not in _SUFFIX:
        raise TypeError(f"the celerite kernels take float32 or float64, got {a.dtype}")
    if a.ndim != 2 or not 1 <= a.shape[1] <= MAX_TERMS:
        raise ValueError(f"celerite: a has shape {tuple(a.shape)}, expected (B, J) with "
                         f"1 <= J <= {MAX_TERMS}")
    if t.ndim != 1 or t.shape[0] < 1:
        raise ValueError(f"celerite: t has shape {tuple(t.shape)}, expected (n,) with n >= 1")
    for name, x in (("a", a), ("b", b), ("c", c), ("d", d)):
        _check(name, x, a, a.shape)
    _check("t", t, a, t.shape)
    return a.shape[0], a.shape[1], t.shape[0]


def celerite_forward_cuda(a, b, c, d, t, y, var, save: bool):
    """(ll, saved): the log-likelihood of every row, (B,), and, if `save`,
    the (n, F, B) array the backward reads (else None). a, b, c, d:
    contiguous (B, J) CUDA tensors; t: (n,); y, var: (B, n)."""
    global launches_fwd
    B, J, n = _check_inputs(a, b, c, d, t)
    _check("y", y, a, (B, n))
    _check("var", var, a, (B, n))
    fwd, _ = _entry_points()[a.dtype]
    ll = torch.empty((B,), dtype=a.dtype, device=a.device)
    saved = (torch.empty((n, saved_fields(J), B), dtype=a.dtype, device=a.device)
             if save else None)
    if B == 0:
        return ll, saved
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fwd(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), t.data_ptr(),
                  y.data_ptr(), var.data_ptr(), ll.data_ptr(),
                  saved.data_ptr() if save else None, J, B, n, stream)
    if err != 0:
        raise RuntimeError(f"celerite forward launch failed with CUDA error {err}")
    launches_fwd += 1
    launch_shapes[(B, n, J)] = launch_shapes.get((B, n, J), 0) + 1
    return ll, saved


def celerite_backward_cuda(a, b, c, d, t, saved, ll, gll):
    """Gradients of sum(gll * ll) with respect to a, b, c, d ((B, J) each),
    y and var ((B, n) each), from the forward's `saved` array and `ll`;
    zero in the rows whose ll is -inf."""
    global launches_bwd
    B, J, n = _check_inputs(a, b, c, d, t)
    _check("saved", saved, a, (n, saved_fields(J), B))
    _check("ll", ll, a, (B,))
    _check("gll", gll, a, (B,))
    _, bwd = _entry_points()[a.dtype]
    grads = [torch.empty_like(a) for _ in range(4)]
    grads += [torch.empty((B, n), dtype=a.dtype, device=a.device) for _ in range(2)]
    if B == 0:
        return tuple(grads)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = bwd(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), t.data_ptr(),
                  saved.data_ptr(), ll.data_ptr(), gll.data_ptr(),
                  *(g.data_ptr() for g in grads), J, B, n, stream)
    if err != 0:
        raise RuntimeError(f"celerite backward launch failed with CUDA error {err}")
    launches_bwd += 1
    return tuple(grads)


class _CeleriteLoglike(torch.autograd.Function):
    """ll = celerite log-likelihood of (a, b, c, d, t, y, var): the forward
    kernel, and the backward kernel for the gradient; first derivatives
    only."""

    @staticmethod
    def forward(ctx, a, b, c, d, t, y, var, save):
        ll, saved = celerite_forward_cuda(a, b, c, d, t, y, var, save)
        if save:
            ctx.save_for_backward(a, b, c, d, t, saved, ll)
        return ll

    @staticmethod
    @once_differentiable
    def backward(ctx, gll):
        a, b, c, d, t, saved, ll = ctx.saved_tensors
        ga, gb, gc, gd, gy, gvar = celerite_backward_cuda(a, b, c, d, t, saved, ll,
                                                          gll.contiguous())
        return ga, gb, gc, gd, None, gy, gvar, None


def celerite_loglike_cuda(a, b, c, d, t, y, var):
    """The celerite log-likelihood of every row on the GPU, differentiable
    once in every argument but the epochs: a, b, c, d (B, J), t (n,)
    relative epochs, y and var (B, n), all CUDA tensors of one dtype."""
    if t.requires_grad:
        raise ValueError("the celerite kernels have no gradient with respect to the epochs; "
                         "use celerite_loglike(..., fused=False)")
    inputs = [x.contiguous() for x in (a, b, c, d, t, y, var)]
    save = torch.is_grad_enabled() and any(x.requires_grad for x in inputs)
    return _CeleriteLoglike.apply(*inputs, save)
