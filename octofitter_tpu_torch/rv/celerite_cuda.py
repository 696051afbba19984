"""ctypes wrappers of the celerite CUDA kernels (`csrc/celerite.cu`, with
the step arithmetic in `csrc/celerite.cuh`), and the autograd Function
that joins them.

`celerite_loglike_cuda(a, b, c, d, t, y, var)` gives the celerite
log-likelihood of B rows in one forward launch and, in the backward pass,
its gradients with respect to a, b, c, d, y and var in one backward launch.
Both run on PyTorch's current stream for CUDA tensors and raise for
anything else: they have no CPU path and no fallback. Their plain PyTorch
version is `celerite.py:_celerite_plain`, which `celerite_loglike` runs for
CPU tensors.

The kernels walk the epochs in chunks of C (`chunk_epochs`). When a
gradient is wanted the forward writes a checkpoint of each row's state
after every chunk but the last (`checkpoint_shape`; none where n <= C), and
the backward recomputes each chunk from it instead of reading a saved
array.

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
# epochs per chunk by dtype and J: a whole number of 16-byte copies; long
# where rows are few (the kernels are latency-bound there, and each chunk
# costs two block barriers), short from MANY_ROWS rows on, so that tiles of
# up to 128 rows fit the backward's shared memory (its chunk's inputs twice,
# terms, and per-epoch D, z, W, f and packed P) several times per SM. The
# forward and the backward both read C from here, so a checkpoint is always
# read with the chunk length it was written with.
MANY_ROWS = 16384
_CHUNK = {torch.float32: {1: 32, 2: 16, 3: 8, 4: 8},
          torch.float64: {1: 16, 2: 8, 3: 8, 4: 4}}
_CHUNK_MANY = {torch.float32: {1: 8, 2: 4, 3: 4, 4: 4},
               torch.float64: {1: 4, 2: 2, 3: 2, 4: 2}}


@functools.cache
def _library():
    lib = load_library(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for suffix in _SUFFIX.values():
        fwd = getattr(lib, f"celerite_fwd_{suffix}")
        fwd.argtypes = [ptr] * 9 + [i32, i64, i64, i32, ptr]
        fwd.restype = i32
        bwd = getattr(lib, f"celerite_bwd_{suffix}")
        bwd.argtypes = [ptr] * 16 + [i32, i64, i64, i32, ptr]
        bwd.restype = i32
    lib.celerite_occupancy.argtypes = [i32] * 4 + [i64, ctypes.POINTER(i32)]
    lib.celerite_occupancy.restype = i32
    return lib


def _entry_points(dtype):
    lib = _library()
    return getattr(lib, f"celerite_fwd_{_SUFFIX[dtype]}"), getattr(lib, f"celerite_bwd_{_SUFFIX[dtype]}")


def chunk_epochs(J: int, dtype, B: int) -> int:
    """The kernels' chunk length C, in epochs, for B rows of J terms."""
    return (_CHUNK_MANY if B >= MANY_ROWS else _CHUNK)[dtype][J]


def checkpoint_words(J: int) -> int:
    """Values in one checkpoint of a row's state: the packed symmetric S
    (2J (2J + 1) / 2), W (2J), f (2J), D and z."""
    m = 2 * J
    return m * (m + 1) // 2 + 2 * m + 2


def checkpoint_shape(B: int, n: int, J: int, chunk: int) -> tuple[int, int, int]:
    """Shape of the forward's checkpoints: one record of
    `checkpoint_words(J)` per row after every chunk of `chunk` epochs but
    the last, laid out (records, words, B); no record where n <= chunk."""
    return (-(-n // chunk) - 1, checkpoint_words(J), B)


def occupancy(B: int, J: int, dtype, backward: bool) -> dict:
    """How a kernel launches for B rows on the current card: rows and
    threads per block, shared memory per block, resident blocks per SM, and
    the chunk length."""
    chunk = chunk_epochs(J, dtype, B)
    out = (ctypes.c_int * 4)()
    err = _library().celerite_occupancy(J, torch.finfo(dtype).bits // 8, int(backward), chunk, B,
                                        out)
    if err != 0:
        raise RuntimeError(f"celerite occupancy query failed with CUDA error {err}")
    return {"rows_per_block": out[0], "threads_per_block": out[1], "smem_bytes": out[2],
            "blocks_per_sm": out[3], "chunk": chunk}


def _check(name, x, like, shape):
    if x.device != like.device or x.dtype != like.dtype:
        raise ValueError(f"celerite: {name} is {x.dtype} on {x.device}, expected "
                         f"{like.dtype} on {like.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"celerite: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"celerite: {name} is not contiguous")


def _check_inputs(a, b, c, d, t, y, var):
    if a.device.type != "cuda":
        raise ValueError(f"the celerite kernels need CUDA tensors, got a on {a.device}")
    if a.dtype not in _SUFFIX:
        raise TypeError(f"the celerite kernels take float32 or float64, got {a.dtype}")
    if a.ndim != 2 or not 1 <= a.shape[1] <= MAX_TERMS:
        raise ValueError(f"celerite: a has shape {tuple(a.shape)}, expected (B, J) with "
                         f"1 <= J <= {MAX_TERMS}")
    if t.ndim != 1 or t.shape[0] < 1:
        raise ValueError(f"celerite: t has shape {tuple(t.shape)}, expected (n,) with n >= 1")
    B, J, n = a.shape[0], a.shape[1], t.shape[0]
    for name, x in (("a", a), ("b", b), ("c", c), ("d", d)):
        _check(name, x, a, a.shape)
    _check("t", t, a, t.shape)
    _check("y", y, a, (B, n))
    _check("var", var, a, (B, n))
    chunk = chunk_epochs(J, a.dtype, B)
    if chunk <= 0 or (chunk * a.element_size()) % 16:
        raise ValueError(f"celerite: a chunk of {chunk} epochs is not a positive whole number "
                         f"of 16-byte copies of {a.dtype}")
    return B, J, n, chunk


def celerite_forward_cuda(a, b, c, d, t, y, var, save: bool):
    """(ll, ckpt): the log-likelihood of every row, (B,), and, if `save`,
    the checkpoints the backward reads (`checkpoint_shape` at
    `chunk_epochs`, else None). a, b, c, d: contiguous (B, J) CUDA tensors;
    t: (n,); y, var: (B, n)."""
    global launches_fwd
    B, J, n, chunk = _check_inputs(a, b, c, d, t, y, var)
    fwd, _ = _entry_points(a.dtype)
    ll = torch.empty((B,), dtype=a.dtype, device=a.device)
    ckpt = (torch.empty(checkpoint_shape(B, n, J, chunk), dtype=a.dtype, device=a.device)
            if save else None)
    if B == 0:
        return ll, ckpt
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fwd(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), t.data_ptr(),
                  y.data_ptr(), var.data_ptr(), ll.data_ptr(),
                  ckpt.data_ptr() if save and ckpt.numel() else None, J, B, n, chunk, stream)
    if err != 0:
        raise RuntimeError(f"celerite forward launch failed with CUDA error {err}")
    launches_fwd += 1
    launch_shapes[(B, n, J)] = launch_shapes.get((B, n, J), 0) + 1
    return ll, ckpt


def celerite_backward_cuda(a, b, c, d, t, y, var, ckpt, ll, gll):
    """Gradients of sum(gll * ll) with respect to a, b, c, d ((B, J) each),
    y and var ((B, n) each), from the forward's inputs, its checkpoints
    `ckpt` and `ll`; zero in the rows whose ll is -inf."""
    global launches_bwd
    B, J, n, chunk = _check_inputs(a, b, c, d, t, y, var)
    _check("ckpt", ckpt, a, checkpoint_shape(B, n, J, chunk))
    _check("ll", ll, a, (B,))
    _check("gll", gll, a, (B,))
    _, bwd = _entry_points(a.dtype)
    grads = [torch.empty_like(a) for _ in range(4)]
    grads += [torch.empty((B, n), dtype=a.dtype, device=a.device) for _ in range(2)]
    if B == 0:
        return tuple(grads)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = bwd(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), t.data_ptr(),
                  y.data_ptr(), var.data_ptr(), ckpt.data_ptr() if ckpt.numel() else None,
                  ll.data_ptr(), gll.data_ptr(), *(g.data_ptr() for g in grads), J, B, n, chunk,
                  stream)
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
        ll, ckpt = celerite_forward_cuda(a, b, c, d, t, y, var, save)
        if save:
            ctx.save_for_backward(a, b, c, d, t, y, var, ckpt, ll)
        return ll

    @staticmethod
    @once_differentiable
    def backward(ctx, gll):
        a, b, c, d, t, y, var, ckpt, ll = ctx.saved_tensors
        ga, gb, gc, gd, gy, gvar = celerite_backward_cuda(a, b, c, d, t, y, var, ckpt, ll,
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
