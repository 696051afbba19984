"""Kepler-equation solvers.

PyTorch port of `octofitter_tpu/orbits/kepler.py`. The elliptic solve
`kepler_solver` is a `torch.autograd.Function`: its forward pass
launches the hand-written CUDA kernel (`kernels/csrc/kepler.cu`) for a
CUDA tensor and runs the plain twin `_markley` for a CPU tensor; its
backward (and forward-mode jvp) pass is the implicit derivative of
E - e sin E = M,

    dE = (dM + sin E de) / (1 - e cos E),

in plain torch, so the gradient never differentiates the solver body.
"""

from __future__ import annotations

import math

import torch

from .kernels.kepler import kepler_solve_cuda

_PI = math.pi
_PI2 = math.pi * math.pi


def _markley(M, e):
    """Plain PyTorch twin of the CUDA kernel: reduce M to [-pi, pi), run
    the Markley (1995) starter + 5th-order refinement + one Newton polish
    on |M|, restore the sign and the 2 pi offset."""
    Mr = torch.remainder(M + _PI, 2 * _PI) - _PI  # floor-mod, as jnp.mod
    offset = M - Mr
    sgn = torch.where(Mr < 0, -1.0, 1.0).to(M.dtype)
    M = torch.abs(Mr)

    alpha = (3 * _PI2 + 1.6 * _PI * (_PI - M) / (1 + e)) / (_PI2 - 6)
    d = 3 * (1 - e) + alpha * e
    q = 2 * alpha * d * (1 - e) - M * M
    r = 3 * alpha * d * (d - 1 + e) * M + M * M * M
    w = torch.pow(torch.abs(r) + torch.sqrt(q * q * q + r * r), 1.0 / 3.0) ** 2
    E1 = (2 * r * w / (w * w + w * q + q * q) + M) / d

    sE = torch.sin(E1)
    cE = torch.cos(E1)
    f0 = E1 - e * sE - M
    f1 = 1 - e * cE
    f2 = e * sE
    f3 = e * cE
    f4 = -f2
    d3 = -f0 / (f1 - f0 * f2 / (2 * f1))
    d4 = -f0 / (f1 + d3 * f2 / 2 + d3 * d3 * f3 / 6)
    d5 = -f0 / (f1 + d4 * f2 / 2 + d4 * d4 * f3 / 6 + d4 * d4 * d4 * f4 / 24)
    E = E1 + d5
    E = E - (E - e * torch.sin(E) - M) / (1 - e * torch.cos(E))
    return sgn * E + offset


class _KeplerSolve(torch.autograd.Function):
    """E(M, e) for same-shape M and e; see the module docstring."""

    @staticmethod
    def forward(M, e):
        if M.device.type == "cuda":
            return kepler_solve_cuda(M.contiguous(), e.contiguous())
        if M.device.type == "cpu":
            return _markley(M, e)
        raise ValueError(f"kepler_solver has no kernel for device {M.device}")

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, e = inputs
        ctx.save_for_backward(output, e)
        ctx.save_for_forward(output, e)

    @staticmethod
    def backward(ctx, gE):
        E, e = ctx.saved_tensors
        gM = gE / (1 - e * torch.cos(E))
        return gM, gM * torch.sin(E)

    @staticmethod
    def jvp(ctx, dM, de):
        E, e = ctx.saved_tensors
        num = torch.zeros_like(E) if dM is None else dM
        if de is not None:
            num = num + torch.sin(E) * de
        return num / (1 - e * torch.cos(E))

    @staticmethod
    def vmap(info, in_dims, M, e):
        # elementwise: put the batch dimension first on both and solve the
        # whole batch in one call (one kernel launch on the GPU)
        def batched(x, d):
            if d is None:
                return x.expand((info.batch_size,) + x.shape)
            return x.movedim(d, 0)

        M, e = batched(M, in_dims[0]), batched(e, in_dims[1])
        return _KeplerSolve.apply(M, e), 0


def _as_tensors(M, e, device):
    """(M, e) as tensors broadcast to one shape: numbers take the dtype and
    device of the other argument where it is a tensor, else float64 on
    `device`, which must then exist (the GPU by default)."""
    ref = M if isinstance(M, torch.Tensor) else e
    if isinstance(ref, torch.Tensor):
        dtype, device = ref.dtype, ref.device
    else:
        dtype, device = torch.float64, torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"kepler_solver was asked for device {device!s}, but no CUDA device is "
                "available; pass device=\"cpu\""
            )
    M = torch.as_tensor(M, dtype=dtype, device=device)
    e = torch.as_tensor(e, dtype=M.dtype, device=M.device)
    return torch.broadcast_tensors(M, e)


def kepler_solver(M, e, *, device="cuda"):
    """Solve E - e*sin(E) = M for eccentric anomaly E, elliptic case e<1.

    M and e broadcast; M may be any real value (reduced to [-pi, pi)
    internally) and E is continuous with M (E - M is periodic). Where
    neither is a tensor, the solve runs on `device`."""
    return _KeplerSolve.apply(*_as_tensors(M, e, device))


def _hyperbolic_newton(M, e):
    """Solve e*sinh(H) - H = M by guarded Newton (e > 1)."""
    absM = torch.abs(M)
    sgn = torch.where(M < 0, -1.0, 1.0).to(M.dtype)
    H = torch.log(2 * absM / e + 1.8)
    for _ in range(30):
        f = e * torch.sinh(H) - H - absM
        fp = e * torch.cosh(H) - 1
        H = H - f / fp
    return sgn * H


class _KeplerSolveHyperbolic(torch.autograd.Function):
    @staticmethod
    def forward(M, e):
        return _hyperbolic_newton(M, e)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, e = inputs
        ctx.save_for_backward(output, e)

    @staticmethod
    def backward(ctx, gH):
        H, e = ctx.saved_tensors
        gM = gH / (e * torch.cosh(H) - 1)
        return gM, -gM * torch.sinh(H)


def kepler_solver_hyperbolic(M, e, *, device="cuda"):
    """Solve e*sinh(H) - H = M for hyperbolic anomaly H (e > 1); where
    neither argument is a tensor, on `device`."""
    return _KeplerSolveHyperbolic.apply(*_as_tensors(M, e, device))
