"""Carry state across from a JAX `octofitter_tpu.LogDensityModel`.

The two packages flatten a model's parameters in the same order, so a
flat unconstrained vector from one is valid as it stands in the other.
`load_jax_state` takes the JAX model's initialization as numpy arrays
(this module imports no JAX) and sets it on a port model, so both
packages can start their samplers from the same points.
`load_jax_pt_checkpoint` reads a JAX `octofit_pigeons` checkpoint into
the port's resume state, so both packages can continue one tuned ladder.
`gp_kernel_from_jax` rebuilds a JAX Gaussian-process kernel or celerite
term in the port, so both packages can evaluate the same kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .model.logdensity import LogDensityModel


def load_jax_state(model: LogDensityModel, *, parameter_names, starting_points,
                   laplace_sigma, discrete_names=()) -> LogDensityModel:
    """Set `starting_points` ((n, D), unconstrained) and `laplace_sigma`
    ((D, D)) from a JAX model on `model`, after checking that both use
    the same flat parameter order and the same discrete variables (the
    JAX model's `discrete_names`). Returns `model`."""
    names = list(parameter_names)
    if names != list(model.parameter_names):
        raise ValueError(
            f"parameter order differs: JAX model {names}, "
            f"port model {model.parameter_names}"
        )
    if list(discrete_names) != list(model.discrete_names):
        raise ValueError(
            f"discrete variables differ: JAX model {list(discrete_names)}, "
            f"port model {model.discrete_names}"
        )
    pts = np.asarray(starting_points, dtype=np.float64)
    sigma = np.asarray(laplace_sigma, dtype=np.float64)
    D = model.D
    if pts.ndim != 2 or pts.shape[1] != D:
        raise ValueError(f"starting_points must be (n, {D}), got {pts.shape}")
    if sigma.shape != (D, D):
        raise ValueError(f"laplace_sigma must be ({D}, {D}), got {sigma.shape}")
    model.starting_points = model.tensor(pts)
    model.laplace_sigma = model.tensor(sigma)
    return model


def load_jax_pt_checkpoint(path, generator: torch.Generator) -> dict:
    """The resume state of a JAX `octofit_pigeons` checkpoint (`.npz`),
    for `octofitter_tpu_torch.octofit_pigeons(..., resume=state,
    generator=generator)`: the ladder's states, both legs' schedules, the
    per-rung step-size (dual averaging) and trajectory-length (Adam)
    adaptation, the diagonal metrics, the Gaussian reference, the replica
    labels and directions, the counters and the next round. The JAX key
    has no torch counterpart: the run continues from `generator`'s
    current state (a generator on the model's device, seeded by the
    caller)."""
    from .samplers.tempering import pt_state_from_npz

    with np.load(path) as z:
        state = pt_state_from_npz(z)
    state["generator_state"] = generator.get_state()
    return state


def gp_kernel_from_jax(kernel, *, device="cuda"):
    """The port's counterpart of a JAX `octofitter_tpu.rv` kernel: a
    `Kernel` (sums and products included) or a `CeleriteTerm` (sums
    included), matched by class name, its nested kernels rebuilt the same
    way and every other field (a number or an array, JAX's or numpy's) made
    a float64 tensor on `device`: the GPU unless the caller says
    device="cpu"."""
    from .rv import celerite, kernels

    name = type(kernel).__name__
    cls = getattr(kernels, name, None) or getattr(celerite, name, None)
    if cls is None or not dataclasses.is_dataclass(kernel):
        raise TypeError(f"not a Gaussian-process kernel or celerite term: {name}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("gp_kernel_from_jax was asked for a CUDA device, but none is "
                           "available; pass device=\"cpu\"")
    fields = {}
    for field in dataclasses.fields(kernel):
        value = getattr(kernel, field.name)
        if dataclasses.is_dataclass(value):
            fields[field.name] = gp_kernel_from_jax(value, device=device)
        else:
            fields[field.name] = torch.as_tensor(np.asarray(value, dtype=np.float64),
                                                 device=device)
    return cls(**fields)
