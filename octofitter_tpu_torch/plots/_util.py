"""Shared plotting helpers.

matplotlib is imported (with the Agg backend) only by the functions that
draw (`pyplot`), so the package imports on a machine without it, such as
the GPU machine: there the private `_*_arrays` functions compute what a
panel would draw, and a machine with matplotlib draws from a saved
`Chains`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import MJUP2MSOL


def pyplot(caller: str):
    """matplotlib.pyplot with the Agg backend, or an ImportError that names
    the drawing function `caller`."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            f"{caller} draws with matplotlib, which is not installed; compute on this "
            "machine and draw where matplotlib is (savechain / loadchain)"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def savable(fn):
    """Add a uniform `fname=` kwarg to a plot function: save the
    figure (150 dpi) after drawing."""

    @functools.wraps(fn)
    def wrapper(*args, fname=None, **kwargs):
        out = fn(*args, **kwargs)
        if fname is not None:
            ax = out
            while isinstance(ax, (list, tuple, np.ndarray)):
                ax = ax[0] if len(ax) else None
            fig = ax.get_figure() if hasattr(ax, "get_figure") else pyplot(fn.__name__).gcf()
            fig.savefig(fname, dpi=150, bbox_inches="tight")
        return out

    if wrapper.__doc__:
        wrapper.__doc__ += "\n\n    fname: optional path to save the figure."
    return wrapper


def pick_planet(model, planet_name):
    return (
        model.system.planets[0]
        if planet_name is None
        else next(p for p in model.system.planets if p.name == planet_name)
    )


def flat_draws(model, chain, n_draws, rng=None) -> np.ndarray:
    """(n, D) rows of posterior draws, chosen as the JAX package chooses
    them (`rng.choice(total, size=min(n_draws, total), replace=False)` of a
    `default_rng(0)`), so both packages plot the same draws."""
    rng = rng or np.random.default_rng(0)
    total = chain.n_chains * chain.n_draws
    idx = rng.choice(total, size=min(n_draws, total), replace=False)
    return np.stack([chain[n].reshape(-1)[idx] for n in model.parameter_names], axis=-1)


def map_row(model, chain, sample_idx=None) -> np.ndarray:
    """(1, D): the draw of highest log posterior (or `sample_idx`)."""
    lp = chain.internals.get("logpost")
    if sample_idx is None:
        sample_idx = int(np.argmax(lp.reshape(-1))) if lp is not None else 0
    names = model.parameter_names
    return np.asarray([[chain[n].reshape(-1)[sample_idx] for n in names]])


def orbits_of(model, rows):
    """(theta_nt, orbits) of the (n, D) rows: one `arr2nt` and one
    `construct_orbits` for all of them, each element field of shape (n,)."""
    nt = model.arr2nt(model.tensor(rows))
    return nt, model.construct_orbits(nt)


def planet_mass(model, nt, name, n):
    """The planet's mass in Msun at each of the n rows (n,), or None for a
    planet without one (the JAX package then plots with mass 0)."""
    pl = nt.planets[name]
    if "mass" not in pl:
        return None
    return torch.broadcast_to(model.tensor(pl.mass) * MJUP2MSOL, (n,))


def mass_or_zero(model, nt, name, n):
    m = planet_mass(model, nt, name, n)
    return torch.zeros(n, dtype=model.dtype, device=model.device) if m is None else m


def to_host(arrays: dict) -> dict:
    """The tensors of `arrays` in one device-to-host copy, as float64 numpy
    arrays; other values pass through."""
    keys = [k for k, v in arrays.items() if isinstance(v, torch.Tensor)]
    out = dict(arrays)
    if not keys:
        return out
    flat = torch.cat([arrays[k].reshape(-1).to(torch.float64) for k in keys]).cpu().numpy()
    at = 0
    for k in keys:
        n = arrays[k].numel()
        out[k] = flat[at: at + n].reshape(tuple(arrays[k].shape))
        at += n
    return out
