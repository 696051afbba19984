"""Chain <-> model round-trip helpers.

PyTorch port of `octofitter_tpu/model/chain_tools.py`: the reference's
`construct_elements` (`sampling.jl:98-113`: orbit objects from chain
rows) and `mcmcchain2result` (`sampling.jl:649-900`: chain draws back
into structured parameter sets), batched over draws. As in the JAX
package they take no discrete values, so on a model with discrete priors
`arr2nt` raises.
"""

from __future__ import annotations

import numpy as np
import torch


def chain_to_flat(model, chain):
    """(n_samples, D) natural-space parameter matrix (numpy) from a Chains."""
    return np.stack(
        [np.asarray(chain[n]).reshape(-1) for n in model.parameter_names],
        axis=-1,
    )


def mcmcchain2result(model, chain, idx=None):
    """Resolve chain draws into structured Params (`mcmcchain2result`,
    `sampling.jl:649-900`): idx, optional indices into the flattened
    (chain, draw) axis. Returns Params whose leaves lead with the draws."""
    flat = chain_to_flat(model, chain)
    if idx is not None:
        flat = flat[np.atleast_1d(idx)]
    with torch.no_grad():
        return model.arr2nt(model.tensor(flat))


def construct_elements(model, chain, planet_name, idx):
    """Orbit elements of planet `planet_name` at draws `idx`
    (`construct_elements`, `sampling.jl:98-113`), every field leading with
    len(idx)."""
    idx = np.atleast_1d(idx)
    i_planet = [p.name for p in model.system.planets].index(planet_name)
    return model.construct_orbits(mcmcchain2result(model, chain, idx))[i_planet]
