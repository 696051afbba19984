"""Chain save/load (a copy of the JAX package's numpy-only module).

Equivalent of the reference's FITS chain I/O (the reference's `src/io.jl:20-149`
`savechain`/`loadchain`): a binary table with one column per parameter
(posterior section and internals section), chain shape and metadata in
the header. Column names are stored verbatim (the reference's
unicode -> LaTeX round-trip is unnecessary here since our FITS writer
stores names as-is).
"""

from __future__ import annotations

import numpy as np

from ..chains import Chains
from .fits import read_bintable, read_header, write_bintable

_INTERNAL_PREFIX = "internals_"


def savechain(path, chain: Chains, **extra_metadata):
    table = {}
    for k, v in chain.data.items():
        table[k] = np.asarray(v).reshape(-1)
    for k, v in chain.internals.items():
        if np.ndim(v) == 2:
            table[_INTERNAL_PREFIX + k] = np.asarray(v, dtype=np.float64).reshape(-1)
    cards = {
        "NCHAINS": chain.n_chains,
        "NDRAWS": chain.n_draws,
    }
    # header keys must be <= 8 chars; store metadata as a numbered list
    for i, (k, v) in enumerate(
        (k, v)
        for k, v in {**chain.info, **extra_metadata}.items()
        if isinstance(v, (str, int, float, bool, np.integer, np.floating))
    ):
        cards[f"INFK{i}"] = str(k)[:60]
        cards[f"INFV{i}"] = v
    write_bintable(path, table, header_cards=cards)


def loadchain(path) -> Chains:
    table = read_bintable(path)
    header = read_header(path, hdu=1)
    n_chains = int(header.get("NCHAINS", 1))
    n_draws = int(header.get("NDRAWS", len(next(iter(table.values()))) // n_chains))
    data, internals = {}, {}
    for k, v in table.items():
        arr = np.asarray(v).reshape(n_chains, n_draws)
        if k.startswith(_INTERNAL_PREFIX):
            internals[k[len(_INTERNAL_PREFIX):]] = arr
        else:
            data[k] = arr
    info = {}
    i = 0
    while f"INFK{i}" in header:
        info[str(header[f"INFK{i}"])] = header.get(f"INFV{i}")
        i += 1
    return Chains(data, internals, info)
