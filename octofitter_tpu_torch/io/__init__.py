"""I/O: FITS tables and chain save/load (copies of the JAX package's
numpy-only reader, writer and chain I/O), and Orbitize! interop."""

from .fits import read_bintable, write_bintable, read_header
from .chains_io import savechain, loadchain
from .orbitize import (
    loadhdf5,
    savehdf5,
    Whereistheplanet_search,
    Whereistheplanet_astrom,
)

__all__ = [
    "read_bintable",
    "write_bintable",
    "read_header",
    "savechain",
    "loadchain",
    "loadhdf5",
    "savehdf5",
    "Whereistheplanet_search",
    "Whereistheplanet_astrom",
]
