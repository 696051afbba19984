"""I/O: FITS tables and chain save/load (copies of the JAX package's
numpy-only reader, writer and chain I/O)."""

from .fits import read_bintable, write_bintable, read_header
from .chains_io import savechain, loadchain

__all__ = ["read_bintable", "write_bintable", "read_header", "savechain", "loadchain"]
