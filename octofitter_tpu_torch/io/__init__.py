"""I/O: FITS tables (a copy of the JAX package's numpy-only reader and writer)."""

from .fits import read_bintable, write_bintable, read_header

__all__ = ["read_bintable", "write_bintable", "read_header"]
