"""Native (C++) host-side components, loaded with ctypes.

Port of `octofitter_tpu/native/__init__.py`. `fasttable.cpp` (a copy of
the JAX package's) is compiled with g++ (or `$CXX`) at first use into the
git-ignored `octofitter_tpu_torch/_build/`, under a name keyed by a hash of
the source and the flags, so an edited source is rebuilt and the package
tree holds no build output. Nothing is compiled when this module is
imported. Where the compiler is missing or fails, `available()` is false
and every consumer keeps its pure-Python path: environments without a
compiler lose speed, not functionality.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import warnings
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fasttable.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfasttable-{digest}.so"


def _build(out: Path) -> None:
    """Compile the source into `out`; a concurrent build never sees half a
    file (the compiler writes a temporary name, renamed into place)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


@functools.cache
def _lib():
    """The loaded library, or None where it could not be built or loaded."""
    out = library_path()
    try:
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.SubprocessError) as e:  # no compiler, a failed build or load
        warnings.warn(f"native fasttable unavailable ({e}); using the Python path")
        return None
    lib.fasttable_parse.restype = ctypes.c_int
    lib.fasttable_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char, ctypes.c_char,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
    ]
    lib.fasttable_free.restype = None
    lib.fasttable_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    return lib


def available() -> bool:
    """True when the native parser compiled and loaded."""
    return _lib() is not None


def parse_numeric_table(path, *, delimiter: str | None = None, skip: int = 0,
                        comment: str | None = "#") -> np.ndarray:
    """Parse a numeric text table natively -> (rows, cols) float64 array.

    delimiter: a single character (e.g. ","), or None for whitespace.
    skip: leading lines to skip (headers). comment: line-comment char.
    Non-numeric fields become NaN. Raises RuntimeError if the native
    library is unavailable (callers should fall back) or the file is
    ragged/unreadable.
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError("native fasttable unavailable")
    data_p = ctypes.POINTER(ctypes.c_double)()
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    rc = lib.fasttable_parse(
        os.fsencode(path), skip,
        delimiter.encode("ascii") if delimiter else b"\x00",
        comment.encode("ascii") if comment else b"\x00",
        ctypes.byref(data_p), ctypes.byref(rows), ctypes.byref(cols),
    )
    if rc != 0:
        raise RuntimeError(
            f"fasttable_parse({path!r}) failed with code {rc} "
            "(1=open, 2=read, 3=ragged rows, 4=alloc)"
        )
    try:
        n = rows.value * cols.value
        if n == 0:
            return np.zeros((rows.value, cols.value))
        arr = np.ctypeslib.as_array(data_p, shape=(rows.value, cols.value)).copy()
    finally:
        lib.fasttable_free(data_p)
    return arr


def read_csv_columns(path) -> dict[str, np.ndarray]:
    """Fast CSV -> dict of float64 columns keyed by (stripped) header
    names; non-numeric cells are NaN. Native fast path for the GOST
    scan-law loader and the GOST catalog lookup."""
    with open(path, "r") as f:
        header = f.readline()
    names = [c.strip() for c in header.rstrip("\n\r").split(",")]
    arr = parse_numeric_table(path, delimiter=",", skip=1, comment=None)
    if arr.shape[1] != len(names):
        raise RuntimeError(
            f"{path}: header has {len(names)} columns, data {arr.shape[1]}"
        )
    return {n: arr[:, i] for i, n in enumerate(names)}


__all__ = ["available", "parse_numeric_table", "read_csv_columns"]
