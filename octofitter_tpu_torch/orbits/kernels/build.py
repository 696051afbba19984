"""Build a CUDA source of this package into a shared library, and load it.

Each `csrc/*.cu` file has a plain C interface and is compiled by `nvcc`
into its own shared library, which `ctypes` loads. The library goes into
`octofitter_tpu_torch/_build/` (git-ignored) under a name keyed by a hash
of the source, the headers it includes from `csrc/` and the flags, so a
fresh checkout builds at first use and an edited source or header is
rebuilt. Nothing is compiled when a module is imported: the first launch
of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: a CUDA toolkit is needed to build the kernels")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def source_files(source: Path) -> list[Path]:
    """`source` and every file it includes with `#include "..."`, directly
    or through another such file (paths relative to the including file)."""
    found, todo = [], [source.resolve()]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
            todo.append((path.parent / name.decode()).resolve())
    return found


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(
        b"".join(f.read_bytes() for f in source_files(source))
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build(source: Path) -> tuple[Path, str]:
    """Compile `source` unless its library exists; return (path, nvcc log).

    The log holds ptxas's register and spill report for each kernel; it
    is empty when the library was already built."""
    out = library_path(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, proc.stdout + proc.stderr


def build_all(sources) -> list[tuple[Path, str]]:
    """`build` every source, one nvcc process each, all started together."""
    sources = list(sources)
    with ThreadPoolExecutor(max(len(sources), 1)) as pool:
        return list(pool.map(build, sources))


@functools.cache
def load_library(source: Path) -> ctypes.CDLL:
    """Build `source` if needed and load it once per process."""
    path, _ = build(source)
    return ctypes.CDLL(str(path))
