"""Build the port's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/*.cu`` compiles on its own into a shared library with a plain
C interface, under ``build/`` at the repository root, named by a hash of
its source and flags: an edited source builds anew, an unchanged one loads
from the file. ``utils/compilation_cache.py`` moves that directory to a
cache shared by checkouts and processes (``CACHE_ENV`` names it, so child
processes inherit it). Nothing here runs at import time, so the CPU tests
import the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
CACHE_ENV = "MMDGAN_TORCH_COMPILATION_CACHE"
CACHE_MIN_SECONDS_ENV = "MMDGAN_TORCH_CACHE_MIN_COMPILE_SECONDS"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def build_dir() -> Path:
    """The compilation cache's directory when one is enabled, else ``build/``."""
    cache = os.environ.get(CACHE_ENV)
    return Path(cache) if cache else BUILD_DIR


def library_path(source: str, directory: Path = None) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return (directory or build_dir()) / f"{Path(source).stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library exists; returns the path.
    Under a compilation cache, a build faster than the cache's
    ``min_compile_seconds`` goes to ``build/`` instead."""
    out = library_path(source)
    if out.exists():
        return out
    local = library_path(source, BUILD_DIR)
    if local.exists():
        return local
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if (out != local and time.perf_counter() - start
            < float(os.environ.get(CACHE_MIN_SECONDS_ENV, 0.0))):
        local.parent.mkdir(parents=True, exist_ok=True)
        out = local
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return out


def load(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if needed and load it."""
    return ctypes.CDLL(str(build(source)))
