"""Build the port's native sources at first use and load them with
``ctypes``: the CUDA kernels (``csrc/*.cu``) with ``nvcc``, the host
library of the record reader (``csrc/tfrec.cc``) with ``g++``.

Each source compiles on its own into a shared library with a plain C
interface, under ``build/`` at the repository root, named by a hash of its
source and flags: an edited source builds anew, an unchanged one loads
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
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
CACHE_ENV = "MMDGAN_TORCH_COMPILATION_CACHE"
CACHE_MIN_SECONDS_ENV = "MMDGAN_TORCH_CACHE_MIN_COMPILE_SECONDS"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# No -march=native: the hash keys the source and these flags, not the host's
# CPU, and a compilation cache may share the build directory between hosts.
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found:
        return found
    raise RuntimeError("g++ not found: the host library of the record reader needs a "
                       "C++ compiler (set CXX or put g++ on PATH)")


def _flags(source: str) -> tuple:
    return HOST_FLAGS if source.endswith(".cc") else NVCC_FLAGS


def _command(source: str, out: Path) -> list:
    if source.endswith(".cc"):
        return [_cxx(), *HOST_FLAGS, str(CSRC / source), "-o", str(out)]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / source)]


def build_dir() -> Path:
    """The compilation cache's directory when one is enabled, else ``build/``."""
    cache = os.environ.get(CACHE_ENV)
    return Path(cache) if cache else BUILD_DIR


def library_path(source: str, directory: Path = None) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(source)).encode()).hexdigest()[:16]
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
    cmd = _command(source, tmp)
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed on {source} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if (out != local and time.perf_counter() - start
            < float(os.environ.get(CACHE_MIN_SECONDS_ENV, 0.0))):
        local.parent.mkdir(parents=True, exist_ok=True)
        out = local
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return out


def resource_usage(source: str) -> list:
    """What ``ptxas -v`` says of each kernel of the CUDA source
    ``csrc/<source>`` (registers, shared memory, spill stores and loads):
    a device-only compile with the library's flags into a temporary cubin,
    so it can run beside ``build``. Returns the ``ptxas info`` lines and
    the stack and spill line of each kernel."""
    with tempfile.TemporaryDirectory() as tmp:
        device_flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        cmd = [_nvcc(), *device_flags, "-cubin", "-Xptxas", "-v",
               "-o", os.path.join(tmp, "kernels.cubin"), str(CSRC / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -cubin failed on {source} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if line.startswith("ptxas info") or "spill" in line]


def load(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if needed and load it."""
    return ctypes.CDLL(str(build(source)))
