"""A persistent compilation cache for fast restarts
(``mmdgan_tpu/utils/compilation_cache.py:21-45``).

What a restarted JAX process recompiles is XLA's executable of the step;
what a restarted port process recompiles is the ``nvcc`` build of
``csrc/*.cu`` (``ops/_build.py``), which lands in the checkout's ``build/``
keyed by a hash of the source and flags. Pointing that directory at a
cache shared by checkouts, worktrees and processes lets a resumed run, the
next chunk or a new serving worker load the library instead of running
``nvcc`` (PERF.md §6 has the cold build against a hit on the card).
Anything compiled through inductor or Triton keeps its cache in the same
directory (``TORCHINDUCTOR_CACHE_DIR``, ``TRITON_CACHE_DIR``). The settings
are environment variables, so processes started from this one inherit
them.
"""

from __future__ import annotations

import os

from mmdgan_torch.ops import _build


def enable_compilation_cache(cache_dir: str, min_compile_seconds: float = 1.0) -> str:
    """Turn on the persistent compilation cache rooted at ``cache_dir``
    (created if missing); returns it.

    Call before the first kernel build. The directory may be shared
    between processes: entries are named by a hash of what they compile
    and written by an atomic rename.

    :param min_compile_seconds: a kernel build faster than this is kept in
        the checkout's ``build/``, not in the cache (0 caches every build).
    """
    cache_dir = os.path.abspath(os.fspath(cache_dir))
    os.makedirs(cache_dir, exist_ok=True)
    os.environ[_build.CACHE_ENV] = cache_dir
    os.environ[_build.CACHE_MIN_SECONDS_ENV] = str(float(min_compile_seconds))
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache_dir, "inductor")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache_dir, "triton")
    return cache_dir
