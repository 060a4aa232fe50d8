"""Host allocator tuning for the streaming batch path.

Measured on this host (round 3, docs/DESIGN.md "page-fault wall"):
first-touch page faults run at ~50 MB/s, and glibc returns every
>=128 KB allocation to the kernel on free (mmap/munmap per buffer), so
each per-batch NumPy array refaults its pages from scratch — a 200 MB
astype measured 3.1 s cold vs 0.03 s once pages are reused. Raising
M_MMAP_THRESHOLD / M_TRIM_THRESHOLD keeps large buffers on the heap
between batches: steady-state host stages sped up ~100x.

Call tune_malloc() once at entry (cli, bench, multihost). Safe no-op on
non-glibc platforms.

setup_compile_cache() points JAX's persistent compilation cache at one
fixed directory, so a cold process reuses the packed pipelines that an
earlier one compiled (cli, bench, chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import logging
import os

log = logging.getLogger(__name__)

_done = False

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)

M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3


def tune_malloc(threshold: int = 1 << 30) -> bool:
    """Keep <threshold-sized allocations on the heap across free()."""
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = bool(libc.mallopt(M_MMAP_THRESHOLD, threshold)) and bool(
            libc.mallopt(M_TRIM_THRESHOLD, threshold)
        )
        _done = ok
        return ok
    except Exception as e:  # non-glibc / sandboxed
        log.debug("mallopt unavailable: %s", e)
        return False


def setup_compile_cache(default_dir: str = REPO_CACHE_DIR) -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and this
    sets no other directory; otherwise the cache goes to `default_dir`
    (<repo>/.jax_cache). The path is part of the cache key, so it must
    not move between runs."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", default_dir)
    return default_dir
