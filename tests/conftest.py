"""Test configuration: force an 8-virtual-device CPU mesh (SURVEY.md §4.2).

All tests run on CPU with XLA_FLAGS forcing 8 host devices, so every
shard_map / collective code path is exercised without a multi-GPU host;
the same program runs unchanged on real device meshes. The GPU path is
driven by `python chip_smoke.py` on a machine with the card (README).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from bwtpu.hosttune import setup_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Persistent compilation cache: the default tier is jit-compile
# dominated (ring/engine program variants), and the programs are
# identical run-to-run — cache them on disk so repeat runs (and the
# xdist workers, which share the dir) skip recompilation. Keyed by HLO;
# a code change just misses and recompiles. JAX_COMPILATION_CACHE_DIR,
# when set, takes precedence over tests/.jax_cache.
setup_compile_cache(os.path.join(os.path.dirname(__file__), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)
