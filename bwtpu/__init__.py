"""bwtpu — accelerator-native FM-index short-read alignment engine.

A brand-new engine with the capabilities of the reference aligner
(cloudozer/BWT; see SURVEY.md — the reference mount was empty, so the
golden model in `bwtpu.golden` is the executable behavioral spec, per
SURVEY.md §0.1 step 2):

- host-side index construction: suffix array (C++ SA-IS with NumPy
  fallback) -> BWT -> C table -> checkpointed Occ -> sampled SA
  (`bwtpu.index`),
- device-side search: exact backward search, bounded-mismatch
  (<=k substitutions) search, locate + SAM-equivalent emission, as
  batched JAX programs over int32 lattices in device memory
  (`bwtpu.kernels`, `bwtpu.engine`),
- distribution: index replication or interval sharding over a
  ('shard', 'data') device mesh with ring-rotation of read batches and
  all-gather hit merge (`bwtpu.dist`).

Pinned behavioral conventions (SURVEY.md §3, §7.6 item 3) are documented
in `bwtpu.golden` and enforced by the parity tests in `tests/`.
"""

__version__ = "0.1.0"

from bwtpu.config import EngineConfig  # noqa: F401


def __getattr__(name):  # lazy: keep `import bwtpu` light (no jax import)
    if name in ("Engine", "DistEngine", "build_fm_index",
                "build_sharded_index", "load_index", "save_index",
                "GoldenFMIndex"):
        import importlib

        mod = {
            "Engine": "bwtpu.engine",
            "DistEngine": "bwtpu.dist",
            "build_fm_index": "bwtpu.index",
            "build_sharded_index": "bwtpu.index",
            "load_index": "bwtpu.index",
            "save_index": "bwtpu.index",
            "GoldenFMIndex": "bwtpu.golden",
        }[name]
        return getattr(importlib.import_module(mod), name)
    raise AttributeError(name)
