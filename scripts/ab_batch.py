"""A/B: exact packed compact pipeline rate vs batch size and k-mer depth.

A larger batch amortizes the fixed per-dispatch cost until its
working set evicts the gather tables (DESIGN.md "Batch size"). Same
measurement discipline as bench.py: distinct inputs per dispatch,
best-of-2, jax.block_until_ready on every output.

Run: python scripts/ab_batch.py [--configs 262144:11 524288:11 ...]
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="*", default=[
        "262144:11", "524288:11"])
    ap.add_argument("--nbatches", type=int, default=2)
    ap.add_argument("--k2", action="store_true",
                    help="measure the k=2 inexact pipeline instead")
    ap.add_argument("--loc-factor", type=float, default=None,
                    help="override compaction cap factor (k2 default 2)")
    args = ap.parse_args()

    import jax

    from bwtpu.config import EngineConfig
    from bwtpu.engine import (exact_pipeline_packed, inexact_pipeline_packed,
                              pack_reads_for_bench, upload_index)
    from bwtpu.index import build_fm_index
    from bwtpu.simulate import ECOLI_SCALE, random_genome, simulate_reads

    L = 100
    cfg = EngineConfig(sa_rate=1, max_hits=4, max_cand=8, read_len=L)
    genome = random_genome(ECOLI_SCALE, seed=1)
    idx = build_fm_index(genome, cfg)
    dev = upload_index([idx])
    shard0 = jax.tree.map(lambda x: x[0], dev.shard)

    any_overflow = 0
    for spec in args.configs:
        B, d = (int(x) for x in spec.split(":"))
        encs = []
        for i in range(args.nbatches):
            rds, _ = simulate_reads(genome, B, read_len=L,
                                    max_mismatches=2, seed=2 + i)
            rw, ab = pack_reads_for_bench(rds)
            encs.append((jax.device_put(rw), jax.device_put(ab)))
        if args.k2:
            fx = jax.jit(functools.partial(
                inexact_pipeline_packed, L=L, k=2, d=d,
                max_loc=cfg.max_cand, sa_rate=cfg.sa_rate,
                loc_factor=args.loc_factor or cfg.loc_factor, min_trips=1,
                compact_output=True))
            probe = 1
        else:
            fx = jax.jit(functools.partial(
                exact_pipeline_packed, L=L, d=d, max_hits=cfg.max_hits,
                sa_rate=cfg.sa_rate, loc_factor=0.75, min_trips=1,
                compact_output=True))
            probe = 0
        np.asarray(fx(shard0, *encs[0])[probe])  # compile
        best = 0.0
        over = 0
        for _ in range(2):
            t0 = time.time()
            outs = jax.block_until_ready([fx(shard0, *e) for e in encs])
            best = max(best, B * args.nbatches / (time.time() - t0))
            over = max(over, sum(
                int(np.asarray(o[5])) + int((np.asarray(o[4]) > 0).sum())
                for o in outs))
        print(f"B={B} d={d} k2={args.k2}: {best/1e6:.3f} M reads/s  "
              f"overflow={over}", flush=True)
        any_overflow += over
    if any_overflow:
        # a lossy config's rate is inflated: make the sweep fail loudly
        # (ADVICE r3 — DESIGN.md claims sweeps run overflow-free)
        print(f"ERROR: {any_overflow} overflowed rows across configs — "
              "rates above are from lossy configs", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
