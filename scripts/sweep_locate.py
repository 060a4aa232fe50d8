"""Sweep the locate/candidate stage of the exact packed pipeline.

Round-3 stage attribution pinned locate as the largest exact stage:
the fused locate+verify row comes from a ~295 MB table, while the
other gathers hit cache-resident 4.6-9 MB tables (docs/DESIGN.md
"gather cost vs table size"). This sweep measures the alternatives
that table-size curve implies (VERDICT r3 next-round item 1):

  - locv ON  (sa_rate=1): one gather from the big fused table
  - locv OFF (sa_rate=1): ssa element take (18 MB) + text-row take (16 MB)
  - sa_rate=2/4: bounded LF walk over the cache-resident 1-step lattice
    (4.6 MB) + ssa take from a 9.2/4.6 MB table + text-row take
  x loc_factor (compaction cap) and min_trips (candidate thinning)
  x batch size

Same measurement discipline as bench.py: distinct inputs per dispatch,
best-of-2, block on every output; overflow fetched with
the outputs and any lossy config fails the sweep loudly.

Run: python scripts/sweep_locate.py [--quick]
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
    ap.add_argument("--nbatches", type=int, default=2)
    ap.add_argument("--quick", action="store_true",
                    help="shrink to smoke scale (CPU ok) — wiring check")
    ap.add_argument("--configs", nargs="*", default=None,
                    help="sa_rate:locv:loc_factor:min_trips:B entries")
    args = ap.parse_args()

    import jax

    from bwtpu.config import EngineConfig
    from bwtpu.engine import (compact_cap, exact_pipeline_packed,
                              pack_reads_for_bench, upload_index)
    from bwtpu.index import build_fm_index
    from bwtpu.simulate import ECOLI_SCALE, random_genome, simulate_reads

    L = 100
    n_genome = 50_000 if args.quick else ECOLI_SCALE
    genome = random_genome(n_genome, seed=1)

    if args.configs:
        grid = []
        for spec in args.configs:
            sr, lv, lf, mt, B = spec.split(":")
            grid.append((int(sr), lv in ("1", "true"), float(lf), int(mt),
                         int(B)))
    else:
        B0 = 1024 if args.quick else 524288
        grid = [
            # (sa_rate, locv, loc_factor, min_trips, B)
            (1, True, 0.75, 1, B0),     # shipped r3 config (baseline)
            (1, False, 0.75, 1, B0),    # split ssa + text rows
            (2, False, 0.75, 1, B0),    # walk over cache-resident lattice
            (4, False, 0.75, 1, B0),
            (2, False, 0.5, 1, B0),     # tighter cap
            (2, False, 0.5, 2, B0),     # extra thinning trip
            (1, True, 0.5, 1, B0),
            (2, False, 0.5, 1, B0 * 2), # bigger batch, small working set
            (1, True, 0.75, 1, B0 * 2),
        ]

    idx_cache: dict = {}
    enc_cache: dict = {}
    results = []
    any_overflow = 0
    for sa_rate, locv, loc_factor, min_trips, B in grid:
        if sa_rate not in idx_cache:
            cfg = EngineConfig(sa_rate=sa_rate, max_hits=4, max_cand=8,
                               read_len=L)
            t0 = time.time()
            idx_cache[sa_rate] = build_fm_index(genome, cfg)
            print(f"# built index sa_rate={sa_rate} in {time.time()-t0:.1f}s",
                  flush=True)
        idx = idx_cache[sa_rate]
        if B not in enc_cache:
            batches = []
            for i in range(args.nbatches):
                rds, _ = simulate_reads(genome, B, read_len=L,
                                        max_mismatches=2, seed=2 + i)
                batches.append(pack_reads_for_bench(rds))
            enc_cache[B] = batches
        dev = upload_index([idx], locv=locv if sa_rate == 1 else False)
        shard0 = jax.tree.map(lambda x: x[0], dev.shard)
        encs = [(jax.device_put(rw), jax.device_put(ab))
                for rw, ab in enc_cache[B]]
        depths = sorted(idx.kmer_tables)
        d = max(dd for dd in depths if dd <= L)
        fx = jax.jit(functools.partial(
            exact_pipeline_packed, L=L, d=d, max_hits=4,
            sa_rate=sa_rate, loc_factor=loc_factor, min_trips=min_trips,
            compact_output=True))
        np.asarray(fx(shard0, *encs[0])[0])  # compile + warm
        best, over, occ = 0.0, 0, 0.0
        cap = compact_cap(2 * B, loc_factor)
        for _ in range(2):
            t0 = time.time()
            outs = jax.block_until_ready([fx(shard0, *e) for e in encs])
            best = max(best, B * args.nbatches / (time.time() - t0))
            over = max(over, sum(
                int(np.asarray(o[5])) + int((np.asarray(o[4]) > 0).sum())
                for o in outs))
            occ = max(occ, max(int(np.asarray(o[3])) for o in outs) / cap)
        tag = (f"sa_rate={sa_rate} locv={int(locv)} lf={loc_factor} "
               f"mt={min_trips} B={B}")
        print(f"{tag}: {best/1e6:.3f} M reads/s  overflow={over}  "
              f"cap_occ={occ:.2f}", flush=True)
        results.append((tag, best, over))
        any_overflow += over
        del dev, shard0, encs, fx

    best_cfg = max(results, key=lambda r: r[1])
    print(f"# best: {best_cfg[0]} at {best_cfg[1]/1e6:.3f} M reads/s")
    if any_overflow:
        print(f"ERROR: {any_overflow} overflowed rows in some configs — "
              "those rates are lossy", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
