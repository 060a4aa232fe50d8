"""Sweep the k-mer START-TABLE depth for the exact and k2 pipelines.

Motivation (round 5): the depth-11 start table is 4^11 x 2 x 4 B =
33 MB — gathered once per lane per search from outside the smaller
caches (DESIGN.md "gather cost vs table size"), while a depth-9/10
table (0.5/8 MB) stays cache-resident. A shallower start leaves wider
intervals (E[width] = n/4^d), which costs extra multi-step trips from
the 9 MB lattice — so the trade is one expensive gather vs a few cheap
ones. This sweep measures it on the device with bench.py's discipline
(distinct batches, best-of-2, overflow fetched with outputs, lossy
configs fail loudly).

One index is built per depth (the ladder only materializes {4, 8, d}).

Run: python scripts/sweep_depth.py [--quick]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smoke scale (CPU ok) — wiring check")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--k2-batch", type=int, default=None)
    ap.add_argument("--depths", type=int, nargs="*", default=None)
    args = ap.parse_args()

    import jax

    if args.quick:  # wiring check must not contend for the real chip
        jax.config.update("jax_platforms", "cpu")

    from bwtpu.config import EngineConfig
    from bwtpu.engine import (exact_pipeline_packed, inexact_pipeline_packed,
                              pack_reads_for_bench, upload_index)
    from bwtpu.hosttune import tune_malloc
    from bwtpu.index import build_fm_index
    from bwtpu.simulate import ECOLI_SCALE, random_genome, simulate_reads

    tune_malloc()
    L = 100
    n = 50_000 if args.quick else ECOLI_SCALE
    B = args.batch or (1024 if args.quick else 524288)
    Bk = args.k2_batch or (1024 if args.quick else 262144)
    depths = args.depths or ([4, 7] if args.quick else [9, 10, 11, 12])
    genome = random_genome(n, seed=1)

    encs, encs_k = [], []
    rw0 = ab0 = None
    for i in range(2):
        rds, _ = simulate_reads(genome, B, read_len=L, max_mismatches=2,
                                seed=2 + i)
        rw, ab = pack_reads_for_bench(rds)
        encs.append((rw, ab))
        encs_k.append((rw[:Bk], ab[:Bk]))

    results = {"config": f"depth sweep n={n} B={B} Bk={Bk}", "rows": []}
    for d in depths:
        cfg = EngineConfig(sa_rate=1, max_hits=4, max_cand=8, read_len=L,
                           kmer_d=d)
        idx = build_fm_index(genome, cfg)
        dev = upload_index([idx])
        shard0 = jax.tree.map(lambda x: x[0], dev.shard)
        de = [(jax.device_put(a), jax.device_put(b)) for a, b in encs]
        dek = [(jax.device_put(a), jax.device_put(b)) for a, b in encs_k]

        fx = jax.jit(functools.partial(
            exact_pipeline_packed, L=L, d=d, max_hits=cfg.max_hits,
            sa_rate=1, loc_factor=0.45, min_trips=1,
            compact_output=True))
        np.asarray(fx(shard0, *de[0])[0])
        best = 0.0
        over = 0
        for _ in range(2):
            t0 = time.time()
            outs = [fx(shard0, *e) for e in de]
            for o in outs:
                np.asarray(o[0][:64])
            best = max(best, 2 * B / (time.time() - t0))
            over = max(over, sum(
                int(np.asarray(o[5])) + int((np.asarray(o[4]) > 0).sum())
                for o in outs))
        row = {"d": d, "exact_rps": round(best, 1), "exact_overflow": over,
               "table_mb": round(4 ** d * 8 / 1e6, 1)}
        if d <= L // 3:
            fi = jax.jit(functools.partial(
                inexact_pipeline_packed, L=L, k=2, d=d,
                max_loc=cfg.max_cand, sa_rate=1, loc_factor=1.5,
                min_trips=1, compact_output=True))
            np.asarray(fi(shard0, *dek[0])[1])
            bestk = 0.0
            overk = 0
            for _ in range(2):
                t0 = time.time()
                outs = [fi(shard0, *e) for e in dek]
                for o in outs:
                    np.asarray(o[1][:64])
                bestk = max(bestk, 2 * Bk / (time.time() - t0))
                overk = max(overk, sum(
                    int(np.asarray(o[5])) + int((np.asarray(o[4]) > 0).sum())
                    for o in outs))
            row["k2_rps"] = round(bestk, 1)
            row["k2_overflow"] = overk
        results["rows"].append(row)
        print(json.dumps(row), flush=True)
        del dev, shard0, de, dek, idx
        import gc

        gc.collect()
    print(json.dumps(results))


if __name__ == "__main__":
    main()
