"""Host-side attribution of the FASTQ -> SAM production loop.

The FASTQ -> SAM loop ran far below the device rate, so the gap sits
on the host (VERDICT r2 item 1 second half). This runs
the exact e2e loop bench.py runs (columnar parse -> packed vmapped
dispatch -> one-round-trip hits fetch -> vectorized primary -> C SAM
formatter -> file) with a wall clock around every stage.

Run: python scripts/e2e_profile.py [--reads 1048576] [--batch 262144]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1048576)
    ap.add_argument("--batch", type=int, default=262144)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from bwtpu.config import EngineConfig
    from bwtpu.engine import Engine
    from bwtpu.hosttune import tune_malloc
    from bwtpu.index import build_fm_index
    from bwtpu.readblock import read_fastq_block
    from bwtpu.results import ContigTable, select_primary_flat
    from bwtpu.sam import sam_header
    from bwtpu.samfast import emit_single
    from bwtpu.simulate import ECOLI_SCALE, random_genome, simulate_reads

    tune_malloc()
    L = 100
    B = args.batch
    cfg = EngineConfig(sa_rate=1, max_hits=4, max_cand=8, read_len=L,
                       loc_factor=0.75, k=0, min_trips=1, hit_factor=0.5)
    genome = random_genome(ECOLI_SCALE, seed=1)
    idx = build_fm_index(genome, cfg)
    eng = Engine([idx])
    ctable = ContigTable.build(idx.contigs)

    d = tempfile.mkdtemp(prefix="bwtpu_e2e_prof_")
    fq = os.path.join(d, "reads.fq")
    n_batches = -(-args.reads // B)
    with open(fq, "w") as f:
        for i in range(n_batches):
            rds, _ = simulate_reads(genome, B, read_len=L,
                                    max_mismatches=2, seed=100 + i)
            for r in rds:
                f.write(f"@{r.rid}.{i}\n{r.seq}\n+\n{'I' * L}\n")
    fq_mb = os.path.getsize(fq) / 1e6

    t = {k: 0.0 for k in ("parse", "slice", "dispatch", "finish",
                          "primary", "emit", "write")}

    # warm/compile
    blk0 = read_fastq_block(fq)
    h = eng.dispatch_block(blk0.slice(0, B), 0, pad_to=B)
    flat = eng.finish_block(h)
    select_primary_flat(flat)

    sam = os.path.join(d, "out.sam")
    t_all = time.time()
    t0 = time.time()
    blk = read_fastq_block(fq)
    t["parse"] += time.time() - t0
    out = open(sam, "wb")
    out.write(sam_header(idx.contigs).encode())
    # SERIALIZED stages (no overlap) so attribution is clean; the bench
    # overlaps finish/emit with the next dispatch, so the e2e wall is
    # bounded below by max(stage sums), not their total.
    recs = []
    for i in range(0, blk.n, B):
        t0 = time.time()
        sub = blk.slice(i, i + B)
        t["slice"] += time.time() - t0
        t0 = time.time()
        h = eng.dispatch_block(sub, 0, pad_to=B)
        t["dispatch"] += time.time() - t0
        recs.append((sub, h))
    for sub, h in recs:
        t0 = time.time()
        flat = eng.finish_block(h)
        t["finish"] += time.time() - t0
        t0 = time.time()
        prim = select_primary_flat(flat)
        t["primary"] += time.time() - t0
        t0 = time.time()
        buf = emit_single(sub, prim, ctable)
        t["emit"] += time.time() - t0
        t0 = time.time()
        out.write(buf)
        t["write"] += time.time() - t0
    out.close()
    wall = time.time() - t_all
    sam_mb = os.path.getsize(sam) / 1e6
    os.remove(fq)
    os.remove(sam)
    os.rmdir(d)

    print(json.dumps({
        "reads": blk.n, "fq_mb": round(fq_mb, 1),
        "sam_mb": round(sam_mb, 1),
        "wall_s": round(wall, 2),
        "serialized_reads_per_s": round(blk.n / wall, 1),
        "engine_device_s": round(eng.stats.device_s, 2),
        "engine_host_s": round(eng.stats.host_s, 2),
        **{f"{k}_s": round(v, 3) for k, v in t.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
