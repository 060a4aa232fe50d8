"""In-jit amortized stage attribution for the PACKED compact pipeline.

The round-2 prefix method (scripts/stage_times.py) timed each stage
prefix as its own dispatch, so fixed per-dispatch costs swamped small
stage deltas. Here each stage PREFIX runs `reps` times inside ONE jit
via lax.fori_loop (inputs perturbed per trip by a dynamic row roll so
XLA cannot CSE trips, and dispatches carry distinct seeds so no cache
replays an answer — DESIGN.md "Stage attribution").
Stage cost = successive difference / reps; the roll's own cost cancels
in the difference (every prefix pays it once per trip).

Prefixes mirror engine.exact_pipeline_packed(compact_output=True) +
the hits-output packing (engine._packed_fn hits_output=True) — the
exact program the bench and cli align run. Keep them in sync by hand;
parity of the real pipeline is pinned by tests, this script only
attributes time.

Run:  python scripts/stage_attr.py [--batch 262144] [--reps 8]
      [--min-trips 0] [--loc-factor 1.0]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=262144)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--dispatches", type=int, default=3)
    ap.add_argument("--min-trips", type=int, default=0)
    ap.add_argument("--loc-factor", type=float, default=1.0)
    ap.add_argument("--hit-factor", type=float, default=0.5)
    ap.add_argument("--no-locv", action="store_true",
                    help="A/B: small-table locate_rows + verify_packed "
                         "instead of the fused locv row gather")
    ap.add_argument("--kmer-d", type=int, default=None,
                    help="k-mer start depth (table size 4^d * 8 B: d=11 "
                         "-> 33 MB, d=10 -> 8.4 MB; with min_trips >= 1 "
                         "the extra trip equalizes candidate quality)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bwtpu.config import EngineConfig
    from bwtpu.engine import (compact_cap, device_prep_packed,
                              pack_reads_for_bench, pick_kmer_depth,
                              upload_index)
    from bwtpu.hosttune import tune_malloc
    from bwtpu.index import build_fm_index
    from bwtpu.kernels import prep
    from bwtpu.kernels.compact import compact as compact_mask
    from bwtpu.kernels.compact import compact_counts
    from bwtpu.kernels.search import interval_rows
    from bwtpu.kernels.searchk import search_early_stop_packed
    from bwtpu.kernels.locate import locate_rows
    from bwtpu.kernels.verify2 import verify_packed, verify_packed_locv
    from bwtpu.simulate import ECOLI_SCALE, random_genome, simulate_reads

    tune_malloc()
    L = 100
    cfg = EngineConfig(sa_rate=1, max_hits=4, max_cand=8, read_len=L,
                       kmer_d=args.kmer_d)
    genome = random_genome(ECOLI_SCALE, seed=1)
    idx = build_fm_index(genome, cfg)
    dev = upload_index([idx], locv=not args.no_locv)
    shard = jax.tree.map(lambda x: x[0], dev.shard)
    use_locv = not args.no_locv
    d = pick_kmer_depth(sorted(idx.kmer_tables), L)
    step = cfg.occ_step
    B = args.batch
    H = cfg.max_hits
    mt = args.min_trips
    rds, _ = simulate_reads(genome, B, read_len=L, max_mismatches=2, seed=2)
    rw_h, ab_h = pack_reads_for_bench(rds)
    rw = jax.device_put(rw_h)
    ab = jax.device_put(ab_h)
    B2 = 2 * B
    cap = compact_cap(B2, args.loc_factor)
    hit_cap = min(cap, compact_cap(B2, args.hit_factor))

    def acc(x):
        return x.astype(jnp.int32).sum()

    # ---- stage prefixes (each consumes its LAST output fully so XLA
    # cannot dead-code the stage; upstream stages are consumed by the
    # downstream ones by construction) ----

    def upto_prep(sh, rwi, abi):
        rw2, ab2, lens2, lm2 = device_prep_packed(rwi, abi, L)
        return acc(rw2) + acc(ab2)

    def upto_kmer(sh, rwi, abi):
        rw2, ab2, lens2, lm2 = device_prep_packed(rwi, abi, L)
        key, amb_tail = prep.kmer_key_packed(rw2, ab2, 0, L, d)
        start = jnp.take(sh.kmer_tables[d], key, axis=0)
        return acc(start) + acc(amb_tail)

    def _search(sh, rwi, abi):
        rw2, ab2, lens2, lm2 = device_prep_packed(rwi, abi, L)
        sp, ep, rem, over = search_early_stop_packed(
            sh.lattice, sh.latk, sh.latk_inv, sh.C, sh.dollar_row,
            sh.kmer_tables[d], rw2, ab2, 0, L, d, step, H, mt)
        return rw2, ab2, lens2, lm2, sp, ep, rem, over

    def upto_search(sh, rwi, abi):
        *_, sp, ep, rem, over = _search(sh, rwi, abi)
        return acc(sp) + acc(ep) + acc(rem) + acc(over)

    def _compact(sh, rwi, abi):
        rw2, ab2, lens2, lm2, sp, ep, rem, over = _search(sh, rwi, abi)
        rows, rvalid, overflow = interval_rows(sp, ep, H)
        sel, count, co, _dropped = compact_counts(ep - sp, H, cap)
        return rw2, ab2, lens2, lm2, rem, rows, sel, count, co

    def upto_compact(sh, rwi, abi):
        *_, sel, count, co = _compact(sh, rwi, abi)
        return acc(sel) + count + co

    def _locate(sh, rwi, abi):
        """'locate' = the locv row gather (fused path) or the small-
        table ssa lookup (--no-locv), matching the engine's branch."""
        rw2, ab2, lens2, lm2, rem, rows, sel, count, co = _compact(
            sh, rwi, abi)
        sel_valid = jnp.arange(cap, dtype=jnp.int32) < count
        rows_c = jnp.take(rows.reshape(-1), sel)
        if use_locv:
            rec = jnp.take(sh.locv, rows_c, axis=0)
            spos = jnp.where(sel_valid, rec[:, 0], -1)
        else:
            rec = None
            spos = locate_rows(sh.lattice, sh.ssa, sh.C, sh.dollar_row,
                               rows_c, sel_valid, cfg.sa_rate)
        return (rw2, ab2, lens2, lm2, rem, sel, count, co, sel_valid,
                rec, spos)

    def upto_locate(sh, rwi, abi):
        *_, rec, spos = _locate(sh, rwi, abi)
        return acc(spos)

    def _fused(sh, rwi, abi):
        (rw2, ab2, lens2, lm2, rem, sel, count, co, sel_valid, rec,
         spos) = _locate(sh, rwi, abi)
        lane = sel // H
        W = rw2.shape[1]
        fused = jnp.concatenate(
            [rw2, ab2, lm2, lens2[:, None], rem[:, None]], axis=1)
        fc = jnp.take(fused, lane, axis=0)
        cand = spos - fc[:, 3 * W + 1]
        return (W, sel, count, co, sel_valid, rec, spos, cand, fc)

    def upto_fused(sh, rwi, abi):
        *_, cand, fc = _fused(sh, rwi, abi)
        return acc(fc) + acc(cand)

    def _verify(sh, rwi, abi):
        (W, sel, count, co, sel_valid, rec, spos, cand, fc) = _fused(
            sh, rwi, abi)
        if use_locv:
            nm = verify_packed_locv(
                rec, sh.text_len, cand, sel_valid & (spos >= 0),
                fc[:, :W], fc[:, W:2 * W], fc[:, 2 * W:3 * W], fc[:, 3 * W])
        else:
            nm = verify_packed(
                sh.text_rows, sh.text_len, cand, sel_valid & (spos >= 0),
                fc[:, :W], fc[:, W:2 * W], fc[:, 2 * W:3 * W], fc[:, 3 * W])
        return sel, count, cand, nm

    def upto_verify(sh, rwi, abi):
        *_, nm = _verify(sh, rwi, abi)
        return acc(nm)

    def upto_hits(sh, rwi, abi):
        sel, count, cand, nm = _verify(sh, rwi, abi)
        keep = (nm <= 0) & (jnp.arange(cap, dtype=jnp.int32) < count)
        sel2, cnt2, hov = compact_mask(keep, hit_cap)
        payload = jnp.stack([cand, sel * 4 + nm], axis=1)
        out2 = jnp.take(payload, sel2, axis=0)
        return acc(out2) + cnt2 + hov

    stages = [
        ("prep", upto_prep), ("kmer", upto_kmer), ("search", upto_search),
        ("compact", upto_compact), ("locate", upto_locate),
        ("fused", upto_fused), ("verify", upto_verify), ("hits", upto_hits),
    ]

    def wrap(stage):
        @jax.jit
        def run(sh, rwi, abi, seed):
            def body(t, a):
                r = (seed + t) % jnp.int32(B)
                return a + stage(sh, jnp.roll(rwi, r, axis=0),
                                 jnp.roll(abi, r, axis=0))
            return jax.lax.fori_loop(0, args.reps, body, jnp.int32(0))
        return run

    results = {}
    prev = 0.0
    for name, stage in stages:
        run = wrap(stage)
        np.asarray(run(shard, rw, ab, jnp.int32(0)))  # compile + warm
        best = float("inf")
        for trial in range(2):
            t0 = time.time()
            outs = [run(shard, rw, ab, jnp.int32(1000 * (trial + 1) + i))
                    for i in range(args.dispatches)]
            for o in outs:
                np.asarray(o)
            best = min(best, (time.time() - t0) / (args.dispatches * args.reps))
        results[name + "_ms"] = round((best - prev) * 1e3, 2)
        results["cum_" + name + "_ms"] = round(best * 1e3, 2)
        prev = best
        print(f"# {name}: cum {best * 1e3:.2f} ms", file=sys.stderr, flush=True)

    full_ms = prev * 1e3
    print(json.dumps({
        "batch": B, "reps": args.reps, "min_trips": mt,
        "loc_factor": args.loc_factor, "cap": cap, "hit_cap": hit_cap,
        "full_ms": round(full_ms, 2),
        "reads_per_s": round(B / (full_ms / 1e3), 1),
        **{k: v for k, v in results.items() if not k.startswith("cum_")},
    }), flush=True)


if __name__ == "__main__":
    main()
