"""bwtpu command line (layer L6, SURVEY.md §1).

Subcommands:
  build-index  FASTA -> on-disk index artifact (sharded, versioned)
  align        index + FASTQ (single or paired) -> SAM, streamed in
               batches with a checkpointed batch cursor for resume
               (SURVEY.md §5.3-5.4) and a structured per-batch log line
               (§5.5)
  simulate     deterministic test genomes / read sets (component C20)
  bench        the driver benchmark (bench.py)

Examples:
  python cli.py build-index ref.fa idx/ --shards 4 --sa-rate 8
  python cli.py align idx/ reads.fq -o out.sam -k 2
  python cli.py align idx/ r1.fq --paired r2.fq -o out.sam
  python cli.py simulate --scale ecoli -o data/
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

log = logging.getLogger("bwtpu.cli")


def cmd_build_index(args):
    import numpy as np

    from bwtpu.config import EngineConfig
    from bwtpu.index import build_sharded_index, save_index
    from bwtpu.io import read_fasta

    t0 = time.time()
    genome, contigs = read_fasta(args.fasta)
    cfg = EngineConfig(
        sa_rate=args.sa_rate,
        kmer_d=args.kmer_d,
        read_len=args.read_len,
        max_hits=args.max_hits,
        max_cand=args.max_cand,
    )
    n_shards = args.shards
    if n_shards == 0:  # auto: keep every shard under ~256 Mbp
        n_shards = max(1, -(-len(genome) // (256 * 10**6)))
    shards, manifest = build_sharded_index(
        genome, n_shards, config=cfg, contigs=contigs, overlap=args.overlap,
        jobs=args.jobs,
    )
    save_index(args.out, shards, manifest)
    total_bytes = sum(
        s.search_lattice.nbytes + s.ssa.nbytes + s.text_packed.nbytes
        + s.mark_rank_ck.nbytes
        + sum(t.nbytes for t in s.kmer_tables.values())
        for s in shards
    )
    print(
        f"built index: {len(genome)} bp, {len(contigs)} contig(s), "
        f"{n_shards} shard(s), {total_bytes/1e6:.1f} MB, "
        f"{time.time()-t0:.1f}s -> {args.out}"
    )


def _open_out(path):
    return sys.stdout if path in (None, "-") else open(path, "w")


def _align_block_stream(engine, stream, manifest, args, k, bs, start_batch,
                        cursor_path, mode):
    """Columnar single-end fast path: chunk-prefetched ReadBlock batches
    (readblock.read_fastq_stream — parse overlaps dispatch/emit) ->
    primary SAM records via the vectorized assembler + C formatter
    (VERDICT r2 #1). Byte-equal to the Read-list path
    (tests/test_fastpath.py)."""
    import numpy as np

    from bwtpu.results import ContigTable, select_primary_flat
    from bwtpu.samfast import emit_single
    from bwtpu.sam import sam_header

    from concurrent.futures import ThreadPoolExecutor

    ctable = ContigTable.build(manifest.contigs)
    out = (
        sys.stdout.buffer
        if args.out in (None, "-")
        else open(args.out, mode + "b")
    )
    t_start = time.time()
    total = 0
    # finish (device fetch + vectorized assembly) runs in one worker
    # thread so it overlaps SAM formatting/IO on the main thread; SAM
    # and the cursor are still written strictly in order
    ex = ThreadPoolExecutor(max_workers=1)

    def process(handle):
        flat = engine.finish_block(handle)
        return flat, select_primary_flat(flat)

    try:
        if mode == "w":
            out.write(sam_header(manifest.contigs).encode())
        inflight = []

        def drain_one():
            nonlocal total
            bi0, t0, sub, fut = inflight.pop(0)
            flat, prim = fut.result()
            out.write(emit_single(sub, prim, ctable, truncated=flat.truncated))
            total += sub.n
            print(
                json.dumps({
                    "event": "batch", "batch": bi0, "reads": sub.n,
                    "hits": int(len(flat.read_idx)),
                    "reads_per_s": round(sub.n / (time.time() - t0), 1),
                    "ms": round((time.time() - t0) * 1e3, 1),
                }),
                file=sys.stderr,
            )
            _save_cursor(cursor_path, bi0 + 1)

        for bi, sub in enumerate(stream, start=start_batch):
            handle = engine.dispatch_block(sub, k, pad_to=bs,
                                           tiered=args.tiered)
            inflight.append((bi, time.time(), sub, ex.submit(process, handle)))
            if len(inflight) > 3:
                drain_one()
        while inflight:
            drain_one()
    finally:
        ex.shutdown(wait=False)
        if out is not sys.stdout.buffer:
            out.close()
    return total, t_start


def _align_ragged_block_stream(engine, gen, manifest, args, k, bs,
                               start_batch, cursor_path, mode):
    """Length-bucketed ragged fast path (VERDICT r3 item 7 — the
    single-process twin of bwtpu/multihost.py's bucketed schedule):
    each input-order chunk dispatches one packed columnar block per
    distinct read length (padded to the next power of two so compiled
    programs are reused across chunks), and the chunk emits in INPUT
    order via a vectorized record reorder
    (samfast.reorder_sam_records) — a mixed-length FASTQ never demotes
    to the ~0.38 M reads/s object-per-read path."""
    from concurrent.futures import ThreadPoolExecutor

    from bwtpu.results import ContigTable, select_primary_flat
    from bwtpu.sam import sam_header
    from bwtpu.samfast import emit_single, reorder_sam_records

    ctable = ContigTable.build(manifest.contigs)
    out = (
        sys.stdout.buffer
        if args.out in (None, "-")
        else open(args.out, mode + "b")
    )
    t_start = time.time()
    total = 0
    ex = ThreadPoolExecutor(max_workers=1)

    def process(handles):
        blobs, idxs, n = [], [], 0
        for blk, sub, h in handles:
            flat = engine.finish_block(h)
            prim = select_primary_flat(flat)
            blobs.append(
                emit_single(blk, prim, ctable, truncated=flat.truncated)
            )
            idxs.append(sub)
            n += blk.n
        return reorder_sam_records(blobs, idxs), n

    try:
        if mode == "w":
            out.write(sam_header(manifest.contigs).encode())
        inflight = []

        def drain_one():
            nonlocal total
            bi0, t0, fut = inflight.pop(0)
            blob, nreads = fut.result()
            out.write(blob)
            total += nreads
            print(
                json.dumps({
                    "event": "batch", "batch": bi0, "reads": nreads,
                    "reads_per_s": round(nreads / (time.time() - t0), 1),
                    "ms": round((time.time() - t0) * 1e3, 1),
                }),
                file=sys.stderr,
            )
            _save_cursor(cursor_path, bi0 + 1)

        for bi, groups in enumerate(gen, start=start_batch):
            handles = []
            for blk, sub in groups:
                pad = 1 << max(0, (blk.n - 1).bit_length())
                handles.append(
                    (blk, sub, engine.dispatch_block(blk, k, pad_to=pad,
                                                     tiered=args.tiered))
                )
            inflight.append((bi, time.time(), ex.submit(process, handles)))
            if len(inflight) > 2:
                drain_one()
        while inflight:
            drain_one()
    finally:
        ex.shutdown(wait=False)
        if out is not sys.stdout.buffer:
            out.close()
    return total, t_start


def _align_paired_block_stream(engine, stream1, stream2, manifest, args, k,
                               bs, start_batch, cursor_path, mode):
    """Columnar paired fast path: both mates stack on the batch axis
    into ONE dispatch per round; pairing is vectorized
    (results.select_pairs) and the whole round emits through one
    interleaved C-formatter call (samfast.emit_paired). Byte-equal to
    the Read-list path (tests/test_fastpath.py)."""
    from concurrent.futures import ThreadPoolExecutor

    from bwtpu.readblock import concat_blocks
    from bwtpu.results import (ContigTable, select_pairs,
                               select_primary_flat, split_flat)
    from bwtpu.sam import sam_header
    from bwtpu.samfast import emit_paired

    ctable = ContigTable.build(manifest.contigs)
    out = (
        sys.stdout.buffer
        if args.out in (None, "-")
        else open(args.out, mode + "b")
    )
    t_start = time.time()
    total = 0
    ex = ThreadPoolExecutor(max_workers=1)

    def process(sub1, sub2, handle):
        flat = engine.finish_block(handle)
        f1, f2 = split_flat(flat, sub1.n)
        choice = select_pairs(f1, f2, sub1.L, sub2.L, args.min_insert,
                              args.max_insert)
        return emit_paired(sub1, sub2, f1, f2, choice,
                           select_primary_flat(f1), select_primary_flat(f2),
                           ctable)

    try:
        if mode == "w":
            out.write(sam_header(manifest.contigs).encode())
        inflight = []

        def drain_one():
            nonlocal total
            bi0, t0, n_pair, fut = inflight.pop(0)
            out.write(fut.result())
            total += 2 * n_pair
            print(
                json.dumps({
                    "event": "batch", "batch": bi0, "reads": 2 * n_pair,
                    "reads_per_s": round(
                        2 * n_pair / (time.time() - t0), 1
                    ),
                    "ms": round((time.time() - t0) * 1e3, 1),
                }),
                file=sys.stderr,
            )
            _save_cursor(cursor_path, bi0 + 1)

        for bi, (sub1, sub2) in enumerate(zip(stream1, stream2),
                                          start=start_batch):
            if sub1.n != sub2.n:
                raise SystemExit("paired files differ in read count")
            handle = engine.dispatch_block(
                concat_blocks(sub1, sub2), k, pad_to=2 * bs,
                tiered=args.tiered
            )
            inflight.append(
                (bi, time.time(), sub1.n, ex.submit(process, sub1, sub2, handle))
            )
            if len(inflight) > 3:
                drain_one()
        while inflight:
            drain_one()
    finally:
        ex.shutdown(wait=False)
        if out is not sys.stdout.buffer:
            out.close()
    return total, t_start


def cmd_align(args):
    from bwtpu.engine import Engine
    from bwtpu.index import load_index
    from bwtpu.io import read_reads
    from bwtpu.sam import emit_sam, pair_and_emit_sam, sam_header

    shards, manifest = load_index(args.index)
    if getattr(args, "esc_factor", None) is not None:
        import dataclasses as _dc

        shards = [
            _dc.replace(s, config=s.config.replace(
                esc_factor=args.esc_factor))
            for s in shards
        ]
    engine = Engine(shards, manifest)
    k = args.k if args.k is not None else shards[0].config.k
    bs = args.batch_size

    if args.autotune_caps:
        # occupancy-adaptive capacities (Engine.autotune_caps): probe
        # the first chunk at the configured ceilings, then size
        # loc_factor/hit_factor to the observed live fractions —
        # healing absorbs batches that beat the thin margin
        try:
            from bwtpu.readblock import read_fastq_stream

            res0 = read_fastq_stream(args.reads, bs)
            sample = next(res0[2], None) if res0 else None
            if sample is not None and 0 < sample.L <= engine.config.read_len:
                lf = engine.autotune_caps(sample, k, pad_to=bs)
                print(json.dumps({
                    "event": "autotune", "loc_factor": lf,
                    "hit_factor": engine._hf(k),
                }), file=sys.stderr)
        except Exception as e:  # tuning is an optimization, never fatal
            log.warning("autotune-caps skipped: %s", e)

    profile_ctx = None
    if args.profile:
        import jax

        os.makedirs(args.profile, exist_ok=True)
        jax.profiler.start_trace(args.profile)
        profile_ctx = True

    cursor_path = (args.out + ".cursor") if args.out and args.out != "-" else None
    start_batch = 0
    if args.resume and cursor_path and os.path.exists(cursor_path):
        with open(cursor_path) as f:
            start_batch = json.load(f)["next_batch"]
        log.info("resuming at batch %d", start_batch)
    mode = "a" if (args.resume and start_batch > 0) else "w"

    if not args.profile and not args.rescore:
        # columnar fast path (uniform-length FASTQ); falls back to the
        # Read-list path for ragged/FASTA inputs. Resume skips
        # already-done chunks WITHOUT parsing them (scan checkpoints).
        from bwtpu.readblock import read_fastq_stream

        res = read_fastq_stream(args.reads, bs, start=start_batch)
        if not args.paired:
            if res is not None and 0 < res[1] <= engine.config.read_len:
                _n_total, _L, stream = res
                total, t_start = _align_block_stream(
                    engine, stream, manifest, args, k, bs, start_batch,
                    cursor_path, mode,
                )
                _print_summary(engine, total, t_start)
                return engine
            if res is None:
                # mixed-length FASTQ: length-bucketed columnar path
                from bwtpu.readblock import read_fastq_stream_ragged

                resr = read_fastq_stream_ragged(args.reads, bs,
                                                start=start_batch)
                if resr is not None and 0 < resr[1] <= engine.config.read_len:
                    _n_total, _maxL, gen = resr
                    total, t_start = _align_ragged_block_stream(
                        engine, gen, manifest, args, k, bs, start_batch,
                        cursor_path, mode,
                    )
                    _print_summary(engine, total, t_start)
                    return engine
        else:
            res2 = read_fastq_stream(args.paired, bs, start=start_batch)
            if (
                res is not None and res2 is not None
                and res[0] == res2[0] and res[1] == res2[1]
                and 0 < res[1] <= engine.config.read_len
            ):
                total, t_start = _align_paired_block_stream(
                    engine, res[2], res2[2], manifest, args, k, bs,
                    start_batch, cursor_path, mode,
                )
                _print_summary(engine, total, t_start)
                return engine

    reads = read_reads(args.reads)
    out = sys.stdout if args.out in (None, "-") else open(args.out, mode)
    t_start = time.time()
    total = 0
    try:
        if args.paired:
            reads2 = read_reads(args.paired)
            if len(reads2) != len(reads):
                raise SystemExit("paired files differ in read count")
            if mode == "w":
                out.write(sam_header(manifest.contigs))
            for bi in range(0, len(reads), bs):
                if bi // bs < start_batch:
                    continue
                t0 = time.time()
                r1 = reads[bi : bi + bs]
                r2 = reads2[bi : bi + bs]
                h1 = engine.align_batch(r1, k=k)
                h2 = engine.align_batch(r2, k=k)
                pair_and_emit_sam(
                    list(zip(r1, r2)), h1, h2, manifest.contigs, out,
                    min_insert=args.min_insert, max_insert=args.max_insert,
                    header=False,
                )
                total += 2 * len(r1)
                _log_batch(bi // bs, 2 * len(r1), h1, h2, t0)
                _save_cursor(cursor_path, bi // bs + 1)
        else:
            if mode == "w":
                out.write(sam_header(manifest.contigs))
            # pipelined: keep a few batches in flight (hides dispatch
            # latency); SAM + cursor are written strictly in order
            inflight = []

            def drain_one():
                nonlocal total
                bi0, t0, chunk, handle = inflight.pop(0)
                hits = engine.finish_batch(handle)
                tags = None
                if args.rescore:
                    # banded-SW rescore of the primary hit -> AS:i tag
                    from bwtpu.golden import select_primary
                    from bwtpu.sw import rescore_candidates

                    primaries = [
                        [select_primary(h)[0]] if h else [] for h in hits
                    ]
                    scores = rescore_candidates(engine, chunk, primaries)
                    tags = [
                        f"AS:i:{scores[(i, 0)]}" if (i, 0) in scores else None
                        for i in range(len(chunk))
                    ]
                emit_sam(chunk, hits, manifest.contigs, out, header=False,
                         tags_per_read=tags)
                total += len(chunk)
                _log_batch(bi0, len(chunk), hits, None, t0)
                _save_cursor(cursor_path, bi0 + 1)

            for bi in range(0, len(reads), bs):
                if bi // bs < start_batch:
                    continue
                chunk = reads[bi : bi + bs]
                inflight.append(
                    (bi // bs, time.time(), chunk, engine.dispatch_batch(chunk, k))
                )
                if len(inflight) > 3:
                    drain_one()
            while inflight:
                drain_one()
    finally:
        if out is not sys.stdout:
            out.close()
        if profile_ctx:
            import jax

            jax.profiler.stop_trace()

    _print_summary(engine, total, t_start)
    return engine


def _print_summary(engine, total, t_start):
    dt = time.time() - t_start
    st = engine.stats
    print(
        json.dumps({
            "event": "summary", "reads": total, "hits": st.hits,
            "reads_per_s": round(total / dt, 1), "wall_s": round(dt, 2),
            "device_s": round(st.device_s, 2), "host_s": round(st.host_s, 2),
            "overflow_reads": st.overflow_reads,
            "compact_overflows": st.compact_overflows,
            "heals": st.heals, "escalated": st.escalated,
        }),
        file=sys.stderr,
    )


def _log_batch(bid, n, h1, h2, t0):
    dt = time.time() - t0
    nh = sum(len(h) for h in h1) + (sum(len(h) for h in h2) if h2 else 0)
    print(
        json.dumps({
            "event": "batch", "batch": bid, "reads": n, "hits": nh,
            "reads_per_s": round(n / dt, 1), "ms": round(dt * 1e3, 1),
        }),
        file=sys.stderr,
    )


def _save_cursor(path, next_batch):
    if path:
        with open(path, "w") as f:
            json.dump({"next_batch": next_batch}, f)


def cmd_simulate(args):
    from bwtpu.io import write_fasta, write_fastq
    from bwtpu.simulate import (CHR21_SCALE, ECOLI_SCALE, PHIX_SCALE,
                                random_genome, simulate_pairs, simulate_reads)

    scale = {"phix": PHIX_SCALE, "ecoli": ECOLI_SCALE, "chr21": CHR21_SCALE}.get(
        args.scale, None
    )
    n = scale if scale else int(args.scale)
    os.makedirs(args.out, exist_ok=True)
    genome = random_genome(n, seed=args.seed)
    write_fasta(os.path.join(args.out, "ref.fa"), [("sim1", genome)])
    reads, truth = simulate_reads(
        genome, args.n_reads, read_len=args.read_len,
        max_mismatches=args.mismatches, n_frac=args.n_frac, seed=args.seed + 1,
        error_rate=args.error_rate,
    )
    write_fastq(os.path.join(args.out, "reads.fq"), reads)
    with open(os.path.join(args.out, "truth.json"), "w") as f:
        json.dump(truth, f)
    if args.pairs:
        pairs, ptruth = simulate_pairs(
            genome, args.pairs, read_len=args.read_len, seed=args.seed + 2
        )
        write_fastq(os.path.join(args.out, "reads_1.fq"), [p[0] for p in pairs])
        write_fastq(os.path.join(args.out, "reads_2.fq"), [p[1] for p in pairs])
        with open(os.path.join(args.out, "truth_pairs.json"), "w") as f:
            json.dump(ptruth, f)
    print(f"simulated {n} bp genome + {args.n_reads} reads -> {args.out}")


def cmd_bench(args):
    import bench

    bench.main()


def cmd_scaling(args):
    """Scaling-efficiency harness (BASELINE north star: >=80% reads/s
    efficiency scaling out). Runs the ring DistEngine over 1..max_data
    data-parallel lanes on the available devices and reports efficiency
    vs the single-lane rate. On a CPU host this exercises the code path
    functionally; meaningful numbers need real multi-GPU hosts."""
    import jax
    import numpy as np

    from bwtpu.config import EngineConfig
    from bwtpu.dist import DistEngine
    from bwtpu.index import build_sharded_index
    from bwtpu.simulate import random_genome, simulate_reads

    cfg = EngineConfig(sa_rate=8, max_hits=4, max_cand=8, read_len=args.read_len)
    genome = random_genome(args.genome_bp, seed=1)
    shards, manifest = build_sharded_index(
        genome, args.shards, config=cfg, overlap=cfg.read_len * 2
    )
    reads, _ = simulate_reads(genome, args.n_reads, read_len=args.read_len,
                              max_mismatches=2, seed=2)
    n_dev = len(jax.devices())
    base = None
    rows = []
    nd = 1
    while args.shards * nd <= n_dev:
        eng = DistEngine(shards, manifest, n_data=nd)
        eng.align_batch(reads[: args.shards * nd * 2], k=args.k)  # compile
        t0 = time.time()
        eng.align_batch(reads, k=args.k)
        rps = len(reads) / (time.time() - t0)
        if base is None:
            base = rps
        eff = rps / (base * nd)
        rows.append({"n_data": nd, "devices": args.shards * nd,
                     "reads_per_s": round(rps, 1),
                     "efficiency": round(eff, 3)})
        nd *= 2
    print(json.dumps({"event": "scaling", "shards": args.shards, "rows": rows}))


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s %(message)s")
    from bwtpu.hosttune import setup_compile_cache, tune_malloc

    tune_malloc()  # page-fault wall: docs/DESIGN.md, bwtpu/hosttune.py
    setup_compile_cache()
    p = argparse.ArgumentParser(prog="bwtpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-index", help="build an FM-index artifact")
    b.add_argument("fasta")
    b.add_argument("out")
    b.add_argument("--shards", type=int, default=0, help="0 = auto")
    b.add_argument("--sa-rate", type=int, default=8)
    b.add_argument("--kmer-d", type=int, default=None)
    b.add_argument("--read-len", type=int, default=100)
    b.add_argument("--max-hits", type=int, default=16)
    b.add_argument("--max-cand", type=int, default=32)
    b.add_argument("--overlap", type=int, default=256)
    b.add_argument("--jobs", type=int, default=1,
                   help="parallel shard-build processes")
    b.set_defaults(fn=cmd_build_index)

    a = sub.add_parser("align", help="align reads, emit SAM")
    a.add_argument("index")
    a.add_argument("reads")
    a.add_argument("--paired", help="mate FASTQ for paired-end")
    a.add_argument("-o", "--out", default="-")
    a.add_argument("-k", type=int, default=None, help="max mismatches (default: index config)")
    a.add_argument("--batch-size", type=int, default=16384)
    a.add_argument("--min-insert", type=int, default=0)
    a.add_argument("--max-insert", type=int, default=1000)
    a.add_argument("--tiered", action="store_true",
                   help="exact-first tiered inexact search: only reads "
                        "with no exact hit escalate to the seed "
                        "expansion (stratum reporting contract — "
                        "engine.tiered_pipeline_packed docstring; "
                        "primary/MAPQ identical to full enumeration). "
                        "Multiple-x faster on low-error read sets")
    a.add_argument("--esc-factor", type=float, default=None,
                   help="tiered: escalated-read capacity as a fraction "
                        "of the batch (default: index config, 1.0)")
    a.add_argument("--autotune-caps", action="store_true",
                   help="probe the first chunk and size the candidate/"
                        "hit capacities to measured occupancy (healing "
                        "backstops the thin margin)")
    a.add_argument("--resume", action="store_true",
                   help="resume from <out>.cursor after an interrupted run")
    a.add_argument("--rescore", action="store_true",
                   help="banded Smith-Waterman rescore of each primary "
                        "hit; adds an AS:i tag (single-end, Read-list "
                        "path)")
    a.add_argument("--profile", help="write a jax profiler trace to this dir")
    a.set_defaults(fn=cmd_align)

    s = sub.add_parser("simulate", help="generate test genome + reads")
    s.add_argument("--scale", default="phix", help="phix|ecoli|chr21|<bp>")
    s.add_argument("-o", "--out", default="data/sim")
    s.add_argument("--n-reads", type=int, default=1000)
    s.add_argument("--read-len", type=int, default=100)
    s.add_argument("--mismatches", type=int, default=2)
    s.add_argument("--n-frac", type=float, default=0.0)
    s.add_argument("--error-rate", type=float, default=None,
                   help="per-base substitution rate (Binomial mismatch "
                        "count, capped at --mismatches); default: "
                        "uniform 0..--mismatches")
    s.add_argument("--pairs", type=int, default=0)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_simulate)

    be = sub.add_parser("bench", help="run the driver benchmark")
    be.set_defaults(fn=cmd_bench)

    sc = sub.add_parser("scaling", help="ring-scaling efficiency harness")
    sc.add_argument("--shards", type=int, default=2)
    sc.add_argument("--genome-bp", type=int, default=200_000)
    sc.add_argument("--n-reads", type=int, default=2048)
    sc.add_argument("--read-len", type=int, default=100)
    sc.add_argument("-k", type=int, default=0)
    sc.set_defaults(fn=cmd_scaling)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
