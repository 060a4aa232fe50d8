"""Benchmark harness: prints ONE JSON line with the driver metric.

Metric (BASELINE.json): reads/s/chip for exact + 2-mismatch search vs
the CPU reference. The "CPU reference" is the golden model
(bwtpu.golden) — the reference repo's interpreted per-read walk style
(the mount was empty; SURVEY.md §0) — measured in-process on a sample
and extrapolated.

Config: E. coli-scale (4.6 Mbp) random genome, 100 bp simulated reads,
both strands, replicated index, one chip (BASELINE configs 1-2).
`--smoke` runs a 50 kbp / 1 K-read miniature of the same code path so
trace-time failures on the bench entry can never ship silently
(VERDICT r1 item 2c); it is wired into the test suite and Makefile.

Measurement method: N DISTINCT pre-staged device batches are
dispatched back-to-back (the way a production stream runs) and waited
on once with jax.block_until_ready; the wall is the best of two such
rounds after a compile-and-warm call.

Roofline (VERDICT r1 item 7): the early-stop engine's speed of light is
restated in GATHERED ROWS PER READ by stage (kmer start, multi-step
probe trips, compacted 1-step finisher, locate, packed verify), with
the two data-dependent quantities (probe trips, finisher lane count)
measured on-device via search_early_stop_uniform(with_stats=True).
Rows, not bytes: the pipelines are bound by the data-dependent gather
RATE, which is calibrated per run on the device's own tables
(calibrate_ns_per_row). sol_fraction = model_time / measured_time with
model_time = rows * ns_per_row; the model excludes scatters, cumsums
and elementwise traffic, so it is a lower bound. The bytes-based
share of the device's peak memory bandwidth (PEAK_HBM_BYTES_PER_S) is
emitted beside it; it is null on a device without a published peak
(the CPU).
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np

# jax device_kind -> published peak device-memory bandwidth (bytes/s).
# NVIDIA H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

def calibrate_ns_per_row(table, n_rows=1 << 22, reps=3) -> float:
    """Measure this device's data-dependent gather rate (ns/row) on the
    actual lattice table. The rate — not bytes — is the binding
    resource for the FM-index pipelines (docs/DESIGN.md "Gather model"),
    so the roofline calibrates it per run instead of trusting a
    constant. The consumer sums ALL columns so XLA cannot narrow the
    gather (DESIGN.md "Gather model"), and each dispatch uses a
    distinct index stream so no cache serves a repeat."""
    import jax
    import jax.numpy as jnp

    N = np.int64(table.shape[0])

    # The table MUST be a jit ARGUMENT, not a closure capture: a
    # closed-over array is embedded in the HLO as a constant (294 MB
    # for the locv table).
    @jax.jit
    def probe(tbl, seed):
        idx = (
            jnp.arange(n_rows, dtype=jnp.uint32) * (jnp.uint32(2654435761)
                                                    + jnp.uint32(2) * seed)
        ) % jnp.uint32(N)
        return jnp.take(tbl, idx.astype(jnp.int32), axis=0).sum(axis=0)

    jax.block_until_ready(probe(table, jnp.uint32(0)))  # compile + warm
    t0 = time.time()
    jax.block_until_ready(
        [probe(table, jnp.uint32(s + 1)) for s in range(reps)])
    return (time.time() - t0) / (reps * n_rows) * 1e9


def hbm_bandwidth(dev) -> float | None:
    """Published peak memory bandwidth of `dev` (bytes/s); None on the
    CPU, which has no device metric. A GPU missing from the table is an
    error, never a default."""
    if dev.platform == "cpu":
        return None
    try:
        return PEAK_HBM_BYTES_PER_S[dev.device_kind]
    except KeyError:
        raise ValueError(
            f"no peak bandwidth on file for device_kind "
            f"{dev.device_kind!r}; add it to PEAK_HBM_BYTES_PER_S"
        ) from None


def gather_model(B2, L, d, step, trips, n_unf, max_loc, nS,
                 loc_factor, sa_rate, locv=False):
    """Data-dependent gather (rows, bytes, locv_rows) for one packed
    compact-path batch.

    Stages (bwtpu/engine.py exact/inexact_pipeline_packed):
      kmer start        B2*nS lanes x 1 row (8 B)
      multi-step probes trips x B2*nS lanes x 1 OCCK record (step 3: 512 B)
      finisher          cap_fix lanes x (slen-d) steps x 2 rows (128 B)
      locate+verify     locv fused: cap_loc x 2 rows (locv row carrying
                        SA value + verify window, plus the fused read
                        row) else: cap_loc x 1 locate row (4 B direct
                        SA | sa_rate x 128 B walk) + cap_loc x 2 verify
                        rows
    Compacted arrays have STATIC shapes, so traffic is the capacity,
    not the live count; n_unf only gates whether the finisher runs.

    locv_rows is returned separately because the fused table is the one
    table that does NOT gather at the cache-resident rate: the measured
    per-row cost is size-dependent (7 ns at 9 MB vs ~35 ns at 295 MB —
    DESIGN.md "gather cost vs TABLE SIZE"), so the roofline prices it
    with its own calibrated ns/row instead of pretending every row is
    cheap (round-4 model fix; the old single-rate model understated the
    light-speed time by ~2x and made sol_fraction uninterpretable).
    """
    from bwtpu.index import OCCK_WIDTH
    from bwtpu.kernels.verify2 import locv_row_width, window_row_width

    lanes = B2 * nS
    slen = L // nS if nS > 1 else L
    rec_k = OCCK_WIDTH[step] * 4
    cap_fix = max(256, B2 // 64)
    cap_loc = max(B2 * loc_factor, 4096)
    W = (L + 15) // 16

    rows = lanes                            # kmer table rows
    bytes_ = lanes * 8
    rows += trips * lanes                   # multi-step probe gathers
    bytes_ += trips * lanes * rec_k
    if n_unf > 0:                           # compacted 1-step finisher
        fix_rows = nS * cap_fix * max(slen - d, 0) * 2
        rows += fix_rows
        bytes_ += fix_rows * 128
    locv_rows = 0
    if locv:                                # fused locate+verify row
        locv_rows = cap_loc
        bytes_ += cap_loc * locv_row_width(L) * 4
    elif sa_rate == 1:                      # locate
        rows += cap_loc
        bytes_ += cap_loc * 4
    else:
        rows += cap_loc * sa_rate
        bytes_ += cap_loc * sa_rate * 128
    if not locv:                            # verify text row (stride-8)
        rows += cap_loc
        bytes_ += cap_loc * (window_row_width(L) + 7) * 4
    rows += cap_loc                         # fused read row
    bytes_ += cap_loc * (3 * W + 1 + nS) * 4
    return rows, bytes_, locv_rows


def multihost_probe(n_reads_per_host=2048, batch=512, n_procs=2):
    """One real n-process jax.distributed run on CPU (the launcher path
    BASELINE config 4-5 uses on a pod): builds a small sharded index,
    spawns `python -m bwtpu.multihost` processes against a localhost
    coordinator, and returns the aggregate host_summary rate (VERDICT
    r3 item 4). CPU-mesh collectives — a launcher-path liveness +
    throughput probe, not a device number. Running it at n_procs=1 and 2
    on the same per-host read volume yields the weak-scaling efficiency
    ratio rps(2)/(2*rps(1)) — the CPU proxy for the north star's
    '>=80% reads/s scaling efficiency' (VERDICT r4 item 6)."""
    import json as _json
    import os
    import socket
    import subprocess
    import sys as _sys
    import tempfile

    from bwtpu.config import EngineConfig
    from bwtpu.index import build_sharded_index, save_index
    from bwtpu.simulate import random_genome, simulate_reads

    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="bwtpu_mh_")
    genome = random_genome(400_000, seed=17)
    cfg = EngineConfig(sa_rate=4, max_hits=8, max_cand=8, read_len=100)
    shards, manifest = build_sharded_index(genome, 2, config=cfg,
                                           overlap=128)
    idx_dir = os.path.join(tmp, "idx")
    save_index(idx_dir, shards, manifest)
    read_files = []
    for h in range(n_procs):
        rds, _ = simulate_reads(genome, n_reads_per_host, read_len=100,
                                max_mismatches=2, seed=40 + h)
        p = os.path.join(tmp, f"reads{h}.fq")
        with open(p, "w") as f:
            for r in rds:
                f.write(f"@{r.rid}\n{r.seq}\n+\n{'I' * 100}\n")
        read_files.append(p)

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    # the children run on the CPU; hiding the GPUs keeps them from
    # reserving device memory the parent process holds
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [
        subprocess.Popen(
            [_sys.executable, "-m", "bwtpu.multihost",
             "--coordinator", f"localhost:{port}",
             "--num-processes", str(n_procs), "--process-id", str(h),
             "--index", idx_dir, "--reads", read_files[h],
             "--out", os.path.join(tmp, "out.sam"), "-k", "0",
             "--batch-size", str(batch), "--platform", "cpu",
             "--host-devices", "4"],
            env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for h in range(n_procs)
    ]
    total_reads = 0
    max_wall = 0.0
    for p in procs:
        _, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(
                f"multihost process failed: {err.decode()[-500:]}")
        for line in err.decode().splitlines():
            if '"host_summary"' in line:
                rec = _json.loads(line)
                total_reads += rec["reads"]
                max_wall = max(max_wall, rec["wall_s"])
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return total_reads / max(max_wall, 1e-9), total_reads, max_wall


def main():
    from bwtpu.hosttune import setup_compile_cache, tune_malloc

    tune_malloc()  # page-fault wall: docs/DESIGN.md, bwtpu/hosttune.py
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="20 kbp genome, 1 K reads — trace/shape check")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--nbatches", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU even where a GPU is present")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    setup_compile_cache()

    from bwtpu.config import EngineConfig
    from bwtpu.engine import (device_prep_packed, exact_pipeline_packed,
                              inexact_pipeline_packed,
                              pack_reads_for_bench, pick_kmer_depth,
                              upload_index)
    from bwtpu.golden import GoldenFMIndex
    from bwtpu.index import build_fm_index
    from bwtpu.kernels.searchk import search_early_stop_packed
    from bwtpu.kernels.verify import seed_layout
    from bwtpu.simulate import ECOLI_SCALE, random_genome, simulate_reads

    t0_all = time.time()
    timings = {}
    # sa_rate=1: full SA resident (4 B/base; ~18 MB at E. coli scale) so
    # locate is one element gather, no LF walk (docs/DESIGN.md)
    L = 100
    cfg = EngineConfig(sa_rate=1, max_hits=4, max_cand=8, read_len=L)
    # 20 kbp smoke: the smoke tier is a trace/shape check, not a
    # measurement — smaller genome = faster default test tier
    # (VERDICT r4 item 8). It cannot catch size-dependent failures —
    # only the full run can, which is why the roofline is
    # exception-guarded below.
    n_genome = 20_000 if args.smoke else ECOLI_SCALE
    genome = random_genome(n_genome, seed=1)
    t0 = time.time()
    idx = build_fm_index(genome, cfg)
    timings["index_build_s"] = round(time.time() - t0, 1)
    dev = upload_index([idx])
    shard0 = jax.tree.map(lambda x: x[0], dev.shard)
    depths = sorted(idx.kmer_tables)
    step = cfg.occ_step

    # Large batches amortize the fixed per-dispatch cost. The sizes
    # come from a batch sweep (scripts/ab_batch.py) on earlier
    # hardware: exact peaked at 524 K, and k=2 — whose 3-seed working
    # set is 3x wider — fell off a cache cliff between 459 K and 524 K.
    # ROADMAP queue 1 item 4 re-derives both on the GPU.
    B = args.batch or (1024 if args.smoke else 524288)
    B_k2 = min(B, 458752)
    t0 = time.time()
    n_batches = args.nbatches
    encs = []
    encs_k2 = []
    reads = None
    for i in range(n_batches):
        rds, _ = simulate_reads(genome, B, read_len=L, max_mismatches=2,
                                seed=2 + i)
        reads = reads or rds
        rw, ab = pack_reads_for_bench(rds)
        encs.append((jax.device_put(rw), jax.device_put(ab)))
        if B_k2 == B:
            # same batch geometry: reuse the exact batches instead of
            # uploading byte-identical copies (ADVICE r3 — doubled
            # encode_upload_s for nothing in smoke/small-batch runs)
            encs_k2.append(encs[-1])
        else:
            encs_k2.append(
                (jax.device_put(rw[:B_k2]), jax.device_put(ab[:B_k2]))
            )
    timings["encode_upload_s"] = round(time.time() - t0, 1)

    # --- exact (config 1) ---
    # min_trips=1 + loc_factor=0.45: one guaranteed multi-step trip
    # divides false candidates 4^3-fold, leaving measured occupancy
    # 0.45*B2 live candidates. Round 4 shipped 0.5 for safety margin
    # (the sweep found 0.4 LOSSY — DESIGN.md "locate/cap sweep");
    # round 5 runs the caps occupancy-
    # sized at 0.45 (VERDICT r4 item 3) because self-healing re-dispatch
    # is the backstop that makes zero-margin caps safe — the bench still
    # reports exact_overflow so a loss would be visible, and the e2e
    # engines below pick their caps by measured occupancy automatically
    # (Engine.autotune_caps).
    mt = 1
    exact_lf = 0.45
    d = pick_kmer_depth(depths, L)
    fx = jax.jit(functools.partial(
        exact_pipeline_packed, L=L, d=d, max_hits=cfg.max_hits,
        sa_rate=cfg.sa_rate, loc_factor=exact_lf, min_trips=mt,
        compact_output=True))
    np.asarray(fx(shard0, *encs[0])[0])
    exact_rps = 0.0
    exact_over = 0
    for _ in range(2):  # best-of-2
        t0 = time.time()
        outs = jax.block_until_ready([fx(shard0, *e) for e in encs])
        exact_rps = max(exact_rps, B * n_batches / (time.time() - t0))
        exact_over = max(
            exact_over,
            sum(int(np.asarray(o[5])) + int((np.asarray(o[4]) > 0).sum())
                for o in outs),
        )

    # --- inexact k=2 (config 2) ---
    # k2 loc_factor=1.5: the 3-seed candidate pool is nearly all TRUE
    # duplicates (~1.34*B2 live — every seed of a true locus matches),
    # so 1.5 leaves ~12% headroom with zero overflow where 1.0 drops
    # ~500 K rows, and it beat lf=2 in the round-4 ab_batch sweep.
    k2_lf = 1.5
    d_seed = pick_kmer_depth(depths, L // 3)
    fi = jax.jit(functools.partial(
        inexact_pipeline_packed, L=L, k=2, d=d_seed, max_loc=cfg.max_cand,
        sa_rate=cfg.sa_rate, loc_factor=k2_lf, min_trips=mt,
        compact_output=True))
    np.asarray(fi(shard0, *encs_k2[0])[1])
    k2_rps = 0.0
    k2_over = 0
    for _ in range(2):
        t0 = time.time()
        outs = jax.block_until_ready([fi(shard0, *e) for e in encs_k2])
        k2_rps = max(k2_rps, B_k2 * n_batches / (time.time() - t0))
        k2_over = max(
            k2_over,
            sum(int(np.asarray(o[5])) + int((np.asarray(o[4]) > 0).sum())
                for o in outs),
        )

    # --- tiered k=2 (VERDICT r3 item 2): exact-first, escalate misses ---
    # Stratum semantics (engine.tiered_pipeline_packed docstring):
    # escalated reads get the full <= k set, exact-hit reads their
    # complete nm == 0 stratum; primary/MAPQ identical to the full
    # enumeration. The bench read set escalates ~2/3 of reads (uniform
    # {0,1,2}-mismatch simulation); error-free production sets escalate
    # far less and win proportionally more.
    from bwtpu.engine import tiered_pipeline_packed

    ftd = jax.jit(functools.partial(
        tiered_pipeline_packed, L=L, k=2, d=d, d_seed=d_seed,
        max_hits=cfg.max_hits, max_cand=cfg.max_cand, sa_rate=cfg.sa_rate,
        loc_factor=exact_lf, k2_loc_factor=k2_lf, esc_factor=0.75,
        min_trips=mt))
    np.asarray(ftd(shard0, *encs_k2[0])[0])
    k2t_rps = 0.0
    k2t_over = 0
    esc_frac = 0.0
    for _ in range(2):
        t0 = time.time()
        outs = jax.block_until_ready([ftd(shard0, *e) for e in encs_k2])
        k2t_rps = max(k2t_rps, B_k2 * n_batches / (time.time() - t0))
        k2t_over = max(k2t_over, sum(
            int((np.asarray(o[10]) > 0).sum()) + int(np.asarray(o[11]))
            for o in outs))
        esc_frac = max(esc_frac, max(
            int(np.asarray(o[9])) for o in outs) / B_k2)

    # --- tiered k=2 at a realistic error profile (VERDICT r4 item 5) ---
    # 0.5%/base binomial errors: ~61% of 100 bp reads are error-free,
    # vs ~1/3 in the adversarial uniform {0,1,2} set above. The flat k2
    # pipeline runs on the SAME reads so the tiered speedup is a
    # measurement, not the model extrapolation DESIGN.md carried.
    encs_le = []
    for i in range(n_batches):
        rds_le, _ = simulate_reads(genome, B_k2, read_len=L,
                                   max_mismatches=2, seed=60 + i,
                                   error_rate=0.005)
        rw_le, ab_le = pack_reads_for_bench(rds_le)
        encs_le.append((jax.device_put(rw_le), jax.device_put(ab_le)))
    k2t_le_rps = 0.0
    esc_frac_le = 0.0
    for _ in range(2):
        t0 = time.time()
        outs = jax.block_until_ready([ftd(shard0, *e) for e in encs_le])
        k2t_le_rps = max(k2t_le_rps, B_k2 * n_batches / (time.time() - t0))
        esc_frac_le = max(esc_frac_le, max(
            int(np.asarray(o[9])) for o in outs) / B_k2)
    k2_le_rps = 0.0
    for _ in range(2):
        t0 = time.time()
        jax.block_until_ready([fi(shard0, *e) for e in encs_le])
        k2_le_rps = max(k2_le_rps, B_k2 * n_batches / (time.time() - t0))

    # --- end-to-end FASTQ -> SAM (production path, VERDICT r2 item 1) ---
    # The device numbers above exclude parse/upload/assembly/emission;
    # this measures the whole pipe the way `cli.py align` runs it:
    # columnar parse -> packed dispatch (pipelined) -> count-sliced
    # compact fetch -> vectorized primary -> C SAM formatter -> file.
    import dataclasses as _dc
    import os as _os
    import tempfile as _tf

    from bwtpu.engine import Engine
    from bwtpu.io import write_fastq
    from bwtpu.readblock import read_fastq_block, read_fastq_stream
    from bwtpu.results import ContigTable, select_primary_flat
    from bwtpu.sam import sam_header
    from bwtpu.samfast import emit_single

    from concurrent.futures import ThreadPoolExecutor

    from bwtpu.readblock import concat_blocks
    from bwtpu.results import select_pairs, split_flat
    from bwtpu.samfast import emit_paired
    from bwtpu.simulate import simulate_pairs

    # The e2e loop is HOST-bound (roofline below) and wants overlap
    # depth, not dispatch amortization: 262 K chunks measured 341 K
    # reads/s where 524 K chunks measured 239 K (fewer chunks = less
    # parse/assemble overlap), so its chunk size stays 262 K even when
    # the device bench batch is larger.
    Bc = min(B, 262144)
    e2e_dir = _tf.mkdtemp(prefix="bwtpu_e2e_")
    ctable = ContigTable.build(idx.contigs)
    t0 = time.time()
    # single-end FASTQ (exact + k2 e2e share it)
    n_e2e = 1 if args.smoke else max(2, 1048576 // Bc)
    fq_path = _os.path.join(e2e_dir, "reads.fq")
    with open(fq_path, "w") as f:
        for i in range(n_e2e):
            rds, _ = simulate_reads(genome, Bc, read_len=L,
                                    max_mismatches=2, seed=100 + i)
            for r in rds:
                f.write(f"@{r.rid}.{i}\n{r.seq}\n+\n{'I' * L}\n")
    # low-error (0.5%/base) FASTQ: the production-like profile where
    # tiered e2e shows its win (flat k2 on the SAME file for the ratio)
    fq_le_path = _os.path.join(e2e_dir, "reads_le.fq")
    with open(fq_le_path, "w") as f:
        for i in range(n_e2e):
            rds, _ = simulate_reads(genome, Bc, read_len=L,
                                    max_mismatches=2, seed=500 + i,
                                    error_rate=0.005)
            for r in rds:
                f.write(f"@{r.rid}.{i}\n{r.seq}\n+\n{'I' * L}\n")
    # paired FASTQ pair (config 5 shape): Bc/2 pairs per chunk so the
    # stacked two-mate dispatch stays at Bc rows
    Bcp = Bc // 2
    n_pair_chunks = 1 if args.smoke else 2
    fq1_path = _os.path.join(e2e_dir, "reads_1.fq")
    fq2_path = _os.path.join(e2e_dir, "reads_2.fq")
    with open(fq1_path, "w") as f1, open(fq2_path, "w") as f2:
        for i in range(n_pair_chunks):
            prs, _ = simulate_pairs(genome, Bcp, read_len=L,
                                    max_mismatches=2, seed=300 + i)
            for r1, r2 in prs:
                f1.write(f"@{r1.rid}.{i}\n{r1.seq}\n+\n{'I' * L}\n")
                f2.write(f"@{r2.rid}.{i}\n{r2.seq}\n+\n{'I' * L}\n")
    timings["e2e_setup_s"] = round(time.time() - t0, 1)

    def e2e_single(k, lf_ceiling, fq=None, tiered=False):
        """FASTQ -> SAM the way cli.py align runs it: chunk-prefetched
        columnar parse, packed dispatch (pipelined), one-round-trip hit
        fetch, vectorized primary, C SAM formatter. tiered=True runs
        the exact-first/escalate dispatch (cli.py align --tiered).

        Capacities are OCCUPANCY-ADAPTIVE (VERDICT r4 item 3): the
        engine starts at a generic lf_ceiling, autotune_caps observes
        the candidate-stage live fraction on the warm batch and
        tightens loc_factor to the ladder value just above it; healing
        absorbs any batch that beats the thin margin."""
        fq = fq or fq_path
        eng = Engine([_dc.replace(idx, config=cfg.replace(
            loc_factor=lf_ceiling, k=k, min_trips=1, hit_factor=0.5))])
        warm = read_fastq_block(fq)
        wslice = warm.slice(0, Bc)
        eng.autotune_caps(wslice, k, pad_to=Bc)
        if tiered:  # tier 1 runs at the k=0 caps — tune those too
            eng.autotune_caps(wslice, 0, pad_to=Bc)
        # warm the tuned program so the timed loop never compiles
        eng.finish_block(
            eng.dispatch_block(wslice, k, pad_to=Bc, tiered=tiered))
        del warm, wslice
        ex = ThreadPoolExecutor(max_workers=1)

        def process(h):
            flat = eng.finish_block(h)
            return flat, select_primary_flat(flat)

        sam_path = _os.path.join(e2e_dir, f"out{k}.sam")
        t0 = time.time()
        n_reads = 0
        eng.stats.escalated = 0
        with open(sam_path, "wb") as out:
            out.write(sam_header(idx.contigs).encode())
            inflight = []

            def drain():
                sub, fut = inflight.pop(0)
                flat, prim = fut.result()
                out.write(emit_single(sub, prim, ctable,
                                      truncated=flat.truncated))

            _n, _L_s, stream = read_fastq_stream(fq, Bc)
            for sub in stream:
                n_reads += sub.n
                h = eng.dispatch_block(sub, k, pad_to=Bc, tiered=tiered)
                inflight.append((sub, ex.submit(process, h)))
                if len(inflight) > 2:
                    drain()
            while inflight:
                drain()
        ex.shutdown(wait=False)
        wall = time.time() - t0
        over = eng.stats.overflow_reads + eng.stats.compact_overflows
        mb = _os.path.getsize(sam_path) / 1e6
        _os.remove(sam_path)
        return (n_reads / wall, wall, n_reads, mb, over, eng.stats.heals,
                eng._lf(k), eng.stats.escalated / max(n_reads, 1))

    def e2e_paired(k, lf_ceiling):
        """Paired FASTQ pair -> SAM (cli.py align --paired path): both
        mates stacked into ONE dispatch per round, vectorized pairing
        (results.select_pairs), one interleaved C-formatter call.
        Capacities occupancy-adaptive like e2e_single."""
        eng = Engine([_dc.replace(idx, config=cfg.replace(
            loc_factor=lf_ceiling, k=k, min_trips=1, hit_factor=0.5))])
        warm1 = read_fastq_block(fq1_path).slice(0, Bcp)
        warm2 = read_fastq_block(fq2_path).slice(0, Bcp)
        wblk = concat_blocks(warm1, warm2)
        eng.autotune_caps(wblk, k, pad_to=Bc)
        eng.finish_block(eng.dispatch_block(wblk, k, pad_to=Bc))
        del warm1, warm2, wblk
        ex = ThreadPoolExecutor(max_workers=1)

        def process(sub1, sub2, h):
            flat = eng.finish_block(h)
            f1, f2 = split_flat(flat, sub1.n)
            choice = select_pairs(f1, f2, sub1.L, sub2.L, 0, 1000)
            return emit_paired(sub1, sub2, f1, f2, choice,
                               select_primary_flat(f1),
                               select_primary_flat(f2), ctable)

        sam_path = _os.path.join(e2e_dir, "outp.sam")
        t0 = time.time()
        n_reads = 0
        with open(sam_path, "wb") as out:
            out.write(sam_header(idx.contigs).encode())
            inflight = []

            def drain():
                fut = inflight.pop(0)
                out.write(fut.result())

            _n1, _l1, s1 = read_fastq_stream(fq1_path, Bcp)
            _n2, _l2, s2 = read_fastq_stream(fq2_path, Bcp)
            for sub1, sub2 in zip(s1, s2):
                n_reads += sub1.n + sub2.n
                h = eng.dispatch_block(concat_blocks(sub1, sub2), k,
                                       pad_to=Bc)
                inflight.append(ex.submit(process, sub1, sub2, h))
                if len(inflight) > 2:
                    drain()
            while inflight:
                drain()
        ex.shutdown(wait=False)
        wall = time.time() - t0
        over = eng.stats.overflow_reads + eng.stats.compact_overflows
        mb = _os.path.getsize(sam_path) / 1e6
        _os.remove(sam_path)
        return (n_reads / wall, wall, n_reads, mb, over, eng.stats.heals,
                eng._lf(k))

    # generic ceilings (the config defaults a user would start from);
    # autotune_caps tightens them from measured occupancy
    (e2e_rps, e2e_s, n_reads_e2e, sam_mb, e2e_over, e2e_heals,
     e2e_lf_tuned, _) = e2e_single(0, 2)
    e2e_k2 = e2e_single(2, 4)
    e2e_pe = e2e_paired(2, 4)
    # tiered e2e on the low-error profile, flat k2 on the same file:
    # the production-path version of the device-rate tiered comparison
    e2e_k2_le = e2e_single(2, 4, fq=fq_le_path)
    e2e_k2t_le = e2e_single(2, 4, fq=fq_le_path, tiered=True)
    for p in (fq_path, fq_le_path, fq1_path, fq2_path):
        _os.remove(p)
    _os.rmdir(e2e_dir)

    # --- roofline: measure the data-dependent quantities, then model ---
    # Guarded: the roofline is diagnostic calibration, and it runs AFTER
    # every real measurement above. Round 4 lost ALL its driver-captured
    # numbers because an unguarded calibration crash here destroyed the
    # completed e2e results (VERDICT r4 weak #1b) — a failure now
    # degrades the sol_* fields to None instead.
    bw = hbm_bandwidth(jax.devices()[0])
    ns_per_row = ns_locv = None
    trips = trips_k2 = None
    sol_exact_rps = sol_k2_rps = None
    ex_rows = ex_bytes = ex_lrows = k2_rows = k2_bytes = k2_lrows = None
    try:
        ns_per_row = calibrate_ns_per_row(
            shard0.latk, n_rows=(1 << 22) if not args.smoke else (1 << 16))
        rw2, ab2, *_ = device_prep_packed(*encs[0], L)
        B2 = int(rw2.shape[0])
        *_, trips, n_unf = search_early_stop_packed(
            shard0.lattice, shard0.latk, shard0.latk_inv, shard0.C,
            shard0.dollar_row, shard0.kmer_tables[d], rw2, ab2, 0, L, d,
            step, cfg.max_hits, mt, with_stats=True)
        trips, n_unf = int(trips), int(n_unf)
        locv_on = dev.shard.locv.shape[-1] > 1
        # the fused locate+verify table gathers at a size-dependent rate
        # (DESIGN.md table-size curve): price its rows with their OWN
        # calibration instead of the cache-resident latk rate
        ns_locv = (
            calibrate_ns_per_row(
                shard0.locv,
                n_rows=(1 << 22) if not args.smoke else (1 << 16))
            if locv_on else ns_per_row
        )
        ex_rows, ex_bytes, ex_lrows = gather_model(
            B2, L, d, step, trips, n_unf, cfg.max_hits, 1, exact_lf,
            cfg.sa_rate, locv=locv_on)
        sol_exact_rps = B / (
            (ex_rows * ns_per_row + ex_lrows * ns_locv) * 1e-9)
        # k2 stats run on a B_k2-sized prep and normalize by B_k2: the k2
        # measurement runs at B_k2 (its working set evicts the gather
        # tables at larger batches — DESIGN.md "Batch size"), so
        # the model must describe the batch the measurement uses
        # (ADVICE r3).
        rw2k, ab2k, *_ = device_prep_packed(*encs_k2[0], L)
        B2k = int(rw2k.shape[0])
        trips_k2 = n_unf_k2 = 0
        for off, slen in seed_layout(L, 3):
            *_, t_s, u_s = search_early_stop_packed(
                shard0.lattice, shard0.latk, shard0.latk_inv, shard0.C,
                shard0.dollar_row, shard0.kmer_tables[d_seed],
                rw2k, ab2k, off, slen, d_seed, step, cfg.max_cand, mt,
                with_stats=True)
            trips_k2 += int(t_s)
            n_unf_k2 += int(u_s)
        k2_rows, k2_bytes, k2_lrows = gather_model(
            B2k, L, d_seed, step, trips_k2, n_unf_k2, cfg.max_cand, 3,
            k2_lf, cfg.sa_rate, locv=locv_on)
        sol_k2_rps = B_k2 / (
            (k2_rows * ns_per_row + k2_lrows * ns_locv) * 1e-9)
    except Exception as e:  # calibration is best-effort, never fatal
        print(f"# roofline calibration failed: {e}", flush=True)

    # --- multihost launcher probe + weak-scaling efficiency (CPU) ---
    # 1 proc and 2 procs at IDENTICAL per-host read volume; efficiency =
    # rps(2proc) / (2 * rps(1proc)) — the north star's scaling metric on
    # the only mesh this environment provides (VERDICT r4 item 6).
    mh_rps = mh_reads = mh_wall = None
    mh1_rps = scaling_eff = None
    if not args.smoke:
        try:
            mh_rps, mh_reads, mh_wall = multihost_probe(n_procs=2)
            mh1_rps, _, _ = multihost_probe(n_procs=1)
            scaling_eff = mh_rps / (2.0 * mh1_rps)
        except Exception as e:  # launcher liveness is reported, not fatal
            print(f"# multihost probe failed: {e}", flush=True)

    # --- CPU reference (golden, interpreted walks) on a sample ---
    t0 = time.time()
    golden = GoldenFMIndex(genome)
    timings["golden_build_s"] = round(time.time() - t0, 1)
    sample = reads[:20]
    t0 = time.time()
    for r in sample:
        golden.align_read(r.seq, k=0)
    cpu_exact_rps = len(sample) / (time.time() - t0)
    t0 = time.time()
    for r in sample[:5]:
        golden.align_read(r.seq, k=2)
    cpu_k2_rps = 5 / (time.time() - t0)

    print(json.dumps({
        "metric": "reads/s/chip exact 100bp E.coli-scale (both strands)"
                  + (" [SMOKE]" if args.smoke else ""),
        "value": round(exact_rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(exact_rps / cpu_exact_rps, 1),
        "extras": {
            "e2e_exact_reads_per_s": round(e2e_rps, 1),
            "e2e_wall_s": round(e2e_s, 2),
            "e2e_reads": n_reads_e2e,
            "e2e_sam_mb": round(sam_mb, 1),
            "e2e_overflows": int(e2e_over),
            "e2e_heals": int(e2e_heals),
            "e2e_exact_lf_autotuned": e2e_lf_tuned,
            "e2e_k2_lf_autotuned": e2e_k2[6],
            "e2e_k2_reads_per_s": round(e2e_k2[0], 1),
            "e2e_k2_wall_s": round(e2e_k2[1], 2),
            "e2e_k2_reads": e2e_k2[2],
            "e2e_k2_overflows": int(e2e_k2[4]),
            "e2e_paired_reads_per_s": round(e2e_pe[0], 1),
            "e2e_paired_wall_s": round(e2e_pe[1], 2),
            "e2e_paired_reads": e2e_pe[2],
            "e2e_paired_overflows": int(e2e_pe[4]),
            "e2e_k2_lowerr_reads_per_s": round(e2e_k2_le[0], 1),
            "e2e_k2_tiered_lowerr_reads_per_s": round(e2e_k2t_le[0], 1),
            "e2e_tiered_lowerr_speedup": round(
                e2e_k2t_le[0] / max(e2e_k2_le[0], 1e-9), 2),
            "e2e_tiered_escalated_frac": round(e2e_k2t_le[7], 3),
            "e2e_tiered_overflows": int(e2e_k2t_le[4]),
            "multihost_2proc_cpu_reads_per_s": (
                round(mh_rps, 1) if mh_rps else None),
            "multihost_2proc_reads": mh_reads,
            "multihost_2proc_wall_s": mh_wall,
            "multihost_1proc_cpu_reads_per_s": (
                round(mh1_rps, 1) if mh1_rps else None),
            "scaling_eff_2proc_cpu": (
                round(scaling_eff, 3) if scaling_eff else None),
            "k2_reads_per_s": round(k2_rps, 1),
            "k2_tiered_reads_per_s": round(k2t_rps, 1),
            "k2_tiered_overflow": int(k2t_over),
            "k2_escalated_frac": round(esc_frac, 3),
            "k2_tiered_lowerr_reads_per_s": round(k2t_le_rps, 1),
            "k2_lowerr_reads_per_s": round(k2_le_rps, 1),
            "k2_lowerr_escalated_frac": round(esc_frac_le, 3),
            "k2_tiered_lowerr_speedup": round(
                k2t_le_rps / max(k2_le_rps, 1e-9), 2),
            "exact_overflow": exact_over,
            "k2_overflow": k2_over,
            "min_trips": mt,
            "exact_loc_factor": exact_lf,
            "k2_loc_factor": k2_lf,
            "cpu_ref_exact_reads_per_s": round(cpu_exact_rps, 2),
            "cpu_ref_k2_reads_per_s": round(cpu_k2_rps, 2),
            "k2_vs_baseline": round(k2_rps / cpu_k2_rps, 1),
            # sol_* fields are None when the guarded roofline failed
            "sol_fraction": (round(exact_rps / sol_exact_rps, 4)
                             if sol_exact_rps else None),
            "k2_sol_fraction": (round(k2_rps / sol_k2_rps, 4)
                                if sol_k2_rps else None),
            "sol_exact_reads_per_s": (round(sol_exact_rps, 1)
                                      if sol_exact_rps else None),
            "sol_k2_reads_per_s": (round(sol_k2_rps, 1)
                                   if sol_k2_rps else None),
            "model_rows_per_read_exact": (
                round((ex_rows + ex_lrows) / B, 2)
                if ex_rows is not None else None),
            "model_rows_per_read_k2": (
                round((k2_rows + k2_lrows) / B_k2, 2)
                if k2_rows is not None else None),
            "model_locv_rows_per_read_exact": (
                round(ex_lrows / B, 2) if ex_lrows is not None else None),
            "ns_per_row_locv": (round(ns_locv, 2)
                                if ns_locv is not None else None),
            "model_bytes_per_read_exact": (
                round(ex_bytes / B, 1) if ex_bytes is not None else None),
            "model_bytes_per_read_k2": (
                round(k2_bytes / B_k2, 1) if k2_bytes is not None else None),
            # null on the CPU: no published device peak to divide by
            "hbm_frac_of_byte_bw": (
                round(ex_bytes / B * exact_rps / bw, 5)
                if ex_bytes is not None and bw else None),
            "probe_trips_exact": trips,
            "probe_trips_k2": trips_k2,
            "ns_per_row_measured": (round(ns_per_row, 2)
                                    if ns_per_row is not None else None),
            "hbm_gbps_peak": round(bw / 1e9, 1) if bw else None,
            "device_kind": jax.devices()[0].device_kind,
            "device_count": len(jax.devices()),
            "kmer_d": d,
            "platform": jax.devices()[0].platform,
            "batch_reads": B,
            "batch_reads_k2": B_k2,
            "total_s": round(time.time() - t0_all, 1),
            **timings,
        },
    }))


if __name__ == "__main__":
    main()
