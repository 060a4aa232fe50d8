"""Smoke run of the FASTQ -> SAM align path on one GPU, end to end.

    python chip_smoke.py               # one GPU: every single-card phase
    python chip_smoke.py --four-cards  # four GPUs: DistEngine vs Engine only
    python chip_smoke.py --rehearse    # the same phases, tiny, on the CPU
    python chip_smoke.py --four-cards --rehearse   # 4 virtual CPU devices

Single-card phases, in one process (one JAX process per card):

1. device check: the first JAX device must be a GPU (unless --rehearse);
   prints the card's name and power limit, the JAX version and the
   compile-cache directory;
2. main path at E. coli scale (4.6 Mbp, 100 bp reads on both strands),
   all through cli.main: simulate, build-index --sa-rate 1, then align
   >= 1 M reads in four modes (exact, -k 2 --autotune-caps, --paired,
   -k 2 --tiered on a low-error read set). Each mode checks that the
   index lives on the device, that every read's primary record is its
   simulated origin, that no read is marked truncated (xo:i:1) and that
   the SAM records of a sample are byte-equal to the golden oracle's;
3. sharded index on one card at chr21 scale (46.7 Mbp, --sa-rate 8):
   the 4-shard stacked-vmap Engine must report exactly the 1-shard
   Engine's hits and SAM;
4. compile seconds (the persistent executable cache off) and memory
   analysis of the packed exact and k <= 2 programs;
5. one profiler trace per mode of one aligned block, reduced to device
   time per pipeline stage (search, finisher, locate, verify).

--four-cards runs only: DistEngine over four cards on the chr21-scale
reference, as (shard=4, data=1) and (shard=2, data=2), for k = 0 and
k = 2, against the single-card Engine on the same shards in the same
process; the per-card placement of the index shards; and
__graft_entry__.mesh_checks (healed ring, tiered mesh) on the cards.

Any failed check exits non-zero. The last line of standard output is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
Work files go to a temporary directory; traces and the per-phase log
go to --out (default chiprun_out/chip_smoke).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# full size / --rehearse size
SIZES = {
    "full": dict(
        ecoli="ecoli", n_reads=1 << 20, n_pairs=1 << 19, batch=1 << 18,
        golden_exact=1000, golden_k2=500, chr21="chr21",
        chr21_reads=1 << 17, mesh_reads=1 << 16, mesh_batch=1 << 14,
    ),
    "tiny": dict(
        ecoli="60000", n_reads=6000, n_pairs=3000, batch=2048,
        golden_exact=300, golden_k2=100, chr21="240000",
        chr21_reads=3000, mesh_reads=1000, mesh_batch=256,
    ),
}
STAGES = ("finisher", "search", "locate", "verify")


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(msg):
    print(msg, flush=True)


class Tee(io.TextIOBase):
    """Write-through to a stream while keeping a copy (cli's JSON event
    lines go to stderr)."""

    def __init__(self, stream):
        self.stream = stream
        self.buf = io.StringIO()

    def write(self, s):
        self.stream.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.stream.flush()


def run_cli(argv):
    """cli.main(argv) in this process; returns (result, stderr text)."""
    import cli

    tee = Tee(sys.stderr)
    with contextlib.redirect_stderr(tee):
        res = cli.main(argv)
    return res, tee.buf.getvalue()


def events(text, name):
    out = []
    for line in text.splitlines():
        if line.startswith("{") and f'"event": "{name}"' in line:
            out.append(json.loads(line))
    return out


def sam_records(path):
    """(header lines, record lines) of a SAM file."""
    header, recs = [], []
    with open(path) as f:
        for line in f:
            (header if line.startswith("@") else recs).append(line)
    return header, recs


def head_fastq(path, n, out_path):
    from bwtpu.io import read_fastq

    with open(path) as f, open(out_path, "w") as o:
        o.writelines(itertools.islice(f, 4 * n))
    return read_fastq(out_path)


def check_primary(recs, truth, what):
    """Every read's primary record is its simulated origin (pos, strand,
    nm) and carries no truncation mark."""
    check(len(recs) == len(truth), f"{what}: {len(recs)} records for "
          f"{len(truth)} reads")
    bad = []
    for i, (line, t) in enumerate(zip(recs, truth)):
        f = line.rstrip("\n").split("\t")
        flag = int(f[1])
        strand = "-" if flag & 16 else "+"
        ok = (
            not flag & 4 and int(f[3]) - 1 == t["pos"]
            and strand == t["strand"] and f"NM:i:{t['nm']}" in f[11:]
            and "xo:i:1" not in f[11:]
        )
        if not ok:
            bad.append((i, line.strip()[:160], t))
    check(not bad, f"{what}: {len(bad)} reads miss their origin, "
          f"first {bad[:3]}")


def check_pairs(recs, truth, what):
    check(len(recs) == 2 * len(truth), f"{what}: record count")
    bad = []
    for i, t in enumerate(truth):
        f1 = recs[2 * i].split("\t")
        f2 = recs[2 * i + 1].split("\t")
        fl1, fl2 = int(f1[1]), int(f2[1])
        ok = (
            fl1 & 2 and fl2 & 2 and not fl1 & 16 and fl2 & 16
            and int(f1[3]) - 1 == t["pos1"] and int(f2[3]) - 1 == t["pos2"]
            and "xo:i:1" not in recs[2 * i] + recs[2 * i + 1]
        )
        if not ok:
            bad.append((i, f1[:4], f2[:4], t))
    check(not bad, f"{what}: {len(bad)} pairs miss their origin, "
          f"first {bad[:3]}")


def index_platforms(engine):
    sh = engine.dev.shard
    lat = sh[0].lattice if isinstance(sh, list) else sh.lattice
    return {d.platform for d in lat.devices()}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(args):
    import jax

    from bwtpu.hosttune import setup_compile_cache

    cache = setup_compile_cache()
    devs = jax.devices()
    want = "cpu" if args.rehearse else "gpu"
    check(devs[0].platform == want,
          f"device check: first JAX device is {devs[0].platform!r}, "
          f"need {want!r}")
    need = 4 if args.four_cards else 1
    check(len(devs) >= need, f"device check: {len(devs)} devices, "
          f"need {need}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "nvidia-smi unavailable"
    check(args.rehearse or smi.strip(), "device check: nvidia-smi gave "
          "no card")
    log(f"card: {smi}")
    log(f"jax {jax.__version__}; devices {len(devs)} x "
        f"{devs[0].device_kind} ({devs[0].platform}); compile cache {cache}")
    return devs


def phase_main_path(args, sz, work, modes):
    """E. coli scale through cli.main: simulate, build-index, 4 modes."""
    from bwtpu.golden import GoldenFMIndex
    from bwtpu.io import read_fasta
    from bwtpu.sam import emit_sam, pair_and_emit_sam, sam_header

    want = "cpu" if args.rehearse else "gpu"
    ex, k2, le = (os.path.join(work, d) for d in ("ec_exact", "ec_k2",
                                                   "ec_lowerr"))
    t0 = time.time()
    run_cli(["simulate", "--scale", sz["ecoli"], "-o", ex, "--n-reads",
             str(sz["n_reads"]), "--mismatches", "0", "--pairs",
             str(sz["n_pairs"]), "--seed", "0"])
    run_cli(["simulate", "--scale", sz["ecoli"], "-o", k2, "--n-reads",
             str(sz["n_reads"]), "--mismatches", "2", "--seed", "0"])
    run_cli(["simulate", "--scale", sz["ecoli"], "-o", le, "--n-reads",
             str(sz["n_reads"]), "--mismatches", "2", "--error-rate",
             "0.005", "--seed", "0"])
    idx = os.path.join(work, "ec_idx")
    run_cli(["build-index", os.path.join(ex, "ref.fa"), idx,
             "--sa-rate", "1"])
    log(f"main path: simulated + built E. coli-scale index in "
        f"{time.time() - t0:.1f} s")
    genome, contigs = read_fasta(os.path.join(ex, "ref.fa"))
    t0 = time.time()
    golden = GoldenFMIndex(genome)
    log(f"main path: golden oracle built in {time.time() - t0:.1f} s")
    bs = str(sz["batch"])
    runs = {
        "exact": (ex, ["-k", "0", "--batch-size", bs], 0,
                  sz["golden_exact"]),
        "k2": (k2, ["-k", "2", "--autotune-caps", "--batch-size", bs], 2,
               sz["golden_k2"]),
        "paired": (ex, ["-k", "2", "--batch-size",
                        str(sz["batch"] // 2)], 2, sz["golden_k2"] // 2),
        "tiered": (le, ["-k", "2", "--tiered", "--batch-size", bs], 2,
                   sz["golden_k2"]),
    }
    for mode in modes:
        d, extra, k, n_gold = runs[mode]
        sam = os.path.join(work, f"{mode}.sam")
        if mode == "paired":
            argv = ["align", idx, os.path.join(d, "reads_1.fq"), "--paired",
                    os.path.join(d, "reads_2.fq"), "-o", sam] + extra
        else:
            argv = ["align", idx, os.path.join(d, "reads.fq"), "-o",
                    sam] + extra
        t0 = time.time()
        engine, err = run_cli(argv)
        wall = time.time() - t0
        check(engine is not None, f"{mode}: align returned no engine")
        check(index_platforms(engine) == {want},
              f"{mode}: index arrays on {index_platforms(engine)}")
        summ = events(err, "summary")
        check(summ, f"{mode}: no summary line")
        if mode == "k2":
            check(events(err, "autotune"),
                  "k2: --autotune-caps printed no autotune event")
        del engine
        header, recs = sam_records(sam)
        check("".join(header) == sam_header(contigs), f"{mode}: header")
        if mode == "paired":
            with open(os.path.join(d, "truth_pairs.json")) as f:
                check_pairs(recs, json.load(f), mode)
        else:
            with open(os.path.join(d, "truth.json")) as f:
                check_primary(recs, json.load(f), mode)
        # byte-equality with the golden oracle on a sample
        buf = io.StringIO()
        if mode == "paired":
            r1 = head_fastq(os.path.join(d, "reads_1.fq"), n_gold,
                            os.path.join(work, "s1.fq"))
            r2 = head_fastq(os.path.join(d, "reads_2.fq"), n_gold,
                            os.path.join(work, "s2.fq"))
            h1 = [golden.align_read(r.seq, k=k) for r in r1]
            h2 = [golden.align_read(r.seq, k=k) for r in r2]
            pair_and_emit_sam(list(zip(r1, r2)), h1, h2, contigs, buf,
                              header=False)
            got = "".join(recs[: 2 * n_gold])
        else:
            rs = head_fastq(os.path.join(d, "reads.fq"), n_gold,
                            os.path.join(work, "s.fq"))
            emit_sam(rs, [golden.align_read(r.seq, k=k) for r in rs],
                     contigs, buf, header=False)
            got = "".join(recs[:n_gold])
        want_sam = buf.getvalue()
        if got != want_sam:
            diff = next(i for i, (a, b) in enumerate(
                zip(got.splitlines(), want_sam.splitlines())) if a != b)
            raise PhaseError(
                f"{mode}: SAM differs from golden at record {diff}: "
                f"{got.splitlines()[diff]!r} vs "
                f"{want_sam.splitlines()[diff]!r}")
        n_reads = len(recs)
        log(f"main path {mode}: {n_reads} reads, every primary at its "
            f"origin, no xo:i:1, golden-equal SAM on "
            f"{n_gold * (2 if mode == 'paired' else 1)} records; "
            f"wall {wall:.1f} s; summary {json.dumps(summ[-1])}")
        os.remove(sam)
    return idx, {"exact": ex, "k2": k2, "paired": ex, "tiered": le}


def flat_key(flat):
    import numpy as np

    return [np.asarray(a) for a in (flat.read_idx, flat.pos,
                                    flat.strand_rev, flat.nm)]


def phase_sharded(args, sz, work):
    """chr21 scale, 4 shards vs 1 shard, one card."""
    import numpy as np

    from bwtpu.readblock import read_fastq_block

    d = os.path.join(work, "chr21")
    t0 = time.time()
    run_cli(["simulate", "--scale", sz["chr21"], "-o", d, "--n-reads",
             str(sz["chr21_reads"]), "--mismatches", "2", "--seed", "7"])
    ref = os.path.join(d, "ref.fa")
    for s in (4, 1):
        run_cli(["build-index", ref, os.path.join(work, f"c21_s{s}"),
                 "--shards", str(s), "--sa-rate", "8", "--jobs", str(s)])
    log(f"sharded: simulated + built 4- and 1-shard indexes in "
        f"{time.time() - t0:.1f} s")
    reads = os.path.join(d, "reads.fq")
    bs = sz["chr21_reads"]
    engines, sams = {}, {}
    for s in (4, 1):
        sam = os.path.join(work, f"c21_s{s}.sam")
        eng, err = run_cli(["align", os.path.join(work, f"c21_s{s}"), reads,
                            "-k", "2", "-o", sam, "--batch-size", str(bs)])
        engines[s] = eng
        sams[s] = sam_records(sam)
        os.remove(sam)
    e4, e1 = engines[4], engines[1]
    check(e4.dev.n_shards == 4 and e4.vmap_shards,
          "sharded: the 4-shard engine is not the stacked vmap dispatch")
    with open(os.path.join(d, "truth.json")) as f:
        check_primary(sams[1][1], json.load(f), "sharded 1-shard")
    check(sams[4] == sams[1], "sharded: 4-shard SAM != 1-shard SAM")
    blk = read_fastq_block(reads)
    flats = [e.finish_block(e.dispatch_block(blk, 2, pad_to=bs))
             for e in (e4, e1)]
    a, b = (flat_key(f) for f in flats)
    check(all(np.array_equal(x, y) for x, y in zip(a, b)),
          "sharded: 4-shard hit lists != 1-shard hit lists")
    check(flats[0].truncated is None and flats[1].truncated is None,
          "sharded: truncated reads")
    log(f"sharded: {blk.n} reads k<=2, 4-shard == 1-shard: "
        f"{len(a[0])} hits, SAM equal")


def packed_program(eng, kind, k, L, Bp, level=0):
    """The jitted packed program dispatch_block runs for (kind, k) on a
    Bp-row block, with its arguments (same selection as dispatch_block,
    single-shard index)."""
    import numpy as np

    from bwtpu.engine import pick_kmer_depth

    W = (L + 15) // 16
    rw = np.zeros((Bp, W), np.int32)
    ab = np.zeros((Bp, W), np.int32)
    if kind == "tiered":
        d = pick_kmer_depth(eng.kmer_depths, L)
        fn = eng._packed_fn("tiered", k, d, L, True, level=level)
        return fn, (eng._shard_tree(0), rw, ab)
    d = pick_kmer_depth(eng.kmer_depths, L if k == 0 else L // (k + 1))
    fn = eng._packed_fn(kind, k, d, L, True, hits_output=True,
                        vmapped=eng.vmap_shards, level=level)
    shard = eng.dev.shard if eng.vmap_shards else eng._shard_tree(0)
    return fn, (shard, rw, ab)


def phase_compile(args, sz, idx):
    import jax

    from bwtpu.engine import Engine
    from bwtpu.index import load_index

    eng = Engine(*load_index(idx))
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        for kind, k in (("exact", 0), ("inexact", 2)):
            fn, a = packed_program(eng, kind, k, 100, sz["batch"])
            t0 = time.time()
            lowered = fn.lower(*a)
            t1 = time.time()
            compiled = lowered.compile()
            t2 = time.time()
            ma = compiled.memory_analysis()
            mem = {
                f: getattr(ma, f, None) for f in (
                    "argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "alias_size_in_bytes",
                    "generated_code_size_in_bytes")
            } if ma is not None else None
            log(f"compile {kind} k={k} B={sz['batch']}: lower "
                f"{t1 - t0:.2f} s, compile {t2 - t1:.2f} s (executable "
                f"cache off; XLA's kernel and autotune caches in the "
                f"cache dir may be warm); memory_analysis "
                f"{json.dumps(mem)}")
    finally:
        jax.config.update("jax_enable_compilation_cache", was)
    return eng


def hlo_stage_map(hlo_text):
    """HLO instruction name -> pipeline stage, from the op_name metadata
    the pipelines' jax.named_scope blocks leave in the compiled HLO. A
    fusion carries its root op's metadata, so it counts for the root's
    stage. Keys use '_' for '.', as GPU kernels are named after their
    fusion that way."""
    import re

    inst = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name="([^"]*)"')
    # a scope shows as a path element, wrapped as vmap(search) etc.
    scope = {st: re.compile(rf"(^|[/(]){st}([)/]|$)") for st in STAGES}
    out = {}
    for line in hlo_text.splitlines():
        m = inst.match(line)
        if m:
            name, op = m.groups()
            out[name.replace(".", "_")] = next(
                (st for st in STAGES if scope[st].search(op)), "other")
    return out


def reduce_trace(trace_dir, stage_map):
    """Per-stage op time (ns) from the .xplane.pb under trace_dir, plus
    the planes it came from. Device planes (/device:GPU:*) when present,
    else the CPU client's op events. Kernels that run inside a CUDA
    graph carry hlo_op "command_buffer", so on the GPU the kernel
    (fusion) name identifies the op."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = ProfileData.from_file(path)
    dev = [p for p in pd.planes if p.name.startswith("/device:")]
    planes = dev or [p for p in pd.planes if p.name.startswith("/host:CPU")]
    totals = {st: 0 for st in STAGES + ("other", "memcpy")}
    sample = []
    spans = []
    per_op = {}
    for pl in planes:
        lines = list(pl.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"]
        for ln in ops or lines:
            for ev in ln.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None and not ops:
                    continue
                if op is None or dev:
                    op = ev.name
                op = op.replace(".", "_")
                if len(sample) < 60:
                    sample.append({"plane": pl.name, "line": ln.name,
                                   "name": ev.name, "ns": ev.duration_ns,
                                   "stats": {k: str(v)[:200] for k, v in
                                             stats.items()}})
                st = ("memcpy" if op.startswith("Memcpy")
                      else stage_map.get(op, "other"))
                totals[st] += ev.duration_ns
                n, t = per_op.get((op, st), (0, 0))
                per_op[(op, st)] = (n + 1, t + ev.duration_ns)
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy = 0.0
    end = None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (max(b for _, b in spans) - min(a for a, _ in spans)
              if spans else 0.0)
    with open(os.path.join(trace_dir, "events_sample.json"), "w") as f:
        json.dump({"planes": [p.name for p in pd.planes],
                   "lines": {p.name: [ln.name for ln in p.lines]
                             for p in planes},
                   "top_ops": [
                       {"op": op, "stage": st, "n": n, "ns": t}
                       for (op, st), (n, t) in sorted(
                           per_op.items(), key=lambda kv: -kv[1][1])[:40]],
                   "events": sample}, f, indent=1)
    return totals, busy, window, bool(dev)


def phase_trace(args, sz, eng, dirs, out):
    import jax

    from bwtpu.readblock import concat_blocks, read_fastq_block

    bs = sz["batch"]

    def block(mode, name="reads.fq", n=bs):
        blk = read_fastq_block(os.path.join(dirs[mode], name))
        return blk.slice(0, min(n, blk.n))

    modes = {
        "exact": (block("exact"), 0, False),
        "k2": (block("k2"), 2, False),
        # both mates stacked into one dispatch, as cli align --paired
        "paired": (concat_blocks(block("paired", "reads_1.fq", bs // 2),
                                 block("paired", "reads_2.fq", bs // 2)),
                   2, False),
        "tiered": (block("tiered"), 2, True),
    }
    for mode, (blk, k, tiered) in modes.items():
        eng.finish_block(eng.dispatch_block(blk, k, pad_to=bs,
                                            tiered=tiered))  # compile
        kind = "tiered" if tiered else ("exact" if k == 0 else "inexact")
        heals0 = eng.stats.heals
        tdir = os.path.join(out, f"trace_{mode}")
        shutil.rmtree(tdir, ignore_errors=True)
        jax.profiler.start_trace(tdir)
        t0 = time.time()
        flat = eng.finish_block(eng.dispatch_block(blk, k, pad_to=bs,
                                                   tiered=tiered))
        wall = time.time() - t0
        jax.profiler.stop_trace()
        check(flat.truncated is None, f"trace {mode}: truncated reads")
        # a healed block also ran the doubled-cap programs
        stage_map = {}
        for level in range(eng.stats.heals - heals0 + 1):
            fn, a = packed_program(eng, kind, k, blk.L, bs, level)
            stage_map.update(hlo_stage_map(fn.lower(*a).compile().as_text()))
        totals, busy, window, on_dev = reduce_trace(tdir, stage_map)
        check(not args.rehearse and on_dev or args.rehearse,
              f"trace {mode}: no device plane in the trace")
        check(sum(totals.values()) > 0, f"trace {mode}: no op events")
        where = "device" if on_dev else "cpu (not a device metric)"
        ms = {st: round(v / 1e6, 3) for st, v in totals.items()}
        log(f"trace {mode}: {blk.n} reads, "
            f"{eng.stats.heals - heals0} heals, wall {wall * 1e3:.1f} ms; "
            f"{where} op ms by stage {json.dumps(ms)}; busy "
            f"{busy / 1e6:.3f} ms of a {window / 1e6:.3f} ms op window")


def phase_four_cards(args, sz, work, devs):
    """DistEngine over 4 cards vs the single-card Engine, same shards."""
    from bwtpu.dist import DistEngine
    from bwtpu.engine import Engine
    from bwtpu.index import load_index
    from bwtpu.io import read_fastq

    d = os.path.join(work, "chr21")
    t0 = time.time()
    run_cli(["simulate", "--scale", sz["chr21"], "-o", d, "--n-reads",
             str(sz["mesh_reads"]), "--mismatches", "2", "--seed", "7"])
    ref = os.path.join(d, "ref.fa")
    for s in (4, 2):
        run_cli(["build-index", ref, os.path.join(work, f"c21_s{s}"),
                 "--shards", str(s), "--sa-rate", "8", "--jobs", str(s)])
    log(f"four cards: simulated + built 4- and 2-shard indexes in "
        f"{time.time() - t0:.1f} s")
    reads = read_fastq(os.path.join(d, "reads.fq"))
    devs = devs[:4]
    for s, nd in ((4, 1), (2, 2)):
        shards, manifest = load_index(os.path.join(work, f"c21_s{s}"))
        de = DistEngine(shards, manifest, n_data=nd, devices=devs)
        # every card holds exactly its own shard of every index table
        for name in ("lattice", "latk", "ssa", "text_rows"):
            arr = getattr(de.dev.shard, name)
            owner = {}
            for piece in arr.addressable_shards:
                start = piece.index[0].start or 0
                check(piece.data.shape[0] == 1,
                      f"mesh {s}x{nd}: {name} piece holds "
                      f"{piece.data.shape[0]} shards")
                owner[piece.device.id] = start
            check(sorted(owner) == sorted(dv.id for dv in devs),
                  f"mesh {s}x{nd}: {name} on devices {sorted(owner)}")
            want = sorted(list(range(s)) * nd)
            check(sorted(owner.values()) == want,
                  f"mesh {s}x{nd}: {name} shard placement {owner}")
        use = [dv.memory_stats() for dv in devs]
        if all(use):
            b = [u["bytes_in_use"] for u in use]
            check(b[0] <= 1.5 * max(b[1:]) + (64 << 20),
                  f"mesh {s}x{nd}: device 0 holds {b[0]} B vs {b[1:]}")
            log(f"mesh {s}x{nd}: bytes in use per card {b}")
        single = Engine(shards, manifest, device=devs[0])
        for k in (0, 2):
            t0 = time.time()
            got = de.align_all(reads, k=k, batch_size=sz["mesh_batch"])
            t1 = time.time()
            ref_hits = single.align_all(reads, k=k,
                                        batch_size=sz["mesh_batch"])
            t2 = time.time()
            check(got == ref_hits, f"mesh {s}x{nd} k={k}: DistEngine hits "
                  f"!= Engine hits")
            n_hits = sum(len(h) for h in got)
            # every read carries <= 2 substitutions: k=2 must place all
            check(n_hits > 0 and (k == 0 or all(got)),
                  f"mesh {s}x{nd} k={k}: {n_hits} hits, "
                  f"{sum(not h for h in got)} reads unplaced")
            log(f"mesh (shard={s}, data={nd}) k={k}: {len(reads)} reads, "
                f"{n_hits} hits, DistEngine == Engine (dist wall "
                f"{t1 - t0:.1f} s incl. compile, engine {t2 - t1:.1f} s)")
        del de, single, shards
    import __graft_entry__

    __graft_entry__.mesh_checks(4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the DistEngine phase on four cards")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU (4 virtual devices with "
                         "--four-cards)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny sizes on the GPU (a quick first check)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "chip_smoke"))
    args = ap.parse_args(argv)
    if args.rehearse:
        # as many virtual CPU devices as the real run has cards
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
                 if "xla_force_host_platform_device_count" not in f]
        flags.append("--xla_force_host_platform_device_count="
                     f"{4 if args.four_cards else 1}")
        os.environ["XLA_FLAGS"] = " ".join(flags)
    sz = SIZES["tiny" if (args.rehearse or args.tiny) else "full"]
    import jax

    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
    os.makedirs(args.out, exist_ok=True)
    t_all = time.time()
    try:
        devs = phase_device(args)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            if args.four_cards:
                phase_four_cards(args, sz, work, devs)
            else:
                idx, dirs = phase_main_path(
                    args, sz, work, ("exact", "k2", "paired", "tiered"))
                phase_sharded(args, sz, work)
                eng = phase_compile(args, sz, idx)
                phase_trace(args, sz, eng, dirs, args.out)
    except PhaseError as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    log(f"all phases passed in {time.time() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
