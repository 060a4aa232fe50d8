"""Batch SAM emission over flat arrays (production path, C14).

Pairs bwtpu.results (vectorized primary selection) with the C++ batch
formatter (csrc/samfmt.cc) so the FASTQ->SAM path never touches
per-read Python objects. The Python fallback below is field-for-field
the same formatter (used when no toolchain is available and as the
equality oracle in tests); both are byte-equal to bwtpu.sam.emit_sam,
asserted in tests/test_fastpath.py.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np

from bwtpu import sais
from bwtpu.readblock import ReadBlock
from bwtpu.results import ContigTable, Primary
from bwtpu.sam import FLAG_REVERSE, FLAG_UNMAPPED

log = logging.getLogger(__name__)

_fmt_ready = False
_out_cache: list = []


def _out_buf(cap: int) -> np.ndarray:
    """Reused output buffer: a fresh 60 MB allocation per batch pays
    ~50 MB/s first-touch faults on this host (docs/DESIGN.md
    "page-fault wall"); one cached buffer amortizes them away."""
    if not _out_cache or _out_cache[0].size < cap:
        _out_cache[:] = [np.empty(int(cap * 5 // 4), dtype=np.uint8)]
    return _out_cache[0]


def _native_fmt():
    """The shared library with bwtpu_sam_format2 configured, or None.
    (The v2 symbol adds the truncation-tag column; sais._load_native
    rebuilds a library older than its sources, so a library without it
    means the build failed — never called with a mismatched
    signature.)"""
    global _fmt_ready
    lib = sais._load_native()
    if lib is None:
        return None
    if not _fmt_ready:
        try:
            fn = lib.bwtpu_sam_format2
        except AttributeError:
            log.warning("native library lacks bwtpu_sam_format2; "
                        "Python fallback")
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            u8p, i64p, u8p, u8p, ctypes.c_int32, ctypes.c_int64,
            u8p, i32p, i32p, i64p, i32p, i32p, i64p, i64p, i32p, u8p,
            u8p, u8p, i64p, u8p, ctypes.c_int64,
        ]
        _fmt_ready = True
    return lib


def format_records(
    block: ReadBlock,
    mapped: np.ndarray,
    flag: np.ndarray,
    rname_id: np.ndarray,
    pos1: np.ndarray,
    mapq: np.ndarray,
    rnext_id: np.ndarray,  # -1 '*', -2 '=', else contig id
    pnext1: np.ndarray,
    tlen: np.ndarray,
    nm: np.ndarray,
    revcomp: np.ndarray,
    ctable: ContigTable,
    force_python: bool = False,
    trunc: np.ndarray | None = None,
) -> bytes:
    """Low-level columnar record formatter (SAM field layout pinned by
    bwtpu/sam.py::_record). trunc (bool[n] or None) appends an xo:i:1
    tag to reads still capacity-truncated after self-healing retries
    (engine.finish_block; VERDICT r3 item 3)."""
    n, L = block.n, block.L
    lib = None if force_python else _native_fmt()
    if lib is not None:
        rn_blob = np.frombuffer(ctable.name_blob, dtype=np.uint8)
        if rn_blob.size == 0:
            rn_blob = np.zeros(1, dtype=np.uint8)
        max_rn = int(np.max(np.diff(ctable.name_off), initial=1))
        cap = int(block.id_blob.size) + n * (2 * L + max_rn + 136)
        out = _out_buf(cap)
        c = lambda a, t: np.ascontiguousarray(a, dtype=t)
        u8 = lambda a: c(a, np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        i32 = lambda a: c(a, np.int32).ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        i64 = lambda a: c(a, np.int64).ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        # keep converted arrays alive through the call
        keep = [
            c(block.id_blob, np.uint8), c(block.id_off, np.int64),
            c(block.seq, np.uint8),
            c(block.qual, np.uint8) if block.qual is not None else None,
            c(mapped, np.uint8), c(flag, np.int32), c(rname_id, np.int32),
            c(pos1, np.int64), c(mapq, np.int32), c(rnext_id, np.int32),
            c(pnext1, np.int64), c(tlen, np.int64), c(nm, np.int32),
            c(revcomp, np.uint8),
            c(trunc, np.uint8) if trunc is not None else None,
            rn_blob, c(ctable.name_off, np.int64),
        ]
        ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
        qual_ptr = (
            ptr(keep[3], ctypes.c_uint8)
            if keep[3] is not None
            else ctypes.POINTER(ctypes.c_uint8)()
        )
        trunc_ptr = (
            ptr(keep[14], ctypes.c_uint8)
            if keep[14] is not None
            else ctypes.POINTER(ctypes.c_uint8)()
        )
        written = lib.bwtpu_sam_format2(
            ptr(keep[0], ctypes.c_uint8), ptr(keep[1], ctypes.c_int64),
            ptr(keep[2], ctypes.c_uint8), qual_ptr,
            ctypes.c_int32(L), ctypes.c_int64(n),
            ptr(keep[4], ctypes.c_uint8), ptr(keep[5], ctypes.c_int32),
            ptr(keep[6], ctypes.c_int32), ptr(keep[7], ctypes.c_int64),
            ptr(keep[8], ctypes.c_int32), ptr(keep[9], ctypes.c_int32),
            ptr(keep[10], ctypes.c_int64), ptr(keep[11], ctypes.c_int64),
            ptr(keep[12], ctypes.c_int32), ptr(keep[13], ctypes.c_uint8),
            trunc_ptr,
            ptr(keep[15], ctypes.c_uint8), ptr(keep[16], ctypes.c_int64),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(cap),
        )
        if written >= 0:
            return out[:written].tobytes()
        log.warning("bwtpu_sam_format capacity bug (cap=%d); Python fallback", cap)
    return _format_py(
        block, mapped, flag, rname_id, pos1, mapq, rnext_id, pnext1, tlen,
        nm, revcomp, ctable, trunc,
    )


def _comp_full() -> bytes:
    """Complement table matching dna.revcomp_str (which uppercases
    first): lowercase acgt complement like uppercase, all else 'N'."""
    table = bytearray(b"N" * 256)
    for a, b in zip(b"ATCGatcg", b"TAGCTAGC"):
        table[a] = b
    return bytes(table)


_COMP_FULL = _comp_full()


def _format_py(
    block, mapped, flag, rname_id, pos1, mapq, rnext_id, pnext1, tlen, nm,
    revcomp, ctable, trunc=None,
) -> bytes:
    names = [
        ctable.name_blob[ctable.name_off[i] : ctable.name_off[i + 1]]
        for i in range(len(ctable.starts))
    ]
    ids_blob = block.id_blob.tobytes()
    io_ = block.id_off
    seqs = block.seq.tobytes()
    quals = block.qual.tobytes() if block.qual is not None else None
    L = block.L
    cigar = f"{L}M".encode()
    parts: list[bytes] = []
    for i in range(block.n):
        rid = ids_blob[io_[i] : io_[i + 1]]
        s = seqs[i * L : (i + 1) * L]
        q = quals[i * L : (i + 1) * L] if quals is not None else b"*"
        if revcomp[i]:
            s = s[::-1].translate(_COMP_FULL)
            if quals is not None:
                q = q[::-1]
        rx = rnext_id[i]
        rnext = b"*" if rx == -1 else (b"=" if rx == -2 else names[rx])
        xo = b"\txo:i:1" if trunc is not None and trunc[i] else b""
        if mapped[i]:
            parts.append(
                b"\t".join([
                    rid, b"%d" % flag[i], names[rname_id[i]], b"%d" % pos1[i],
                    b"%d" % mapq[i], cigar, rnext, b"%d" % pnext1[i],
                    b"%d" % tlen[i], s, q, b"NM:i:%d" % nm[i],
                ]) + xo
            )
        else:
            parts.append(
                b"\t".join([
                    rid, b"%d" % flag[i], b"*", b"0", b"0", b"*", rnext,
                    b"%d" % pnext1[i], b"0", s, q,
                ]) + xo
            )
    return b"\n".join(parts) + b"\n" if parts else b""


def reorder_sam_records(blobs: list[bytes], idx_lists: list[np.ndarray]
                        ) -> bytes:
    """Reassemble per-bucket SAM blobs into INPUT record order.

    The ragged (length-bucketed) align path emits one blob per length
    bucket; each record is exactly one newline-terminated line. This
    splits the concatenated blobs at newlines and gathers the records
    into the order given by the buckets' original indices — one
    vectorized pass, no per-record Python objects (the reorder-buffer
    twin of bwtpu/multihost.py's emit ordering)."""
    big = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    if big.size == 0:
        return b""
    ends = np.flatnonzero(big == 10)
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lens = ends - starts + 1  # keep the newline
    order = np.argsort(np.concatenate(idx_lists), kind="stable")
    s, l = starts[order], lens[order]
    total = int(l.sum())
    excl = np.cumsum(l) - l
    src = np.repeat(s, l) + (np.arange(total, dtype=np.int64)
                             - np.repeat(excl, l))
    return big[src].tobytes()


def emit_paired(
    block1: ReadBlock, block2: ReadBlock,
    flat1, flat2, choice, prim1: Primary, prim2: Primary,
    ctable: ContigTable, force_python: bool = False,
) -> bytes:
    # mate truncation flags ride the per-mate FlatHits (engine healing)
    """Paired-end emission over flat arrays: byte-equal to
    bwtpu.sam.pair_and_emit_sam (tests/test_fastpath.py).

    choice = results.select_pairs(flat1, flat2, ...); pairs without a
    proper pair fall back to each mate's independent primary
    (prim1/prim2 = results.select_primary_flat). Mate records are
    emitted adjacent via a row-interleaved block, so the whole paired
    batch is ONE C-formatter call."""
    from bwtpu.readblock import interleave_blocks
    from bwtpu.sam import (FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED,
                           FLAG_PAIRED, FLAG_PROPER, FLAG_READ1, FLAG_READ2)

    n, L1, L2 = block1.n, block1.L, block2.L
    paired = choice.i1 >= 0
    idx1 = np.where(paired, choice.i1, 0)
    idx2 = np.where(paired, choice.i2, 0)
    hp1, hs1, hn1 = flat1.pos[idx1], flat1.strand_rev[idx1], flat1.nm[idx1]
    hp2, hs2, hn2 = flat2.pos[idx2], flat2.strand_rev[idx2], flat2.nm[idx2]
    cid1p, lp1p = ctable.resolve(hp1, L1)
    cid2p, lp2p = ctable.resolve(hp2, L2)
    p1ok = cid1p >= 0
    p2ok = cid2p >= 0
    same = p1ok & p2ok & (cid1p == cid2p)
    proper = np.where(same, FLAG_PROPER, 0)
    base1 = FLAG_PAIRED | FLAG_READ1
    base2 = FLAG_PAIRED | FLAG_READ2
    f1p = base1 | proper | np.where(hs2, FLAG_MATE_REVERSE, 0)
    f2p = base2 | proper | np.where(hs1, FLAG_MATE_REVERSE, 0)
    rnext1p = np.where(same, -2, np.where(p2ok, cid2p, -1))
    pnext1p = np.where(p2ok, lp2p + 1, 0)
    rnext2p = np.where(same, -2, np.where(p1ok, cid1p, -1))
    pnext2p = np.where(p1ok, lp1p + 1, 0)

    # fallback: independent primaries (mate flags depend on the mate's
    # primary EXISTENCE, not its boundary-resolvability — sam.py rule)
    c1f, l1f = ctable.resolve(prim1.pos, L1)
    c2f, l2f = ctable.resolve(prim2.pos, L2)
    eff1f = prim1.mapped & (c1f >= 0)
    eff2f = prim2.mapped & (c2f >= 0)
    f1f = (
        base1
        | np.where(~prim2.mapped, FLAG_MATE_UNMAPPED, 0)
        | np.where(prim2.mapped & prim2.strand_rev, FLAG_MATE_REVERSE, 0)
    )
    f2f = (
        base2
        | np.where(~prim1.mapped, FLAG_MATE_UNMAPPED, 0)
        | np.where(prim1.mapped & prim1.strand_rev, FLAG_MATE_REVERSE, 0)
    )

    def merge(pp, ff):
        return np.where(paired, pp, ff)

    mapped1 = merge(p1ok, eff1f)
    mapped2 = merge(p2ok, eff2f)
    flagb1 = merge(f1p, f1f)
    flagb2 = merge(f2p, f2f)
    sr1 = merge(hs1, prim1.strand_rev).astype(bool)
    sr2 = merge(hs2, prim2.strand_rev).astype(bool)
    # own-strand FLAG_REVERSE rides only on MAPPED records (sam._record)
    flag1 = np.where(
        mapped1, flagb1 | np.where(sr1, FLAG_REVERSE, 0),
        flagb1 | FLAG_UNMAPPED,
    )
    flag2 = np.where(
        mapped2, flagb2 | np.where(sr2, FLAG_REVERSE, 0),
        flagb2 | FLAG_UNMAPPED,
    )

    def inter(a, b):
        return np.stack(
            [np.asarray(a), np.asarray(b)], axis=1
        ).reshape(-1)

    blk = interleave_blocks(block1, block2)
    return format_records(
        blk,
        mapped=inter(mapped1, mapped2),
        flag=inter(flag1, flag2).astype(np.int32),
        rname_id=inter(merge(cid1p, c1f), merge(cid2p, c2f)).astype(np.int32),
        pos1=inter(merge(lp1p, l1f) + 1, merge(lp2p, l2f) + 1),
        mapq=inter(merge(np.full(n, 37), prim1.mapq),
                   merge(np.full(n, 37), prim2.mapq)).astype(np.int32),
        rnext_id=inter(merge(rnext1p, np.full(n, -1)),
                       merge(rnext2p, np.full(n, -1))).astype(np.int32),
        pnext1=inter(merge(pnext1p, np.zeros(n, np.int64)),
                     merge(pnext2p, np.zeros(n, np.int64))),
        tlen=inter(np.where(paired, choice.tlen1, 0),
                   np.where(paired, -choice.tlen1, 0)),
        nm=inter(merge(hn1, prim1.nm), merge(hn2, prim2.nm)).astype(np.int32),
        revcomp=inter(mapped1 & sr1, mapped2 & sr2),
        ctable=ctable,
        force_python=force_python,
        trunc=(
            None
            if getattr(flat1, "truncated", None) is None
            and getattr(flat2, "truncated", None) is None
            else inter(
                flat1.truncated
                if flat1.truncated is not None
                else np.zeros(n, bool),
                flat2.truncated
                if flat2.truncated is not None
                else np.zeros(n, bool),
            )
        ),
    )


def emit_single(
    block: ReadBlock, primary: Primary, ctable: ContigTable,
    force_python: bool = False, truncated: np.ndarray | None = None,
) -> bytes:
    """Single-end emission: one primary record per read (pinned rule,
    bwtpu/sam.py::emit_sam). Boundary-crossing primaries emit unmapped
    records (io.resolve_position convention). truncated (bool[n] or
    None, e.g. FlatHits.truncated) tags capacity-cut reads xo:i:1."""
    n = block.n
    cid, lpos = ctable.resolve(primary.pos, block.L)
    eff = primary.mapped & (cid >= 0)
    flag = np.where(
        eff, np.where(primary.strand_rev, FLAG_REVERSE, 0), FLAG_UNMAPPED
    ).astype(np.int32)
    z64 = np.zeros(n, dtype=np.int64)
    return format_records(
        block,
        mapped=eff, flag=flag, rname_id=cid, pos1=lpos + 1,
        mapq=primary.mapq, rnext_id=np.full(n, -1, np.int32), pnext1=z64,
        tlen=z64, nm=primary.nm, revcomp=eff & primary.strand_rev,
        ctable=ctable, force_python=force_python, trunc=truncated,
    )
