"""Alignment engine — the jit'd batch pipeline (layer L5, component C15).

The reference drives one interpreted loop per read (SURVEY.md §3.2); the
engine is its accelerator re-design: a pure function
  align : (index lattices, read batch) -> hits
compiled once with jax.jit (SURVEY.md §7.0), processing both strands of
thousands of reads per call. Host code does encoding/packing, batching
and hit assembly.

Pipeline structure (driven by the measured gather economics in
docs/DESIGN.md — cost is per gathered row, row width free). Both paths
run off 2-bit packed read words (device_prep_packed) when the
multi-step lattice is present:

  exact:   kmer-start -> multi-step early-stop search -> ONE
           compaction -> locate -> packed XOR/popcount verify
           (exact = the k=0 case of the unified candidate path)
  inexact: per-slot static seed searches on the packed words -> ONE
           compaction over all seed intervals -> locate -> packed
           verify (duplicates from different seed slots are deduped on
           the host — bwtpu.results)

Outputs are compacted hit lists (optionally nm<=k-filtered and packed
for a one-round-trip fetch); the dense scatter-back layout survives
only as the fallback for 1-step indexes. Multi-shard single-process
runs vmap the per-shard pipeline over the stacked shard axis; the
multi-device path wraps the same per-shard function in shard_map
(bwtpu.dist).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from bwtpu import dna
from bwtpu.config import EngineConfig
from bwtpu.golden import Hit
from bwtpu.index import FMIndex, OCCK_STEP_FROM_WIDTH, ShardManifest
from bwtpu.io import Read
from bwtpu.kernels.compact import compact, compact_counts, scatter_back
from bwtpu.kernels.compact import compact as compact_mask
from bwtpu.kernels.locate import locate_rows
from bwtpu.kernels.search import backward_search, interval_rows
from bwtpu.kernels.search2 import backward_search_ra, right_align
from bwtpu.kernels.prep import revcomp_packed
from bwtpu.kernels.searchk import (backward_searchk_uniform,
                                   search_early_stop_packed,
                                   search_early_stop_uniform)
from bwtpu.kernels.verify2 import (NM_INVALID, build_text_rows, pack_reads,
                                   verify_packed, verify_packed_locv)
from bwtpu.kernels.verify import seed_layout

log = logging.getLogger(__name__)

KMER_BUCKETS = (12, 11, 10, 9, 8, 4)  # static depths we may compile for


class Shard(NamedTuple):
    """One shard's device-resident index (leading shard axis when
    stacked). A pytree — vmap/shard_map over axis 0."""

    lattice: jnp.ndarray  # int32[n_blocks+1, 32]
    latk: jnp.ndarray  # int32[n_blocksK+1, W]; W encodes the step per
    #                    index.OCCK_WIDTH (128->3, 512->4); (1, 1) dummy
    #                    = no multi-step lattice
    latk_inv: jnp.ndarray  # int32[4] rows with SA[r] < step (-1 pad)
    ssa: jnp.ndarray  # int32[n_sampled(max)]
    C: jnp.ndarray  # int32[8]
    dollar_row: jnp.ndarray  # int32
    n: jnp.ndarray  # int32
    text_len: jnp.ndarray  # int32
    text_rows: jnp.ndarray  # int32[n_words(max), R] stride-1 windows
    locv: jnp.ndarray  # int32[n(max), 1+2W+1] fused locate+verify rows
    #                    (sa_rate == 1 only); (1, 1) dummy = absent
    kmer_tables: dict  # {depth: int32[4^depth, 2]}


@dataclasses.dataclass
class DeviceIndexSet:
    # stacked on axis 0 (Shard) — the vmap/shard_map form — or a LIST
    # of axis-free per-shard Shard trees (upload_index stacked=False:
    # at human scale the stacked form costs either relayout copies
    # under vmap or slice copies per dispatch — engine.Engine
    # vmap_shards docstring)
    shard: Shard | list
    shard_offsets: np.ndarray  # int64[S], host-side

    @property
    def n_shards(self) -> int:
        if isinstance(self.shard, list):
            return len(self.shard)
        return self.shard.lattice.shape[0]


LOCV_MAX_BYTES = 4 << 30  # fused locate+verify table HBM budget


def upload_index(
    shards: list[FMIndex], device=None, read_len: int | None = None,
    sharding_fn=None, locv: bool | None = None, stacked: bool = True,
) -> DeviceIndexSet:
    """Stack shards (padded to common shapes) and place on device.

    sharding_fn(extra_dims) -> sharding for jax.device_put, used by the
    distributed engine; defaults to single-device placement.

    locv: build the fused locate+verify row table (one gather = SA
    value + verify window; kernels/verify2.build_locv_rows). None =
    auto: on when sa_rate == 1, the multi-step lattice is present and
    the table fits LOCV_MAX_BYTES across shards. An A/B at E. coli bench
    scale measured a 5% gain: the single gather from the 295 MB table
    replaces the ssa element take + the text-row take, but gathers get
    slower as tables leave cache (docs/DESIGN.md "gather cost vs table
    size"), which is why the win is smaller than the 2-rows-for-3 the
    row model predicts.
    """
    read_len = read_len or shards[0].config.read_len

    def pad_stack(arrs):
        pad_to = max(a.shape[0] for a in arrs)
        out = np.zeros((len(arrs), pad_to) + arrs[0].shape[1:], dtype=arrs[0].dtype)
        for i, a in enumerate(arrs):
            out[i, : a.shape[0]] = a
        return out

    if sharding_fn is None:
        put = lambda x, extra: jax.device_put(x, device=device)
    else:
        put = lambda x, extra: jax.device_put(x, sharding_fn(extra))

    depths = sorted(set.intersection(*[set(s.kmer_tables) for s in shards]))
    # multi-step lattice: all shards must have it (same step) for the
    # (static) multi-step search path to be usable; otherwise ship a
    # dummy whose shape tells the pipelines to stay on the 1-step path.
    have_latk = all(s.occk_lattice is not None for s in shards) and (
        len({s.occk_lattice.shape[1] for s in shards}) == 1
    )
    from bwtpu.kernels.verify2 import build_locv_rows, locv_row_width

    if locv is None:
        locv = (
            shards[0].config.sa_rate == 1
            and have_latk
            and sum(s.n for s in shards) * locv_row_width(read_len) * 4
            <= LOCV_MAX_BYTES
        )
    if locv and shards[0].config.sa_rate != 1:
        raise ValueError("locv table requires sa_rate == 1 (ssa must "
                         "be the full row-ordered suffix array)")

    if not stacked:
        # axis-free per-shard trees: no stacked copy ever exists on the
        # device, so no slice/relayout copies at dispatch (human scale;
        # Engine vmap_shards docstring). Arrays are padded to common
        # shapes so ONE compiled program serves every shard.
        def pad_to(a, m):
            if a.shape[0] == m:
                return a
            out = np.zeros((m,) + a.shape[1:], dtype=a.dtype)
            out[: a.shape[0]] = a
            return out

        m_lat = max(s.search_lattice.shape[0] for s in shards)
        m_latk = max(s.occk_lattice.shape[0] for s in shards) if have_latk else 1
        m_ssa = max(s.ssa.shape[0] for s in shards)
        trs = [build_text_rows(s.text_packed, read_len) for s in shards]
        m_tr = max(t.shape[0] for t in trs)
        shard_list = []
        for s, tr in zip(shards, trs):
            if locv:
                lv = build_locv_rows(s.text_packed, s.ssa, read_len)
                lv = pad_to(lv, m_ssa)
            else:
                lv = np.zeros((1, 1), dtype=np.int32)
            shard_list.append(Shard(
                lattice=put(pad_to(s.search_lattice, m_lat), 1),
                latk=put(
                    pad_to(s.occk_lattice, m_latk) if have_latk
                    else np.zeros((1, 1), np.int32), 1),
                latk_inv=put(
                    s.occk_invalid if have_latk
                    else np.full(4, -1, np.int32), 0),
                ssa=put(pad_to(s.ssa, m_ssa), 0),
                C=put(s.C, 0),
                dollar_row=put(np.int32(s.dollar_row), 0),
                n=put(np.int32(s.n), 0),
                text_len=put(np.int32(s.text_len), 0),
                text_rows=put(pad_to(tr, m_tr), 1),
                locv=put(lv, 1),
                kmer_tables={
                    dd: put(s.kmer_tables[dd], 1) for dd in depths
                },
            ))
        return DeviceIndexSet(
            shard=shard_list,
            shard_offsets=np.array(
                [s.shard_offset for s in shards], np.int64),
        )

    if have_latk:
        latk = pad_stack([s.occk_lattice for s in shards])
        latk_inv = np.stack([s.occk_invalid for s in shards])
    else:
        latk = np.zeros((len(shards), 1, 1), dtype=np.int32)
        latk_inv = np.full((len(shards), 4), -1, dtype=np.int32)
    if locv:
        locv_arr = pad_stack([
            build_locv_rows(s.text_packed, s.ssa, read_len) for s in shards
        ])
    else:
        locv_arr = np.zeros((len(shards), 1, 1), dtype=np.int32)
    shard = Shard(
        lattice=put(pad_stack([s.search_lattice for s in shards]), 2),
        latk=put(latk, 2),
        latk_inv=put(latk_inv, 1),
        ssa=put(pad_stack([s.ssa for s in shards]), 1),
        C=put(np.stack([s.C for s in shards]), 1),
        dollar_row=put(np.array([s.dollar_row for s in shards], np.int32), 0),
        n=put(np.array([s.n for s in shards], np.int32), 0),
        text_len=put(np.array([s.text_len for s in shards], np.int32), 0),
        text_rows=put(
            pad_stack([build_text_rows(s.text_packed, read_len) for s in shards]),
            2,
        ),
        locv=put(locv_arr, 2),
        kmer_tables={
            dd: put(np.stack([s.kmer_tables[dd] for s in shards]), 2)
            for dd in depths
        },
    )
    return DeviceIndexSet(
        shard=shard,
        shard_offsets=np.array([s.shard_offset for s in shards], np.int64),
    )


def pick_kmer_depth(available: list[int], min_len: int) -> int:
    """Largest available table depth <= min pattern length (0 if none)."""
    for dd in sorted(available, reverse=True):
        if dd <= min_len:
            return dd
    return 0


# ---------------------------------------------------------------------------
# Host-side batch encoding (NumPy; everything the device needs, padded)
# ---------------------------------------------------------------------------


class EncodedBatch(NamedTuple):
    # search inputs (both strands stacked: rows [0,B) fwd, [B,2B) rev)
    ra_codes: np.ndarray  # int32[2B, L] right-aligned
    ra_amb: np.ndarray  # int32[2B, L]
    lens: np.ndarray  # int32[2B]
    # verify inputs
    read_words: np.ndarray  # int32[2B, W]
    amb_bits: np.ndarray  # int32[2B, W]
    len_mask: np.ndarray  # int32[2B, W]
    # seed inputs (built on demand for inexact)
    seed_ra: np.ndarray | None  # int32[2B*S, cap]
    seed_amb: np.ndarray | None
    seed_lens: np.ndarray | None  # int32[2B*S]
    seed_off: np.ndarray | None  # int32[2B*S]
    min_len: int
    min_seed_len: int


def encode_batch(
    config: EngineConfig, reads: list[Read], k: int, pad_to: int | None = None
) -> tuple[EncodedBatch, int]:
    B = len(reads)
    Bp = pad_to or B
    L = max(config.read_len, max((len(r.seq) for r in reads), default=1))
    codes = np.zeros((Bp, L), dtype=np.int32)
    amb = np.zeros((Bp, L), dtype=np.int32)
    lens = np.zeros(Bp, dtype=np.int32)
    if reads and all(len(r.seq) == L for r in reads) and Bp == B:
        c, m = dna.encode_with_mask("".join(r.seq for r in reads))
        codes[:B] = c.reshape(B, L)
        amb[:B] = m.reshape(B, L)
        lens[:B] = L
    else:
        for i, r in enumerate(reads):
            c, m = dna.encode_with_mask(r.seq)
            codes[i, : len(c)] = c
            amb[i, : len(c)] = m
            lens[i] = len(c)

    # both strands, left-aligned
    rc = np.where(
        np.arange(L)[None, :] < lens[:, None],
        3 - np.take_along_axis(
            codes, np.clip(lens[:, None] - 1 - np.arange(L)[None, :], 0, L - 1),
            axis=1,
        ),
        0,
    )
    ra_m = np.take_along_axis(
        amb, np.clip(lens[:, None] - 1 - np.arange(L)[None, :], 0, L - 1), axis=1
    )
    rc_amb = np.where(np.arange(L)[None, :] < lens[:, None], ra_m, 0)
    codes2 = np.concatenate([codes, rc]).astype(np.int32)
    amb2 = np.concatenate([amb, rc_amb]).astype(np.int32)
    lens2 = np.concatenate([lens, lens])

    ra_c, ra_a = right_align(codes2, amb2, lens2)
    rw, ab, lm = pack_reads(codes2, amb2, lens2)
    valid_lens = lens[:B][lens[:B] > 0]
    min_len = int(valid_lens.min()) if len(valid_lens) else 0

    seed_ra = seed_amb = seed_lens = seed_off = None
    min_seed_len = 0
    if k > 0:
        S = k + 1
        cap = -(-L // S)
        B2 = 2 * Bp
        q, r = lens2 // S, lens2 % S
        s_idx = np.arange(S)[None, :]
        off = (s_idx * q[:, None] + np.minimum(s_idx, r[:, None])).astype(np.int32)
        slen = (q[:, None] + (s_idx < r[:, None])).astype(np.int32)
        # extract + right-align in one gather per element (host numpy)
        i_idx = np.arange(cap)[None, None, :]
        src = off[:, :, None] + i_idx - (cap - slen[:, :, None])
        ok = src >= off[:, :, None]
        src_safe = np.clip(src, 0, L - 1)
        sc = np.take_along_axis(
            np.repeat(codes2[:, None, :], S, axis=1), src_safe, axis=2
        )
        sa_ = np.take_along_axis(
            np.repeat(amb2[:, None, :], S, axis=1), src_safe, axis=2
        )
        seed_ra = np.where(ok, sc, 0).reshape(B2 * S, cap).astype(np.int32)
        seed_amb = np.where(ok, sa_, 0).reshape(B2 * S, cap).astype(np.int32)
        seed_lens = slen.reshape(B2 * S)
        seed_off = off.reshape(B2 * S)
        pos_seeds = seed_lens[seed_lens > 0]
        min_seed_len = int(pos_seeds.min()) if len(pos_seeds) else 0

    return (
        EncodedBatch(
            ra_codes=ra_c, ra_amb=ra_a, lens=lens2,
            read_words=rw, amb_bits=ab, len_mask=lm,
            seed_ra=seed_ra, seed_amb=seed_amb, seed_lens=seed_lens,
            seed_off=seed_off, min_len=min_len, min_seed_len=min_seed_len,
        ),
        Bp,
    )


# ---------------------------------------------------------------------------
# Device-side pipelines (pure functions of one shard + batch)
# ---------------------------------------------------------------------------


def compact_cap(n_lanes: int, loc_factor, scale: int = 1) -> int:
    """Compacted-stage capacity for a batch of n_lanes read-strand rows.
    Shared by the single-chip pipelines and the ring builder (dist.py)
    so home-buffer shapes can never drift from the pipeline's.

    scale (= 2**heal_level) also raises the 4096 floor: small batches
    sit on the floor, so doubling only loc_factor would leave their cap
    unchanged and self-healing could never converge."""
    return max(int(n_lanes * loc_factor), 4096 * scale)


def _locate_compacted(shard: Shard, rows, valid, *, sa_rate, cap,
                      counts=None):
    """Compact valid rows, locate them, scatter positions back (-1 fill).

    When `valid` is the prefix mask of per-lane counts (interval_rows
    output), pass `counts` so the cheaper structured compaction runs
    (compact_counts — bit-identical sel, skips the full-lane scatter).

    Returns (pos, loc_over, dropped) — dropped bool[lanes] flags lanes
    whose candidates were cut by the capacity (None on the generic-mask
    path), feeding the per-row overflow accounting the self-healing
    re-dispatch keys on."""
    shape = rows.shape
    flat_rows = rows.reshape(-1)
    if counts is not None:
        sel, count, loc_over, dropped = compact_counts(counts, shape[-1], cap)
    else:
        sel, count, loc_over = compact(valid.reshape(-1), cap)
        dropped = None
    sel_rows = jnp.take(flat_rows, sel)
    sel_valid = jnp.arange(cap, dtype=jnp.int32) < count
    pos_c = locate_rows(
        shard.lattice, shard.ssa, shard.C,
        shard.dollar_row, sel_rows, sel_valid, sa_rate,
    )
    pos = scatter_back(pos_c, sel, count, flat_rows.shape[0], fill=-1)
    return pos.reshape(shape), loc_over, dropped


def _exact_finish(shard, sp, ep, fix_over, *, max_hits, sa_rate, loc_factor,
                  cap_scale=1):
    """Interval expand -> compacted locate, shared by the search variants."""
    rows, valid, overflow = interval_rows(sp, ep, max_hits)
    cap = compact_cap(sp.shape[0], loc_factor, cap_scale)
    pos, loc_over, dropped = _locate_compacted(
        shard, rows, valid, sa_rate=sa_rate, cap=cap, counts=ep - sp,
    )
    if dropped is not None:
        # compaction drops count as per-row overflow too: the row's
        # results are incomplete either way, and the healing re-dispatch
        # treats both identically
        overflow = overflow + dropped.astype(jnp.int32)
    # fixup-capacity losses (per-lane, search2._fixup_stragglers) join
    # the same per-row incompleteness channel
    overflow = overflow + fix_over
    valid = valid & (pos >= 0)
    return pos, valid, overflow, loc_over


def exact_pipeline(
    shard: Shard, ra_codes, ra_amb, lens,
    *, d: int, max_hits: int, sa_rate: int, loc_factor: int = 2,
    cap_scale: int = 1,
):
    """Exact path (BASELINE configs 1+3): kmer-start search -> locate.

    Returns (pos int32[B2, H], valid bool[B2, H], overflow int32[B2],
    loc_overflow int32 scalar)."""
    kt = shard.kmer_tables[d] if d > 0 else jnp.zeros((1, 2), jnp.int32)
    sp, ep, fix_over = backward_search_ra(
        shard.lattice, shard.C, shard.dollar_row, shard.n, kt,
        ra_codes, ra_amb, lens, d, cap_scale=cap_scale,
    )
    return _exact_finish(
        shard, sp, ep, fix_over, max_hits=max_hits, sa_rate=sa_rate,
        loc_factor=loc_factor, cap_scale=cap_scale,
    )


def inexact_pipeline(
    shard: Shard, enc_seed_ra, enc_seed_amb, enc_seed_lens, enc_seed_off,
    read_words, amb_bits, len_mask, lens,
    *, k: int, d: int, max_loc: int, sa_rate: int, loc_factor: int = 4,
    cap_scale: int = 1,
):
    """Inexact path (config 2): pigeonhole seed-and-extend (SURVEY.md §7.4).

    Returns (cand int32[B2, Ct], nm int32[B2, Ct], valid bool[B2, Ct],
    overflow int32[B2], loc_overflow scalar, ver_overflow scalar)."""
    kt = shard.kmer_tables[d] if d > 0 else jnp.zeros((1, 2), jnp.int32)
    sp, ep, fix_over = backward_search_ra(
        shard.lattice, shard.C, shard.dollar_row, shard.n, kt,
        enc_seed_ra, enc_seed_amb, enc_seed_lens, d, cap_scale=cap_scale,
    )
    empty = enc_seed_lens == 0
    sp = jnp.where(empty, 0, sp)
    ep = jnp.where(empty, 0, ep)
    return _inexact_from_intervals(
        shard, sp, ep, enc_seed_off, read_words, amb_bits, len_mask, lens,
        k=k, max_loc=max_loc, sa_rate=sa_rate, loc_factor=loc_factor,
        fix_over=fix_over, cap_scale=cap_scale,
    )


def _inexact_from_intervals(
    shard, sp, ep, enc_seed_off, read_words, amb_bits, len_mask, lens,
    *, k, max_loc, sa_rate, loc_factor, fix_over,
    compact_output=False, cap_scale=1,
):
    """Seed intervals -> ONE compaction -> locate -> packed verify.

    All per-candidate work (locate, candidate start math, verify) runs
    on a single compacted lane set; the verify inputs ride ONE fused
    gather (separate gathers of read words / ambiguity / length mask /
    lens cost a full row fetch EACH — docs/DESIGN.md). Duplicate
    candidates from different seed slots are NOT deduped on device:
    verifying a duplicate costs one row, while deduping cost a dense
    (B2, Ct, Ct) pass plus an extra compact round trip; the host
    assembler (assemble_hits) dedupes on (read, pos, strand) anyway.
    """
    B2 = read_words.shape[0]
    nS = k + 1
    Ct = nS * max_loc
    rows, rvalid, overflow_s = interval_rows(sp, ep, max_loc)

    # floor: small batches stopped early can carry several candidates
    # per lane; a few thousand compacted lanes cost almost nothing.
    # loc_factor may be fractional: the compacted stages pay their CAP
    # in gather rows (DESIGN.md), and exact candidates average well
    # under 1/lane, so cap < B2 buys measurable rows/read.
    cap = compact_cap(B2, loc_factor, cap_scale)
    sel, count, comp_over, dropped = compact_counts(ep - sp, max_loc, cap)
    # per-row incompleteness = interval overflow (width > max_loc) OR
    # compaction drop OR straggler-fixup loss (fix_over, per lane):
    # either way this row may be missing hits, and the healing
    # re-dispatch / truncation marking treat them identically
    overflow = (overflow_s + dropped.astype(jnp.int32) + fix_over).reshape(
        B2, nS
    ).sum(axis=1)
    sel_valid = jnp.arange(cap, dtype=jnp.int32) < count
    rows_c = jnp.take(rows.reshape(-1), sel)
    lane = sel // max_loc  # seed-lane id (= read_row * nS + seed_slot)
    b_idx = lane // nS
    W = read_words.shape[1]
    # seed offsets ride the fused row (one per slot, selected by
    # one-hot) instead of their own per-candidate element gather —
    # element takes cost a full row fetch each (docs/DESIGN.md)
    fused = jnp.concatenate(
        [read_words, amb_bits, len_mask, lens[:, None],
         enc_seed_off.reshape(B2, nS)], axis=1
    )
    fc = jnp.take(fused, b_idx, axis=0)  # (cap, 3W+1+nS)
    if nS > 1:
        from bwtpu.kernels import common

        off_l = common.select_lane(fc[:, 3 * W + 1 :], lane - b_idx * nS, nS)
    else:
        off_l = fc[:, 3 * W + 1]
    use_locv = sa_rate == 1 and shard.locv.shape[-1] > 1
    if use_locv:
        # fused locate+verify: ONE row gather yields SA position AND
        # the text window (kernels/verify2.build_locv_rows) — replaces
        # the ssa element gather + the text-row gather
        with jax.named_scope("locate"):
            rec = jnp.take(shard.locv, rows_c, axis=0)
        spos_c = jnp.where(sel_valid, rec[:, 0], -1)
        cand_c = spos_c - off_l
        with jax.named_scope("verify"):
            nm_c = verify_packed_locv(
                rec, shard.text_len, cand_c, sel_valid & (spos_c >= 0),
                fc[:, :W], fc[:, W : 2 * W], fc[:, 2 * W : 3 * W],
                fc[:, 3 * W],
            )
    else:
        with jax.named_scope("locate"):
            spos_c = locate_rows(
                shard.lattice, shard.ssa, shard.C, shard.dollar_row,
                rows_c, sel_valid, sa_rate,
            )
        cand_c = spos_c - off_l
        with jax.named_scope("verify"):
            nm_c = verify_packed(
                shard.text_rows, shard.text_len, cand_c,
                sel_valid & (spos_c >= 0),
                fc[:, :W], fc[:, W : 2 * W], fc[:, 2 * W : 3 * W],
                fc[:, 3 * W],
            )
    if compact_output:
        # single-device fast path: skip the dense scatter_backs
        # entirely and hand the host the compacted hit list to decode
        return cand_c, nm_c, sel, count, overflow, comp_over
    total = B2 * Ct
    cand = scatter_back(cand_c, sel, count, total, fill=-1).reshape(B2, Ct)
    nm = scatter_back(nm_c, sel, count, total, fill=NM_INVALID).reshape(B2, Ct)
    hit_valid = nm <= k
    return cand, nm, hit_valid, overflow, comp_over, jnp.int32(0)


# ---------------------------------------------------------------------------
# Device-side batch prep for uniform-length reads (minimal host->device
# traffic: the host ships only the 2-bit packed forward reads (~0.5 MB
# per 8 K batch) and the device derives codes, reverse complements,
# seeds and masks with static vector ops — no gathers).
# ---------------------------------------------------------------------------


def _unpack_words(words: jnp.ndarray, L: int, step: int) -> jnp.ndarray:
    """(B, W) packed words -> (B, L) fields of `step` bits at even slots."""
    rep = jnp.repeat(words, 16, axis=1)[:, :L]
    shifts = (2 * (np.arange(L) % 16)).astype(np.int32)
    return (rep >> shifts) & ((1 << step) - 1)


def _pack_words(vals: jnp.ndarray, W: int) -> jnp.ndarray:
    """(B, L) 2-bit values -> (B, W) packed words (disjoint-bit sum)."""
    B, L = vals.shape
    pad = jnp.zeros((B, W * 16 - L), vals.dtype)
    v = jnp.concatenate([vals, pad], axis=1).reshape(B, W, 16).astype(jnp.uint32)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    return jnp.sum(v << shifts, axis=2).astype(jnp.int32)


def device_prep_uniform(read_words, amb_bits, L: int, k: int):
    """Derive the full EncodedBatch-equivalent on device (uniform lens).

    read_words/amb_bits: int32[B, W] forward-strand packed reads.
    Returns (ra_codes2, ra_amb2, lens2, read_words2, amb_bits2,
    len_mask2, seeds...) with both strands stacked, matching
    encode_batch's layout exactly.
    """
    B, W = read_words.shape
    codes = _unpack_words(read_words, L, 2)
    amb = _unpack_words(amb_bits, L, 1)
    rc = (3 - codes[:, ::-1]).astype(jnp.int32)
    rca = amb[:, ::-1]
    codes2 = jnp.concatenate([codes, rc])
    amb2 = jnp.concatenate([amb, rca])
    lens2 = jnp.full(2 * B, L, jnp.int32)
    rw2 = jnp.concatenate([read_words, _pack_words(rc, W)])
    ab2 = jnp.concatenate([amb_bits, _pack_words(rca, W)])
    lm = _pack_words(jnp.ones((1, L), jnp.int32), W)
    lm2 = jnp.broadcast_to(lm, (2 * B, W)).astype(jnp.int32)

    seeds = None
    if k > 0:
        nS = k + 1
        cap = -(-L // nS)
        parts_c, parts_a, offs, slens = [], [], [], []
        for off, slen in seed_layout(L, nS):
            pad = jnp.zeros((2 * B, cap - slen), jnp.int32)
            parts_c.append(jnp.concatenate([pad, codes2[:, off : off + slen]], axis=1))
            parts_a.append(jnp.concatenate([pad, amb2[:, off : off + slen]], axis=1))
            offs.append(off)
            slens.append(slen)
        seed_ra = jnp.stack(parts_c, axis=1).reshape(2 * B * nS, cap)
        seed_amb = jnp.stack(parts_a, axis=1).reshape(2 * B * nS, cap)
        seed_off = jnp.tile(jnp.asarray(offs, jnp.int32), (2 * B, 1)).reshape(-1)
        seed_lens = jnp.tile(jnp.asarray(slens, jnp.int32), (2 * B, 1)).reshape(-1)
        seeds = (seed_ra, seed_amb, seed_lens, seed_off)
    return codes2, amb2, lens2, rw2, ab2, lm2, seeds


def device_prep_packed(read_words, amb_bits, L: int):
    """Packed-only batch prep: both-strand packed words, no code planes.

    Replaces device_prep_uniform on the flagship path: deriving
    int32[B2, L] code planes measured 40% of an exact batch
    (scripts/stage_times.py, round 2); the packed search
    (kernels/searchk.search_early_stop_packed) reads the 2-bit words
    directly, so prep reduces to a SWAR reverse complement
    (kernels/prep.py) plus constants.
    """
    B, W = read_words.shape
    rc_w, rc_a = revcomp_packed(read_words, amb_bits, L)
    rw2 = jnp.concatenate([read_words, rc_w])
    ab2 = jnp.concatenate([amb_bits, rc_a])
    lens2 = jnp.full(2 * B, L, jnp.int32)
    lm = _pack_words(jnp.ones((1, L), jnp.int32), W)
    lm2 = jnp.broadcast_to(lm, (2 * B, W)).astype(jnp.int32)
    return rw2, ab2, lens2, lm2


def _shard_occ_step(shard: Shard) -> int:
    """Static (trace-time) multi-step size inferred from the lattice
    record width. Single source of truth: index.OCCK_WIDTH (via its
    reverse map), so an index-side layout change can't silently strand
    the engine on the 1-step fallback (round-1 regression, VERDICT #1).
    0 = dummy lattice, stay on the 1-step path."""
    return OCCK_STEP_FROM_WIDTH.get(shard.latk.shape[-1], 0)


def exact_pipeline_packed(shard, read_words, amb_bits, *, L, d, max_hits,
                          sa_rate, loc_factor=2, min_trips=0,
                          compact_output=False, cap_scale=1, wide_steps=0):
    step = _shard_occ_step(shard)
    assert not (compact_output and not (step and d >= 1))
    if step and d >= 1:
        # early-stop search + full-length packed verify: exact search is
        # the k = 0 case of the unified candidate path (hit iff nm == 0;
        # candidate start = locate(row) - remaining). FM intervals only
        # narrow, so verifying the <= max_hits candidates of a partial
        # suffix match is complete (true hits are a subset) and the
        # verify filters the superset exactly. The search reads the
        # 2-bit packed rows directly (kernels/prep.py) — no (B2, L)
        # code planes (DESIGN.md "packed prep").
        rw2, ab2, lens2, lm2 = device_prep_packed(read_words, amb_bits, L)
        # clamp like _seed_expand_packed does: short reads against a
        # deep-kmer large-genome index can have L - d < the engine's
        # genome-sized wide_steps, which trips searchk's trace-time
        # assert on an otherwise valid align run (ADVICE r4)
        with jax.named_scope("search"):
            sp, ep, rem, fix_over = search_early_stop_packed(
                shard.lattice, shard.latk, shard.latk_inv, shard.C,
                shard.dollar_row, shard.kmer_tables[d], rw2, ab2, 0, L, d,
                step, max_hits, min_trips, cap_scale=cap_scale,
                wide_steps=min(wide_steps, max(L - d, 0)),
            )
        out = _inexact_from_intervals(
            shard, sp, ep, rem, rw2, ab2, lm2, lens2,
            k=0, max_loc=max_hits, sa_rate=sa_rate,
            loc_factor=loc_factor, fix_over=fix_over,
            compact_output=compact_output, cap_scale=cap_scale,
        )
        if compact_output:
            return out
        cand, nm, valid, overflow, loc_over, ver_over = out
        return cand, valid, overflow, loc_over + ver_over
    ra2, raa2, lens2, _, _, _, _ = device_prep_uniform(read_words, amb_bits, L, 0)
    return exact_pipeline(
        shard, ra2, raa2, lens2, d=d, max_hits=max_hits, sa_rate=sa_rate,
        loc_factor=loc_factor, cap_scale=cap_scale,
    )


def _seed_expand_packed(shard, rw2, ab2, lm2, lens2, *, L, k, d, max_loc,
                        sa_rate, loc_factor, min_trips, step,
                        compact_output, cap_scale, wide_steps=0):
    """Pigeonhole seed expansion on already-prepped both-strand packed
    rows (shared by inexact_pipeline_packed and the tiered path, which
    runs it on a compacted escalated subset)."""
    B2 = rw2.shape[0]
    nS = k + 1
    sps, eps, offs, fovs = [], [], [], []
    for off, slen in seed_layout(L, nS):
        with jax.named_scope("search"):
            sp_s, ep_s, rem_s, over = search_early_stop_packed(
                shard.lattice, shard.latk, shard.latk_inv, shard.C,
                shard.dollar_row, shard.kmer_tables[d],
                rw2, ab2, off, slen, d, step, max_loc, min_trips,
                cap_scale=cap_scale,
                wide_steps=min(wide_steps, max(slen - d, 0)),
            )
        sps.append(sp_s)
        eps.append(ep_s)
        offs.append(off + rem_s)
        fovs.append(over)
    sp = jnp.stack(sps, axis=1).reshape(B2 * nS)
    ep = jnp.stack(eps, axis=1).reshape(B2 * nS)
    seed_off = jnp.stack(offs, axis=1).reshape(B2 * nS)
    fix_over = jnp.stack(fovs, axis=1).reshape(B2 * nS)
    return _inexact_from_intervals(
        shard, sp, ep, seed_off, rw2, ab2, lm2, lens2,
        k=k, max_loc=max_loc, sa_rate=sa_rate, loc_factor=loc_factor,
        fix_over=fix_over,
        compact_output=compact_output, cap_scale=cap_scale,
    )


def inexact_pipeline_packed(shard, read_words, amb_bits, *, L, k, d, max_loc,
                            sa_rate, loc_factor=4, min_trips=0,
                            compact_output=False, cap_scale=1, wide_steps=0):
    step = _shard_occ_step(shard)
    assert not (compact_output and not (step and d >= 1))
    if step and d >= 1:
        # multi-step early-stop path: each seed slot has one uniform
        # (static) length, so the seed searches run per slot as static
        # (off, slen) subfields of the packed rows — no right-aligned
        # seed arrays, no code planes at all (kernels/prep.py). A seed
        # stops once its interval fits the per-seed candidate budget;
        # the full-length verify filters the partial-suffix superset
        # (candidate start = locate(row) - (seed offset + remaining)).
        rw2, ab2, lens2, lm2 = device_prep_packed(read_words, amb_bits, L)
        return _seed_expand_packed(
            shard, rw2, ab2, lm2, lens2, L=L, k=k, d=d, max_loc=max_loc,
            sa_rate=sa_rate, loc_factor=loc_factor, min_trips=min_trips,
            step=step, compact_output=compact_output,
            cap_scale=cap_scale, wide_steps=wide_steps,
        )
    _, _, lens2, rw2, ab2, lm2, seeds = device_prep_uniform(
        read_words, amb_bits, L, k
    )
    seed_ra, seed_amb, seed_lens, seed_off = seeds
    return inexact_pipeline(
        shard, seed_ra, seed_amb, seed_lens, seed_off, rw2, ab2, lm2, lens2,
        k=k, d=d, max_loc=max_loc, sa_rate=sa_rate, loc_factor=loc_factor,
        cap_scale=cap_scale,
    )


def tiered_pipeline_packed(shard, read_words, amb_bits, *, L, k, d, d_seed,
                           max_hits, max_cand, sa_rate, loc_factor,
                           k2_loc_factor, esc_factor=1.0, min_trips=0,
                           cap_scale=1, wide_steps=0):
    """Tiered inexact search (VERDICT r3 item 2): exact-first, escalate
    only the reads with no nm == 0 hit to the (k+1)-seed pigeonhole
    expansion.

    Every read pays one full-read exact pass (the k = 0 candidate path
    at its tight loc_factor); reads that produced an exact hit on either
    strand are DONE — only the remainder is compacted (esc_factor caps
    the escalated fraction) and runs the 3-seed expansion, whose
    candidate compaction then scales with the escalated count instead of
    the whole batch. On error-free production read sets the escalated
    minority makes this a multiple-x win; on the bench's uniform
    {0,1,2}-mismatch simulation ~2/3 escalate (reported as
    k2_escalated_frac).

    Reporting contract (stratum semantics, documented in DESIGN.md):
      - reads with NO exact hit: the full <= k hit set (pigeonhole is
        complete for them) — golden k parity;
      - reads WITH an exact hit: all their nm == 0 hits (golden k = 0
        parity) plus any incidental nm <= k hits the exact pass's
        verify surfaced — a superset of golden k=0, subset of golden k.
    Primary selection and MAPQ are IDENTICAL to the full enumeration
    (the primary is a best-nm hit and the nm == 0 set is complete).

    Returns (cand1, nm1, sel1, cnt1, cand2, nm2, sel2, cnt2, esc_sel,
    esc_cnt, ov_rows, comp_over): list 1 = exact-tier candidates in the
    usual flat-slot space (row = sel1 // max_hits); list 2 = escalated-
    tier candidates in ESCALATED lane space — its read-strand row
    row2 = sel2 // ((k+1)*max_cand) maps to the real row via
    esc_sel[row2 % esc_cap] (+B for the reverse half); ov_rows is the
    combined per-row incompleteness count (healing/truncation channel).
    """
    from bwtpu.kernels.common import popcount32
    from bwtpu.kernels.compact import compact

    step = _shard_occ_step(shard)
    assert step and d >= 1 and d_seed >= 1, (step, d, d_seed)
    B, W = read_words.shape
    rw2, ab2, lens2, lm2 = device_prep_packed(read_words, amb_bits, L)
    B2 = 2 * B

    # ---- tier 1: full-read exact candidate pass ----
    with jax.named_scope("search"):
        sp, ep, rem, fov = search_early_stop_packed(
            shard.lattice, shard.latk, shard.latk_inv, shard.C,
            shard.dollar_row, shard.kmer_tables[d], rw2, ab2, 0, L, d,
            step, max_hits, min_trips, cap_scale=cap_scale,
            wide_steps=min(wide_steps, max(L - d, 0)),
        )
    cand1, nm1, sel1, cnt1, ov1, co1 = _inexact_from_intervals(
        shard, sp, ep, rem, rw2, ab2, lm2, lens2,
        k=0, max_loc=max_hits, sa_rate=sa_rate, loc_factor=loc_factor,
        fix_over=fov, compact_output=True,
        cap_scale=cap_scale,
    )
    cap1 = cand1.shape[0]

    # per-read "has an exact hit" (either strand): scatter-max over the
    # compacted candidate rows — B2-sized, no dense pass
    live1 = jnp.arange(cap1, dtype=jnp.int32) < cnt1
    is0 = live1 & (nm1 == 0)
    row1 = sel1 // max_hits
    has0 = jnp.zeros(B2, jnp.int32).at[row1].max(
        is0.astype(jnp.int32), mode="drop"
    )
    read_has0 = (has0[:B] + has0[B:]) > 0

    # escalate live reads (not all-ambiguous padding) without one
    n_amb = jnp.sum(popcount32(
        (ab2[:B] & lm2[:B]).astype(jnp.uint32)), axis=1)
    alive = n_amb < jnp.minimum(lens2[:B], L)
    escalate = (~read_has0) & alive
    esc_cap = compact_cap(B, esc_factor, cap_scale)
    esc_cap = min(esc_cap, B)
    esc_sel, esc_cnt, esc_over = compact(escalate, esc_cap)
    # reads escalated past capacity lose their inexact tier: per-read
    # incompleteness for the healing/marking channel
    esc_dropped = escalate & (
        jnp.cumsum(escalate.astype(jnp.int32)) > esc_cap
    )

    # ---- tier 2: seed expansion on the escalated subset ----
    live_e = jnp.arange(esc_cap, dtype=jnp.int32) < esc_cnt
    live_pair = jnp.concatenate([live_e, live_e])
    rw2e = jnp.concatenate(
        [jnp.take(rw2, esc_sel, axis=0), jnp.take(rw2, B + esc_sel, axis=0)]
    )
    ab2e = jnp.concatenate(
        [jnp.take(ab2, esc_sel, axis=0), jnp.take(ab2, B + esc_sel, axis=0)]
    )
    # kill the slack lanes beyond esc_cnt (compact() pads sel with lane
    # 0 — without this they would duplicate read 0's hits): all-
    # ambiguous rows die in the first search step
    ab2e = jnp.where(live_pair[:, None], ab2e, lm2[:1])
    lm2e = jnp.broadcast_to(lm2[:1], (2 * esc_cap, W)).astype(jnp.int32)
    lens2e = jnp.full(2 * esc_cap, L, jnp.int32)
    cand2, nm2, sel2, cnt2, ov2, co2 = _seed_expand_packed(
        shard, rw2e, ab2e, lm2e, lens2e, L=L, k=k, d=d_seed,
        max_loc=max_cand, sa_rate=sa_rate, loc_factor=k2_loc_factor,
        min_trips=min_trips, step=step, compact_output=True,
        cap_scale=cap_scale, wide_steps=wide_steps,
    )

    # combined per-row incompleteness: tier-1 rows + escalation drops +
    # tier-2 rows scattered back to their real rows
    ereal = jnp.where(live_e, esc_sel, B2)
    ov_rows = ov1 + jnp.concatenate([esc_dropped, esc_dropped]).astype(
        jnp.int32
    )
    ov_rows = ov_rows.at[ereal].add(ov2[:esc_cap], mode="drop")
    ov_rows = ov_rows.at[jnp.where(live_e, B + esc_sel, B2)].add(
        ov2[esc_cap:], mode="drop"
    )
    comp_over = co1 + co2 + esc_over
    return (cand1, nm1, sel1, cnt1, cand2, nm2, sel2, cnt2,
            esc_sel, esc_cnt, ov_rows, comp_over)


def pack_reads_for_bench(reads):
    """Pack a uniform-length read list to (read_words, amb_bits)."""
    B = len(reads)
    L = len(reads[0].seq)
    c, m = dna.encode_with_mask("".join(r.seq for r in reads))
    codes = c.reshape(B, L).astype(np.int32)
    amb = m.reshape(B, L).astype(np.int32)
    rw, ab, _ = pack_reads(codes, amb, np.full(B, L, np.int32))
    return rw, ab


# ---------------------------------------------------------------------------
# Engine (host orchestration)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchStats:
    reads: int = 0
    hits: int = 0
    overflow_reads: int = 0
    compact_overflows: int = 0
    heals: int = 0  # self-healing re-dispatches (doubled-cap retries)
    truncated_reads: int = 0  # reads still capacity-cut after max_heals
    escalated: int = 0  # tiered dispatch: reads sent to the seed tier
    device_s: float = 0.0
    host_s: float = 0.0


def _index_arrays(s):
    """Host-resident array leaves of one FMIndex shard (size probe for
    the stacked-vmap auto mode)."""
    arrs = [s.search_lattice, s.mark_rank_ck, s.ssa, s.text_packed]
    arrs += list(s.kmer_tables.values())
    if s.occk_lattice is not None:
        arrs.append(s.occk_lattice)
    return arrs


class Engine:
    """Single-process alignment engine over one or more index shards."""

    # stacked-vmap residency limit: above this total table size the
    # stacked form's batched gathers force relayout COPIES of the big
    # tables at compile (an OOM at 10 x 250 Mbp on a 16 GB device,
    # round 4 — DESIGN.md "human-scale index"), so auto mode switches
    # to axis-free per-shard dispatch well before that. ROADMAP queue
    # 1 item 4 re-derives the threshold for the 80 GB card.
    VMAP_STACK_MAX_BYTES = 2 << 30

    def __init__(
        self,
        shards: list[FMIndex],
        manifest: ShardManifest | None = None,
        device=None,
        vmap_shards: bool | None = None,
        fuse_shards: bool | None = None,
    ):
        self.shards = shards
        self.manifest = manifest
        self.config = shards[0].config
        if vmap_shards is None:
            # auto: stacked vmap (one dispatch for all shards) until the
            # tables are big enough that its relayout copies would OOM —
            # a user aligning against a human-scale artifact through
            # cli.py must land in list mode without knowing the flag
            table_bytes = sum(
                a.nbytes for s in shards
                for a in _index_arrays(s)
            )
            vmap_shards = not (
                len(shards) > 1 and table_bytes > self.VMAP_STACK_MAX_BYTES
            )
        self.dev = upload_index(shards, device=device, stacked=vmap_shards)
        self._device = device
        # fuse_shards (list mode only): trace ALL per-shard programs
        # into ONE jitted function (tuple of shard trees as arguments —
        # no stacked copy, so none of the vmap relayout OOM), so an
        # S-shard block costs ONE dispatch + ONE fetch instead of S.
        # An A/B at human scale (2.5 Gbp / 10 shards, DESIGN.md "fused
        # dispatch A/B") found no win over the per-shard loop once the
        # loop ships ONE H2D of the packed reads and ONE grouped fetch,
        # while the 10-program XLA compile adds minutes — async
        # dispatches already overlap. Default OFF; the path stays
        # suite-covered (tests/test_unstacked.py) for transports where
        # dispatch latency does serialize.
        self.fuse_shards = False if fuse_shards is None else fuse_shards
        self.kmer_depths = sorted(shards[0].kmer_tables)
        self.stats = BatchStats()
        # vmap_shards=False: dispatch one program per shard instead of
        # vmapping over the stacked shard axis. At human scale (10 x
        # 250 Mbp shards, ~14 GB of tables) the vmapped program's
        # batched gathers force relayout COPIES of the big tables and
        # the compile ran out of device memory (round 4 — DESIGN.md
        # "human-scale index"); per-shard programs gather the sliced
        # tables directly. Bacterial-scale multi-shard runs keep the
        # vmapped single dispatch (S serial dispatches each pay a
        # fixed dispatch cost — round-1 weak #6).
        self.vmap_shards = vmap_shards
        self._compiled: dict = {}
        # max observed candidate-stage live fraction (live rows / lane
        # count) per k, fed by finish_block; autotune_caps reads it
        self._cand_live_frac: dict = {}
        # per-k loc_factor / hit_factor overrides set by autotune_caps
        # (config values stay the ceilings)
        self._lf_override: dict = {}
        self._hf_override: dict = {}
        # max observed live hit fraction per k (hits-mode cnt / lanes)
        self._hit_live_frac: dict = {}

    def _wide_steps(self, d: int) -> int:
        """Static two-gather 1-step narrowings to run before the
        multi-step search loop. The multi-step record serves both
        interval bounds only within its 256-row window, so when the
        start-table intervals are wider (E[width] = n/4^d — ~600 at
        2.5 Gbp with d=11) every lane would straggle into the tiny
        compacted finisher (measured: 7/8 of a 131 K-lane batch at
        human scale, DESIGN.md round 4). Each wide step narrows 4x at
        two always-correct gathers; sized so E[width] <= 8 after the
        phase. 0 at bacterial scale — the flagship path is unchanged."""
        if d <= 0:
            return 0
        lam = max(sh.n for sh in self.shards) / 4.0 ** d
        w = 0
        # target E[width] <= 8: at ~15 (2.5 Gbp, d=12) the FIRST
        # multi-step trip still straggles ~6% of lanes (interval spans
        # the 256-row window with P ~ width/256) — more than the B/64
        # finisher, so every batch healed; <= 8 leaves ~2x headroom
        while lam > 8 and w < 8:
            lam /= 4
            w += 1
        return w

    def _shard_tree(self, s: int):
        """Axis-free Shard tree for shard s (list mode returns the
        uploaded per-shard tree directly — no device slice copy)."""
        sh = self.dev.shard
        if isinstance(sh, list):
            return sh[s]
        return jax.tree.map(lambda x: x[s], sh)

    def _occ_step(self) -> int:
        """Multi-step size from shape metadata alone. dispatch_* used to
        call _shard_occ_step(self._shard_tree(0)), which in stacked mode
        eagerly slice-copies EVERY shard-0 table (potentially hundreds
        of MB) per dispatch just to read a static width (ADVICE r4); the
        stacked latk's trailing dim is identical without slicing."""
        sh = self.dev.shard
        latk = sh[0].latk if isinstance(sh, list) else sh.latk
        return OCCK_STEP_FROM_WIDTH.get(latk.shape[-1], 0)

    # quantized loc_factor ladder: adaptive tuning picks from here so a
    # stream compiles at most a couple of cap variants, not one per
    # occupancy wiggle
    LF_LADDER = (0.25, 0.35, 0.45, 0.5, 0.6, 0.75, 1.0, 1.25, 1.5,
                 2.0, 3.0, 4.0, 6.0)

    def autotune_caps(self, block, k: int | None = None,
                      margin: float = 1.12, pad_to: int | None = None):
        """Occupancy-adaptive capacities (VERDICT r4 item 3): dispatch
        `block` once at the CURRENT caps, observe the candidate-stage
        live fraction (rides the one-round-trip hits fetch), and point
        config.loc_factor at the smallest ladder value that covers
        live * margin. Compacted stages pay their CAP in gather rows
        (docs/DESIGN.md "Locate/cap sweep"), so sizing the cap just
        above measured occupancy is the
        single biggest knob — and self-healing re-dispatch (bounded,
        supersets) absorbs the occasional batch that beats the margin,
        which is exactly why the margin can be thin.

        Returns the chosen loc_factor. Call once per stream (or per
        read-profile change); each new value compiles one program
        variant on first use."""
        k = self.config.k if k is None else k
        self._cand_live_frac.pop(k, None)
        self._hit_live_frac.pop(k, None)
        ov0 = self.stats.overflow_reads + self.stats.compact_overflows
        self.finish_block(self.dispatch_block(block, k, pad_to=pad_to))
        if self.stats.overflow_reads + self.stats.compact_overflows > ov0:
            # the probe itself hit a cap even after healing: observed
            # live fractions are understated — do not tighten from them
            log.warning("autotune_caps: probe batch overflowed; keeping "
                        "configured ceilings for k=%d", k)
            return self._lf(k)
        live = self._cand_live_frac.get(k)
        if live is None:  # dense fallback path: no occupancy channel
            return self._lf(k)
        target = live * margin
        lf = next((v for v in self.LF_LADDER if v >= target),
                  self.config.loc_factor)
        # never tune ABOVE the configured factor: the configured value
        # is the safety ceiling, healing covers upward excursions. The
        # override is PER k — exact and k2 candidate densities differ
        # ~3x, a shared factor would starve one or bloat the other.
        lf = min(lf, self.config.loc_factor)
        if lf != self._lf(k):
            log.info(
                "autotune_caps: k=%d live frac %.3f -> loc_factor %s "
                "(was %s)", k, live, lf, self._lf(k),
            )
        self._lf_override[k] = lf
        # hit buffer: the hits-mode finish transfers the FULL static
        # buffer (hit_cap x 8 B) device-to-host, so an oversized
        # hit_factor is pure transfer waste — size it to the observed
        # live hit fraction the same way
        hlive = self._hit_live_frac.get(k)
        if hlive is not None:
            hf = next((v for v in self.LF_LADDER if v >= hlive * margin),
                      self.config.hit_factor)
            self._hf_override[k] = min(hf, self.config.hit_factor)
        return lf

    def _lf(self, k: int) -> float:
        """Effective base loc_factor for this k (autotune override or
        the configured ceiling)."""
        return self._lf_override.get(k, self.config.loc_factor)

    def _hf(self, k: int) -> float:
        """Effective base hit_factor for this k."""
        return self._hf_override.get(k, self.config.hit_factor)

    def _caps(self, k: int, level: int):
        """Capacity set at heal level `level` (self-healing overflow,
        VERDICT r3 item 3): every capacity doubles per level, so a batch
        that overflowed at level l re-runs with 2x caps at l+1 (bounded
        by config.max_heals). At escalated levels the hit buffer widens
        to the compaction cap so the hit compaction structurally cannot
        drop (hover == 0 for level >= 1); loc_factor is clamped so the
        cap never exceeds the total candidate-slot count."""
        f = 1 << level
        cfg = self.config
        mh = cfg.max_hits * f
        mc = cfg.max_cand * f
        max_loc = mc if k else mh
        nS = k + 1
        lf = min(self._lf(k) * f, nS * max_loc)
        hf = self._hf(k) if level == 0 else lf
        return mh, mc, lf, hf

    def _exact_fn(self, d: int, level: int = 0):
        mh, mc, lf, hf = self._caps(0, level)
        key = ("exact", d, mh, lf)
        if key not in self._compiled:
            cfg = self.config

            def per_shard(shard, ra_codes, ra_amb, lens):
                return exact_pipeline(
                    shard, ra_codes, ra_amb, lens,
                    d=d, max_hits=mh, sa_rate=cfg.sa_rate,
                    loc_factor=lf, cap_scale=1 << level,
                )

            # shard lattices are padded to one common shape, so a
            # single compiled function serves every shard
            self._compiled[key] = jax.jit(per_shard)
        return self._compiled[key]

    def _inexact_fn(self, k: int, d: int, level: int = 0):
        mh, mc, lf, hf = self._caps(k, level)
        key = ("inexact", k, d, mc, lf)
        if key not in self._compiled:
            cfg = self.config

            def per_shard(shard, s_ra, s_amb, s_lens, s_off, rw, ab, lm, lens):
                return inexact_pipeline(
                    shard, s_ra, s_amb, s_lens, s_off, rw, ab, lm, lens,
                    k=k, d=d, max_loc=mc, sa_rate=cfg.sa_rate,
                    loc_factor=lf, cap_scale=1 << level,
                )

            self._compiled[key] = jax.jit(per_shard)
        return self._compiled[key]

    def dispatch_batch(self, reads: list[Read], k: int, _level: int = 0):
        """Encode + launch device work for one batch; returns a handle.

        Device results stay on-device until finish_batch — callers can
        keep several batches in flight to hide dispatch and transfer
        latency (the device executes them in order). Uniform-length
        batches take the packed fast
        path: only 2-bit packed forward reads cross the host-device
        link (~0.5 MB / 8 K reads); everything else is derived on
        device (device_prep_uniform).

        _level: self-healing escalation level — all capacities run at
        2**_level x their configured values (finish_batch re-dispatches
        on overflow).
        """
        shard = self.dev.shard
        S = self.dev.n_shards
        shard_outs = []
        L = len(reads[0].seq) if reads else 0
        # packed fast path: all reads one length, and the prebuilt text
        # window rows (sized by config.read_len) are wide enough
        if reads and 0 < L <= self.config.read_len and all(
            len(r.seq) == L for r in reads
        ):
            B = len(reads)
            c, m = dna.encode_with_mask("".join(r.seq for r in reads))
            codes = c.reshape(B, L).astype(np.int32)
            amb = m.reshape(B, L).astype(np.int32)
            rw, ab, _ = pack_reads(codes, amb, np.full(B, L, np.int32))
            d = pick_kmer_depth(
                self.kmer_depths, L if k == 0 else L // (k + 1)
            )
            # compacted outputs skip the dense scatter_backs; needs the
            # multi-step path
            compact = bool(self._occ_step() and d >= 1)
            kind = "exact" if k == 0 else "inexact"
            fn = self._packed_fn(kind, k, d, L, compact, level=_level)
            if S > 1 and not self.vmap_shards:
                rw = jax.device_put(rw, self._device)  # ONE H2D, not S
                ab = jax.device_put(ab, self._device)
            for s in range(S):
                shard_outs.append(fn(self._shard_tree(s), rw, ab))
            mode = "compact" if compact else "dense"
            return (reads, B, k, shard_outs, time.perf_counter(), mode,
                    _level)

        enc, B = encode_batch(self.config, reads, k)
        if k == 0:
            d = pick_kmer_depth(self.kmer_depths, enc.min_len)
            fn = self._exact_fn(d, level=_level)
            for s in range(S):
                shard_outs.append(
                    fn(self._shard_tree(s), enc.ra_codes, enc.ra_amb,
                       enc.lens))
        else:
            d = pick_kmer_depth(self.kmer_depths, enc.min_seed_len)
            fn = self._inexact_fn(k, d, level=_level)
            for s in range(S):
                shard_outs.append(
                    fn(
                        self._shard_tree(s), enc.seed_ra, enc.seed_amb,
                        enc.seed_lens, enc.seed_off, enc.read_words,
                        enc.amb_bits, enc.len_mask, enc.lens,
                    )
                )
        return (reads, B, k, shard_outs, time.perf_counter(), "dense",
                _level)

    def _packed_fn(self, kind: str, k: int, d: int, L: int, compact: bool,
                   hits_output: bool = False, vmapped: bool = False,
                   level: int = 0, n_list: int = 0):
        """n_list > 0: return a fused-list function over n_list per-shard
        trees — `lfn((tree_0..tree_{S-1}), rw, ab) -> (out_0..out_{S-1})`
        traced as ONE program (one dispatch, one fetch). The trees are
        separate arguments, so unlike the stacked vmap form no relayout
        copy of the big tables is materialized (the human-scale OOM —
        Engine vmap_shards docstring)."""
        mh, mc, lf, hf = self._caps(k if kind != "exact" else 0, level)
        # tiered runs BOTH cap sets: tier 1 at the k=0 caps, tier 2 at
        # the k caps — both belong in the program cache key
        caps0 = self._caps(0, level) if kind == "tiered" else None
        key = (
            "packed", kind, k, d, L, compact, hits_output, vmapped,
            mh, mc, lf, hf, n_list, caps0,
        )
        if key not in self._compiled:
            cfg = self.config
            if kind == "exact":

                ws = self._wide_steps(d)

                def pipe(shard, rw, ab):
                    return exact_pipeline_packed(
                        shard, rw, ab, L=L, d=d, max_hits=mh,
                        sa_rate=cfg.sa_rate, loc_factor=lf,
                        min_trips=cfg.min_trips, compact_output=compact,
                        cap_scale=1 << level,
                        wide_steps=ws,
                    )
            elif kind == "tiered":
                assert not hits_output and compact
                mh0, _, lf0, _ = caps0
                ws = self._wide_steps(d)
                d_seed = pick_kmer_depth(self.kmer_depths, L // (k + 1))

                def pipe(shard, rw, ab):
                    return tiered_pipeline_packed(
                        shard, rw, ab, L=L, k=k, d=d, d_seed=d_seed,
                        max_hits=mh0, max_cand=mc, sa_rate=cfg.sa_rate,
                        loc_factor=lf0, k2_loc_factor=lf,
                        esc_factor=cfg.esc_factor,
                        min_trips=cfg.min_trips, cap_scale=1 << level,
                        wide_steps=ws,
                    )
            else:

                ws = self._wide_steps(d)

                def pipe(shard, rw, ab):
                    return inexact_pipeline_packed(
                        shard, rw, ab, L=L, k=k, d=d, max_loc=mc,
                        sa_rate=cfg.sa_rate, loc_factor=lf,
                        min_trips=cfg.min_trips, compact_output=compact,
                        cap_scale=1 << level,
                        wide_steps=ws,
                    )

            fn = pipe
            if hits_output:
                assert compact
                # one-round-trip output: keep only verified hits
                # (nm <= k), pack (sel, nm) into one int32, and return
                # fixed-shape arrays + scalars so the host fetches the
                # whole result in a single device_get: one finish-side
                # sync instead of a count pre-fetch plus three slice
                # dispatches (DESIGN.md "e2e profile"). Hits are a subset
                # of the cap-compacted candidates, so reusing the same
                # cap introduces no new overflow class.
                Ct_l = (k + 1) * (mc if k else mh)

                def fn(shard, rw, ab):
                    cand_c, nm_c, sel, count, overflow, co = pipe(shard, rw, ab)
                    keep = (nm_c <= k) & (
                        jnp.arange(sel.shape[0], dtype=jnp.int32) < count
                    )
                    # hit buffer sized by hit_factor: the whole buffer
                    # crosses device-to-host (config.hit_factor)
                    hit_cap = min(
                        sel.shape[0],
                        compact_cap(2 * rw.shape[0], hf, 1 << level),
                    )
                    sel2, cnt2, hover = compact_mask(keep, hit_cap)
                    # hit-compaction drops join the per-row overflow
                    # bitmap: with healing disabled (heal_overflow=False
                    # or max_heals=0) those reads' hits were previously
                    # dropped with only a log warning and no xo:i:1
                    # truncation mark (ADVICE r4) — hover == 0 was only
                    # structurally guaranteed at heal level >= 1
                    drop = keep & (
                        jnp.cumsum(keep.astype(jnp.int32)) > hit_cap
                    )
                    overflow = overflow.at[sel // Ct_l].add(
                        drop.astype(jnp.int32), mode="drop"
                    )
                    # ONE row gather for the whole payload: separate
                    # element takes of (cand, sel, nm) each cost a full
                    # per-element gather (the largest stage of the
                    # round-3 stage attribution)
                    payload = jnp.stack([cand_c, sel * 4 + nm_c], axis=1)
                    out2 = jnp.take(payload, sel2, axis=0)
                    # packed per-row overflow bitmap (one bit per read-
                    # strand row, incl. compaction drops): ~B2/8 bytes
                    # riding the one fetch, so the healing re-dispatch
                    # and final truncation marking know WHICH reads are
                    # affected without a second round trip
                    B2 = overflow.shape[0]
                    nw = -(-B2 // 32)
                    ovb = jnp.zeros(nw * 32, jnp.uint32).at[:B2].set(
                        (overflow > 0).astype(jnp.uint32)
                    )
                    ovbm = jnp.sum(
                        ovb.reshape(nw, 32)
                        << jnp.arange(32, dtype=jnp.uint32)[None, :],
                        axis=1,
                    ).astype(jnp.int32)
                    # entries >= cnt2 are garbage; the host slices first.
                    # count (candidate-stage live rows) rides along so
                    # the host can observe occupancy for adaptive caps
                    # (autotune_caps) without an extra round trip
                    return (out2[:, 0], out2[:, 1], cnt2,
                            (overflow > 0).sum(), co, hover, ovbm, count)

            if vmapped:
                fn = jax.vmap(fn, in_axes=(0, None, None))
            if n_list:
                fn_one = fn

                def fn(shard_trees, rw, ab):
                    return tuple(fn_one(t, rw, ab) for t in shard_trees)

            self._compiled[key] = jax.jit(fn)
        return self._compiled[key]

    def _maybe_heal_batch(self, reads, k, overflow, compact_over, level):
        """Self-healing re-dispatch (VERDICT r3 item 3): when any row
        overflowed a capacity (interval / compaction / fixup) and heal
        levels remain, re-run the whole batch with every cap doubled.
        Retried results are a strict superset (caps only grow), so they
        simply replace the originals. Returns the healed hits or None."""
        n_over = int((overflow.sum(axis=0) > 0).sum())
        cfg = self.config
        if (n_over or compact_over) and cfg.heal_overflow and (
            level < cfg.max_heals
        ):
            self.stats.heals += 1
            log.info(
                "align_batch: %d overflowed rows / %d compaction drops — "
                "healing with 2^%d x caps", n_over, compact_over, level + 1,
            )
            return self.finish_batch(
                self.dispatch_batch(reads, k, _level=level + 1)
            )
        return None

    def finish_batch(self, handle) -> list[list[Hit]]:
        reads, B, k, shard_outs, t_disp, mode, level = handle
        t1 = time.perf_counter()
        mh, mc, lf, hf = self._caps(k, level)
        Ct = (k + 1) * mc if k else mh
        if mode == "compact":
            # (cand_c, nm_c, sel, count, overflow, comp_over) per shard
            shard_comp = [
                tuple(np.asarray(o[i]) for i in range(4)) for o in shard_outs
            ]
            overflow = np.stack([np.asarray(o[4]) for o in shard_outs])
            compact_over = sum(int(np.asarray(o[5])) for o in shard_outs)
            self.stats.device_s += time.perf_counter() - t_disp
            healed = self._maybe_heal_batch(reads, k, overflow, compact_over,
                                            level)
            if healed is not None:
                return healed
            if compact_over:
                log.warning(
                    "align_batch: compaction capacity overflowed by %d rows "
                    "after %d heals; results may be incomplete — raise "
                    "loc_factor or max_heals", compact_over, level,
                )
            out = assemble_hits_compact(
                reads, B, shard_comp, k, Ct,
                [sh.text_len for sh in self.shards],
                [sh.shard_offset for sh in self.shards],
            )
            return self._finish_stats(reads, out, overflow, compact_over, t1)
        if k == 0:
            pos = np.stack([np.asarray(o[0]) for o in shard_outs])
            valid = np.stack([np.asarray(o[1]) for o in shard_outs])
            overflow = np.stack([np.asarray(o[2]) for o in shard_outs])
            nm = None
            compact_over = sum(int(np.asarray(o[3])) for o in shard_outs)
        else:
            pos = np.stack([np.asarray(o[0]) for o in shard_outs])
            nm = np.stack([np.asarray(o[1]) for o in shard_outs])
            valid = np.stack([np.asarray(o[2]) for o in shard_outs])
            overflow = np.stack([np.asarray(o[3]) for o in shard_outs])
            compact_over = sum(
                int(np.asarray(o[4])) + int(np.asarray(o[5])) for o in shard_outs
            )
        self.stats.device_s += time.perf_counter() - t_disp
        healed = self._maybe_heal_batch(reads, k, overflow, compact_over, level)
        if healed is not None:
            return healed
        return self._assemble(reads, B, pos, nm, valid, overflow, compact_over, t1)

    def align_batch(self, reads: list[Read], k: int | None = None) -> list[list[Hit]]:
        if not reads:
            return []
        k = self.config.k if k is None else k
        handle = self.dispatch_batch(reads, k)
        return self.finish_batch(handle)

    # ---- columnar fast path (production FASTQ->SAM, VERDICT r2 #1) ----

    def dispatch_block(self, block, k: int | None = None,
                       pad_to: int | None = None, _level: int = 0,
                       tiered: bool = False):
        """Dispatch a uniform-length columnar ReadBlock (bwtpu.readblock)
        on the packed pipelines. pad_to keeps batch shapes static across
        a stream (one compiled program); pad rows are all-ambiguous so
        they die in the first search step, and finish_block drops them.

        tiered (k > 0 only): exact-first tiered dispatch
        (tiered_pipeline_packed) — every read runs the cheap full-read
        exact pass, only reads with no exact hit escalate to the
        (k+1)-seed expansion. Stratum reporting contract (see the
        pipeline docstring): escalated reads carry their full <= k set,
        exact-hit reads their complete nm == 0 stratum; primary/MAPQ
        identical to full enumeration. Falls back to the full inexact
        pipeline when the multi-step lattice is absent (full results
        are a superset of the tiered contract).

        _level: self-healing escalation level (caps x 2**_level);
        finish_block re-dispatches on overflow.
        """
        k = self.config.k if k is None else k
        L = block.L
        if not (0 < L <= self.config.read_len):
            raise ValueError(
                f"block read length {L} not in (0, {self.config.read_len}]"
            )
        from bwtpu.readblock import pack_block

        rw, ab = pack_block(block)
        Bp = pad_to or block.n
        if Bp > block.n:
            W = rw.shape[1]
            rw = np.concatenate([rw, np.zeros((Bp - block.n, W), np.int32)])
            amb_all = np.full((Bp - block.n, W), 0x55555555, np.int32)
            ab = np.concatenate([ab, amb_all])
        d = pick_kmer_depth(self.kmer_depths, L if k == 0 else L // (k + 1))
        compact = bool(self._occ_step() and d >= 1)
        kind = "exact" if k == 0 else "inexact"
        mh, mc, lf, hf = self._caps(k, _level)
        Ct = (k + 1) * mc if k else mh
        # hits mode packs (sel, nm) into one int32: sel*4 + nm
        hits = compact and 2 * Bp * Ct * 4 < 2**31
        if self.dev.n_shards > 1 and not self.vmap_shards:
            # ONE H2D of the packed reads: numpy args re-transfer on
            # every jitted call, so the per-shard dispatch loop was
            # shipping the same ~2 B2 words S times
            rw = jax.device_put(rw, self._device)
            ab = jax.device_put(ab, self._device)
        if tiered and k > 0 and compact:
            d_full = pick_kmer_depth(self.kmer_depths, L)
            S = self.dev.n_shards
            if S > 1 and not self.vmap_shards and self.fuse_shards:
                lfn = self._packed_fn("tiered", k, d_full, L, True,
                                      level=_level, n_list=S)
                out = ("list", lfn(tuple(self.dev.shard), rw, ab))
            elif S > 1 and self.vmap_shards:
                vfn = self._packed_fn("tiered", k, d_full, L, True,
                                      vmapped=True, level=_level)
                out = ("stacked", vfn(self.dev.shard, rw, ab))
            else:
                fn = self._packed_fn("tiered", k, d_full, L, True,
                                     level=_level)
                out = [fn(self._shard_tree(s), rw, ab) for s in range(S)]
            return ("block", block, Bp, k, out, time.perf_counter(),
                    "tiered", _level)
        if tiered and k > 0:
            log.debug("tiered dispatch unavailable without the multi-step "
                      "lattice; running the full inexact pipeline")
        if hits and not self.vmap_shards and self.fuse_shards and (
            self.dev.n_shards > 1
        ):
            # fused list program: one dispatch + one fetch for all S
            # shards (the list-mode answer to r1 weak #6; the stacked
            # vmap form below OOMs at human scale)
            lfn = self._packed_fn(kind, k, d, L, compact, hits_output=True,
                                  level=_level, n_list=self.dev.n_shards)
            out = lfn(tuple(self.dev.shard), rw, ab)
            return ("block", block, Bp, k, ("list", out),
                    time.perf_counter(), "hits", _level)
        if hits and self.vmap_shards:
            # all S shards in ONE dispatch (vmap over the stacked shard
            # axis) and later ONE stacked fetch, instead of S serial
            # dispatches and fetches
            vfn = self._packed_fn(kind, k, d, L, compact, hits_output=True,
                                  vmapped=True, level=_level)
            out = vfn(self.dev.shard, rw, ab)
            return ("block", block, Bp, k, ("stacked", out),
                    time.perf_counter(), "hits", _level)
        fn = self._packed_fn(kind, k, d, L, compact, hits_output=hits,
                             level=_level)
        shard_outs = []
        for s in range(self.dev.n_shards):
            shard_outs.append(fn(self._shard_tree(s), rw, ab))
        mode = "hits" if hits else ("compact" if compact else "dense")
        return ("block", block, Bp, k, shard_outs, time.perf_counter(), mode,
                _level)

    def finish_block(self, handle):
        """Materialize a dispatch_block handle -> results.FlatHits.

        Compact mode fetches the live count per shard first, then only
        the live prefix of each compacted array — device-to-host bytes
        scale with actual hits, not the static capacity.

        Self-healing (VERDICT r3 item 3): any capacity overflow triggers
        a re-dispatch of the same block with doubled caps (bounded by
        config.max_heals); if the final level still overflows, the
        affected reads are flagged in FlatHits.truncated and the SAM
        emitters mark them with an xo:i:1 tag."""
        from bwtpu.results import flatten_hits

        tag, block, Bp, k, shard_outs, t_disp, mode, level = handle
        assert tag == "block"
        mh, mc, lf, hf = self._caps(k, level)
        Ct = (k + 1) * mc if k else mh
        cfg = self.config
        can_heal = cfg.heal_overflow and level < cfg.max_heals
        trunc_rows = None  # bool[2*Bp] at the final level, else None
        if mode == "hits":
            # ONE device_get total (stacked) or per shard: fixed-shape
            # hit arrays + scalars — count rides along; no pre-sync, no
            # slice dispatches
            shard_comp = []
            n_over = 0
            compact_over = 0
            hit_over = 0
            cand_live = 0
            if isinstance(shard_outs, tuple) and shard_outs[0] == "stacked":
                hc_s, hm_s, cnt_s, ov_s, co_s, ho_s, bm_s, cc_s = (
                    jax.device_get(shard_outs[1])
                )
                per_shard = [
                    (hc_s[s], hm_s[s], int(cnt_s[s]), int(ov_s[s]),
                     int(co_s[s]), int(ho_s[s]), bm_s[s], int(cc_s[s]))
                    for s in range(hc_s.shape[0])
                ]
            else:
                if isinstance(shard_outs, tuple) and shard_outs[0] == "list":
                    shard_outs = shard_outs[1]  # fused-list dispatch
                # ONE grouped device_get for every shard's outputs: each
                # per-shard device_get was a separate blocking round trip
                per_shard = [
                    (hc, hm, int(cnt), int(ov), int(co), int(ho), bm,
                     int(cc))
                    for hc, hm, cnt, ov, co, ho, bm, cc in
                    jax.device_get(list(shard_outs))
                ]
            bm_or = None
            hit_live = 0
            for hc, hm, cnt, ov, co, ho, bm, cc in per_shard:
                hm = hm[:cnt]
                shard_comp.append((hc[:cnt], hm % 4, hm // 4, cnt))
                n_over += ov
                compact_over += co
                hit_over += ho
                cand_live = max(cand_live, cc)
                hit_live = max(hit_live, cnt)
                bm_or = bm if bm_or is None else (bm_or | bm)
            # candidate/hit-stage live rows per lane, for adaptive caps
            self._cand_live_frac[k] = max(
                self._cand_live_frac.get(k, 0.0), cand_live / (2 * Bp)
            )
            self._hit_live_frac[k] = max(
                self._hit_live_frac.get(k, 0.0), hit_live / (2 * Bp)
            )
            self.stats.device_s += time.perf_counter() - t_disp
            if (n_over or compact_over or hit_over) and can_heal:
                return self._heal_block(block, k, Bp, level, n_over,
                                        compact_over + hit_over)
            if n_over and bm_or is not None:
                bits = (
                    (bm_or.astype(np.uint32)[:, None]
                     >> np.arange(32, dtype=np.uint32)[None, :]) & 1
                ).reshape(-1)
                trunc_rows = bits[: 2 * Bp].astype(bool)
            if hit_over:
                log.warning(
                    "align block: hit buffer overflowed by %d hits after "
                    "%d heals — results incomplete; raise config.hit_factor",
                    hit_over, level,
                )
                self.stats.compact_overflows += hit_over
            t1 = time.perf_counter()
            s_idx, row_idx, p, m = compact_to_columns(shard_comp, k, Ct)
        elif mode == "tiered":
            if isinstance(shard_outs, tuple) and shard_outs[0] == "stacked":
                outs_np = jax.device_get(shard_outs[1])
                per_shard = [
                    tuple(np.asarray(o)[s] for o in outs_np)
                    for s in range(np.asarray(outs_np[0]).shape[0])
                ]
            else:
                if isinstance(shard_outs, tuple) and shard_outs[0] == "list":
                    shard_outs = shard_outs[1]  # fused-list dispatch
                per_shard = jax.device_get(list(shard_outs))
            mh0 = self._caps(0, level)[0]
            s_l, row_l, p_l, m_l = [], [], [], []
            compact_over = 0
            ov_accum = None
            for s, out in enumerate(per_shard):
                rows, p_s, m_s, _nov, co_s = tiered_to_columns(
                    out, mh0, mc, k, Bp
                )
                s_l.append(np.full(len(rows), s, dtype=np.int64))
                row_l.append(rows)
                p_l.append(p_s)
                m_l.append(m_s)
                compact_over += co_s
                ov = np.asarray(out[10]) > 0
                ov_accum = ov if ov_accum is None else (ov_accum | ov)
                self.stats.escalated += int(np.asarray(out[9]))
            n_over = int(ov_accum.sum())
            self.stats.device_s += time.perf_counter() - t_disp
            if (n_over or compact_over) and can_heal:
                return self._heal_block(block, k, Bp, level, n_over,
                                        compact_over, tiered=True)
            if n_over:
                trunc_rows = np.asarray(ov_accum, dtype=bool)
            t1 = time.perf_counter()
            s_idx = np.concatenate(s_l)
            row_idx = np.concatenate(row_l)
            p = np.concatenate(p_l)
            m = np.concatenate(m_l)
        elif mode == "compact":
            shard_comp = []
            n_over = 0
            compact_over = 0
            ov_rows = None
            for o in shard_outs:
                cand_c, nm_c, sel, count, overflow, co = o
                cnt = int(np.asarray(count))
                self._cand_live_frac[k] = max(
                    self._cand_live_frac.get(k, 0.0), cnt / (2 * Bp)
                )
                # one grouped transfer (each np.asarray is a separate
                # blocking round trip)
                cand_np, nm_np, sel_np, ovr, co_ = jax.device_get(
                    (cand_c[:cnt], nm_c[:cnt], sel[:cnt], overflow > 0, co)
                )
                shard_comp.append((cand_np, nm_np, sel_np, cnt))
                n_over += int(ovr.sum())
                ov_rows = ovr if ov_rows is None else (ov_rows | ovr)
                compact_over += int(co_)
            self.stats.device_s += time.perf_counter() - t_disp
            if (n_over or compact_over) and can_heal:
                return self._heal_block(block, k, Bp, level, n_over,
                                        compact_over)
            if n_over:
                trunc_rows = np.asarray(ov_rows, dtype=bool)
            t1 = time.perf_counter()
            s_idx, row_idx, p, m = compact_to_columns(shard_comp, k, Ct)
        else:
            if k == 0:
                pos = np.stack([np.asarray(o[0]) for o in shard_outs])
                valid = np.stack([np.asarray(o[1]) for o in shard_outs])
                overflow = np.stack([np.asarray(o[2]) for o in shard_outs])
                nm = None
                compact_over = sum(int(np.asarray(o[3])) for o in shard_outs)
            else:
                pos = np.stack([np.asarray(o[0]) for o in shard_outs])
                nm = np.stack([np.asarray(o[1]) for o in shard_outs])
                valid = np.stack([np.asarray(o[2]) for o in shard_outs])
                overflow = np.stack([np.asarray(o[3]) for o in shard_outs])
                compact_over = sum(
                    int(np.asarray(o[4])) + int(np.asarray(o[5]))
                    for o in shard_outs
                )
            self.stats.device_s += time.perf_counter() - t_disp
            ov_rows = overflow.sum(axis=0) > 0
            n_over = int(ov_rows.sum())
            if (n_over or compact_over) and can_heal:
                return self._heal_block(block, k, Bp, level, n_over,
                                        compact_over)
            if n_over:
                trunc_rows = ov_rows
            t1 = time.perf_counter()
            s_idx, row_idx, p, m = dense_to_columns(pos, nm, valid)
        if compact_over:
            log.warning(
                "align block: compaction capacity overflowed by %d rows "
                "after %d heals; affected reads are marked truncated — "
                "raise loc_factor/max_cand or max_heals",
                compact_over, level,
            )
        if n_over:
            log.warning(
                "align block: %d read-strand rows overflowed interval "
                "capacity after %d heals (max_hits=%d, max_cand=%d); "
                "affected reads are marked truncated",
                n_over, level, mh, mc,
            )
        flat = flatten_hits(
            block.n, block.L, Bp, s_idx, row_idx, p, m,
            [sh.text_len for sh in self.shards],
            [sh.shard_offset for sh in self.shards],
        )
        if trunc_rows is not None:
            # read-strand rows -> per-read flags ([0,Bp) fwd, [Bp,2Bp) rev)
            tr = np.zeros(block.n, dtype=bool)
            rows = np.flatnonzero(trunc_rows) % Bp
            rows = rows[rows < block.n]
            tr[rows] = True
            flat = flat._replace(truncated=tr)
            self.stats.truncated_reads += int(tr.sum())
        t2 = time.perf_counter()
        self.stats.reads += block.n
        self.stats.hits += len(flat.read_idx)
        self.stats.overflow_reads += n_over
        self.stats.compact_overflows += compact_over
        self.stats.host_s += t2 - t1
        return flat

    def _heal_block(self, block, k, Bp, level, n_over, compact_over,
                    tiered=False):
        """Re-dispatch a block with doubled caps (self-healing)."""
        self.stats.heals += 1
        log.info(
            "align block: %d overflowed rows / %d compaction drops — "
            "healing with 2^%d x caps", n_over, compact_over, level + 1,
        )
        return self.finish_block(
            self.dispatch_block(block, k, pad_to=Bp, _level=level + 1,
                                tiered=tiered)
        )

    def _assemble(self, reads, B, pos, nm, valid, overflow, compact_over, t1):
        if compact_over:
            log.warning(
                "align_batch: compaction capacity overflowed by %d rows; "
                "results may be incomplete — raise loc_factor/max_cand",
                compact_over,
            )
        out = assemble_hits(
            reads, B, pos, nm, valid,
            [sh.text_len for sh in self.shards],
            [sh.shard_offset for sh in self.shards],
        )
        return self._finish_stats(reads, out, overflow, compact_over, t1)

    def _finish_stats(self, reads, out, overflow, compact_over, t1):
        n_over = int((overflow.sum(axis=0) > 0).sum())
        if n_over:
            log.warning(
                "align_batch: %d read-strand rows overflowed interval "
                "capacity (max_hits=%d, max_cand=%d); raise the caps",
                n_over, self.config.max_hits, self.config.max_cand,
            )
        t2 = time.perf_counter()
        self.stats.reads += len(reads)
        self.stats.hits += sum(len(h) for h in out)
        self.stats.overflow_reads += n_over
        self.stats.compact_overflows += compact_over
        self.stats.host_s += t2 - t1
        return out

    def align_all(
        self,
        reads: list[Read],
        k: int | None = None,
        batch_size: int | None = None,
        pipeline_depth: int = 3,
    ) -> list[list[Hit]]:
        """Streamed alignment with `pipeline_depth` batches in flight
        (hides per-sync dispatch latency; SURVEY.md §7.6 item 5)."""
        k = self.config.k if k is None else k
        bs = batch_size or self.config.batch_size
        out: list[list[Hit]] = []
        inflight: list = []
        for i in range(0, len(reads), bs):
            inflight.append(self.dispatch_batch(reads[i : i + bs], k))
            if len(inflight) > pipeline_depth:
                out.extend(self.finish_batch(inflight.pop(0)))
        while inflight:
            out.extend(self.finish_batch(inflight.pop(0)))
        return out


def _assemble_flat(reads, B, s_idx, row_idx, p, m, text_lens, offsets):
    """Flat (shard, read-strand row, local pos, nm) vectors -> per-read
    deduped sorted Hit lists. Vectorized via bwtpu.results (the per-hit
    Python dict loop here measured 1.30 s / 262 K-read batch — VERDICT
    r2 missing #1)."""
    from bwtpu.results import flatten_hits, hit_lists

    read_lens = np.array([len(r.seq) for r in reads], dtype=np.int64)
    flat = flatten_hits(
        len(reads), read_lens, B, s_idx, row_idx, p, m, text_lens, offsets
    )
    return hit_lists(flat)


def dense_to_columns(pos, nm, valid):
    """(S, 2B, H) dense device outputs -> flat (s_idx, row_idx, p, m)."""
    s_idx, row_idx, h_idx = np.nonzero(valid)
    p = pos[s_idx, row_idx, h_idx]
    m = nm[s_idx, row_idx, h_idx] if nm is not None else np.zeros(len(p), int)
    return s_idx, row_idx, p, m


def tiered_to_columns(out, max_hits, max_cand, k, B):
    """Host decode of tiered_pipeline_packed output -> flat (row_idx,
    p, m) columns (single shard). Tier-2 rows are mapped from escalated
    lane space back to real read-strand rows via esc_sel.

    Dedups on (row, pos) keeping min nm: for escalated reads, tier-1
    incidental nm <= k hits can overlap tier-2's full pigeonhole set,
    and a duplicated best hit would make n_best = 2 -> MAPQ 0 in
    select_primary_flat (ADVICE r4) — the dedup is what makes the
    'MAPQ identical to full enumeration' contract hold for every
    consumer, not just ones that dedup downstream."""
    (cand1, nm1, sel1, cnt1, cand2, nm2, sel2, cnt2,
     esc_sel, esc_cnt, ov_rows, comp_over) = [np.asarray(o) for o in out]
    c1 = int(cnt1)
    keep1 = nm1[:c1] <= k
    rows1 = (sel1[:c1] // max_hits)[keep1]
    p1, m1 = cand1[:c1][keep1], nm1[:c1][keep1]
    esc_cap = len(esc_sel)
    Ct2 = (k + 1) * max_cand
    c2 = int(cnt2)
    keep2 = nm2[:c2] <= k
    r2e = (sel2[:c2] // Ct2)[keep2]
    fwd = r2e < esc_cap
    real2 = np.where(fwd, esc_sel[r2e % esc_cap],
                     B + esc_sel[(r2e - esc_cap) % esc_cap])
    p2, m2 = cand2[:c2][keep2], nm2[:c2][keep2]
    rows = np.concatenate([rows1, real2])
    p = np.concatenate([p1, p2])
    m = np.concatenate([m1, m2])
    order = np.lexsort((m, p, rows))
    rows, p, m = rows[order], p[order], m[order]
    first = np.ones(len(rows), dtype=bool)
    first[1:] = (rows[1:] != rows[:-1]) | (p[1:] != p[:-1])
    return (
        rows[first], p[first], m[first],
        int((ov_rows > 0).sum()),
        int(comp_over),
    )


def compact_to_columns(shard_comp, k, Ct):
    """Per-shard compacted outputs (cand_c, nm_c, sel, count) -> flat
    (s_idx, row_idx, p, m) columns; sel indexes the flat (2B * Ct)
    candidate slots (read-strand row = sel // Ct)."""
    s_l, row_l, p_l, m_l = [], [], [], []
    for s, (cand_c, nm_c, sel, count) in enumerate(shard_comp):
        cnt = int(count)
        cand_c, nm_c, sel = cand_c[:cnt], nm_c[:cnt], sel[:cnt]
        keep = nm_c <= k
        cand_c, nm_c, sel = cand_c[keep], nm_c[keep], sel[keep]
        s_l.append(np.full(len(sel), s, dtype=np.int64))
        row_l.append(sel // Ct)
        p_l.append(cand_c)
        m_l.append(nm_c)
    return (
        np.concatenate(s_l), np.concatenate(row_l),
        np.concatenate(p_l), np.concatenate(m_l),
    )


def assemble_hits(reads, B, pos, nm, valid, text_lens, offsets):
    """(S, 2B, H) dense device outputs -> per-read Hit lists."""
    s_idx, row_idx, p, m = dense_to_columns(pos, nm, valid)
    return _assemble_flat(reads, B, s_idx, row_idx, p, m, text_lens, offsets)


def assemble_hits_compact(reads, B, shard_comp, k, Ct, text_lens, offsets):
    """Compacted device outputs -> per-read Hit lists."""
    s_idx, row_idx, p, m = compact_to_columns(shard_comp, k, Ct)
    return _assemble_flat(reads, B, s_idx, row_idx, p, m, text_lens, offsets)
