"""Exact backward search v4/v5: multi-step Occ lattice + early stop.

Multi-step: one record gather advances the search by s bases (s = 3 or
4) for both interval bounds (docs/DESIGN.md "multi-step Occ lattice";
layout in bwtpu/index.py at OCCK_BLOCK). The generalized backward step
over the s-mer alphabet (SURVEY.md §3.2 recurrence applied to s-char
blocks):

    sp' = Ks[t] + OccS(t, sp)
    ep' = Ks[t] + OccS(t, ep)

where t is the next s pattern bases (right-to-left) and OccS(t, i)
counts rows r < i whose suffix is preceded by exactly the text s-mer
t. Ks is folded into the stored checkpoints, so a step is: one record
gather, one in-record one-hot checkpoint select, and two R-lane prefix
counts elementwise. The s rows with SA[r] < s store code 0 and are
excluded from checkpoints; queries with t == 0 subtract them via the
occk_invalid row list (same scheme as the 1-step '$' row).

Early stop (search_early_stop_uniform): FM intervals only narrow, so
once a lane's width drops to <= stop_width its candidate rows can be
located and verified directly against the packed text — the remaining
~25 chained gathers are pointless. At bacterial scale the k-mer start
table alone leaves mean width ~1, so the whole-batch loop exits after
~1 multi-step (a while_loop conditioned on the count of still-wide
lanes); the few lanes that stay wide (repeats) or straggle (interval
past the record window) finish on the compacted always-correct 1-step
two-gather path. Callers get (sp, ep, remaining): the interval is for
the pattern SUFFIX P[remaining:], so a candidate's read start is
locate(row) - remaining, and the full-length packed-text verify
(kernels/verify2.py) decides the hit — exactly the seed-and-extend
shape (SURVEY.md §7.4) applied to exact search too.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from bwtpu.kernels import common
from bwtpu.kernels.search2 import _fixup_stragglers, _fixup_stragglers_packed

OCCK_BLOCK = {3: 256, 4: 512}  # must match bwtpu/index.py


def occk_pair_from_record(rec, t, sp, ep, inv, A: int, R: int):
    """fold + OccS-prefix counts at sp and ep from the record of block
    sp // R.

    rec: (B, W) int32 gathered records; t: (B,) s-mer codes 0..A-1;
    sp, ep: (B,) int32 rows; inv: (4,) int32 invalid rows (-1 pad).
    Returns (sp', ep', strag) where strag flags lanes whose ep lies
    past the record's R-row window (their ep' is garbage; the caller
    re-runs them on the 1-step path).
    """
    log2r = R.bit_length() - 1
    fold = common.select_lane(rec[:, :A], t, A)
    # unpack R row codes (one byte each, LSB-first) and match against t
    rep = jnp.repeat(rec[:, A : A + R // 4], 4, axis=1)  # (B, R)
    shifts = (8 * (np.arange(R) % 4)).astype(np.int32)
    codes = (rep >> shifts) & 0xFF
    match = codes == t[:, None]
    idx = np.arange(R, dtype=np.int32)
    base = (sp >> log2r) << log2r
    msp = sp - base
    mep = ep - base
    cnt_sp = jnp.sum(match & (idx[None, :] < msp[:, None]), axis=1)
    cnt_ep = jnp.sum(match & (idx[None, :] < mep[:, None]), axis=1)
    # invalid rows (stored code 0, excluded from fold): subtract when
    # the query s-mer is 0 and the row falls inside the counted prefix
    t0 = t == 0
    for q in range(4):
        r = inv[q]
        in_blk = (r >= base) & (r >= 0)
        off = r - base
        cnt_sp -= (t0 & in_blk & (off < msp)).astype(jnp.int32)
        cnt_ep -= (t0 & in_blk & (off < mep)).astype(jnp.int32)
    strag = mep > R
    return (
        (fold + cnt_sp).astype(jnp.int32),
        (fold + cnt_ep).astype(jnp.int32),
        strag,
    )


def _kmer_start(kmer_table, codes, amb, L: int, d: int):
    """Initial interval from the depth-d start table (one row gather)."""
    weights = (4 ** np.arange(d - 1, -1, -1, dtype=np.int64)).astype(np.int32)
    key = jnp.sum(codes[:, L - d :] * weights[None, :], axis=1)
    start = jnp.take(kmer_table, key, axis=0)
    amb_tail = jnp.sum(amb[:, L - d :], axis=1) > 0
    sp0 = jnp.where(amb_tail, 0, start[:, 0])
    ep0 = jnp.where(amb_tail, 0, start[:, 1])
    return sp0, ep0


def _single_step(lattice, C, dollar_row, c, a, sp, ep):
    """One 1-step update (record gather + paired Occ); returns new
    (sp, ep, strag)."""
    rec = jnp.take(lattice, sp >> 7, axis=0)
    o_sp, o_ep, s1 = common.occ_pair_from_record(rec, dollar_row, c, sp, ep)
    cbase = common.select_scalar_table(C, c + 1, 8)
    sp_new = jnp.where(a == 1, 0, cbase + o_sp)
    ep_new = jnp.where(a == 1, 0, cbase + o_ep)
    return sp_new, ep_new, s1


def _smer_codes(codes, amb, B: int, T: int, step: int):
    """(B, T) s-mer codes + ambiguity for chain groups, leftmost first."""
    region = codes[:, : step * T].reshape(B, T, step)
    wS = (4 ** np.arange(step - 1, -1, -1)).astype(np.int32)
    t_all = jnp.sum(region * wS[None, None, :], axis=2)
    a_all = jnp.sum(amb[:, : step * T].reshape(B, T, step), axis=2) > 0
    return t_all, a_all


@partial(jax.jit, static_argnames=("L", "d", "step"))
def backward_searchk_uniform(
    lattice: jnp.ndarray,  # int32[n_blocks+1, 32]    1-step records
    latk: jnp.ndarray,  # int32[n_blocksK+1, W]    multi-step records
    latk_inv: jnp.ndarray,  # int32[4] invalid rows (-1 pad)
    C: jnp.ndarray,  # int32[8]
    dollar_row: jnp.ndarray,  # int32
    kmer_table: jnp.ndarray,  # int32[4^d, 2]
    codes: jnp.ndarray,  # int32[B, L] base codes (full width = length L)
    amb: jnp.ndarray,  # int32[B, L] ambiguity mask
    L: int,
    d: int,
    step: int,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Full-chain exact backward search of B patterns, all length L
    (static). Requires d >= 1; returns (sp, ep, overflow) with the same
    contract as search2.backward_search_ra."""
    assert d >= 1 and L >= d and step in (3, 4), (L, d, step)
    A = 4**step
    R = OCCK_BLOCK[step]
    B = codes.shape[0]
    sp0, ep0 = _kmer_start(kmer_table, codes, amb, L, d)

    chain = L - d
    p = chain % step
    strag = jnp.zeros(B, dtype=bool)
    sp, ep = sp0, ep0
    for sgl in range(p):
        pos = L - d - 1 - sgl
        sp, ep, s1 = _single_step(
            lattice, C, dollar_row, codes[:, pos], amb[:, pos], sp, ep
        )
        strag = strag | s1

    T = (chain - p) // step
    if T > 0:
        t_all, a_all = _smer_codes(codes, amb, B, T, step)

        def body(t, state):
            sp, ep, strag = state
            g = T - 1 - t
            tS = jax.lax.dynamic_slice_in_dim(t_all, g, 1, axis=1)[:, 0]
            aS = jax.lax.dynamic_slice_in_dim(a_all, g, 1, axis=1)[:, 0]
            rec = jnp.take(latk, sp // R, axis=0)
            sp_new, ep_new, sK = occk_pair_from_record(
                rec, tS, sp, ep, latk_inv, A, R
            )
            sp_new = jnp.where(aS, 0, sp_new)
            ep_new = jnp.where(aS, 0, ep_new)
            return sp_new, ep_new, strag | sK

        sp, ep, strag = jax.lax.fori_loop(0, T, body, (sp, ep, strag))

    lens = jnp.full(B, L, jnp.int32)
    return _fixup_stragglers(
        lattice, C, dollar_row, kmer_table, codes, amb, lens,
        sp0, ep0, sp, ep, strag, d,
    )


@partial(jax.jit, static_argnames=("L", "d", "step", "stop_width",
                                   "with_stats", "cap_scale"))
def search_early_stop_uniform(
    lattice: jnp.ndarray,
    latk: jnp.ndarray,
    latk_inv: jnp.ndarray,
    C: jnp.ndarray,
    dollar_row: jnp.ndarray,
    kmer_table: jnp.ndarray,
    codes: jnp.ndarray,  # int32[B, L]
    amb: jnp.ndarray,  # int32[B, L]
    L: int,
    d: int,
    step: int,
    stop_width: int,
    with_stats: bool = False,
    cap_scale: int = 1,
) -> tuple[jnp.ndarray, ...]:
    """Backward search that stops each lane once ep - sp <= stop_width.

    Returns (sp, ep, remaining, overflow): the interval matches the
    pattern SUFFIX P[remaining:]; a candidate's read start is
    locate(row) - remaining and MUST be verified against the text
    (candidates of a partial suffix are a superset of the true hits).
    Lanes that never narrow (repeats) or straggle finish on the
    compacted 1-step two-gather path with remaining == 0 (their
    intervals are exact). overflow flags the lanes beyond that path's
    capacity PER LANE (int32[B]; forced empty, never silent — the
    self-healing re-dispatch raises cap_scale and marks survivors).

    with_stats=True (a separate compilation; never the production
    path) appends (trips, n_unfinished): the executed multi-step trip
    count and the lane count sent to the compacted finisher — the two
    data-dependent quantities the bench roofline model needs
    (docs/DESIGN.md "early-stop speed of light").
    """
    assert d >= 1 and L >= d and step in (3, 4), (L, d, step)
    A = 4**step
    R = OCCK_BLOCK[step]
    B = codes.shape[0]
    sp0, ep0 = _kmer_start(kmer_table, codes, amb, L, d)

    # s-mer groups are anchored at the RIGHT end of the chain so the
    # fast path never runs phase singles (a masked full-batch step
    # still fetches a row per lane); the p leftover positions at the
    # pattern's left end belong to the compacted finisher below, which
    # re-runs its few lanes' whole chain anyway.
    chain = L - d
    p = chain % step
    T = chain // step
    rem = jnp.full(B, chain, jnp.int32)
    strag = jnp.zeros(B, dtype=bool)
    stopped = (ep0 - sp0) <= stop_width
    sp, ep = sp0, ep0

    # compacted-finisher capacity (cap_scale = healing escalation)
    cap = min(B, max(256, B // 64) * cap_scale)
    if T > 0:
        t_all, a_all = _smer_codes(codes[:, p:], amb[:, p:], B, T, step)

        def cond(state):
            sp, ep, rem, stopped, strag, t = state
            # stragglers are excluded from `active` and can never stop,
            # so counting them in the pool would force all T steps of
            # useless work once only stragglers remain (ADVICE r1)
            n_pool = jnp.sum((~stopped & ~strag).astype(jnp.int32))
            return (t < T) & (n_pool > cap)

        def body(state):
            sp, ep, rem, stopped, strag, t = state
            g = T - 1 - t
            tS = jax.lax.dynamic_slice_in_dim(t_all, g, 1, axis=1)[:, 0]
            aS = jax.lax.dynamic_slice_in_dim(a_all, g, 1, axis=1)[:, 0]
            active = ~stopped & ~strag
            # inactive lanes gather record 0 (cache-hot) — see the
            # packed variant below for the rationale
            rec = jnp.take(latk, jnp.where(active, sp // R, 0), axis=0)
            sp_n, ep_n, sK = occk_pair_from_record(
                rec, tS, sp, ep, latk_inv, A, R
            )
            sp_n = jnp.where(aS, 0, sp_n)
            ep_n = jnp.where(aS, 0, ep_n)
            sp = jnp.where(active, sp_n, sp)
            ep = jnp.where(active, ep_n, ep)
            rem = jnp.where(active, rem - step, rem)
            strag = strag | (active & sK)
            # a lane that straggled THIS step has a garbage ep: only
            # strag-free lanes may stop on the width test
            stopped = stopped | (active & ~sK & ((ep - sp) <= stop_width))
            return sp, ep, rem, stopped, strag, t + 1

        sp, ep, rem, stopped, strag, trips = jax.lax.while_loop(
            cond, body, (sp, ep, rem, stopped, strag, jnp.int32(0))
        )
    else:
        trips = jnp.int32(0)

    # finish still-wide, leftover-phase and straggler lanes with the
    # full 1-step chain (compacted); their intervals become exact, so
    # remaining = 0
    unfinished = (~stopped & (rem > 0)) | strag
    lens = jnp.full(B, L, jnp.int32)
    sp, ep, overflow = _fixup_stragglers(
        lattice, C, dollar_row, kmer_table, codes, amb, lens,
        sp0, ep0, sp, ep, unfinished, d, cap=cap,
    )
    rem = jnp.where(unfinished, 0, rem)
    if with_stats:
        n_unf = jnp.sum(unfinished.astype(jnp.int32))
        return sp, ep, rem, overflow, trips, n_unf
    return sp, ep, rem, overflow


@partial(jax.jit, static_argnames=("off", "L", "d", "step", "stop_width",
                                   "min_trips", "with_stats", "cap_scale",
                                   "wide_steps"))
def search_early_stop_packed(
    lattice: jnp.ndarray,
    latk: jnp.ndarray,
    latk_inv: jnp.ndarray,
    C: jnp.ndarray,
    dollar_row: jnp.ndarray,
    kmer_table: jnp.ndarray,
    words: jnp.ndarray,  # int32[B, W] 2-bit packed reads (both strands)
    amb_bits: jnp.ndarray,  # int32[B, W] packed ambiguity
    off: int,  # pattern = bases [off, off+L) of each packed row
    L: int,
    d: int,
    step: int,
    stop_width: int,
    min_trips: int = 0,
    with_stats: bool = False,
    cap_scale: int = 1,
    wide_steps: int = 0,
) -> tuple[jnp.ndarray, ...]:
    """search_early_stop_uniform on 2-bit PACKED rows (the production
    prep path): the k-mer start key, the per-trip s-mer codes and the
    compacted finisher's codes are extracted straight from the packed
    words (kernels/prep.py SWAR ops), so no (B, L) code plane is ever
    materialized (docs/DESIGN.md "packed prep"). Bit-identical to the uniform
    variant on unpacked codes (tests/test_kernels_jnp.py).

    `off`/`L` select a static subfield of each row, which is how the
    pigeonhole seed searches run without right-aligned seed arrays.
    Same return contract as search_early_stop_uniform.

    min_trips > 0 delays the width-based stop until a lane has taken
    that many multi-steps (empty lanes still stop immediately): each
    extra step divides the FALSE-candidate rate by 4^step while true
    hits always survive (intervals only narrow and a true hit matches
    every suffix), so a longer verified suffix trades ~B cheap probe
    gathers per trip for a several-fold smaller locate/verify
    compaction cap (docs/DESIGN.md "candidate thinning"). Stopping
    later is always sound — the verify decides the superset either
    way.

    wide_steps > 0 (round 4, human scale): the multi-step record only
    serves both bounds within its 256-row window, so an interval wider
    than that flags the lane a straggler. At genome scales where the
    start-table intervals are hundreds wide (E[width] = n/4^d — ~600
    at 2.5 Gbp with d=11), EVERY lane would straggle into the tiny
    compacted finisher (measured: 7/8 of a 131 K-lane batch lost to
    fixup capacity — DESIGN.md). The wide phase runs `wide_steps`
    always-correct TWO-gather 1-step narrowings (any width) on the
    chain's right end first, dividing widths 4x per step, then hands
    the narrowed intervals to the multi-step loop. Callers size it so
    E[width] after the phase is <= ~8 (engine._wide_steps); 0 at
    bacterial scale — the flagship path is unchanged.
    """
    from bwtpu.kernels import prep

    assert d >= 1 and L >= d and step in (3, 4), (L, d, step)
    assert 0 <= wide_steps <= L - d, (wide_steps, L, d)
    A = 4**step
    R = OCCK_BLOCK[step]
    B = words.shape[0]

    key, amb_tail = prep.kmer_key_packed(words, amb_bits, off, L, d)
    start = jnp.take(kmer_table, key, axis=0)
    sp0 = jnp.where(amb_tail, 0, start[:, 0])
    ep0 = jnp.where(amb_tail, 0, start[:, 1])

    chain = L - d
    rem = jnp.full(B, chain, jnp.int32)
    strag = jnp.zeros(B, dtype=bool)
    width0 = ep0 - sp0
    may_stop0 = (width0 <= 0) if min_trips > 0 else (width0 <= stop_width)
    stopped = may_stop0
    sp, ep = sp0, ep0

    for ws in range(wide_steps):
        posn = off + chain - 1 - ws
        c = prep.extract_bits(words, posn, 2).astype(jnp.int32)
        a = prep.extract_bits(amb_bits, posn, 2) != 0
        act = ~stopped
        spm = jnp.where(act, sp, 0)
        epm = jnp.where(act, ep, 0)
        o = common.occ(
            lattice, dollar_row,
            jnp.concatenate([c, c]), jnp.concatenate([spm, epm]),
        )
        cbase = common.select_scalar_table(C, c + 1, 8)
        spn = jnp.where(a, 0, cbase + o[:B])
        epn = jnp.where(a, 0, cbase + o[B:])
        sp = jnp.where(act, spn, sp)
        ep = jnp.where(act, epn, ep)
        rem = jnp.where(act, rem - 1, rem)
        stopped = stopped | (act & ((ep - sp) <= 0))

    chain = chain - wide_steps
    p = chain % step
    T = chain // step

    # compacted-finisher capacity (cap_scale = healing escalation)
    cap = min(B, max(256, B // 64) * cap_scale)
    if T > 0:
        t_all, a_all = prep.smer_codes_packed(words, amb_bits, off + p,
                                              T, step)

        def cond(state):
            sp, ep, rem, stopped, strag, t = state
            n_pool = jnp.sum((~stopped & ~strag).astype(jnp.int32))
            return (t < T) & ((n_pool > cap) | (t < min_trips))

        def body(state):
            sp, ep, rem, stopped, strag, t = state
            g = T - 1 - t
            tS = jax.lax.dynamic_slice_in_dim(t_all, g, 1, axis=1)[:, 0]
            aS = jax.lax.dynamic_slice_in_dim(a_all, g, 1, axis=1)[:, 0]
            active = ~stopped & ~strag
            # inactive lanes gather record 0 (cache-hot) instead of
            # their stale random row — the loop runs while the live
            # pool exceeds the finisher cap, so at large scales most
            # lanes are stopped for most trips and their dead gathers
            # were paying the full cache-hostile rate (DESIGN.md
            # "gather cost vs table size"; round-5 locate rebuild)
            rec = jnp.take(latk, jnp.where(active, sp // R, 0), axis=0)
            sp_n, ep_n, sK = occk_pair_from_record(
                rec, tS, sp, ep, latk_inv, A, R
            )
            sp_n = jnp.where(aS, 0, sp_n)
            ep_n = jnp.where(aS, 0, ep_n)
            sp = jnp.where(active, sp_n, sp)
            ep = jnp.where(active, ep_n, ep)
            rem = jnp.where(active, rem - step, rem)
            strag = strag | (active & sK)
            width = ep - sp
            may_stop = (width <= stop_width) & (
                (t + 1 >= min_trips) | (width <= 0)
            )
            stopped = stopped | (active & ~sK & may_stop)
            return sp, ep, rem, stopped, strag, t + 1

        sp, ep, rem, stopped, strag, trips = jax.lax.while_loop(
            cond, body, (sp, ep, rem, stopped, strag, jnp.int32(0))
        )
    else:
        trips = jnp.int32(0)

    unfinished = (~stopped & (rem > 0)) | strag
    with jax.named_scope("finisher"):
        sp, ep, overflow = _fixup_stragglers_packed(
            lattice, C, dollar_row, words, amb_bits, off, L,
            sp0, ep0, sp, ep, unfinished, d, cap=cap,
        )
    rem = jnp.where(unfinished, 0, rem)
    if with_stats:
        n_unf = jnp.sum(unfinished.astype(jnp.int32))
        return sp, ep, rem, overflow, trips, n_unf
    return sp, ep, rem, overflow
