"""Exact backward search v2: right-aligned reads + k-mer start table.

Row-budget optimizations (docs/DESIGN.md): the search cost is the
number of gathered lattice rows, so
- reads are RIGHT-ALIGNED on the host (read occupies [L-len, L)), which
  makes "the last d bases" a uniform static slice for every lane, and
  makes the per-step read position uniform across lanes (no per-lane
  element gathers from the read array);
- the first d chained steps are replaced by ONE lookup in the k-mer
  start table: kmer_table[c] = the SA interval [sp, ep) of the d-mer c
  (built exactly from the suffix array at index-build time,
  bwtpu/index.py). Lanes whose read/seed is shorter than d get d=
  effective handling on the host (the caller passes d <= min len).

Ambiguous bases anywhere in the pattern still force an empty interval.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from bwtpu.kernels import common


@partial(jax.jit, static_argnames=("d", "cap_scale"))
def backward_search_ra(
    lattice: jnp.ndarray,  # int32[n_blocks+1, 16]
    C: jnp.ndarray,  # int32[8]
    dollar_row: jnp.ndarray,  # int32
    n: jnp.ndarray,  # int32
    kmer_table: jnp.ndarray,  # int32[4^d, 2] (ignored when d == 0)
    ra_codes: jnp.ndarray,  # int32[B, L] RIGHT-aligned base codes
    ra_amb: jnp.ndarray,  # int32[B, L]
    lens: jnp.ndarray,  # int32[B]; caller guarantees lens >= d or len==0
    d: int,
    cap_scale: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (sp, ep, fixup_overflow): per-read half-open interval
    plus a PER-LANE int32[B] flag of straggler lanes beyond fixup
    capacity (those lanes are forced empty rather than returning
    garbage; the flags are propagated so callers can surface, heal and
    mark them — no silent caps). cap_scale multiplies the fixup
    capacity (self-healing escalation, engine._caps)."""
    B, L = ra_codes.shape
    if d > 0:
        # key of the last d bases (static slice thanks to right alignment)
        tail = ra_codes[:, L - d :]
        weights = (4 ** np.arange(d - 1, -1, -1, dtype=np.int64)).astype(np.int32)
        key = jnp.sum(tail * weights[None, :], axis=1)
        start = jnp.take(kmer_table, key, axis=0)  # (B, 2) one row gather
        sp0, ep0 = start[:, 0], start[:, 1]
        # ambiguous base inside the key -> no match
        amb_tail = jnp.sum(ra_amb[:, L - d :], axis=1) > 0
        sp0 = jnp.where(amb_tail, 0, sp0)
        ep0 = jnp.where(amb_tail, 0, ep0)
        # empty lanes (len == 0) keep an empty interval
        sp0 = jnp.where(lens == 0, 0, sp0)
        ep0 = jnp.where(lens == 0, 0, ep0)
    else:
        sp0 = jnp.zeros(B, dtype=jnp.int32)
        ep0 = jnp.where(lens == 0, 0, jnp.full(B, 1, jnp.int32) * n.astype(jnp.int32))

    # Mainline: ONE record gather per step serves both bounds (the
    # record carries block j and j+1 data); lanes whose interval is
    # still wider than 128 at some step are flagged stragglers and
    # fixed up afterwards with the two-gather path on a compacted
    # mini-batch (docs/DESIGN.md).
    def step(t, state):
        sp, ep, strag = state
        pos = L - 1 - d - t  # uniform position; lane active while in-read
        c = ra_codes[:, pos]
        a = ra_amb[:, pos]
        active = pos >= (L - lens)
        rec = jnp.take(lattice, sp >> 7, axis=0)
        o_sp, o_ep, s2 = common.occ_pair_from_record(rec, dollar_row, c, sp, ep)
        cbase = common.select_scalar_table(C, c + 1, 8)
        sp_new = jnp.where(a == 1, 0, cbase + o_sp)
        ep_new = jnp.where(a == 1, 0, cbase + o_ep)
        sp = jnp.where(active, sp_new, sp)
        ep = jnp.where(active, ep_new, ep)
        return sp, ep, strag | (active & s2)

    strag0 = jnp.zeros(B, dtype=bool)
    sp, ep, strag = jax.lax.fori_loop(0, L - d, step, (sp0, ep0, strag0))
    return _fixup_stragglers(
        lattice, C, dollar_row, kmer_table, ra_codes, ra_amb, lens,
        sp0, ep0, sp, ep, strag, d,
        cap=min(B, max(256, B // 8) * cap_scale),
    )


def _two_gather_search(lattice, C, dollar_row, ra_codes, ra_amb, lens,
                       sp0, ep0, d):
    """Reference two-gather loop (always correct, any interval width)."""
    B, L = ra_codes.shape

    def step(t, state):
        sp, ep = state
        pos = L - 1 - d - t
        c = ra_codes[:, pos]
        a = ra_amb[:, pos]
        active = pos >= (L - lens)
        o = common.occ(
            lattice, dollar_row, jnp.concatenate([c, c]), jnp.concatenate([sp, ep])
        )
        cbase = common.select_scalar_table(C, c + 1, 8)
        sp_new = jnp.where(a == 1, 0, cbase + o[:B])
        ep_new = jnp.where(a == 1, 0, cbase + o[B:])
        return (
            jnp.where(active, sp_new, sp),
            jnp.where(active, ep_new, ep),
        )

    return jax.lax.fori_loop(0, L - d, step, (sp0, ep0))


def _fixup_stragglers(lattice, C, dollar_row, kmer_table, ra_codes, ra_amb,
                      lens, sp0, ep0, sp, ep, strag, d, cap=None):
    """Re-run flagged lanes with the two-gather path (compacted).

    Returns (sp, ep, over_lane int32[B]) — over_lane flags the lanes
    beyond fixup capacity (forced empty; per-lane so the self-healing
    re-dispatch and truncation marking know which reads are affected)."""
    from bwtpu.kernels.compact import compact

    B, L = ra_codes.shape
    cap = cap if cap is not None else max(256, B // 8)
    sel, count, overflow = compact(strag, cap)
    n_strag = jnp.sum(strag.astype(jnp.int32))

    def fixup(args):
        sp, ep = args
        mini_ra = jnp.take(ra_codes, sel, axis=0)
        mini_amb = jnp.take(ra_amb, sel, axis=0)
        in_sel = jnp.arange(cap, dtype=jnp.int32) < count
        mini_lens = jnp.where(in_sel, jnp.take(lens, sel), 0)
        msp0 = jnp.take(sp0, sel)
        mep0 = jnp.where(in_sel, jnp.take(ep0, sel), 0)
        msp, mep = _two_gather_search(
            lattice, C, dollar_row, mini_ra, mini_amb, mini_lens, msp0, mep0, d
        )
        slot = jnp.where(in_sel, sel, B)  # drop beyond count
        sp = sp.at[slot].set(msp, mode="drop")
        ep = ep.at[slot].set(mep, mode="drop")
        return sp, ep

    sp, ep = jax.lax.cond(n_strag > 0, fixup, lambda a: a, (sp, ep))
    # Lanes the fixup could not cover (capacity overflow) would be
    # wrong: force them empty rather than return garbage and surface
    # them per lane. (overflow > 0 is pathological: > cap lanes all
    # sitting on > 128-wide repeat intervals.)
    over_lane = strag & (jnp.cumsum(strag.astype(jnp.int32)) > cap)
    sp = jnp.where(over_lane, 0, sp)
    ep = jnp.where(over_lane, 0, ep)
    return sp, ep, over_lane.astype(jnp.int32)


def _fixup_stragglers_packed(lattice, C, dollar_row, words, amb_bits,
                             off, slen, sp0, ep0, sp, ep, strag, d,
                             cap=None):
    """_fixup_stragglers for 2-bit packed inputs: gather the flagged
    lanes' packed rows, unpack ONLY those (cap lanes, not the batch —
    kernels/prep.py rationale), then run the two-gather chain on the
    slice [off, off+slen). Same (sp, ep, over_lane) contract."""
    from bwtpu.kernels.compact import compact
    from bwtpu.kernels.prep import unpack_slice

    B = words.shape[0]
    cap = cap if cap is not None else max(256, B // 8)
    sel, count, overflow = compact(strag, cap)
    n_strag = jnp.sum(strag.astype(jnp.int32))

    def fixup(args):
        sp, ep = args
        mini_w = jnp.take(words, sel, axis=0)
        mini_a = jnp.take(amb_bits, sel, axis=0)
        mini_ra = unpack_slice(mini_w, off, slen)
        mini_amb = unpack_slice(mini_a, off, slen)  # fields are 0/1
        in_sel = jnp.arange(cap, dtype=jnp.int32) < count
        mini_lens = jnp.where(in_sel, slen, 0)
        msp0 = jnp.take(sp0, sel)
        mep0 = jnp.where(in_sel, jnp.take(ep0, sel), 0)
        msp, mep = _two_gather_search(
            lattice, C, dollar_row, mini_ra, mini_amb, mini_lens,
            msp0, mep0, d
        )
        slot = jnp.where(in_sel, sel, B)  # drop beyond count
        sp = sp.at[slot].set(msp, mode="drop")
        ep = ep.at[slot].set(mep, mode="drop")
        return sp, ep

    sp, ep = jax.lax.cond(n_strag > 0, fixup, lambda a: a, (sp, ep))
    over_lane = strag & (jnp.cumsum(strag.astype(jnp.int32)) > cap)
    sp = jnp.where(over_lane, 0, sp)
    ep = jnp.where(over_lane, 0, ep)
    return sp, ep, over_lane.astype(jnp.int32)


def right_align(codes: np.ndarray, amb: np.ndarray, lens: np.ndarray):
    """Host-side: shift each row right so it ends at column L-1 (NumPy)."""
    B, L = codes.shape
    idx = np.arange(L)[None, :] - (L - lens)[:, None]
    safe = np.clip(idx, 0, L - 1)
    ra_c = np.take_along_axis(codes, safe, axis=1)
    ra_a = np.take_along_axis(amb, safe, axis=1)
    pad = idx < 0
    ra_c[pad] = 0
    ra_a[pad] = 0
    return ra_c, ra_a
