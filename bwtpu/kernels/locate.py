"""Batched LF-walk locate (components C9/C10, SURVEY.md §3.3).

For each SA row, walk r <- LF(r) = C[BWT[r]] + Occ(BWT[r], r) until the
row is SA-sampled, then pos = ssa[mark_rank(r)] + steps. Text sampling
bounds every walk at sa_rate-1 steps, so the batched loop runs a fixed
sa_rate trips with masked termination (SURVEY.md §7.6 item 4).

The '$' row needs no special-casing: it has SA value 0, which is always
sampled (0 % s == 0), so the walk terminates there before ever taking
LF of '$'.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from bwtpu.kernels import common


@partial(jax.jit, static_argnames=("sa_rate",))
def locate_rows(
    lattice: jnp.ndarray,  # int32[n_blocks+1, 32]
    ssa: jnp.ndarray,  # int32[n_sampled]
    C: jnp.ndarray,  # int32[8]
    dollar_row: jnp.ndarray,  # int32 scalar
    rows: jnp.ndarray,  # int32[B] SA rows (flattened batch)
    valid: jnp.ndarray,  # bool[B]
    sa_rate: int,
) -> jnp.ndarray:
    """Returns positions int32[B]; -1 where not valid."""
    B = rows.shape[0]
    if sa_rate == 1:
        # every row is sampled: mark_rank(r) == r and ssa IS the suffix
        # array, so locate is one element gather, no LF walk at all
        # (4 B/base of HBM — the right trade below human-chromosome
        # scale, docs/DESIGN.md).
        return jnp.where(valid, jnp.take(ssa, rows), -1)
    r0 = jnp.where(valid, rows, 0)
    done0 = ~valid
    rank0 = jnp.zeros(B, dtype=jnp.int32)
    steps0 = jnp.zeros(B, dtype=jnp.int32)

    def step(t, state):
        r, done, rank_out, steps_out = state
        j = r >> common.LOG2_BLOCK
        m = r & (common.BLOCK - 1)
        # done lanes gather block 0: their values are dead (rank/steps
        # already latched) but the masked fixed-trip loop still issues
        # their gathers, and a RANDOM dead row costs the full
        # cache-hostile rate (gathers slow down as tables leave cache,
        # DESIGN.md) while a constant hot row is cache-resident. Expected live
        # fraction at trip t is (1 - t/s), so this halves the walk's
        # random-row traffic — the "per-trip compaction" win without a
        # per-trip compaction (round 5, human-scale locate rebuild).
        j = jnp.where(done, 0, j)
        rec = jnp.take(lattice, j, axis=0)  # (B, 16)
        bit, inrank = common.mark_bit_and_rank(rec, m)
        found = (bit == 1) & ~done
        rank = rec[:, common.MARK_RANK_WORD] + inrank
        rank_out = jnp.where(found, rank, rank_out)
        steps_out = jnp.where(found, t, steps_out)
        done = done | found
        # LF step for unfinished rows ('$' never reached: its SA value 0
        # is sampled, so it is caught by the mark check above).
        c = common.bwt_code_at(rec, m)
        ck = common.select_lane(rec[:, 0:4], c, 4)
        inblk = common.block_rank(rec[:, common.BWT_WORD0 : common.BWT_WORD0 + 8], c, m)
        corr = (
            (c == 0) & ((dollar_row >> common.LOG2_BLOCK) == j) & (dollar_row < r)
        ).astype(jnp.int32)
        lf = common.select_scalar_table(C, c + 1, 8) + ck + inblk - corr
        r = jnp.where(done, r, lf)
        return r, done, rank_out, steps_out

    r, done, rank_out, steps_out = jax.lax.fori_loop(
        0, sa_rate, step, (r0, done0, rank0, steps0)
    )
    pos = jnp.take(ssa, rank_out) + steps_out
    return jnp.where(valid, pos, -1)
