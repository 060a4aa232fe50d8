"""Exact backward search (component C8, SURVEY.md §3.2).

Per-base FM-index interval narrowing, batched over thousands of reads:
state (sp, ep) per read; per step two rank queries (one 64 B record
gather each). An empty interval is absorbing (sp' == ep' whenever
sp == ep), so no explicit dead mask is needed; ambiguous read bases
(N) force the interval empty, per the pinned convention.

v1 STATUS: test oracle. The live exact path is search2 (right-aligned)
/ searchk (multi-step early-stop). This module survives as the
simplest bit-exact reference the others are tested against.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bwtpu.kernels import common


@jax.jit
def backward_search(
    lattice: jnp.ndarray,  # int32[n_blocks+1, 16]
    C: jnp.ndarray,  # int32[8]
    dollar_row: jnp.ndarray,  # int32 scalar
    n: jnp.ndarray,  # int32 scalar: number of BWT rows
    codes: jnp.ndarray,  # int32[B, L] left-aligned base codes
    amb: jnp.ndarray,  # int32[B, L] 1 where base is ambiguous
    lens: jnp.ndarray,  # int32[B] valid read lengths
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Returns per-read half-open (sp, ep), each int32[B]."""
    B, L = codes.shape
    sp0 = jnp.zeros(B, dtype=jnp.int32)
    ep0 = jnp.full(B, 1, dtype=jnp.int32) * n.astype(jnp.int32)

    def step(t, state):
        sp, ep = state
        # walk right-to-left over the read
        pos = L - 1 - t
        c = codes[:, pos]
        a = amb[:, pos]
        active = pos < lens
        both = jnp.concatenate([sp, ep])
        cc = jnp.concatenate([c, c])
        o = common.occ(lattice, dollar_row, cc, both)
        cbase = common.select_scalar_table(C, c + 1, 8)
        sp_new = cbase + o[:B]
        ep_new = cbase + o[B:]
        sp_new = jnp.where(a == 1, 0, sp_new)
        ep_new = jnp.where(a == 1, 0, ep_new)
        sp = jnp.where(active, sp_new, sp)
        ep = jnp.where(active, ep_new, ep)
        return sp, ep

    sp, ep = jax.lax.fori_loop(0, L, step, (sp0, ep0))
    return sp, ep


def interval_rows(
    sp: jnp.ndarray, ep: jnp.ndarray, max_hits: int
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Expand [sp, ep) into row lists with fixed capacity.

    Returns (rows int32[B, max_hits], valid bool[B, max_hits],
    overflow int32[B] — number of rows beyond capacity, 0 if none).
    No silent caps (SURVEY.md §7.4): callers must surface overflow.
    """
    width = ep - sp
    k = np.arange(max_hits, dtype=np.int32)[None, :]
    rows = sp[:, None] + k
    valid = k < width[:, None]
    overflow = jnp.maximum(width - max_hits, 0)
    return jnp.where(valid, rows, 0), valid, overflow
