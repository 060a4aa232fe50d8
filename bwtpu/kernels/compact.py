"""Fixed-capacity stream compaction (device-side, static shapes).

Dense lanes cost gather rows whether or not they are valid (cost is per
row — docs/DESIGN.md), so sparse row sets (locate inputs, verify
candidates) are compacted to a small fixed capacity first: one cumsum +
one scatter, then the expensive stage runs on `capacity` lanes instead
of the padded worst case. Overflow is counted, never silent
(SURVEY.md §7.4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def compact(valid: jnp.ndarray, capacity: int):
    """Compact the True lanes of a 1-D mask to the front.

    Returns (sel int32[capacity], count int32, overflow int32) where
    sel[i] = source lane of the i-th valid element (undefined >= count;
    always in range — safe to gather with). overflow = number of valid
    lanes beyond capacity.
    """
    v = valid.astype(jnp.int32)
    pos = jnp.cumsum(v) - v  # exclusive prefix sum: output slot per lane
    count = jnp.minimum(pos[-1] + v[-1], capacity)
    overflow = jnp.maximum(pos[-1] + v[-1] - capacity, 0)
    within = valid & (pos < capacity)
    slot = jnp.where(within, pos, capacity)  # spill slot for drops
    lane_ids = jnp.arange(valid.shape[0], dtype=jnp.int32)
    sel = jnp.zeros(capacity + 1, dtype=jnp.int32).at[slot].set(
        lane_ids, mode="drop"
    )[:capacity]
    return sel, count.astype(jnp.int32), overflow.astype(jnp.int32)


def compact_counts(counts: jnp.ndarray, H: int, capacity: int):
    """Structured compaction: lane l owns slots [l*H, l*H + counts[l]).

    Equivalent to ``compact(valid.reshape(-1), capacity)`` when ``valid``
    is the prefix mask ``k < counts[l]`` over int32[Nlanes, H] (the shape
    interval_rows emits) — but skips the 2M-lane cumsum+scatter: the
    cumsum runs over Nlanes counts and the scatter writes only Nlanes
    values (docs/DESIGN.md "structured compaction").

    Slot recovery scatters ``base_l = l*H - cum_l`` at each live lane's
    first slot: sel[i] = cummax(base)[i] + i directly. base is
    nondecreasing in l (base_{l+1} - base_l = H - c_l >= 0), so one
    scatter-max + one cummax replace the earlier owner-id scatter PLUS
    the per-slot ``cum[owner]`` element gather — element gathers cost a
    full row fetch each (docs/DESIGN.md "Gather model", "Stage
    attribution"). Bit-identical sel/count/overflow.

    Returns (sel, count, overflow, dropped) — dropped bool[Nlanes]
    flags lanes whose slots did not all fit the capacity, the per-lane
    information the self-healing re-dispatch and the per-read truncation
    marking need (SURVEY.md §7.4 "no silent caps", strengthened by
    VERDICT r3 item 3 to "no lost hits"). Pure elementwise on already-
    computed cum/c, so it costs nothing on the common path.
    """
    c = jnp.clip(counts.astype(jnp.int32), 0, H)
    cum = jnp.cumsum(c) - c  # exclusive prefix: first output slot per lane
    total = cum[-1] + c[-1]
    count = jnp.minimum(total, capacity)
    overflow = jnp.maximum(total - capacity, 0)
    dropped = (c > 0) & (cum + c > capacity)
    lane_ids = jnp.arange(c.shape[0], dtype=jnp.int32)
    start = jnp.where(c > 0, cum, capacity)  # empty lanes never own a slot
    base = jnp.zeros(capacity, dtype=jnp.int32).at[start].max(
        lane_ids * H - cum, mode="drop"
    )
    base = jax.lax.cummax(base)
    i = jnp.arange(capacity, dtype=jnp.int32)
    sel = jnp.where(i < count, base + i, 0)
    return sel, count.astype(jnp.int32), overflow.astype(jnp.int32), dropped


def scatter_back(
    values: jnp.ndarray, sel: jnp.ndarray, count: jnp.ndarray, total: int,
    fill,
):
    """Inverse of compact: place values[i] at lane sel[i] for i < count."""
    out = jnp.full((total,) + values.shape[1:], fill, dtype=values.dtype)
    k = jnp.arange(sel.shape[0], dtype=jnp.int32)
    slot = jnp.where(k < count, sel, total)  # drop beyond count
    return out.at[slot].set(values, mode="drop")
