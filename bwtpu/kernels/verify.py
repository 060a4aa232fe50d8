"""Vectorized candidate verification (components C11/C12, SURVEY.md §3.4/§7.4).

The reference's bounded-substitution DFS is re-expressed device-side as
pigeonhole seed-and-extend: with k substitutions, splitting the read
into k+1 seeds guarantees at least one seed matches exactly, so
exact-searching the seeds (reusing the backward-search kernel), locating
their occurrences, and verifying each candidate window against the
2-bit packed reference text yields exactly the DFS's hit set
(output-equivalence argued in SURVEY.md §3.4; asserted against the
golden DFS in tests).

This module holds the verify stage: gather packed text windows at
candidate positions, count mismatches (ambiguous read bases always
mismatch), report nm.

v1 STATUS: `verify_candidates` is a test oracle — the live path is the
packed XOR/popcount verify in verify2.py, tested bit-exact against it.
`seed_layout` here remains the live seed-partition helper (shared by
both generations).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

NM_INVALID = 255  # nm value reported for invalid/out-of-range candidates


@jax.jit
def verify_candidates(
    text_packed: jnp.ndarray,  # int32[n_words (+pad)] 2-bit packed text
    text_len: jnp.ndarray,  # int32 scalar
    cand: jnp.ndarray,  # int32[B, Cmax] candidate start positions
    cand_valid: jnp.ndarray,  # bool[B, Cmax]
    codes: jnp.ndarray,  # int32[B, L] read codes (left-aligned)
    amb: jnp.ndarray,  # int32[B, L]
    lens: jnp.ndarray,  # int32[B]
) -> jnp.ndarray:
    """Returns nm int32[B, Cmax]; NM_INVALID where invalid/out of range."""
    B, Cmax = cand.shape
    L = codes.shape[1]
    W = (L + 30) // 16  # words covering any L-window at any 16-alignment

    in_range = cand_valid & (cand >= 0) & (cand + lens[:, None] <= text_len)
    pos = jnp.where(in_range, cand, 0)
    word0 = pos >> 4  # (B, Cmax)
    widx = word0[:, :, None] + np.arange(W, dtype=np.int32)[None, None, :]
    words = jnp.take(text_packed, widx, mode="clip")  # (B, Cmax, W)

    # text base at window offset i: bit offset q = pos%16 + i
    q = (pos & 15)[:, :, None] + np.arange(L, dtype=np.int32)[None, None, :]
    w = jnp.take_along_axis(words, q >> 4, axis=2)  # (B, Cmax, L)
    tcode = (w >> (2 * (q & 15))) & 3

    rcode = codes[:, None, :]  # (B, 1, L)
    ramb = amb[:, None, :]
    in_read = np.arange(L, dtype=np.int32)[None, None, :] < lens[:, None, None]
    mism = ((tcode != rcode) | (ramb == 1)) & in_read
    nm = jnp.sum(mism, axis=2).astype(jnp.int32)
    return jnp.where(in_range, nm, NM_INVALID)


def seed_layout(read_len: int, n_seeds: int) -> list[tuple[int, int]]:
    """Static (offset, length) split of a read into n_seeds seeds.

    Pinned: near-equal split, remainder distributed to the leftmost
    seeds (so seed s covers [s*q + min(s, r), ...) with q, r =
    divmod(read_len, n_seeds)).
    """
    q, r = divmod(read_len, n_seeds)
    out = []
    off = 0
    for s in range(n_seeds):
        length = q + (1 if s < r else 0)
        out.append((off, length))
        off += length
    return out


def dedupe_sorted(cand: jnp.ndarray, valid: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sort candidates per read and invalidate duplicates.

    cand: int32[B, C]; valid: bool[B, C]. Invalid entries are pushed to
    the end (sorted as +inf surrogate).
    """
    big = jnp.int32(2**31 - 1)
    keyed = jnp.where(valid, cand, big)
    s = jnp.sort(keyed, axis=1)
    first = jnp.concatenate(
        [jnp.ones_like(s[:, :1], dtype=bool), s[:, 1:] != s[:, :-1]], axis=1
    )
    v = (s != big) & first
    return s, v
