"""Shared device-side helpers over the int32 lattice layout.

The layout contract lives in bwtpu/index.py; these helpers are the only
place device code decodes it, so the search, locate and verify stages
can't drift from each other.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

BLOCK = 128
LOG2_BLOCK = 7
REC_WORDS = 32
BWT_WORD0 = 4
MARK_WORD0 = 12
MARK_RANK_WORD = 16
NEXT_CK0 = 17
NEXT_BWT0 = 21


def select_lane(arr: jnp.ndarray, idx: jnp.ndarray, width: int) -> jnp.ndarray:
    """arr[..., idx] as a one-hot masked sum over a STATIC width.

    Equivalent to take_along_axis(arr, idx[..., None], -1)[..., 0] but
    guaranteed to stay elementwise (select + reduce) and fuse into
    the record-gather consumer. A dynamic take_along_axis on a gathered
    (B, W) record can lower to a second HBM element gather, which costs
    like a full row gather PER ELEMENT (docs/DESIGN.md) — one-hot keeps
    the per-step gather count at exactly one.
    """
    iota = np.arange(width, dtype=np.int32)
    return jnp.sum(jnp.where(idx[..., None] == iota, arr[..., :width], 0), axis=-1)


def select_scalar_table(table: jnp.ndarray, idx: jnp.ndarray, width: int) -> jnp.ndarray:
    """table[idx] for a tiny replicated table, as a one-hot masked sum
    (avoids a B-element HBM gather for an 8-entry table like C)."""
    iota = np.arange(width, dtype=np.int32)
    shape = (1,) * idx.ndim + (width,)
    t = table[:width].reshape(shape)
    return jnp.sum(jnp.where(idx[..., None] == iota, t, 0), axis=-1)


def popcount32(x: jnp.ndarray) -> jnp.ndarray:
    """SWAR popcount of int32/uint32 words -> int32 counts."""
    x = x.astype(jnp.uint32)
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((x * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


def unpack_block_codes(bwt_words: jnp.ndarray) -> jnp.ndarray:
    """(..., 8) packed int32 words -> (..., 128) 2-bit base codes.

    Arithmetic right shift is safe: `& 3` keeps only the two original
    bits for every shift amount (0..30).
    """
    rep = jnp.repeat(bwt_words, 16, axis=-1)  # (..., 128)
    shifts = (2 * (np.arange(BLOCK) % 16)).astype(np.int32)
    return (rep >> shifts) & 3


def block_rank(
    bwt_words: jnp.ndarray, c: jnp.ndarray, m: jnp.ndarray
) -> jnp.ndarray:
    """Count of base `c` among the first `m` bases of each 128-base block.

    bwt_words: (..., 8) int32; c, m: (...,) int32. Returns (...,) int32.

    SWAR formulation (8 words of elementwise work per query instead of a
    128-lane unpack): XOR the word against the base pattern replicated
    16x, collapse each 2-bit group to one even-position bit, mask to the
    m-base prefix, popcount.
    """
    w = bwt_words.astype(jnp.uint32)  # (..., 8)
    pattern = (c.astype(jnp.uint32) * jnp.uint32(0x55555555))[..., None]
    y = w ^ pattern
    match = ~(y | (y >> 1)) & jnp.uint32(0x55555555)  # even bit per matching base
    # prefix mask: word k holds bases [16k, 16k+16); keep 2*clip(m-16k,0,16) bits
    k16 = (np.arange(8, dtype=np.int32) * 16)[None, :]
    nb = jnp.clip(m[..., None] - k16, 0, 16).astype(jnp.uint32)
    mask = jnp.where(
        nb >= 16,
        jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << (2 * nb)) - 1,
    )
    return jnp.sum(popcount32(match & mask), axis=-1).astype(jnp.int32)


def occ_from_records(
    rec: jnp.ndarray,
    dollar_row: jnp.ndarray,
    c: jnp.ndarray,
    i: jnp.ndarray,
) -> jnp.ndarray:
    """Occ(c, i) given the already-gathered record of block i>>7."""
    j = i >> LOG2_BLOCK
    m = i & (BLOCK - 1)
    ck = select_lane(rec[:, 0:4], c, 4)
    inblk = block_rank(rec[:, BWT_WORD0 : BWT_WORD0 + 8], c, m)
    corr = ((c == 0) & ((dollar_row >> LOG2_BLOCK) == j) & (dollar_row < i)).astype(
        jnp.int32
    )
    return ck + inblk - corr


def occ(
    lattice: jnp.ndarray,
    dollar_row: jnp.ndarray,
    c: jnp.ndarray,
    i: jnp.ndarray,
) -> jnp.ndarray:
    """Batched Occ(c, i) = count of base c in BWT[0:i).

    lattice: (n_blocks+1, 16) int32; c, i: (B,) int32. One gather of a
    64 B record per query + elementwise in-block rank (SURVEY.md §3.2).
    """
    rec = jnp.take(lattice, i >> LOG2_BLOCK, axis=0)  # (B, 16)
    return occ_from_records(rec, dollar_row, c, i)


def bwt_code_at(rec: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Base code stored at block-local position m of each record (B, 16)."""
    word = select_lane(rec[:, BWT_WORD0 : BWT_WORD0 + 8], m >> 4, 8)
    return (word >> (2 * (m & 15))) & 3


def mark_bit_and_rank(rec: jnp.ndarray, m: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(is-sampled bit, in-block mark rank) at block-local position m.

    rec: (B, 16) records; m: (B,). Rank counts set mark bits strictly
    below m within the block.
    """
    words = rec[:, MARK_WORD0 : MARK_WORD0 + 4]  # (B, 4)
    bit_word = select_lane(words, m >> 5, 4)
    bit = (bit_word >> (m & 31)) & 1
    # mask of bits below m per word k: low clip(m - 32k, 0, 32) bits
    k32 = np.arange(4, dtype=np.int32) * 32
    nbits = jnp.clip(m[:, None] - k32, 0, 32)  # (B, 4)
    full = jnp.uint32(0xFFFFFFFF)
    masks = jnp.where(
        nbits >= 32, full, (jnp.uint32(1) << nbits.astype(jnp.uint32)) - 1
    )
    rank = jnp.sum(popcount32(words.astype(jnp.uint32) & masks), axis=1)
    return bit.astype(jnp.int32), rank.astype(jnp.int32)


def reverse_complement_reads(
    codes: jnp.ndarray, amb: jnp.ndarray, lens: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reverse-complement left-aligned padded reads, keeping left alignment.

    codes: (B, L) int32 base codes; amb: (B, L) int32 0/1 ambiguous
    mask; lens: (B,) valid lengths.
    """
    L = codes.shape[1]
    idx = lens[:, None] - 1 - np.arange(L, dtype=np.int32)[None, :]
    safe = jnp.clip(idx, 0, L - 1)
    rc = 3 - jnp.take_along_axis(codes, safe, axis=1)
    ra = jnp.take_along_axis(amb, safe, axis=1)
    pad = idx < 0
    return jnp.where(pad, 0, rc), jnp.where(pad, 0, ra)


def occ_pair_from_record(rec, dollar_row, c, sp, ep):
    """Occ(c, sp) and Occ(c, ep) from the SINGLE record of block sp>>7.

    Valid whenever ep >> 7 is sp's block or the next one (always true
    once ep - sp <= 128); otherwise the lane is a "straggler" and the
    returned occ_ep is garbage — the strag flag tells the caller to fix
    that lane up with the two-gather path (docs/DESIGN.md).
    Returns (occ_sp, occ_ep, strag).
    """
    j = sp >> LOG2_BLOCK
    jep = ep >> LOG2_BLOCK
    ck_j = select_lane(rec[:, 0:4], c, 4)
    bwt_j = rec[:, BWT_WORD0 : BWT_WORD0 + 8]
    occ_sp = ck_j + block_rank(bwt_j, c, sp & (BLOCK - 1))
    occ_sp -= (
        (c == 0) & ((dollar_row >> LOG2_BLOCK) == j) & (dollar_row < sp)
    ).astype(jnp.int32)

    mep = ep & (BLOCK - 1)
    in_j = jep == j
    occ_ep_j = ck_j + block_rank(bwt_j, c, mep)
    ck_n = select_lane(rec[:, NEXT_CK0 : NEXT_CK0 + 4], c, 4)
    occ_ep_n = ck_n + block_rank(rec[:, NEXT_BWT0 : NEXT_BWT0 + 8], c, mep)
    occ_ep = jnp.where(in_j, occ_ep_j, occ_ep_n)
    occ_ep -= (
        (c == 0) & ((dollar_row >> LOG2_BLOCK) == jep) & (dollar_row < ep)
    ).astype(jnp.int32)
    strag = jep > j + 1
    return occ_sp, occ_ep, strag
