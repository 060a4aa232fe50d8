"""Packed-word batch prep: SWAR bit ops instead of (B, L) code arrays.

A stage decomposition (scripts/stage_times.py, round 2) showed
device_prep_uniform — unpacking 2-bit reads into int32[B2, L] code
planes, reversing them for the reverse strand and re-packing —
taking 40% of an exact batch on elementwise layout churn. But the
search consumes only three tiny derivatives of the reads:

  1. the depth-d k-mer start key        (one int per lane)
  2. the per-trip s-mer codes           (T ~ 30 ints per lane)
  3. full codes for the few hundred compacted finisher lanes

all of which this module extracts DIRECTLY from the 2-bit packed words
(int32[B, W], base b at word b//16, bits 2*(b%16) — the layout pinned
in kernels/verify2.pack_reads) with constant-shift SWAR ops on [B, W]
arrays — no (B, L) materialization at all. The reverse complement is
likewise computed packed: complement = bitwise NOT (2-bit field XOR
0b11), reversal = a 4-step field swap per word + word reversal + a
static funnel shift. Beyond-length slots shift out / zero-fill, so
outputs match verify2.pack_reads(revcomp) bit-exactly (tested in
tests/test_kernels_jnp.py).

All shifts run on uint32 bitcasts (int32 >> is arithmetic), outputs
are int32 to match the rest of the engine.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _u32(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def _i32(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _rev_fields(x: jnp.ndarray) -> jnp.ndarray:
    """Reverse the 16 2-bit fields of each uint32 lane."""
    m2 = jnp.uint32(0x33333333)
    m4 = jnp.uint32(0x0F0F0F0F)
    m8 = jnp.uint32(0x00FF00FF)
    x = ((x >> 2) & m2) | ((x & m2) << 2)
    x = ((x >> 4) & m4) | ((x & m4) << 4)
    x = ((x >> 8) & m8) | ((x & m8) << 8)
    return (x >> 16) | (x << 16)


def _funnel_right(x: jnp.ndarray, slots: int) -> jnp.ndarray:
    """Shift a (B, W) packed stream right by `slots` 2-bit fields,
    zero-filling from beyond the last word (static shift)."""
    if slots == 0:
        return x
    sh = jnp.uint32(2 * slots)
    nxt = jnp.concatenate([x[:, 1:], jnp.zeros_like(x[:, :1])], axis=1)
    return (x >> sh) | (nxt << (jnp.uint32(32) - sh))


def revcomp_packed(words: jnp.ndarray, amb: jnp.ndarray, L: int):
    """Packed reverse complement of uniform length-L reads.

    words/amb: int32[B, W] per pack_reads. Returns (rc_words, rc_amb)
    int32[B, W]: rc_words[b] = packed revcomp (3 - code, reversed),
    rc_amb[b] = reversed ambiguity bits; slots >= L are zero.
    """
    W = words.shape[1]
    S = 16 * W - L  # dead slots at the stream's right end
    u = _u32(words)
    a = _u32(amb)
    # complement: every 2-bit field XOR 0b11 (= bitwise NOT); the
    # garbage this writes into slots >= L reverses to slots < S and is
    # shifted out below
    ru = _rev_fields(~u)[:, ::-1]
    ra = _rev_fields(a)[:, ::-1]
    return _i32(_funnel_right(ru, S)), _i32(_funnel_right(ra, S))


def extract_bits(words: jnp.ndarray, j: int, nbits: int) -> jnp.ndarray:
    """`nbits` bits starting at base slot j (bit 2j) of each packed
    row; static j, nbits <= 26 so at most one word boundary crossed.
    Returns uint32[B]."""
    assert nbits <= 26, nbits
    w, b = divmod(2 * j, 32)
    u = _u32(words)
    v = u[:, w] >> jnp.uint32(b)
    if b + nbits > 32:
        v = v | (u[:, w + 1] << jnp.uint32(32 - b))
    return v & jnp.uint32((1 << nbits) - 1)


def kmer_key_packed(words: jnp.ndarray, amb: jnp.ndarray, off: int,
                    L: int, d: int):
    """Start-table key over bases [off+L-d, off+L): leftmost base gets
    weight 4^(d-1) (the kmer_table convention in index.py). Returns
    (key int32[B], amb_tail bool[B])."""
    assert 1 <= d <= 13, d
    j0 = off + L - d
    v = extract_bits(words, j0, 2 * d)  # field t of the key at bits 2t
    # reverse to MSB-first: field t -> slot 15-t, then drop the 16-d
    # empty low slots
    key = _rev_fields(v) >> jnp.uint32(2 * (16 - d))
    amb_tail = extract_bits(amb, j0, 2 * d) != 0
    return _i32(key), amb_tail


def smer_codes_packed(words: jnp.ndarray, amb: jnp.ndarray, base: int,
                      T: int, step: int):
    """(B, T) s-mer codes + ambiguity flags for the multi-step chain.

    Group g covers bases [base+step*g, base+step*(g+1)); code is
    MSB-first (leftmost base highest weight), matching
    searchk._smer_codes. Static positions — pure shift/mask columns.
    """
    amb_u = _u32(amb)
    cols_t, cols_a = [], []
    for g in range(T):
        j = base + step * g
        v = extract_bits(words, j, 2 * step)
        code = jnp.zeros_like(v)
        av = jnp.uint32(0)
        for f in range(step):  # field f (LSB-first) has weight 4^(step-1-f)
            code = code | (((v >> jnp.uint32(2 * f)) & jnp.uint32(3))
                           << jnp.uint32(2 * (step - 1 - f)))
        av = extract_bits(amb_u, j, 2 * step)
        cols_t.append(_i32(code))
        cols_a.append(av != 0)
    t_all = jnp.stack(cols_t, axis=1)
    a_all = jnp.stack(cols_a, axis=1)
    return t_all, a_all


def unpack_slice(words: jnp.ndarray, off: int, slen: int) -> jnp.ndarray:
    """(B, W) packed -> (B, slen) int32 codes for bases
    [off, off+slen) — used only on small compacted lane sets."""
    j = off + np.arange(slen)
    w = j // 16
    sh = (2 * (j % 16)).astype(np.uint32)
    u = _u32(words)
    return _i32((u[:, w] >> sh[None, :]) & jnp.uint32(3))
