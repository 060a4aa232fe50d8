"""Candidate verification v2: word-aligned XOR + popcount, zero element
gathers.

The v1 verify extracted one text base per (candidate, position) via
element-wise gathers — ~1 s/batch measured on chip. v2 reformulates:

- the packed text is expanded at upload time into STRIDE-1 OVERLAP ROWS
  text_rows[w] = words[w : w+R] (int32[n_words, R]) so the whole window
  of any candidate is ONE row gather (cost is per row, width free —
  docs/DESIGN.md);
- reads are 2-bit packed on the HOST (words, ambiguous-position mask,
  length mask), so the mismatch count is
    x = (window >> bit_phase) XOR read_words
    pair = (x | x >> 1) & 0x5555...  (one bit per mismatching base)
    nm = popcount((pair | amb_bits) & len_mask)
  — pure elementwise work on (cands, R) int32.

Bit phase is the only per-candidate variable (pos % 16), handled by
per-lane variable shifts (vector ops, not gathers).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bwtpu.kernels.common import popcount32

NM_INVALID = 255
EVEN = np.uint32(0x55555555)


def window_row_width(read_len: int) -> int:
    """Words per text window so any read_len window at any phase fits."""
    return (2 * read_len + 30 + 31) // 32 + 1


# Text rows are stride-8: row i carries words [8i, 8i + 7 + R), so a
# candidate at word w gathers row w >> 3 and funnel-selects by w & 7
# (3 log-step selects — pure elementwise). Stride-1 rows (round 1-3)
# cost 9 words/row at L=100 — a shape the compiler padded AND
# relayouted: at human scale it materialized a 9.31 GB transposed COPY
# of the (10, 15.6M, 9) stacked table, the single largest allocation of
# the OOM breakdown (round 4). Stride-8 cuts the table 8x (row width
# R+7 amortizes 8 start positions) and the copy, if XLA still makes
# one, shrinks with it.
TEXT_ROW_STRIDE = 8


def build_text_rows(text_packed: np.ndarray, read_len: int) -> np.ndarray:
    """Host: stride-8 overlap rows over the packed text words."""
    R = window_row_width(read_len) + TEXT_ROW_STRIDE - 1
    w = text_packed.view(np.int32)
    n_rows = -(-len(w) // TEXT_ROW_STRIDE)
    padded = np.concatenate(
        [w, np.zeros(n_rows * TEXT_ROW_STRIDE + R - len(w), dtype=np.int32)]
    )
    return np.lib.stride_tricks.sliding_window_view(padded, R)[
        :: TEXT_ROW_STRIDE
    ][:n_rows].copy()


def pack_reads(codes: np.ndarray, amb: np.ndarray, lens: np.ndarray):
    """Host: per-read packed words + ambiguity bits + length mask.

    codes/amb: (B, L) LEFT-aligned; returns (words, amb_bits, len_mask)
    each int32[B, W] with W = ceil(L/16); one even bit per base
    (bit 2p of word p//16).
    """
    B, L = codes.shape
    W = (L + 15) // 16
    padded = np.zeros((B, W * 16), dtype=np.uint32)
    padded[:, :L] = codes.astype(np.uint32)
    shifts = (2 * (np.arange(W * 16) % 16)).astype(np.uint32)
    words = (padded << shifts[None, :]).reshape(B, W, 16)
    words = np.bitwise_or.reduce(words, axis=2)

    amb_p = np.zeros((B, W * 16), dtype=np.uint32)
    amb_p[:, :L] = amb.astype(np.uint32)
    amb_bits = (amb_p << shifts[None, :]).reshape(B, W, 16)
    amb_bits = np.bitwise_or.reduce(amb_bits, axis=2)

    in_len = (np.arange(W * 16)[None, :] < lens[:, None]).astype(np.uint32)
    len_mask = (in_len << shifts[None, :]).reshape(B, W, 16)
    len_mask = np.bitwise_or.reduce(len_mask, axis=2)
    to_i32 = lambda a: a.astype(np.uint32).view(np.int32)
    return to_i32(words), to_i32(amb_bits), to_i32(len_mask)


def locv_row_width(read_len: int) -> int:
    """Words per fused locate+verify row: SA value + a text window wide
    enough for any candidate start in [SA-read_len, SA] at any phase."""
    W = (read_len + 15) // 16
    return 1 + 2 * W + 1


def build_locv_rows(text_packed: np.ndarray, ssa_full: np.ndarray,
                    read_len: int) -> np.ndarray:
    """Host: fused locate+verify rows for sa_rate == 1 indexes.

    Row r = [SA[r], text words [ws(r), ws(r) + 2W+1)] with
    ws(r) = clip((SA[r] >> 4) - W, 0, n_words-1): every candidate start
    cand = SA[r] - rem (0 <= rem < read_len) has its whole read_len
    window inside the row. One gather of this row then yields BOTH the
    locate result and the verify window — replacing the ssa element
    gather AND the text-row gather, each of which costs a full row
    fetch (docs/DESIGN.md gather model).

    Trades HBM for gathers: (2W+2)*4 B per SA row (64 B at L=100) —
    ~295 MB at E. coli scale, ~3 GB at chr21; engine.upload_index gates
    it by a byte budget and sa_rate == 1 (where ssa IS the suffix
    array, row-ordered).
    """
    W = (read_len + 15) // 16
    R2 = 2 * W + 1
    w = text_packed.view(np.int32)
    nw = len(w)
    padded = np.concatenate([w, np.zeros(R2, dtype=np.int32)])
    sw = np.lib.stride_tricks.sliding_window_view(padded, R2)
    ws = np.clip((ssa_full.astype(np.int64) >> 4) - W, 0, max(nw - 1, 0))
    out = np.empty((len(ssa_full), 1 + R2), dtype=np.int32)
    out[:, 0] = ssa_full
    out[:, 1:] = sw[ws]
    return out


def verify_packed_locv(
    rec: jnp.ndarray,  # int32[Cc, 1+2W+1] gathered locv rows
    text_len: jnp.ndarray,  # int32
    cand: jnp.ndarray,  # int32[Cc] candidate start positions
    cvalid: jnp.ndarray,  # bool[Cc]
    read_words: jnp.ndarray,  # int32[Cc, W]
    amb_bits: jnp.ndarray,  # int32[Cc, W]
    len_mask: jnp.ndarray,  # int32[Cc, W]
    lens: jnp.ndarray,  # int32[Cc]
) -> jnp.ndarray:
    """verify_packed from pre-gathered locv rows (build_locv_rows): the
    candidate's window is aligned out of the row by a static log-step
    word funnel (q <= W word shifts — pure elementwise selects, no
    gather), then the usual bit-phase shift + XOR/popcount."""
    W = read_words.shape[1]
    in_range = cvalid & (cand >= 0) & (cand + lens <= text_len)
    nw = (text_len + 15) >> 4
    spos = rec[:, 0]
    ws = jnp.clip((spos >> 4) - W, 0, jnp.maximum(nw - 1, 0))
    q = jnp.where(in_range, (cand >> 4) - ws, 0)
    win = rec[:, 1:].astype(jnp.uint32)
    b = 1
    while b <= W:
        shifted = jnp.concatenate(
            [win[:, b:], jnp.zeros_like(win[:, :b])], axis=1
        )
        win = jnp.where((q[:, None] & b) != 0, shifted, win)
        b <<= 1
    pos = jnp.where(in_range, cand, 0)
    ob = ((pos & 15) * 2).astype(jnp.uint32)[:, None]
    lo = win[:, :W]
    hi = win[:, 1 : W + 1]
    window = (lo >> ob) | jnp.where(ob == 0, jnp.uint32(0), hi << (32 - ob))
    x = window ^ read_words.astype(jnp.uint32)
    pair = (x | (x >> 1)) & EVEN
    pair = (pair | amb_bits.astype(jnp.uint32)) & len_mask.astype(jnp.uint32)
    nm = jnp.sum(popcount32(pair), axis=1).astype(jnp.int32)
    return jnp.where(in_range, nm, NM_INVALID)


def verify_packed(
    text_rows: jnp.ndarray,  # int32[n_words, R]
    text_len: jnp.ndarray,  # int32
    cand: jnp.ndarray,  # int32[Cc] candidate start positions (compacted)
    cvalid: jnp.ndarray,  # bool[Cc]
    read_words: jnp.ndarray,  # int32[Cc, W] (already per-candidate)
    amb_bits: jnp.ndarray,  # int32[Cc, W]
    len_mask: jnp.ndarray,  # int32[Cc, W]
    lens: jnp.ndarray,  # int32[Cc]
) -> jnp.ndarray:
    """nm int32[Cc]; NM_INVALID where invalid/out of range."""
    W = read_words.shape[1]
    in_range = cvalid & (cand >= 0) & (cand + lens <= text_len)
    pos = jnp.where(in_range, cand, 0)
    w_idx = pos >> 4
    raw = jnp.take(text_rows, w_idx >> 3, axis=0)  # stride-8 row gather
    # align the window to word w_idx: funnel-select by w_idx & 7
    # (log-step word shifts — elementwise, fused into the gather
    # consumer; see TEXT_ROW_STRIDE)
    sub = w_idx & (TEXT_ROW_STRIDE - 1)
    b = 1
    while b < TEXT_ROW_STRIDE:
        shifted = jnp.concatenate(
            [raw[:, b:], jnp.zeros_like(raw[:, :b])], axis=1
        )
        raw = jnp.where((sub[:, None] & b) != 0, shifted, raw)
        b <<= 1
    rows = raw  # (Cc, R+7); consumers slice [:W] / [1:W+1]
    ob = ((pos & 15) * 2).astype(jnp.uint32)[:, None]  # bit phase

    lo = rows[:, :W].astype(jnp.uint32)
    hi = rows[:, 1 : W + 1].astype(jnp.uint32)
    window = (lo >> ob) | jnp.where(ob == 0, jnp.uint32(0), hi << (32 - ob))

    x = window ^ read_words.astype(jnp.uint32)
    pair = (x | (x >> 1)) & EVEN
    pair = (pair | amb_bits.astype(jnp.uint32)) & len_mask.astype(jnp.uint32)
    nm = jnp.sum(popcount32(pair), axis=1).astype(jnp.int32)
    return jnp.where(in_range, nm, NM_INVALID)
