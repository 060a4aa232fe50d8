"""Suffix-array construction dispatch: C++ SA-IS with NumPy fallback.

Component C3 (SURVEY.md §2.1): the only super-linear step of index
construction upstream. The native path is csrc/sais.cc (O(n) induced
sorting, int64) loaded via ctypes. The shared library is built from
csrc/ on first use in each process (`make`, which rebuilds only when a
source is newer than csrc/build/libbwtpu.so) under an exclusive file
lock, so concurrent processes never load a half-written library. With
no toolchain and no prebuilt library we fall back to the O(n log^2 n)
NumPy prefix-doubling in bwtpu.golden (fine for bacterial genomes and
tests; SA-IS matters at chr21/human scale).
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SO = os.path.join(_CSRC, "build", "libbwtpu.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_tried = False


def _build_native() -> None:
    """Bring csrc/build/libbwtpu.so up to date. The flock serializes
    builders across processes (test workers, shard-build jobs), and the
    Makefile links to a temporary name and renames it into place, so a
    reader never sees a partial file."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            subprocess.run(
                ["make", "-C", _CSRC], check=True, capture_output=True,
                timeout=300,
            )
        except (OSError, subprocess.SubprocessError) as e:
            # no toolchain / build failure: a library already in place
            # is still used, else the NumPy fallback
            log.warning("native library build failed (%s)", e)


def _load_native() -> ctypes.CDLL | None:
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        _build_native()
        if not os.path.exists(_SO):
            return None
        try:
            lib = ctypes.CDLL(_SO)
            lib.bwtpu_sais_u8.restype = ctypes.c_int
            lib.bwtpu_sais_u8.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.c_int64,
            ]
            lib.bwtpu_build_lattice.restype = ctypes.c_int64
            lib.bwtpu_build_lattice.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),   # bwt_sym
                ctypes.POINTER(ctypes.c_int64),   # sa
                ctypes.c_int64,                   # n
                ctypes.c_int64,                   # sa_rate
                ctypes.POINTER(ctypes.c_int32),   # lattice
                ctypes.POINTER(ctypes.c_int32),   # ssa
                ctypes.POINTER(ctypes.c_uint8),   # text_codes
                ctypes.c_int64,                   # text_len
                ctypes.POINTER(ctypes.c_int32),   # text_packed
            ]
            lib.bwtpu_build_shard.restype = ctypes.c_int64
            lib.bwtpu_build_shard.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),   # symbols
                ctypes.POINTER(ctypes.c_int64),   # sa
                ctypes.c_int64,                   # n
                ctypes.c_int64,                   # sa_rate
                ctypes.c_int64,                   # step (0 = no occk)
                ctypes.POINTER(ctypes.c_int32),   # lattice
                ctypes.POINTER(ctypes.c_int32),   # ssa
                ctypes.POINTER(ctypes.c_int32),   # text_packed
                ctypes.POINTER(ctypes.c_int32),   # occk_lattice (or NULL)
                ctypes.POINTER(ctypes.c_int32),   # occk_invalid
                ctypes.POINTER(ctypes.c_int64),   # counts5
                ctypes.POINTER(ctypes.c_int64),   # dollar_row
            ]
            lib.bwtpu_key_hist.restype = ctypes.c_int
            lib.bwtpu_key_hist.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),   # symbols
                ctypes.c_int64,                   # n
                ctypes.c_int64,                   # dmax
                ctypes.POINTER(ctypes.c_uint32),  # hist (5^dmax, zeroed)
            ]
            _lib = lib
        except OSError as e:
            log.warning("SA-IS .so load failed (%s); using NumPy fallback", e)
        return _lib


def suffix_array(symbols: np.ndarray, alphabet_size: int = 5,
                 force_fallback: bool = False) -> np.ndarray:
    """Suffix array of `symbols` (uint8, last element the unique 0 sentinel).

    Returns int64 SA. Dispatches to C++ SA-IS when available.
    """
    s = np.ascontiguousarray(symbols, dtype=np.uint8)
    n = len(s)
    if s[-1] != 0 or (n > 1 and np.any(s[:-1] == 0)):
        raise ValueError("input must end with a unique 0 sentinel")
    lib = None if force_fallback else _load_native()
    if lib is not None:
        sa = np.empty(n, dtype=np.int64)
        rc = lib.bwtpu_sais_u8(
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n),
            ctypes.c_int64(alphabet_size),
        )
        if rc == 0:
            return sa
        log.warning("native SA-IS returned rc=%d; using NumPy fallback", rc)
    from bwtpu.golden import suffix_array as np_sa

    return np_sa(s.astype(np.int64))


def native_available() -> bool:
    return _load_native() is not None


def build_lattice_native(bwt_sym, sa, sa_rate, text_codes):
    """One-pass C++ lattice assembly; returns (lattice, ssa, text_packed)
    or None when the native library is unavailable."""
    lib = _load_native()
    if lib is None:
        return None
    n = len(bwt_sym)
    n_blocks = (n + 127) // 128
    lattice = np.zeros((n_blocks + 1, 32), dtype=np.int32)
    ssa_cap = n // sa_rate + 2
    ssa = np.zeros(ssa_cap, dtype=np.int32)
    text_len = len(text_codes)
    text_packed = np.zeros((text_len + 15) // 16, dtype=np.int32)
    bwt_sym = np.ascontiguousarray(bwt_sym, dtype=np.uint8)
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    text_codes = np.ascontiguousarray(text_codes, dtype=np.uint8)
    n_sampled = lib.bwtpu_build_lattice(
        bwt_sym.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
        ctypes.c_int64(sa_rate),
        lattice.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ssa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        text_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(text_len),
        text_packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if n_sampled < 0:
        return None
    return lattice, ssa[:n_sampled].copy(), text_packed


def build_shard_native(symbols, sa, sa_rate, step):
    """Fused one-pass shard assembly (csrc/pack.cc bwtpu_build_shard):
    search lattice + ssa + packed text + raw multi-step Occ lattice (the
    caller adds Ks[t] to the fold words) + invalid rows + symbol counts
    + dollar row, all from ONE cache-friendly pass over `sa`. Returns
    None when the native library is unavailable.

    step == 0 skips the multi-step outputs (occk fields are None)."""
    lib = _load_native()
    if lib is None:
        return None
    from bwtpu.index import OCCK_BLOCK, OCCK_WIDTH

    n = len(symbols)
    n_blocks = (n + 127) // 128
    lattice = np.zeros((n_blocks + 1, 32), dtype=np.int32)
    ssa = np.zeros(n // sa_rate + 2, dtype=np.int32)
    text_packed = np.zeros((n - 1 + 15) // 16, dtype=np.int32)
    if step:
        R, W = OCCK_BLOCK[step], OCCK_WIDTH[step]
        n_blocksK = (n + R - 1) // R
        occk_lattice = np.zeros((n_blocksK + 1, W), dtype=np.int32)
    else:
        occk_lattice = np.zeros((1, 1), dtype=np.int32)
    occk_invalid = np.full(4, -1, dtype=np.int32)
    counts5 = np.zeros(5, dtype=np.int64)
    dollar = np.zeros(1, dtype=np.int64)
    symbols = np.ascontiguousarray(symbols, dtype=np.uint8)
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    n_sampled = lib.bwtpu_build_shard(
        symbols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
        ctypes.c_int64(sa_rate),
        ctypes.c_int64(step),
        lattice.ctypes.data_as(p_i32),
        ssa.ctypes.data_as(p_i32),
        text_packed.ctypes.data_as(p_i32),
        occk_lattice.ctypes.data_as(p_i32),
        occk_invalid.ctypes.data_as(p_i32),
        counts5.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dollar.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n_sampled < 0:
        return None
    return (
        lattice, ssa[:n_sampled].copy(), text_packed,
        occk_lattice if step else None,
        occk_invalid if step else None,
        counts5, int(dollar[0]),
    )


def key_hist_native(symbols, dmax) -> np.ndarray | None:
    """Histogram of the depth-dmax base-5 suffix keys in text order
    (csrc/pack.cc bwtpu_key_hist); None if native unavailable or
    dmax > 12 (5^13 bins would be a 4.9 GB allocation)."""
    lib = _load_native()
    if lib is None or not (1 <= dmax <= 12):
        return None
    symbols = np.ascontiguousarray(symbols, dtype=np.uint8)
    hist = np.zeros(5**dmax, dtype=np.uint32)
    rc = lib.bwtpu_key_hist(
        symbols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(symbols)),
        ctypes.c_int64(dmax),
        hist.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    if rc != 0:
        return None
    return hist
