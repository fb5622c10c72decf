"""ctypes binding (with on-demand g++ build) for the native front-end kernel.

The shared object is compiled once per source change into
``_native/build/`` and memoized. If it cannot be built or loaded (no C++
toolchain), callers fall back to the NumPy/Python implementation:
:func:`try_load` returns None, records the cause in :func:`load_error`
and says so once on stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(__file__)
_SRCS = [os.path.join(_DIR, "pretok.cpp"),
         os.path.join(_DIR, "chunker.cpp"),
         os.path.join(_DIR, "stitch.cpp"),
         os.path.join(_DIR, "encode_prep.cpp")]
_BUILD_DIR = os.path.join(_DIR, "build")

_lib: Optional[ctypes.CDLL] = None
_packed_ws = None
_packed_punct = None
_packed_ws_py = None
_packed_punc_py = None
_packed_lower_special = None
_lower_table = None
_stitch_fn = None
_stitch_flat_fn = None
_prep_fn = None


def _so_path() -> str:
    digest = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            digest.update(f.read())
    # -march=native bakes host ISA extensions into the .so; key the cache
    # on the platform too, so a build dir copied between heterogeneous
    # hosts recompiles instead of loading unsupported instructions.
    import platform
    digest.update(platform.machine().encode())
    digest.update(platform.processor().encode())
    digest.update(b"-O3 -march=native -pthread")
    return os.path.join(_BUILD_DIR, f"native-{digest.hexdigest()[:16]}.so")


def _build(so_path: str) -> None:
    import sysconfig
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # Build into a temp file then rename, so concurrent builders are safe.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-pthread", "-shared", "-fPIC",
             "-std=c++17",
             f"-I{sysconfig.get_paths()['include']}",
             *_SRCS, "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL:
    global _lib, _packed_ws, _packed_punct, _packed_ws_py
    if _lib is not None:
        return _lib
    so_path = _so_path()
    if not os.path.exists(so_path):
        _build(so_path)
    lib = ctypes.CDLL(so_path)
    i64 = ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.swt_split_bounds.restype = i64
    lib.swt_split_bounds.argtypes = [u32p, i64, u8p, u8p, i64p, i64p]
    lib.swt_split_corpus.restype = i64
    lib.swt_split_corpus.argtypes = [u32p, i64p, i64, u8p, u8p, i64p, i64p,
                                     i32p]
    lib.swt_chunk_unique.restype = i64
    lib.swt_chunk_unique.argtypes = [u32p, i64, u8p, i32p, i64p, i64p,
                                     i32p, i64p]
    lib.swt_unique_spans.restype = i64
    lib.swt_unique_spans.argtypes = [u32p, i64p, i64p, i64, i32p, i64p]
    # swt_stitch builds Python objects: PYFUNCTYPE keeps the GIL held.
    global _stitch_fn, _prep_fn
    _stitch_fn = ctypes.PYFUNCTYPE(
        ctypes.py_object, ctypes.py_object, ctypes.py_object, i32p, i32p,
        i64, i64, i32p, i64p, i64)(("swt_stitch", lib))
    global _stitch_flat_fn
    _stitch_flat_fn = ctypes.PYFUNCTYPE(
        ctypes.py_object, ctypes.py_object, ctypes.py_object, i32p, i64p,
        i32p, i64, i32p, i64p, i64)(("swt_stitch_flat", lib))
    # swt_encode_prep_mt snapshots PyUnicode internals under the GIL,
    # then worker threads only touch raw memory: PYFUNCTYPE (GIL held
    # in the calling thread) is still required.
    _prep_fn = ctypes.PYFUNCTYPE(
        i64, ctypes.py_object, u32p, u8p, u8p, i64, i32p, i64p, u32p,
        i32p, i64p)(("swt_encode_prep_mt", lib))
    lib.swt_pack_u16.restype = None
    lib.swt_pack_u16.argtypes = [u32p, i64p, i32p, i64, i64, i32p, u8p,
                                 u8p, ctypes.POINTER(ctypes.c_uint16)]
    from ..frontend.charclass import (LOWER, LOWER_SPECIAL, PUNC_PY,
                                      PUNCT_HF, WS_HF, WS_PY)
    global _packed_punc_py, _packed_lower_special, _lower_table
    _packed_ws = np.ascontiguousarray(np.packbits(WS_HF))
    _packed_punct = np.ascontiguousarray(np.packbits(PUNCT_HF))
    _packed_ws_py = np.ascontiguousarray(np.packbits(WS_PY))
    _packed_punc_py = np.ascontiguousarray(np.packbits(PUNC_PY))
    _packed_lower_special = np.ascontiguousarray(np.packbits(LOWER_SPECIAL))
    _lower_table = np.ascontiguousarray(LOWER, dtype=np.uint32)
    _lib = lib
    return lib


_load_error: Optional[str] = None


def try_load():
    """This module when the native library loads, else None (the caller
    takes its NumPy/Python fallback; the first failure is reported on
    stderr and kept in :func:`load_error`, and no later call tries the
    build again)."""
    global _load_error
    if _load_error is not None:
        return None
    try:
        _load()
    except Exception as e:  # no toolchain, failed build, bad .so
        _load_error = f"{type(e).__name__}: {e}"
        print(f"[subword_tokenizers_tpu] native front end unavailable "
              f"({_load_error}); using the NumPy/Python fallback",
              file=sys.stderr)
        return None
    return sys.modules[__name__]


def load_error() -> Optional[str]:
    """Why :func:`try_load` last fell back, or None if it never did."""
    return _load_error


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def split_bounds(cps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Native single-sentence split; same contract as the NumPy version."""
    lib = _load()
    cps = np.ascontiguousarray(cps, dtype=np.uint32)
    n = cps.shape[0]
    starts = np.empty(n, dtype=np.int64)
    ends = np.empty(n, dtype=np.int64)
    count = lib.swt_split_bounds(
        _ptr(cps, ctypes.c_uint32), n,
        _ptr(_packed_ws, ctypes.c_uint8), _ptr(_packed_punct, ctypes.c_uint8),
        _ptr(starts, ctypes.c_int64), _ptr(ends, ctypes.c_int64))
    return starts[:count], ends[:count]


def chunk_unique(cps: np.ndarray):
    """Whitespace-chunk split + content dedup in one native pass.

    Returns (inverse i32[C], chunk_start i64[C], uniq_start i64[U],
    uniq_len i32[U]) over the Python-isspace class.
    """
    lib = _load()
    cps = np.ascontiguousarray(cps, dtype=np.uint32)
    n = cps.shape[0]
    cap = max(n // 2 + 2, 4)
    inverse = np.empty(cap, dtype=np.int32)
    chunk_start = np.empty(cap, dtype=np.int64)
    uniq_start = np.empty(cap, dtype=np.int64)
    uniq_len = np.empty(cap, dtype=np.int32)
    n_chunks = np.zeros(1, dtype=np.int64)
    n_uniq = lib.swt_chunk_unique(
        _ptr(cps, ctypes.c_uint32), n,
        _ptr(_packed_ws_py, ctypes.c_uint8),
        _ptr(inverse, ctypes.c_int32), _ptr(chunk_start, ctypes.c_int64),
        _ptr(uniq_start, ctypes.c_int64), _ptr(uniq_len, ctypes.c_int32),
        _ptr(n_chunks, ctypes.c_int64))
    c = int(n_chunks[0])
    return (inverse[:c], chunk_start[:c], uniq_start[:n_uniq],
            uniq_len[:n_uniq])


def unique_spans(cps: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Content-dedup spans of ``cps`` in first-occurrence order.

    Returns (inverse i32[n], uniq_idx i64[u]) — uniq_idx[u] is the index
    of the first span with each distinct content.
    """
    lib = _load()
    cps = np.ascontiguousarray(cps, dtype=np.uint32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    n = starts.shape[0]
    inverse = np.empty(n, dtype=np.int32)
    uniq_idx = np.empty(max(n, 1), dtype=np.int64)
    n_uniq = lib.swt_unique_spans(
        _ptr(cps, ctypes.c_uint32), _ptr(starts, ctypes.c_int64),
        _ptr(ends, ctypes.c_int64), n,
        _ptr(inverse, ctypes.c_int32), _ptr(uniq_idx, ctypes.c_int64))
    return inverse, uniq_idx[:n_uniq]


def stitch(strings: list, out_ids: np.ndarray, out_n: np.ndarray,
           inverse: np.ndarray, bounds: np.ndarray,
           alt: Optional[list] = None) -> list:
    """Token-id matrix -> list-of-list-of-str in one native pass.

    ``strings``: id -> token string; ``out_ids`` i32[U, W] with
    ``out_n`` i32[U] valid counts; ``inverse`` i32[C] chunk -> unique row;
    ``bounds`` i64[S+1] chunk ranges per sentence. ``alt``: optional
    same-length string list used for token positions > 0 within a row
    (BPE '##'-continuation rendering).
    """
    _load()
    out_ids = np.ascontiguousarray(out_ids, dtype=np.int32)
    out_n = np.ascontiguousarray(out_n, dtype=np.int32)
    inverse = np.ascontiguousarray(inverse, dtype=np.int32)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    U, W = out_ids.shape
    return _stitch_fn(strings, alt, _ptr(out_ids, ctypes.c_int32),
                      _ptr(out_n, ctypes.c_int32), U, W,
                      _ptr(inverse, ctypes.c_int32),
                      _ptr(bounds, ctypes.c_int64), bounds.shape[0] - 1)


def stitch_flat(strings: list, ids: np.ndarray, starts: np.ndarray,
                counts: np.ndarray, inverse: np.ndarray,
                bounds: np.ndarray, alt: Optional[list] = None) -> list:
    """Flat token-id stream -> list-of-list-of-str (compact fetch path).

    ``ids`` i32[n] dense stream; ``starts`` i64[U] / ``counts`` i32[U]
    per-unique spans into it; ``inverse``/``bounds``/``alt`` as in
    :func:`stitch`.
    """
    _load()
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    inverse = np.ascontiguousarray(inverse, dtype=np.int32)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    return _stitch_flat_fn(strings, alt, _ptr(ids, ctypes.c_int32),
                           _ptr(starts, ctypes.c_int64),
                           _ptr(counts, ctypes.c_int32), ids.shape[0],
                           _ptr(inverse, ctypes.c_int32),
                           _ptr(bounds, ctypes.c_int64),
                           bounds.shape[0] - 1)


def encode_prep(sents: list):
    """Fused front end: str list -> lowered unique chunks + stitch metadata.

    One native pass replacing lower/join/codepoints/chunk_unique/
    searchsorted. Returns (inverse i32[C], bounds i64[S+1],
    uniq_buf u32[total], uniq_off i64[U+1], uniq_len i32[U]) — or None
    when a LOWER_SPECIAL codepoint (U+0130 / U+03A3) requires the exact
    Python ``str.lower()`` fallback path.
    """
    _load()
    total = sum(map(len, sents))
    S = len(sents)
    cap_chunks = (total + S) // 2 + 2
    inverse = np.empty(cap_chunks, dtype=np.int32)
    bounds = np.empty(S + 1, dtype=np.int64)
    uniq_buf = np.empty(max(total, 1), dtype=np.uint32)
    uniq_len = np.empty(cap_chunks, dtype=np.int32)
    n_chunks = np.zeros(1, dtype=np.int64)
    u = _prep_fn(sents, _ptr(_lower_table, ctypes.c_uint32),
                 _ptr(_packed_lower_special, ctypes.c_uint8),
                 _ptr(_packed_ws_py, ctypes.c_uint8),
                 os.cpu_count() or 1,
                 _ptr(inverse, ctypes.c_int32),
                 _ptr(bounds, ctypes.c_int64),
                 _ptr(uniq_buf, ctypes.c_uint32),
                 _ptr(uniq_len, ctypes.c_int32),
                 _ptr(n_chunks, ctypes.c_int64))
    if u == -1:
        return None
    if u == -2:
        raise TypeError("encode_prep expects a list of str")
    c = int(n_chunks[0])
    uniq_len = uniq_len[:u]
    uniq_off = np.zeros(u + 1, dtype=np.int64)
    np.cumsum(uniq_len, out=uniq_off[1:])
    return inverse[:c], bounds, uniq_buf, uniq_off, uniq_len


def pack_u16_rows(uniq_buf: np.ndarray, uniq_off: np.ndarray,
                  uniq_len: np.ndarray, Lc: int,
                  alpha: np.ndarray) -> np.ndarray:
    """Pack unique chunks into the u16 wire matrix for wp_e2e_scan_u16
    (native equivalent of pad + pack_chars + pack_u16). The caller
    guarantees the alphabet fits 13 bits."""
    lib = _load()
    alpha = np.ascontiguousarray(alpha, dtype=np.int32)
    u = uniq_len.shape[0]
    mat = np.empty((u, Lc), dtype=np.uint16)
    lib.swt_pack_u16(
        _ptr(uniq_buf, ctypes.c_uint32), _ptr(uniq_off, ctypes.c_int64),
        _ptr(uniq_len, ctypes.c_int32), u, Lc,
        _ptr(alpha, ctypes.c_int32), _ptr(_packed_ws_py, ctypes.c_uint8),
        _ptr(_packed_punc_py, ctypes.c_uint8),
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    return mat


def split_corpus(cps: np.ndarray, sent_cp_off: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native batched split over a sentence-concatenated codepoint array.

    Returns (word_start, word_end, sent_id) with global offsets.
    """
    lib = _load()
    cps = np.ascontiguousarray(cps, dtype=np.uint32)
    sent_cp_off = np.ascontiguousarray(sent_cp_off, dtype=np.int64)
    n_sent = sent_cp_off.shape[0] - 1
    cap = int(sent_cp_off[-1]) if n_sent >= 0 else 0
    starts = np.empty(cap, dtype=np.int64)
    ends = np.empty(cap, dtype=np.int64)
    sids = np.empty(cap, dtype=np.int32)
    count = lib.swt_split_corpus(
        _ptr(cps, ctypes.c_uint32), _ptr(sent_cp_off, ctypes.c_int64), n_sent,
        _ptr(_packed_ws, ctypes.c_uint8), _ptr(_packed_punct, ctypes.c_uint8),
        _ptr(starts, ctypes.c_int64), _ptr(ends, ctypes.c_int64),
        _ptr(sids, ctypes.c_int32))
    return starts[:count], ends[:count], sids[:count]
