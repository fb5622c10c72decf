"""Corpus → padded symbol-id tensors (the device-side training representation).

The reference trains over ``corpus_as_symbols``: a list of
(symbol-list, frequency) per *word type*, in first-occurrence scan order
(reference: source/bpe.py:73-81, source/wordpiece.py:49-58). That order is
load-bearing — it defines the tie-break for merge selection — so word types
here are enumerated in exactly that order.

Device form: ``sym: i32[n_words, max_len]`` padded with -1, ``freq:
i64[n_words]``. Row index = first-occurrence rank; (row, column) row-major
position is the tie-break key used by the trainers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..frontend.pretokenize import WordBatch
from .symbols import SymbolTable

PAD = -1


def unique_words(wb: WordBatch) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Word types in first-occurrence order with frequencies.

    Returns (words, freq i64[n_uniq], inverse i32[n_words]) where
    ``inverse[i]`` is the type index of occurrence ``i`` — the same
    enumeration as ``Counter(new_words)`` insertion order in the reference
    (source/bpe.py:77).
    """
    cps = wb.cps
    ws, we = wb.word_start, wb.word_end
    from .._native.binding import try_load
    native = try_load()
    if native is not None:
        inverse, uniq_idx = native.unique_spans(cps, ws, we)
        words = [cps[ws[i]:we[i]].astype("<u4").tobytes()
                 .decode("utf-32-le") for i in uniq_idx]
        freqs = np.bincount(inverse,
                            minlength=len(words)).astype(np.int64)
        return words, freqs, inverse

    seen: Dict[bytes, int] = {}
    words = []
    freqs_l: List[int] = []
    inverse = np.empty(wb.n_words, dtype=np.int32)
    for i in range(wb.n_words):
        key = cps[ws[i]:we[i]].tobytes()
        idx = seen.get(key)
        if idx is None:
            idx = len(words)
            seen[key] = idx
            words.append(key.decode("utf-32-le"))
            freqs_l.append(1)
        else:
            freqs_l[idx] += 1
        inverse[i] = idx
    return words, np.asarray(freqs_l, dtype=np.int64), inverse


@dataclass
class SymbolCorpus:
    """Padded word-type tensor plus the evolving symbol table."""

    sym: np.ndarray          # i32[n_words, max_len], PAD-filled
    freq: np.ndarray         # i64[n_words]
    table: SymbolTable
    words: List[str]         # word type strings, first-occurrence order

    @property
    def n_words(self) -> int:
        return int(self.sym.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.sym.shape[1])


def build_bpe_corpus(words: Sequence[str], freq: np.ndarray,
                     table: SymbolTable) -> SymbolCorpus:
    """BPE initial state: each word split into single-character symbols
    (reference: source/bpe.py:79-81)."""
    max_len = max((len(w) for w in words), default=1)
    sym = np.full((max(len(words), 1), max_len), PAD, dtype=np.int32)
    for i, w in enumerate(words):
        for j, ch in enumerate(w):
            sym[i, j] = table.intern(ch)
    return SymbolCorpus(sym=sym, freq=np.asarray(freq, dtype=np.int64),
                        table=table, words=list(words))


def build_wp_corpus(words: Sequence[str], freq: np.ndarray,
                    table: SymbolTable) -> SymbolCorpus:
    """WordPiece initial state: first char bare, remaining chars prefixed
    with '##' (reference: source/wordpiece.py:53-57)."""
    max_len = max((len(w) for w in words), default=1)
    sym = np.full((max(len(words), 1), max_len), PAD, dtype=np.int32)
    for i, w in enumerate(words):
        for j, ch in enumerate(w):
            sym[i, j] = table.intern(ch if j == 0 else "##" + ch)
    return SymbolCorpus(sym=sym, freq=np.asarray(freq, dtype=np.int64),
                        table=table, words=list(words))
