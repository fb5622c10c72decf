"""BERT-style pre-tokenization front end, NumPy-vectorized with an optional
C++ fast path.

Reproduces, bit-for-bit, ``str.lower()`` followed by the HuggingFace
`tokenizers` Rust crate's ``BertPreTokenizer.pre_tokenize_str`` (the exact
pipeline the reference drives through ``SubwordTokenizer.preprocessing``,
reference: source/utils.py:15-29):

1. lower-case the sentence with full Python/Unicode semantics
   (``str.lower()`` is used directly — exact by construction);
2. split on Unicode White_Space (whitespace removed);
3. isolate each punctuation character as its own token, where punctuation is
   ASCII punctuation OR Unicode general category P*;
4. report per-token codepoint offsets into the lowered string.

Everything downstream of ``str.lower()`` operates on flat uint32 codepoint
arrays, so it vectorizes on the host and feeds the device pipeline without
further conversion. A C++ kernel (``subword_tokenizers_tpu/_native``) provides
the split hot loop for large corpora; the NumPy path is the always-available
fallback with identical output.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from .charclass import PUNCT_HF, WS_HF, codepoints

Token = Tuple[str, Tuple[int, int]]


def _split_bounds_numpy(cps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Token (start, end) codepoint offsets for one lowered sentence.

    A token is either a maximal run of non-whitespace non-punctuation
    codepoints, or a single punctuation codepoint.
    """
    n = cps.shape[0]
    if n == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty
    ws = WS_HF[cps]
    punct = PUNCT_HF[cps]
    keep = ~ws
    # A token starts at i if the char is kept and (it is the first char, the
    # previous char was whitespace or punctuation, or it is punctuation
    # itself — punctuation chars always form their own 1-char token).
    prev_break = np.empty(n, dtype=bool)
    prev_break[0] = True
    np.logical_or(ws[:-1], punct[:-1], out=prev_break[1:])
    starts_mask = keep & (prev_break | punct)
    starts = np.flatnonzero(starts_mask)
    # A token ends just before the next whitespace/punct char or at the next
    # token start, whichever comes first.
    next_start = np.empty(len(starts), dtype=np.int64)
    next_start[:-1] = starts[1:]
    next_start[-1:] = n
    # Within [start, next_start) the token runs until the first ws char
    # (punct chars always start a token, so only ws can terminate a run
    # before the next start).
    ends = np.empty(len(starts), dtype=np.int64)
    ws_pos = np.flatnonzero(ws)
    if len(ws_pos):
        idx = np.searchsorted(ws_pos, starts, side="left")
        next_ws = np.where(idx < len(ws_pos), ws_pos[np.minimum(idx, len(ws_pos) - 1)], n)
        np.minimum(next_start, next_ws, out=ends)
    else:
        ends[:] = next_start
    return starts, ends


_native_split = None
_native_checked = False


def _get_native_split():
    global _native_split, _native_checked
    if not _native_checked:
        _native_checked = True
        from .._native.binding import try_load
        native = try_load()
        _native_split = native.split_bounds if native is not None else None
    return _native_split


def split_bounds(cps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Token (start, end) offsets of one lowered codepoint array.

    Dispatches to the C++ kernel when built, NumPy otherwise; both produce
    identical output (cross-checked in tests/test_frontend.py).
    """
    native = _get_native_split()
    if native is not None:
        return native(cps)
    return _split_bounds_numpy(cps)


def pre_tokenize_str(text: str) -> List[Token]:
    """Lower + BERT pre-split of a single sentence.

    Output matches ``BertPreTokenizer().pre_tokenize_str(text.lower())``
    exactly, including codepoint offsets.
    """
    lowered = text.lower()
    cps = codepoints(lowered)
    starts, ends = split_bounds(cps)
    return [
        (lowered[s:e], (int(s), int(e)))
        for s, e in zip(starts.tolist(), ends.tolist())
    ]


@dataclass
class WordBatch:
    """Flat array representation of a pre-tokenized corpus.

    The host-side product of the front end, shared by trainers and encoders:

    - ``cps``        : uint32[total_cps]  — codepoints of the lowered corpus,
                       sentence-concatenated.
    - ``word_start`` : int64[n_words]     — start offset of each word in ``cps``.
    - ``word_end``   : int64[n_words]     — end offset (exclusive).
    - ``sent_id``    : int32[n_words]     — sentence index of each word.
    - ``sent_cp_off``: int64[n_sent + 1]  — codepoint offset of each sentence
                       within ``cps`` (so in-sentence offsets can be recovered).
    """

    cps: np.ndarray
    word_start: np.ndarray
    word_end: np.ndarray
    sent_id: np.ndarray
    sent_cp_off: np.ndarray

    @property
    def n_words(self) -> int:
        return int(self.word_start.shape[0])

    @property
    def n_sentences(self) -> int:
        return int(self.sent_cp_off.shape[0]) - 1

    def word(self, i: int) -> str:
        s, e = int(self.word_start[i]), int(self.word_end[i])
        return self.cps[s:e].astype("<u4").tobytes().decode("utf-32-le")

    def words(self) -> List[str]:
        return [self.word(i) for i in range(self.n_words)]

    def sentence_tokens(self) -> List[List[Token]]:
        """Reference-schema view: per-sentence [(word, (start, end)), ...]
        with offsets relative to the sentence (source/utils.py:15-29)."""
        out: List[List[Token]] = [[] for _ in range(self.n_sentences)]
        offs = self.sent_cp_off
        for i in range(self.n_words):
            sid = int(self.sent_id[i])
            base = int(offs[sid])
            s, e = int(self.word_start[i]), int(self.word_end[i])
            out[sid].append((self.word(i), (s - base, e - base)))
        return out


def pretokenize_batch(corpus: Sequence[str]) -> WordBatch:
    """Lower + pre-split a whole corpus into the flat array representation."""
    from .charclass import lower_codepoints
    cps = lower_codepoints("".join(corpus))
    if cps is not None:
        # Vectorized lower: 1:1 mapping, so raw lengths are the lowered
        # lengths.
        sent_lens = np.fromiter((len(s) for s in corpus), dtype=np.int64,
                                count=len(corpus))
    else:
        # Case special present (U+0130 / final sigma): exact Python path.
        lowered = [s.lower() for s in corpus]
        cps = codepoints("".join(lowered))
        sent_lens = np.fromiter((len(s) for s in lowered), dtype=np.int64,
                                count=len(lowered))
    sent_cp_off = np.zeros(len(corpus) + 1, dtype=np.int64)
    np.cumsum(sent_lens, out=sent_cp_off[1:])

    native = _get_native_split()
    if native is not None:
        from .._native import binding
        word_start, word_end, sent_id = binding.split_corpus(cps, sent_cp_off)
        return WordBatch(cps=cps, word_start=word_start, word_end=word_end,
                         sent_id=sent_id, sent_cp_off=sent_cp_off)

    starts_l, ends_l, sids_l = [], [], []
    for sid in range(len(corpus)):
        s0, s1 = sent_cp_off[sid], sent_cp_off[sid + 1]
        st, en = split_bounds(cps[s0:s1])
        if len(st):
            starts_l.append(st + s0)
            ends_l.append(en + s0)
            sids_l.append(np.full(len(st), sid, dtype=np.int32))
    if starts_l:
        word_start = np.concatenate(starts_l)
        word_end = np.concatenate(ends_l)
        sent_id = np.concatenate(sids_l)
    else:
        word_start = np.zeros(0, dtype=np.int64)
        word_end = np.zeros(0, dtype=np.int64)
        sent_id = np.zeros(0, dtype=np.int32)
    return WordBatch(cps=cps, word_start=word_start, word_end=word_end,
                     sent_id=sent_id, sent_cp_off=sent_cp_off)
