"""WordPiece tokenizers: NaiveWP (training + greedy longest-match encoding)
and FastWP (linear-time end-to-end trie scan), on the accelerator.

Bit-compatible with the reference (source/wordpiece.py) including its
quirks; the implementation is array/automaton based, not a port:

- **Training** runs on device like BPE, with the score
  ``pair_freq / (freq_a * freq_b)`` (source/wordpiece.py:84-87) selected by
  *exact IEEE-double bits* computed in integer arithmetic
  (ops/bitmath.py), so Python float ties — and therefore the
  dict-insertion-order tie-break (source/wordpiece.py:92) — are reproduced
  exactly. Merged tokens are ``a + b[2:]`` with only the vocabulary
  persisted (merges are not recorded), matching source/wordpiece.py:95-96.
- **NaiveWP encoding**: greedy longest-prefix-in-vocab with '##'
  continuation prefixes and whole-word ``[UNK]`` fallback
  (source/wordpiece.py:131-158); batched on device via
  ops/wp_encode.wp_match_encode.
- **FastWP encoding**: end-to-end LinMaxMatch over the raw lowered text
  (NOT the pre-tokenizer — source/wordpiece.py:248), with failure
  links/pops, boundary checks in *Python* char classes
  (source/wordpiece.py:272-288), the literal ``"['UNK']"`` token (a
  different string than NaiveWP's ``"[UNK]"`` — quirk preserved,
  source/wordpiece.py:257), and the ``root_sharp`` corner case
  (source/wordpiece.py:260-261); batched on device via
  ops/wp_encode.wp_e2e_encode.

Resource format is byte-compatible: ``vocab.json`` = JSON list of the
vocabulary set (membership is the contract; source/wordpiece.py:186-208).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..benchmarks import profiling
from ..core.corpus import build_wp_corpus, unique_words
from ..core.symbols import SymbolTable
from ..frontend.charclass import PUNC_PY, WS_PY, codepoints
from .base import SubwordTokenizer
from .trie import E2ETrie, MatchTrie

# Exact-score domain ceiling: the 128-bit scorer needs fa, fb < 2**53 and
# pair counts < 2**53, i.e. total symbol occurrences < 2**52 (~4.5e15 —
# petabytes of text; the reference's own Counter arithmetic is the only
# thing beyond it). Below WIDE_SCORE_MIN the narrow i64 scorer suffices.
MAX_TOKENS_WP = 1 << 52
WIDE_SCORE_MIN = 1 << 26  # fa*fb < 2**53 guaranteed iff total < 2**26

UNK = "[UNK]"
UNK_E2E = "['UNK']"  # FastWP's literal quirk (source/wordpiece.py:257)


class NaiveWP(SubwordTokenizer):
    """WordPiece with greedy longest-match encoding, trained on device."""

    def __init__(self, tokenizer: Optional[object] = None,
                 mesh: Optional[object] = None) -> None:
        """``mesh``: optional 1-D jax Mesh with a 'data' axis for
        data-parallel training (parallel/train.py)."""
        super().__init__(tokenizer)
        self.mesh = mesh
        self.vocab: set = set()
        self.corpus_as_symbols: List[Tuple[List[str], int]] = []
        self._encode_cache: Dict[str, List[str]] = {}
        self._match_trie = None
        self._match_out: Optional[SymbolTable] = None
        self._match_dev = None
        self._checkpoint_dir: Optional[str] = None
        self._checkpoint_every = 1000
        self._resume_dir: Optional[str] = None
        self._progress = False
        self._merge_log: List[Tuple[str, str]] = []

    def _save_checkpoint(self) -> None:
        """Atomic mid-training checkpoint: vocab + merge log."""
        os.makedirs(self._checkpoint_dir, exist_ok=True)
        target = os.path.join(self._checkpoint_dir, "wp_state.json")
        tmp = target + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"vocab": list(self.vocab),
                       "merges": self._merge_log}, f, ensure_ascii=False)
        os.replace(tmp, target)
        self.save_resources(self._checkpoint_dir)

    # ------------------------------------------------------------ training

    def train(self, corpus: List[str], max_vocab: int = 30_000, *,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 1000, resume: bool = False,
              progress: bool = False) -> None:
        """Learn the vocabulary by likelihood-scored merges
        (reference: source/wordpiece.py:29-103); merge loop on device.

        Keyword-only extensions mirror NaiveBPE.train: periodic atomic
        checkpoints (vocab + the internal merge log, which the reference
        does not record but which resume needs to replay corpus state)
        and optional stderr progress.
        """
        if not isinstance(corpus, list) or not all(
                isinstance(example, str) for example in corpus):
            raise TypeError("corpus must be a list of strings.")
        if not isinstance(max_vocab, int):
            raise TypeError("max_vocab must be an int.")

        self.reset()
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_every = max(int(checkpoint_every), 1)
        self._resume_dir = checkpoint_dir if resume else None
        self._progress = progress
        self._merge_log: List[Tuple[str, str]] = []

        wb = self.preprocessing_batch(corpus)
        words, freq, _ = unique_words(wb)
        if not words:
            return

        total_tokens = int((np.array([len(w) for w in words],
                                     dtype=np.int64) * freq).sum())
        if total_tokens >= MAX_TOKENS_WP:
            raise ValueError(
                "corpus exceeds the exact-score domain "
                f"({total_tokens} symbol occurrences >= 2**52)")
        # >= 2**26 total occurrences: fa*fb may exceed 2**53, so scores go
        # through the 128-bit-denominator divider (ops/bitmath.py) — still
        # bit-exact vs CPython's arbitrary-precision int division.
        wide_score = total_tokens >= WIDE_SCORE_MIN
        # i32 weights whenever the total fits: with wide keys the run
        # aggregation still scans i32 (ops/pairstats docstring).
        w32 = total_tokens < 2**31

        import jax.numpy as jnp
        from ..ops.merge import apply_merge
        from ..ops.pairstats import wp_select

        table = SymbolTable()
        corpus_arrays = build_wp_corpus(words, freq, table)
        self.vocab |= set(table.strings())
        sym_cap = len(table) + max(max_vocab - len(self.vocab), 0) + 8
        n_dev = self.mesh.devices.size if self.mesh is not None else 0
        n_pos = (corpus_arrays.sym.shape[0] + n_dev) * max(
            corpus_arrays.sym.shape[1] - 1, 1)
        # Narrow (i32) keys need symbol ids < 2**16 and all counts/weights
        # < 2**31 (run totals accumulate *weighted* frequencies).
        narrow = (sym_cap + 8 < (1 << 16) and n_pos < 2**31
                  and total_tokens < 2**31)
        bits = 16 if narrow else 21
        from ..ops.train_loop import _cand_cap

        if self.mesh is not None:
            from ..parallel.train import (rows_per_device, run_gather_cap,
                                          shard_corpus,
                                          sharded_apply_merge,
                                          sharded_wp_select,
                                          sharded_wp_select_compact,
                                          sharded_wp_select_topk)
            sym, freq_dev = shard_corpus(self.mesh, corpus_arrays.sym,
                                         corpus_arrays.freq)
            cap_local = _cand_cap(max(n_pos // max(n_dev, 1), 1))
            run_cap = run_gather_cap(n_pos // max(n_dev, 1))
            cap_global = _cand_cap(n_pos)
            self._shard_rows = rows_per_device(sym)
            self._sel_stats = {"proven": 0, "compact": 0, "full": 0}
            self._topk_fallbacks = 0  # steps not settled by the certificate

            # Testing/validation knob (mirrors NaiveBPE): pin selection to
            # one exact fallback tier ('compact' | 'full') so the tiers —
            # including the scaled-integer rounding-margin arithmetic that
            # normally only fires on near-tie scores — can be exercised at
            # real-corpus scale. Every tier is exact; the tiering trades
            # communication only, never correctness.
            force_tier = getattr(self, "_force_tier", None)

            def select(s, f):
                # Tiered reduction (parallel/train.py): certificate-proven
                # two-phase top-K, then exact compacted-runs gather, then
                # full position gather (cap overflow only).
                if force_tier is None:
                    bk, bb, bf, bc, proven = sharded_wp_select_topk(
                        self.mesh, s, f, sym_cap, narrow,
                        cand_cap=cap_local, wide_score=wide_score, w32=w32)
                    if bool(proven):
                        self._sel_stats["proven"] += 1
                        return bk, bb, bf, bc
                    self._topk_fallbacks += 1
                if force_tier != "full":
                    bk, bb, bf, bc, exact = sharded_wp_select_compact(
                        self.mesh, s, f, sym_cap, narrow, run_cap,
                        wide_score=wide_score, w32=w32)
                    if bool(exact):
                        self._sel_stats["compact"] += 1
                        return bk, bb, bf, bc
                self._sel_stats["full"] += 1
                return sharded_wp_select(self.mesh, s, f, sym_cap, narrow,
                                         cand_cap=cap_global,
                                         wide_score=wide_score, w32=w32)

            apply_merge_fn = lambda s, a, b, n: sharded_apply_merge(
                self.mesh, s, a, b, n)
        else:
            sym = jnp.asarray(corpus_arrays.sym)
            freq_dev = jnp.asarray(corpus_arrays.freq)
            cap = _cand_cap(n_pos)
            select = lambda s, f: wp_select(s, f, sym_cap, narrow, cap,
                                            wide_score, w32)
            apply_merge_fn = apply_merge

        if self._resume_dir is not None:
            state_file = os.path.join(self._resume_dir, "wp_state.json")
            with open(state_file, "r", encoding="utf-8") as f:
                state = json.load(f)
            for sa, sb in (tuple(p) for p in state["merges"]):
                a_id = table.get(sa)
                b_id = table.get(sb)
                if a_id is None or b_id is None:
                    raise ValueError(
                        "checkpoint does not match this corpus: unknown "
                        f"symbol in merge ({sa!r}, {sb!r})")
                merged = sa + sb[2:]
                self.vocab.add(merged)
                self._merge_log.append((sa, sb))
                sym = apply_merge_fn(sym, a_id, b_id, table.intern(merged))

        pbar = None
        if self._progress:
            from ..utils import Progress
            pbar = Progress(max_vocab - len(self.vocab),
                            "Training WordPiece")

        fused_done = False
        if self.mesh is None and not getattr(self, "_force_per_step", False):
            from ..ops.train_loop import HashCollision, run_fused

            def on_merge(sa, sb, merged):
                self.vocab.add(merged)
                self._merge_log.append((sa, sb))

            since_ckpt = [0]

            def ckpt_cb(steps):
                since_ckpt[0] += steps
                if since_ckpt[0] >= self._checkpoint_every:
                    since_ckpt[0] = 0
                    self._save_checkpoint()

            try:
                sym = run_fused(
                    sym, freq_dev, table, max_vocab, narrow, True,
                    on_merge, wide_score=wide_score, w32=w32,
                    checkpoint_cb=(ckpt_cb if self._checkpoint_dir
                                   is not None else None),
                    progress_cb=pbar.update if pbar is not None else None)
                fused_done = True
            except HashCollision:
                if pbar is not None:
                    pbar.close()
                self._force_per_step = True
                try:
                    return self.train(
                        corpus, max_vocab,
                        checkpoint_dir=self._checkpoint_dir,
                        checkpoint_every=self._checkpoint_every,
                        resume=self._resume_dir is not None,
                        progress=self._progress)
                finally:
                    self._force_per_step = False

        if not fused_done:
            steps = 0
            while len(self.vocab) < max_vocab:
                best_key, _, _, best_count = select(sym, freq_dev)
                if int(best_count) <= 0:
                    break
                key = int(best_key)
                a_id = key >> bits
                b_id = key & ((1 << bits) - 1)
                sa, sb = table.string(a_id), table.string(b_id)
                merged = sa + sb[2:]
                self.vocab.add(merged)
                self._merge_log.append((sa, sb))
                new_id = table.intern(merged)
                sym = apply_merge_fn(sym, a_id, b_id, new_id)
                steps += 1
                if pbar is not None:
                    pbar.update(1)
                if (self._checkpoint_dir is not None
                        and steps % self._checkpoint_every == 0):
                    self._save_checkpoint()
        if pbar is not None:
            pbar.close()
        if self._checkpoint_dir is not None:
            self._save_checkpoint()

        from ..parallel.distributed import fetch_global
        sym_host = fetch_global(sym)
        self.corpus_as_symbols = [
            ([table.string(int(s)) for s in row if s >= 0], int(f))
            for row, f in zip(sym_host, corpus_arrays.freq)
        ]

    # ------------------------------------------------------------ encoding

    def encode_word(self, word: str) -> List[str]:
        """Greedy longest-prefix encoding
        (reference: source/wordpiece.py:131-158).

        Guarded against the reference's non-termination pathology: with
        ``"#"`` in the vocabulary but ``"##"`` absent, the remainder can
        grow by one '#' per step forever; we raise instead of hanging.
        """
        tokens: List[str] = []
        limit = 4 * len(word) + 64
        steps = 0
        while len(word) > 0:
            steps += 1
            if steps > limit:
                raise RuntimeError(
                    "greedy WordPiece encoding does not terminate on "
                    f"{word[:16]!r}... with this vocabulary (the reference "
                    "implementation would hang here)")
            i = len(word)
            while i > 0 and word[:i] not in self.vocab:
                i -= 1
            if i == 0:
                return [UNK]
            tokens.append(word[:i])
            word = word[i:]
            if len(word) > 0:
                word = f"##{word}"
        return tokens

    def tokenize(self, text: str) -> List[str]:
        """Tokenize one sentence (reference: source/wordpiece.py:160-179)."""
        if not isinstance(text, str):
            raise TypeError("Text to tokenize must be a string.")
        pre = self.preprocessing([text])[0]
        cache = self._encode_cache
        out: List[str] = []
        for word, _ in pre:
            toks = cache.get(word)
            if toks is None:
                toks = self.encode_word(word)
                cache[word] = toks
            out.extend(toks)
        return out

    # ------------------------------------------------- batched device path

    def _build_match_trie(self):
        if self._match_trie is None:
            from ..core.dispatch import DeviceCache
            out = SymbolTable()
            out.intern(UNK)
            trie = MatchTrie.build(sorted(self.vocab), out)
            self._match_trie = trie
            self._match_out = out
            # Model state uploads once per (trie, device).
            self._match_dev = DeviceCache(
                lambda: (trie.goto, trie.accept))
        return self._match_trie, self._match_out

    def _match_inputs(self, words: List[str]):
        """Padded alphabet-id matrix + lengths for the greedy matcher."""
        trie, out_table = self._build_match_trie()
        W = len(words)
        wlen = np.fromiter((len(w) for w in words), dtype=np.int32, count=W)
        # Width rounded to a multiple of 8 for compiled-shape reuse.
        L = -(-max(2, int(wlen.max()) if W else 1) // 8) * 8
        flat = trie.alpha[codepoints("".join(words))]
        wmat = np.full((W, L), trie.n_alpha, dtype=np.int32)
        mask = np.arange(L, dtype=np.int32)[None, :] < wlen[:, None]
        wmat[mask] = flat
        return trie, out_table, wmat, wlen

    def _encode_unique_compact(self, words: List[str]):
        """Compact-fetch batched matcher (ops/fetch.py): one device
        program over all slices, dense u16 token stream fetched in two
        calls. Returns (ids, starts, counts, out_table) or None (mesh,
        wide output table, or an overflow row — the legacy path then
        owns the error semantics)."""
        import jax.numpy as jnp

        from ..core.dispatch import scan_device
        from ..ops.fetch import fetch_compact, stack_sorted
        from ..ops.wp_encode import wp_match_encode_stacked

        if self.mesh is not None or not words:
            return None
        trie, out_table, wmat, wlen = self._match_inputs(words)
        if (len(out_table.strings()) >= (1 << 16)
                # Small batches belong on the host executor (legacy
                # sliced path); see core/dispatch.py.
                or scan_device(int(wmat.size)) is not None):
            return None
        goto_dev, accept_dev = self._match_dev.get(None)
        (wmat_s, wlen_s), order, pad, B, sr = stack_sorted(
            (wmat, wlen), (trie.n_alpha, 0), wlen)
        # Static id-prefix: 6 tokens/word covers real vocabularies; an
        # overflow only costs a second fetch (ops/fetch.fetch_compact).
        nq = min(6 * B * sr, B * sr * (wmat_s.shape[2] + 4))
        with profiling.phase("encode.scan_dispatch"):
            pref_d, ids_d, out_n_d, flags_d, total_d = \
                wp_match_encode_stacked(
                    jnp.asarray(wmat_s), jnp.asarray(wlen_s), goto_dev,
                    accept_dev, int(trie.alpha[ord("#")]), nq)
        with profiling.phase("encode.scan_fetch"):
            got = fetch_compact(pref_d, ids_d, out_n_d, flags_d, total_d,
                                order, pad)
        if got is None:
            return None
        ids, starts, counts = got
        return ids, starts, counts, out_table

    def _encode_unique_raw(self, words: List[str]):
        """Batched greedy longest-match to a token-id matrix.

        Returns (out i32[W, CAP], out_n i32[W], out_table) — UNK rows are
        already substituted (single token id 0 == UNK). Raises the
        reference-hang guard on overflow."""
        import contextlib

        import jax
        from ..core.batching import sliced_rows
        from ..core.dispatch import scan_device
        from ..ops.wp_encode import wp_match_encode

        trie, out_table, wmat, wlen = self._match_inputs(words)
        W = len(words)
        dev = scan_device(int(wmat.size), self.mesh)
        goto_dev, accept_dev = self._match_dev.get(dev)
        ctx = jax.default_device(dev) if dev is not None else \
            contextlib.nullcontext()
        hash_aid = int(trie.alpha[ord("#")])

        def fn(wm, wl):
            return wp_match_encode(wm, wl, goto_dev, accept_dev, hash_aid)

        with ctx:
            out, out_n, unk, ovf = sliced_rows(
                fn, (wmat, wlen), (trie.n_alpha, 0), wlen, 4)
        if bool(np.asarray(ovf).any()):
            raise RuntimeError(
                "wp_match_encode overflow: vocabulary drives the greedy "
                "matcher into unbounded '#' growth (the reference would "
                "not terminate on this input)")
        unk = np.asarray(unk)
        out = np.ascontiguousarray(out)
        out_n = np.asarray(out_n).copy()
        if unk.any():
            out[unk, 0] = 0  # UNK interned first in _build_match_trie
            out_n[unk] = 1
        return out, out_n, out_table

    def _encode_unique_device(self, words: List[str]) -> List[List[str]]:
        out, out_n, out_table = self._encode_unique_raw(words)
        return [[out_table.string(int(t)) for t in out[i, :out_n[i]]]
                for i in range(len(words))]

    def tokenize_batch(self, corpus: List[str]) -> List[List[str]]:
        """Corpus tokenization through the batched device encoder; the
        per-sentence token lists are assembled by the native stitch."""
        wb = self.preprocessing_batch(corpus)
        words, _, inverse = unique_words(wb)
        S = len(corpus)
        from .._native.binding import try_load
        binding = try_load()
        if binding is not None:
            bounds = np.searchsorted(
                wb.sent_id, np.arange(S + 1)).astype(np.int64)
            compact = self._encode_unique_compact(words)
            if compact is not None:
                ids, starts, counts, out_table = compact
                return binding.stitch_flat(out_table.strings(), ids,
                                           starts, counts,
                                           inverse.astype(np.int32),
                                           bounds)
            out, out_n, out_table = self._encode_unique_raw(words)
            return binding.stitch(out_table.strings(), out, out_n,
                                  inverse.astype(np.int32), bounds)
        encoded = self._encode_unique_device(words)
        out2: List[List[str]] = [[] for _ in range(S)]
        for occ in range(wb.n_words):
            out2[int(wb.sent_id[occ])].extend(encoded[inverse[occ]])
        return out2

    # ------------------------------------------------------------- state io

    def reset(self) -> None:
        """Reset all learned state (reference: source/wordpiece.py:181-184)."""
        self.vocab.clear()
        self.corpus_as_symbols.clear()
        self._encode_cache = {}
        self._match_trie = None
        self._match_out = None

    def save_resources(self, path: str) -> None:
        """Write ``vocab.json`` (reference format,
        source/wordpiece.py:186-196); atomic like NaiveBPE."""
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, "vocab.json")
        tmp = target + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(list(self.vocab), f, ensure_ascii=False)
        os.replace(tmp, target)

    def load_resources(self, path: str, strict: bool = False) -> None:
        """Load ``vocab.json``. A missing file is a silent no-op for
        parity (reference quirk: source/wordpiece.py:198-208); pass
        ``strict=True`` for a FileNotFoundError instead."""
        vocab_file = os.path.join(path, "vocab.json")
        if os.path.isfile(vocab_file):
            with open(vocab_file, "r", encoding="utf-8") as f:
                self.vocab = set(json.load(f))
            self._encode_cache = {}
            self._match_trie = None
            self._match_out = None
        elif strict:
            raise FileNotFoundError(vocab_file)


class FastWP(NaiveWP):
    """End-to-end WordPiece: linear-time trie scan with punctuation-aware
    boundaries (reference: source/wordpiece.py:211-330)."""

    def __init__(self, tokenizer: Optional[object] = None,
                 mesh: Optional[object] = None) -> None:
        super().__init__(tokenizer, mesh)
        self._e2e_trie: Optional[E2ETrie] = None
        self._e2e_out: Optional[SymbolTable] = None
        self._sharp_seq: Optional[Tuple[int, ...]] = None
        self._unk_id: Optional[int] = None
        self._packed_cache = None

    # ------------------------------------------------------------ training

    def train(self, corpus, max_vocab: int = 30_000, **kwargs) -> None:
        super().train(corpus, max_vocab, **kwargs)
        self._build_e2e()

    def _build_e2e(self):
        out = SymbolTable()
        self._unk_id = out.intern(UNK_E2E)
        trie = E2ETrie.build(self.vocab, out)
        # Corner case constant: NaiveWP encoding of "##"
        # (reference: source/wordpiece.py:260-261). May be non-terminating
        # for pathological vocabularies (see encode_word); poison it so the
        # error only fires if the corner case is actually reached.
        try:
            self._sharp_seq = tuple(out.intern(t)
                                    for t in NaiveWP.encode_word(self, "##"))
        except RuntimeError:
            self._sharp_seq = None
        self._e2e_trie = trie
        self._e2e_out = out
        return trie, out

    def _trie(self):
        if self._e2e_trie is None:
            self._build_e2e()
        return self._e2e_trie, self._e2e_out

    # ------------------------------------------------------------ encoding

    def tokenize(self, text: str) -> List[str]:
        """Single-sentence end-to-end scan on host
        (semantics: source/wordpiece.py:233-316)."""
        if not isinstance(text, str):
            raise TypeError("Text to tokenize must be a string.")
        trie, out_table = self._trie()
        s = text.lower() + " "
        cps = codepoints(s)
        n = len(cps)
        is_sp = WS_PY[cps]
        is_pc = PUNC_PY[cps]
        keys, vals = trie.edge_keys, trie.edge_vals
        fail, pops_off, pops_flat = trie.fail, trie.pops_off, trie.pops_flat
        roots = {0, trie.root_sharp, trie.root_p}

        def goto(node: int, cp: int) -> int:
            key = (node << 21) | cp
            j = np.searchsorted(keys, key)
            if j < len(keys) and keys[j] == key:
                return int(vals[j])
            return -1

        def boundary(i: int) -> bool:
            if i > 0 and is_pc[i - 1]:
                return True
            if i >= n:
                # Reachable only when a whitespace-bearing vocab token lets
                # the matchloop consume the trailing space: the reference's
                # iswdbndry then evaluates seq[len(seq)] and crashes
                # (source/wordpiece.py:285 — `i > len(seq)` is False at
                # i == len(seq), short-circuit falls through to seq[i]).
                raise RuntimeError(
                    "word-boundary check at end of input (the reference "
                    "implementation would crash with IndexError here)")
            return bool(is_sp[i] or is_pc[i])

        result: List[str] = []
        i = 0
        while i < n:
            iter_start = i
            # match loop
            node = 0
            seg: List[int] = []
            while i < n:
                child = goto(node, int(cps[i]))
                while child < 0:
                    f = int(fail[node])
                    if f < 0:
                        break
                    seg.extend(int(t) for t in
                               pops_flat[pops_off[node]:pops_off[node + 1]])
                    node = f
                    child = goto(node, int(cps[i]))
                if child < 0:
                    break
                node = child
                i += 1
            # validate
            if not boundary(i) or node not in roots:
                seg = [self._unk_id]
            elif node == trie.root_sharp and not seg:
                if self._sharp_seq is None:
                    raise RuntimeError(
                        "encode_word('##') does not terminate with this "
                        "vocabulary (reference would hang on this input)")
                seg = list(self._sharp_seq)
            result.extend(out_table.string(t) for t in seg)
            while i < n and not boundary(i):
                i += 1
            while i < n and is_sp[i]:
                i += 1
            if i == iter_start:
                # A char that is punctuation-class (Python: not alnum, not
                # space) but absent from the trie re-enters the exact same
                # state forever — the reference implementation hangs here
                # (source/wordpiece.py:251-269); we refuse instead.
                raise RuntimeError(
                    "end-to-end scan makes no progress at "
                    f"{s[i]!r} (position {i}); the reference "
                    "implementation would hang on this input")
        return result

    def tokenize_batch(self, corpus: List[str]) -> List[List[str]]:
        """Batched device end-to-end scan.

        Default path exploits two structural facts for throughput: the
        scan automaton can never cross a whitespace character (no vocab
        token contains one — the matchloop has no whitespace edge, SKIP
        stops at spaces, and the boundary lookback across a space sees a
        non-punct char), so sentences decompose into independent
        whitespace-delimited chunks; and chunks repeat Zipf-style, so only
        *unique* chunks are scanned. Falls back to the whole-sentence scan
        when the vocabulary does contain whitespace-bearing tokens.
        """
        trie, _ = self._trie()
        if trie.has_ws_token:
            return self._tokenize_batch_sentences(corpus)
        return self._tokenize_batch_chunked(corpus)

    def _run_e2e_packed(self, cps, slen, raw: bool = False):
        """Packed scan (ops/wp_encode_e2e.py): packed char/node
        tables, one scatter per step. Used by the chunked path.
        ``raw=True`` skips host string materialization and returns
        (out_ids, out_n, out_table) for the native stitch."""
        import contextlib

        import jax
        from ..ops.wp_encode_e2e import pack_chars, pack_node_info

        trie, out_table = self._trie()
        n_pops = max(trie.max_pops, 1)
        if n_pops > 8:
            return self._run_e2e(cps, slen, raw)
        if getattr(self, "_packed_cache", None) is None or \
                self._packed_cache[0] is not trie:
            # Model state uploads once per (trie, device) — the goto table
            # is tens of MB and must not travel to the device per call.
            from ..core.dispatch import DeviceCache
            info = pack_node_info(trie.fail, trie.pops_off, trie.pops_flat,
                                  n_pops)
            self._packed_cache = (trie,
                                  DeviceCache(lambda: (info, trie.goto)))
        dev_cache = self._packed_cache[1]
        sharp_seq = self._sharp_seq if self._sharp_seq is not None else (-2,)
        pchar = pack_chars(trie.alpha[cps], WS_PY[cps], PUNC_PY[cps])
        slen32 = slen.astype(np.int32)
        # wp_e2e_scan contract: slen < T for every row (the boundary check
        # at i == slen reads the packed char there).
        assert cps.shape[1] > int(slen32.max(initial=0)), \
            "wp_e2e_scan rows must be padded past slen"
        if self.mesh is not None:
            # Row-parallel encode across the data mesh; model state
            # (goto/node tables) is replicated.
            from ..parallel.encode import (pad_rows, put_sharded,
                                           sharded_e2e_scan)
            node_info, goto_dev = dev_cache.get(None)
            pchar_p, slen_p, n_real = pad_rows(self.mesh, pchar, slen32)
            pchar_d, slen_d = put_sharded(self.mesh, pchar_p, slen_p)
            out, out_n, ovf, stuck, crash = sharded_e2e_scan(
                self.mesh, pchar_d, slen_d, goto_dev, node_info,
                trie.root_p, trie.root_sharp, self._unk_id,
                sharp_seq, n_pops)
            out = out[:n_real]
            out_n = out_n[:n_real]
            ovf = ovf[:n_real]
            stuck = stuck[:n_real]
            crash = crash[:n_real]
        else:
            # Latency-aware dispatch: tiny scans run on the host CPU
            # backend (bit-identical program; see core/dispatch.py); the
            # sliced driver sorts rows by length and dispatches
            # fixed-shape slices asynchronously.
            from ..core.dispatch import scan_device
            from ..ops.wp_encode_e2e import sliced_e2e_scan
            dev = scan_device(int(pchar.size))
            node_info, goto_dev = dev_cache.get(dev)
            ctx = jax.default_device(dev) if dev is not None else \
                contextlib.nullcontext()
            with ctx:
                out, out_n, ovf, stuck, crash = sliced_e2e_scan(
                    pchar, slen32, goto_dev, node_info,
                    trie.root_p, trie.root_sharp, self._unk_id,
                    sharp_seq, n_pops, trie.n_alpha)
        return self._finish_e2e(out, out_n, ovf, stuck, crash, out_table,
                                raw)

    def _finish_e2e(self, out, out_n, ovf, stuck, crash, out_table,
                    raw: bool = False):
        import jax
        # One batched device->host fetch instead of one per array.
        out, out_n, ovf, stuck, crash = jax.device_get(
            (out, out_n, ovf, stuck, crash))
        if bool(crash.any()):
            idx = np.flatnonzero(crash)[:5].tolist()
            raise RuntimeError(
                "word-boundary check at end of input on row(s) "
                f"{idx} (the reference implementation would crash with "
                "IndexError here)")
        if bool(stuck.any()):
            idx = np.flatnonzero(stuck)[:5].tolist()
            raise RuntimeError(
                "end-to-end scan makes no progress on input row(s) "
                f"{idx} — a punctuation-class character absent from the "
                "vocabulary; the reference implementation would hang on "
                "these inputs")
        if bool(ovf.any()):
            raise RuntimeError("wp_e2e_encode output buffer overflow")
        if self._sharp_seq is None and bool((out == -2).any()):
            raise RuntimeError(
                "encode_word('##') does not terminate with this vocabulary "
                "(reference would hang on this input)")
        if raw:
            return out, out_n, out_table
        width = max(int(out_n.max()), 1) if out_n.size else 1
        out = out[:, :width]
        strs = np.asarray(out_table.strings(), dtype=object)
        return strs[out], out_n

    def _run_e2e(self, cps, slen, raw: bool = False):
        """Run the device automaton on padded codepoint rows; returns
        (token-string object-array rows, counts), or with ``raw=True``
        (out_ids, out_n, out_table)."""
        import jax.numpy as jnp
        from ..ops.wp_encode import wp_e2e_encode

        trie, out_table = self._trie()
        is_sp = WS_PY[cps]
        is_pc = PUNC_PY[cps]
        acp = trie.alpha[cps]
        sharp_seq = self._sharp_seq if self._sharp_seq is not None else (-2,)
        out, out_n, ovf, stuck, crash = wp_e2e_encode(
            jnp.asarray(acp), jnp.asarray(is_sp), jnp.asarray(is_pc),
            jnp.asarray(slen), jnp.asarray(trie.goto),
            jnp.asarray(trie.fail), jnp.asarray(trie.pops_off),
            jnp.asarray(trie.pops_flat),
            trie.root_p, trie.root_sharp, self._unk_id,
            sharp_seq, max(trie.max_pops, 1))
        return self._finish_e2e(out, out_n, ovf, stuck, crash, out_table,
                                raw)

    def _tokenize_batch_chunked(self, corpus: List[str]) -> List[List[str]]:
        if len(corpus) == 0:
            return []
        # Fused native path: one C++ pass lowers, splits, dedups and
        # builds sentence bounds; a second packs unique chunks directly
        # into the u16 wire matrix — the lowered text never exists as a
        # Python object (see _native/encode_prep.cpp).
        fused = self._try_fused_chunked(corpus)
        if fused is not None:
            return fused
        # Sentence-level dedup: repeated sentences (common in batch
        # workloads) tokenize once; duplicate slots get independent list
        # copies (the reference returns a fresh list per sentence, and
        # callers may mutate rows).
        seen: Dict[str, int] = {}
        order: List[str] = []
        backmap = np.empty(len(corpus), dtype=np.int64)
        for i, s in enumerate(corpus):
            j = seen.get(s)
            if j is None:
                j = len(order)
                seen[s] = j
                order.append(s)
            backmap[i] = j
        if len(order) < len(corpus):
            uniq = self._tokenize_batch_chunked(order)
            used = np.zeros(len(order), dtype=bool)
            out: List[List[str]] = []
            for j in backmap:
                out.append(list(uniq[j]) if used[j] else uniq[j])
                used[j] = True
            return out

        S = len(corpus)
        from ..frontend.charclass import lower_codepoints
        flat = lower_codepoints(" ".join(corpus))
        if flat is not None:
            lens = np.fromiter((len(s) for s in corpus), dtype=np.int64,
                               count=S)
        else:
            # Case special (U+0130 / final sigma): exact Python lower.
            lowered = [s.lower() for s in corpus]
            flat = codepoints(" ".join(lowered))
            lens = np.fromiter((len(s) for s in lowered), dtype=np.int64,
                               count=S)
        if flat.size == 0:
            return [[] for _ in range(S)]
        sent_start = np.zeros(S, dtype=np.int64)
        np.cumsum(lens[:-1] + 1, out=sent_start[1:])

        from .._native.binding import try_load
        native = try_load()
        if native is not None:
            # One native pass: split + content dedup (exact, memcmp-
            # verified); only unique chunks get padded and scanned.
            inverse, chunk_start, uniq_start, uniq_len = \
                native.chunk_unique(flat)
            if chunk_start.size == 0:
                return [[] for _ in range(S)]
            sid = np.searchsorted(sent_start, chunk_start,
                                  side="right") - 1
            # +2 for the trailing space + boundary lookback; rounded to a
            # multiple of 8 so compiled scan shapes repeat across corpora.
            Lc = -(-(int(uniq_len.max()) + 2) // 8) * 8
            flatp = np.concatenate([flat, np.full(Lc, 32, np.uint32)])
            take = uniq_start[:, None] + np.arange(Lc,
                                                   dtype=np.int64)[None, :]
            umask = (np.arange(Lc, dtype=np.int32)[None, :]
                     < uniq_len[:, None])
            umat = np.where(umask, flatp[take], np.uint32(32))
            uslen = uniq_len + 1  # + trailing space
            n_uniq = uniq_len.size
            return self._scan_and_stitch(umat, uslen, inverse, sid, S,
                                         n_uniq)

        sp = WS_PY[flat]
        keep = ~sp
        prev_sp = np.empty_like(sp)
        prev_sp[0] = True
        prev_sp[1:] = sp[:-1]
        starts = np.flatnonzero(keep & prev_sp)
        if starts.size == 0:
            return [[] for _ in range(S)]
        sp_pos = np.flatnonzero(sp)
        if sp_pos.size:
            idx = np.searchsorted(sp_pos, starts)
            ends = np.where(idx < sp_pos.size,
                            sp_pos[np.minimum(idx, sp_pos.size - 1)],
                            flat.size)
        else:
            # single whitespace-free chunk
            ends = np.full(starts.shape, flat.size, dtype=np.int64)
        sid = np.searchsorted(sent_start, starts, side="right") - 1

        # pad chunks (+1 trailing space, reference: wordpiece.py:248, and
        # +1 more so the boundary lookback at i == slen stays in range;
        # rounded to a multiple of 8 for compiled-shape reuse)
        clen = (ends - starts).astype(np.int32)
        Lc = -(-(int(clen.max()) + 2) // 8) * 8
        C = starts.size
        flatp = np.concatenate([flat, np.full(Lc, 32, np.uint32)])
        take = starts[:, None] + np.arange(Lc, dtype=np.int64)[None, :]
        mask = np.arange(Lc, dtype=np.int32)[None, :] < clen[:, None]
        cmat = np.where(mask, flatp[take], np.uint32(32))

        # Dedup rows: wrapping-u64 rolling hash -> np.unique on the keys,
        # then an exact full-row verification (collision -> exact fallback).
        h = np.zeros(C, dtype=np.uint64)
        B = np.uint64(0x9E3779B97F4A7C15)
        cu = cmat.astype(np.uint64)
        with np.errstate(over="ignore"):
            for j in range(Lc):
                h = h * B + cu[:, j]
        _, uidx, inverse = np.unique(h, return_index=True,
                                     return_inverse=True)
        if not np.array_equal(cmat, cmat[uidx][inverse]):
            # astronomically rare hash collision: exact void-row unique
            cm = np.ascontiguousarray(cmat)
            void = cm.view(np.dtype((np.void,
                                     cm.dtype.itemsize * Lc)))[:, 0]
            _, uidx, inverse = np.unique(void, return_index=True,
                                         return_inverse=True)
        umat = cmat[uidx]
        uslen = clen[uidx] + 1  # + trailing space
        return self._scan_and_stitch(umat, uslen, inverse, sid, S,
                                     len(uidx))

    def _try_fused_chunked(self, corpus: List[str]):
        """Fused native chunked encode; None when any precondition fails
        (no toolchain, wide pops/alphabet, or a case-special codepoint
        that needs exact Python ``str.lower()``). Runs under a mesh too:
        the unique chunks are length-sorted and row-sharded over the data
        axis (parallel/encode.sharded_e2e_scan_u16) with the trie
        replicated."""
        trie, out_table = self._trie()
        n_pops = max(trie.max_pops, 1)
        if (n_pops > 8
                or trie.n_alpha >= (1 << 13)
                or not isinstance(corpus, list)
                or not all(isinstance(s, str) for s in corpus)):
            return None  # odd inputs keep the Python path's exact behavior
        from .._native.binding import try_load
        binding = try_load()
        if binding is None:
            return None
        with profiling.phase("encode.native_prep"):
            prep = binding.encode_prep(corpus)
        if prep is None:
            return None
        inverse, bounds, uniq_buf, uniq_off, uniq_len = prep
        S = len(corpus)
        if uniq_len.size == 0:
            return [[] for _ in range(S)]
        # +2 for the trailing space + boundary lookback; rounded to a
        # multiple of 8 so compiled scan shapes repeat across corpora.
        Lc = -(-(int(uniq_len.max()) + 2) // 8) * 8
        with profiling.phase("encode.pack_u16"):
            mat16 = binding.pack_u16_rows(uniq_buf, uniq_off, uniq_len, Lc,
                                          trie.alpha)
        uslen = (uniq_len + 1).astype(np.int32)  # + trailing space
        compact = self._run_e2e_compact(mat16, uslen)
        if compact is not None:
            ids_flat, starts, counts, out_table = compact
            with profiling.phase("encode.stitch"):
                return binding.stitch_flat(out_table.strings(), ids_flat,
                                           starts, counts, inverse, bounds)
        out_ids, out_n, out_table = self._run_e2e_prepacked(mat16, uslen)
        with profiling.phase("encode.stitch"):
            return binding.stitch(out_table.strings(), out_ids, out_n,
                                  inverse, bounds)

    def _run_e2e_compact(self, mat16, uslen):
        """Compact-fetch scan: one device program over all length-sorted
        slices + on-device token-stream compaction
        (ops/wp_encode_e2e.wp_e2e_scan_u16_fused): ONE put (lengths
        packed into the char matrix) and ONE fetch (a static id-stream
        prefix riding with the counts) instead of ~5 MB of padded i32
        over dozens of calls (see ops/fetch.py). Returns (ids i32[n], starts i64[U], counts i32[U],
        out_table), or None when a precondition fails or any row flags
        an error/hang — the caller falls back to the legacy padded path,
        which raises the exact reference-documented errors."""
        import jax
        import jax.numpy as jnp

        from ..core.batching import quantize_rows, slice_rows_for
        from ..ops.wp_encode_e2e import pack_node_info

        from ..core.dispatch import scan_device

        trie, out_table = self._trie()
        if (self.mesh is not None
                or len(out_table.strings()) >= (1 << 16)
                # Small batches routed to the host executor take the
                # legacy sliced path (see core/dispatch.py).
                or scan_device(int(mat16.size)) is not None):
            return None
        n_pops = max(trie.max_pops, 1)
        # _sharp_seq None = the "'##' would hang" marker protocol: the
        # scan emits -2 sentinels for the corner case; any row carrying
        # one sets flag bit 3 and falls back to the legacy path, whose
        # _finish_e2e raises the documented RuntimeError.
        sharp_seq = self._sharp_seq if self._sharp_seq is not None \
            else (-2,)
        if getattr(self, "_packed_cache", None) is None or \
                self._packed_cache[0] is not trie:
            from ..core.dispatch import DeviceCache
            info = pack_node_info(trie.fail, trie.pops_off, trie.pops_flat,
                                  n_pops)
            self._packed_cache = (trie,
                                  DeviceCache(lambda: (info, trie.goto)))
        node_info, goto_dev = self._packed_cache[1].get(None)

        W, Lc = mat16.shape
        if uslen.max(initial=0) >= (1 << 16):
            return None  # length must fit the u16 wire length column
        order = np.argsort(uslen, kind="stable")
        R = quantize_rows(W)
        pad = R - W
        sr = min(R, slice_rows_for(R))
        B = R // sr
        # One-buffer wire format: length packed into the last column, so
        # the put is a single transfer; zero rows scan to DONE.
        mat_p = np.zeros((R, Lc + 1), dtype=np.uint16)
        mat_p[pad:, :Lc] = mat16[order]
        mat_p[pad:, Lc] = uslen[order]
        # Static id-prefix bound: 4 tokens/row covers real text (~2-3);
        # an overflow only costs a second fetch of the full stream.
        nq = min(4 * R, R * (Lc + 4))
        with profiling.phase("encode.scan_dispatch"):
            from ..ops.wp_encode_e2e import wp_e2e_scan_u16_fused
            pref_d, ids_d, out_n_d, flags_d, total_d = \
                wp_e2e_scan_u16_fused(
                    jnp.asarray(mat_p.reshape(B, sr, Lc + 1)),
                    goto_dev, node_info, trie.root_p, trie.root_sharp,
                    self._unk_id, tuple(sharp_seq), n_pops, nq)
        with profiling.phase("encode.scan_fetch"):
            pref, out_n, flags, total = jax.device_get(
                (pref_d, out_n_d, flags_d, total_d))
            if flags.any():
                return None
            total = int(total)
            if total == 0:
                ids = np.zeros(0, dtype=np.int32)
            elif total <= nq:
                ids = np.asarray(pref)[:total].astype(np.int32)
            else:
                # Quantized prefix of the dense stream: pow2 grid bounds
                # the number of compiled slice shapes.
                nq2 = min(R * (Lc + 4),
                          max(4096, 1 << (total - 1).bit_length()))
                ids = np.asarray(
                    jax.device_get(ids_d[:nq2]))[:total].astype(np.int32)
        starts_sorted = np.zeros(R, dtype=np.int64)
        np.cumsum(out_n[:-1], out=starts_sorted[1:])
        starts = np.empty(W, dtype=np.int64)
        counts = np.empty(W, dtype=np.int32)
        starts[order] = starts_sorted[pad:]
        counts[order] = out_n[pad:]
        return ids, starts, counts, out_table

    def _run_e2e_prepacked(self, mat16, uslen):
        """Sliced scan over an already-packed u16 wire matrix (the fused
        native path); same dispatch/caching as :meth:`_run_e2e_packed`."""
        import contextlib

        import jax

        from ..ops.wp_encode_e2e import pack_node_info, sliced_e2e_scan_u16

        trie, out_table = self._trie()
        n_pops = max(trie.max_pops, 1)
        if getattr(self, "_packed_cache", None) is None or \
                self._packed_cache[0] is not trie:
            from ..core.dispatch import DeviceCache
            info = pack_node_info(trie.fail, trie.pops_off, trie.pops_flat,
                                  n_pops)
            self._packed_cache = (trie,
                                  DeviceCache(lambda: (info, trie.goto)))
        dev_cache = self._packed_cache[1]
        sharp_seq = self._sharp_seq if self._sharp_seq is not None else (-2,)
        if self.mesh is not None:
            # Row-sharded scan: length-sort so each shard's lockstep loop
            # exits at its own block's max trip count (blocked sharding
            # over sorted rows = the mesh analogue of sliced_rows), trie
            # replicated, order restored after the fetch.
            from ..parallel.encode import (pad_rows, put_sharded,
                                           sharded_e2e_scan_u16)
            node_info, goto_dev = dev_cache.get(None)
            order = np.argsort(uslen, kind="stable")
            mat_p, len_p, n_real = pad_rows(self.mesh, mat16[order],
                                            uslen[order])
            mat_d, len_d = put_sharded(self.mesh, mat_p, len_p)
            with profiling.phase("encode.scan_dispatch"):
                out, out_n, ovf, stuck, crash = sharded_e2e_scan_u16(
                    self.mesh, mat_d, len_d, goto_dev, node_info,
                    trie.root_p, trie.root_sharp, self._unk_id,
                    sharp_seq, n_pops)
            with profiling.phase("encode.scan_fetch"):
                out, out_n, ovf, stuck, crash = jax.device_get(
                    (out, out_n, ovf, stuck, crash))
            inv = np.empty(uslen.size, dtype=np.int64)
            inv[order] = np.arange(uslen.size, dtype=np.int64)
            out = out[:n_real][inv]
            out_n = out_n[:n_real][inv]
            ovf = ovf[:n_real][inv]
            stuck = stuck[:n_real][inv]
            crash = crash[:n_real][inv]
            return self._finish_e2e(out, out_n, ovf, stuck, crash,
                                    out_table, raw=True)
        from ..core.dispatch import scan_device
        dev = scan_device(int(mat16.size))
        node_info, goto_dev = dev_cache.get(dev)
        ctx = jax.default_device(dev) if dev is not None else \
            contextlib.nullcontext()
        with ctx, profiling.phase("encode.scan_dispatch"):
            out, out_n, ovf, stuck, crash = sliced_e2e_scan_u16(
                mat16, uslen, goto_dev, node_info, trie.root_p,
                trie.root_sharp, self._unk_id, sharp_seq, n_pops)
        with profiling.phase("encode.scan_fetch"):
            return self._finish_e2e(out, out_n, ovf, stuck, crash,
                                    out_table, raw=True)

    def _scan_and_stitch(self, umat, uslen, inverse, sid, S, n_uniq):
        bounds = np.searchsorted(sid, np.arange(S + 1, dtype=sid.dtype))
        from .._native.binding import try_load
        binding = try_load()
        if binding is not None:
            # Native stitch: token-id matrix -> list-of-list-of-str in one
            # C pass (the Python object assembly below is otherwise the
            # single largest cost of the whole encode path).
            out_ids, out_n, out_table = self._run_e2e_packed(
                umat, uslen, raw=True)
            return binding.stitch(out_table.strings(), out_ids, out_n,
                                  inverse, bounds)

        toks, out_n = self._run_e2e_packed(umat, uslen)
        counts = out_n.tolist()
        tok_rows = [toks[i, :counts[i]].tolist() for i in range(n_uniq)]

        # Chunks are in sentence order; group by per-sentence ranges and
        # concatenate at C speed.
        from itertools import chain
        invs = inverse.tolist()
        getter = tok_rows.__getitem__
        return [
            list(chain.from_iterable(map(getter, invs[bounds[i]:
                                                      bounds[i + 1]])))
            for i in range(S)
        ]

    def _tokenize_batch_sentences(self, corpus: List[str]
                                  ) -> List[List[str]]:
        S = len(corpus)
        if S == 0:
            return []
        lowered = [s.lower() + " " for s in corpus]
        flat = codepoints("".join(lowered))
        slen = np.fromiter((len(s) for s in lowered), dtype=np.int32,
                           count=S)
        T = int(slen.max())
        cps = np.full((S, T), 32, dtype=np.uint32)
        mask = np.arange(T, dtype=np.int32)[None, :] < slen[:, None]
        cps[mask] = flat
        toks, out_n = self._run_e2e(cps, slen)
        counts = out_n.tolist()
        return [toks[i, :counts[i]].tolist() for i in range(S)]

    # ------------------------------------------------------------- state io

    def reset(self) -> None:
        super().reset()
        self._e2e_trie = None
        self._e2e_out = None
        self._packed_cache = None

    def load_resources(self, path: str, strict: bool = False) -> None:
        """Load vocab and rebuild the trie
        (reference: source/wordpiece.py:318-324)."""
        super().load_resources(path, strict=strict)
        self._build_e2e()
