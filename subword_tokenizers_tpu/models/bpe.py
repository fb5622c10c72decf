"""BPE tokenizers: NaiveBPE (training + sequential-merge encoding semantics)
and FastBPE (rank-map greedy encoding), on the accelerator.

Semantics are bit-compatible with the reference (source/bpe.py); the
implementation is not a port:

- **Training** runs on device: each merge step is one fused XLA program
  (pair pack → lexicographic sort → run aggregation → exact argmax with
  Counter-order tie-break) followed by a vectorized merge application over
  the whole padded word-type tensor (ops/pairstats.py, ops/merge.py). The
  host only interns the winning pair's strings — string interning is what
  reproduces the reference's set-of-strings vocabulary semantics
  (source/bpe.py:103).
- **Encoding** has a batched device path (`tokenize_batch`) that encodes
  every unique word of a corpus simultaneously (ops/bpe_encode.py), and a
  host path for single sentences. NaiveBPE's "apply every merge in order"
  (source/bpe.py:124-127) is realized as a cursor-monotone greedy loop —
  provably identical output, O(len) instead of O(#merges) per word.

Resource format is byte-compatible: ``merges.json`` = ordered JSON list of
[a, b] pairs (source/bpe.py:167-189); loading a missing file is a silent
no-op like the reference (quirk preserved for CLI parity; see
``strict_resources``).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.corpus import build_bpe_corpus, unique_words
from ..core.symbols import SymbolTable
from .base import SubwordTokenizer

# Training domain ceiling, mirroring MAX_TOKENS_WP (models/wordpiece.py).
# BPE selection is pure integer arithmetic — counts, cumsums and the
# Σ-threshold certificate are exact in i64 far beyond this — so unlike
# WordPiece (whose 2**52 bound is set by the 128-bit exact-double scorer)
# the ceiling here is a conservative shared constant: per-pair counts stay
# < 2**52, every i64 quantity (count sums, Σ t_i over devices, scaled
# certificate bounds) keeps ≥ 11 bits of headroom. The reference has no
# cap (source/bpe.py:50-112); 2**52 symbol occurrences is ~4 PB of text.
MAX_TOKENS_BPE = 1 << 52


def _merge_pass(pair: Tuple[str, str], word: List[str]) -> List[str]:
    """One left-to-right non-overlapping replacement pass
    (reference semantics: source/bpe.py:25-48)."""
    merged = pair[0] + pair[1]
    out: List[str] = []
    i, n = 0, len(word)
    while i < n:
        if i < n - 1 and word[i] == pair[0] and word[i + 1] == pair[1]:
            out.append(merged)
            i += 2
        else:
            out.append(word[i])
            i += 1
    return out


class NaiveBPE(SubwordTokenizer):
    """BPE with the reference's naive-encoder semantics, trained on device."""

    def __init__(self, tokenizer: Optional[object] = None,
                 mesh: Optional[object] = None) -> None:
        """``mesh``: optional 1-D jax Mesh with a 'data' axis — training
        then shards word types across its devices (parallel/train.py)
        with bit-identical results to the single-device path."""
        super().__init__(tokenizer)
        self.mesh = mesh
        self.merges_list: List[Tuple[str, str]] = []
        self.vocab: set = set()
        self.corpus_as_symbols: List[Tuple[List[str], int]] = []
        self._encode_cache: Dict[str, List[str]] = {}
        self._device_tables = None
        self._alt_cache = None
        self._host_ranks: Optional[Dict[Tuple[str, str], int]] = None
        self._has_dups: Optional[bool] = None
        self._checkpoint_dir: Optional[str] = None
        self._checkpoint_every = 1000
        self._resume_dir: Optional[str] = None
        self._progress = False

    # ------------------------------------------------------------ training

    def train(self, corpus: List[str], max_vocab: int = 30_000, *,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 1000, resume: bool = False,
              progress: bool = False) -> None:
        """Learn merges until the vocabulary reaches ``max_vocab``
        (reference: source/bpe.py:50-112). Runs the merge loop on device.

        Extensions beyond the reference signature (keyword-only):
        ``checkpoint_dir`` periodically writes ``merges.json`` (every
        ``checkpoint_every`` merges, atomically) so an interrupted run can
        continue with ``resume=True`` — the checkpointed merges are
        replayed over the rebuilt corpus, reproducing the exact state.
        ``progress`` reports merges done on stderr, like the reference's
        progress bar.
        """
        if not isinstance(corpus, list) or not all(
                isinstance(example, str) for example in corpus):
            raise TypeError("Corpus must be a list of strings.")
        if not isinstance(max_vocab, int):
            raise TypeError("Maximum vocabulary size must be an integer.")

        self.reset()
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_every = max(int(checkpoint_every), 1)
        self._resume_dir = checkpoint_dir if resume else None
        self._progress = progress

        wb = self.preprocessing_batch(corpus)
        words, freq, _ = unique_words(wb)
        for w in words:
            self.vocab.update(w)

        if not words:
            return

        total_tokens = int((np.array([len(w) for w in words],
                                     dtype=np.int64) * freq).sum())
        if total_tokens >= MAX_TOKENS_BPE:
            raise ValueError(
                "corpus exceeds the exact-selection domain "
                f"({total_tokens} symbol occurrences >= 2**52)")

        import jax.numpy as jnp
        from ..ops.merge import apply_merge
        from ..ops.pairstats import bpe_select

        table = SymbolTable()
        corpus_arrays = build_bpe_corpus(words, freq, table)
        # i32 fast path: every id this run can mint stays < 2^16 and all
        # positions/weights fit i32 (see ops/pairstats.py). Under a mesh
        # the row count includes the shard-divisibility padding.
        n_dev = self.mesh.devices.size if self.mesh is not None else 0
        n_pos = (corpus_arrays.sym.shape[0] + n_dev) * max(
            corpus_arrays.sym.shape[1] - 1, 1)
        narrow = (max_vocab + len(table) + 8 < (1 << 16)
                  and total_tokens < 2**31 and n_pos < 2**31)
        # i32 weights whenever the total fits — with wide keys the run
        # aggregation still scans i32 (ops/pairstats docstring).
        w32 = total_tokens < 2**31
        bits = 16 if narrow else 21
        if self.mesh is not None:
            from ..parallel.train import (rows_per_device, run_gather_cap,
                                          shard_corpus,
                                          sharded_apply_merge,
                                          sharded_bpe_select,
                                          sharded_bpe_select_compact,
                                          sharded_bpe_select_topk)
            sym, freq_dev = shard_corpus(self.mesh, corpus_arrays.sym,
                                         corpus_arrays.freq)
            run_cap = run_gather_cap(n_pos // max(n_dev, 1))
            self._shard_rows = rows_per_device(sym)
            self._sel_stats = {"proven": 0, "compact": 0, "full": 0}
            self._topk_fallbacks = 0  # steps not settled by the certificate

            # Testing/validation knob: pin the selection to one tier
            # ('compact' | 'full') so the exact fallback tiers can be
            # exercised at real-corpus scale (every tier is exact — the
            # tiering trades communication only, never correctness).
            force_tier = getattr(self, "_force_tier", None)

            def select(s, f):
                # Tiered reduction (parallel/train.py): two-phase top-K
                # (O(K*D) comm) when the Σ-threshold certificate proves
                # the winner; exact compacted-runs gather (O(distinct*D))
                # otherwise; full position gather only if a shard's
                # distinct-run cap overflows.
                if force_tier is None:
                    bk, bc, bf, proven = sharded_bpe_select_topk(
                        self.mesh, s, f, narrow, w32=w32)
                    if bool(proven):
                        self._sel_stats["proven"] += 1
                        return bk, bc, bf
                    self._topk_fallbacks += 1
                if force_tier != "full":
                    bk, bc, bf, exact = sharded_bpe_select_compact(
                        self.mesh, s, f, narrow, run_cap, w32=w32)
                    if bool(exact):
                        self._sel_stats["compact"] += 1
                        return bk, bc, bf
                self._sel_stats["full"] += 1
                return sharded_bpe_select(self.mesh, s, f, narrow,
                                          w32=w32)

            apply_ = lambda s, a, b, n: sharded_apply_merge(self.mesh, s,
                                                            a, b, n)
        else:
            sym = jnp.asarray(corpus_arrays.sym)
            freq_dev = jnp.asarray(corpus_arrays.freq)
            select = lambda s, f: bpe_select(s, f, narrow, w32)
            apply_ = apply_merge

        if self._resume_dir is not None:
            # Mid-training resume: replay checkpointed merges over the
            # rebuilt corpus (training is deterministic, so replay
            # reproduces the exact interrupted state; SURVEY.md §5).
            ckpt = NaiveBPE()
            ckpt.load_resources(self._resume_dir, strict=True)
            for sa, sb in ckpt.merges_list:
                a_id = table.get(sa)
                b_id = table.get(sb)
                if a_id is None or b_id is None:
                    raise ValueError(
                        "checkpoint does not match this corpus: unknown "
                        f"symbol in merge ({sa!r}, {sb!r})")
                merged = sa + sb
                self.vocab.add(merged)
                self.merges_list.append((sa, sb))
                sym = apply_(sym, a_id, b_id, table.intern(merged))

        pbar = None
        if self._progress:
            from ..utils import Progress
            pbar = Progress(max_vocab - len(self.vocab), "Training BPE")

        fused_done = False
        if self.mesh is None and not getattr(self, "_force_per_step", False):
            from ..ops.train_loop import HashCollision, run_fused

            def on_merge(sa, sb, merged):
                self.vocab.add(merged)
                self.merges_list.append((sa, sb))

            since_ckpt = [0]

            def ckpt_cb(steps):
                since_ckpt[0] += steps
                if since_ckpt[0] >= self._checkpoint_every:
                    since_ckpt[0] = 0
                    self.save_resources(self._checkpoint_dir)

            try:
                sym = run_fused(
                    sym, freq_dev, table, max_vocab, narrow, False,
                    on_merge, w32=w32,
                    checkpoint_cb=(ckpt_cb if self._checkpoint_dir
                                   is not None else None),
                    progress_cb=pbar.update if pbar is not None else None)
                fused_done = True
            except HashCollision:
                # Astronomically rare double-hash collision: redo the
                # whole run with the exact per-step loop.
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
                best_key, best_count, _ = select(sym, freq_dev)
                if int(best_count) <= 0:
                    break
                key = int(best_key)
                a_id = key >> bits
                b_id = key & ((1 << bits) - 1)
                sa, sb = table.string(a_id), table.string(b_id)
                merged = sa + sb
                self.vocab.add(merged)
                self.merges_list.append((sa, sb))
                new_id = table.intern(merged)
                sym = apply_(sym, a_id, b_id, new_id)
                steps += 1
                if pbar is not None:
                    pbar.update(1)
                if (self._checkpoint_dir is not None
                        and steps % self._checkpoint_every == 0):
                    self.save_resources(self._checkpoint_dir)
        if pbar is not None:
            pbar.close()
        if self._checkpoint_dir is not None:
            self.save_resources(self._checkpoint_dir)

        # Keep a host-side view of the final corpus state for parity with
        # the reference's `corpus_as_symbols` (source/bpe.py:23).
        from ..parallel.distributed import fetch_global
        sym_host = fetch_global(sym)[:len(corpus_arrays.freq)]
        self.corpus_as_symbols = [
            ([table.string(int(s)) for s in row if s >= 0], int(f))
            for row, f in zip(sym_host, corpus_arrays.freq)
        ]

    # ------------------------------------------------------------ encoding

    def _ranks_first(self) -> Dict[Tuple[str, str], int]:
        """First-occurrence rank map, cached (invalidated alongside
        _device_tables on reset/load/train)."""
        if self._host_ranks is None:
            ranks: Dict[Tuple[str, str], int] = {}
            for i, p in enumerate(self.merges_list):
                ranks.setdefault(p, i)
            self._host_ranks = ranks
        return self._host_ranks

    def _has_duplicate_merges(self) -> bool:
        if self._has_dups is None:
            self._has_dups = (len(set(self.merges_list))
                              != len(self.merges_list))
        return self._has_dups

    def _encode_symbols(self, word: str) -> List[str]:
        """Host encoder with NaiveBPE semantics (cursor-monotone greedy;
        falls back to the literal sequential scan if the merge list
        contains duplicate pairs, where the shortcut does not apply)."""
        symbols = list(word)
        if self._has_duplicate_merges():
            for pair in self.merges_list:
                symbols = _merge_pass(pair, symbols)
            return symbols
        ranks = self._ranks_first()
        cursor = 0
        while len(symbols) > 1:
            best = None
            best_rank = None
            for i in range(len(symbols) - 1):
                r = ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and r >= cursor and (
                        best_rank is None or r < best_rank):
                    best_rank, best = r, (symbols[i], symbols[i + 1])
            if best is None:
                break
            symbols = _merge_pass(best, symbols)
            cursor = best_rank + 1
        return symbols

    def encode_word(self, word: str) -> List[str]:
        """Encode one word; continuations get '##' prefixes
        (reference: source/bpe.py:114-132)."""
        symbols = self._encode_symbols(word)
        if len(symbols) > 1:
            symbols[1:] = ["##" + s for s in symbols[1:]]
        return symbols

    def tokenize(self, text: str) -> List[str]:
        """Tokenize one sentence (reference: source/bpe.py:134-158)."""
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

    def _build_device_tables(self):
        """Rank hash table for the device encoder; cached per device."""
        if self._device_tables is not None:
            return self._device_tables
        from ..core.dispatch import DeviceCache
        from ..ops.bpe_encode import build_rank_hash
        from ..ops.pairstats import SYM_BITS

        table = SymbolTable()
        entries = []  # (key, rank, out_id)
        for pair, rank in self._rank_map().items():
            a = table.intern(pair[0])
            b = table.intern(pair[1])
            out = table.intern(pair[0] + pair[1])
            entries.append(((a << SYM_BITS) | b, rank, out))
        hkeys, hrank, hout, max_probe = build_rank_hash(entries)
        self._device_tables = (table,
                               DeviceCache(lambda: (hkeys, hrank, hout)),
                               max_probe)
        return self._device_tables

    def _rank_map(self) -> Dict[Tuple[str, str], int]:
        return self._ranks_first()

    _MONOTONE = True

    def _encode_inputs(self, words: List[str]):
        """Padded symbol-id matrix + lengths for the merge-loop encoder,
        or None when this vocabulary needs the exact host fallback
        (duplicate merge pairs, where dict-rank overwrite semantics
        apply)."""
        if self._has_duplicate_merges():
            return None
        table, dev_cache, max_probe = self._build_device_tables()
        max_len = max((len(w) for w in words), default=1)
        W = len(words)
        # Width rounded to a multiple of 8 so compiled shapes repeat
        # across corpora (extra columns are PAD).
        Lq = -(-max(max_len, 2) // 8) * 8
        sym = np.full((W, Lq), -1, dtype=np.int32)
        for i, w in enumerate(words):
            for j, ch in enumerate(w):
                sid = table.get(ch)
                if sid is None:
                    # Unseen char: fresh id, participates in no merge.
                    sid = table.intern(ch)
                sym[i, j] = sid
        wlen = np.fromiter((len(w) for w in words), dtype=np.int32,
                           count=W)
        return table, dev_cache, max_probe, sym, wlen

    def _encode_unique_compact(self, words: List[str]):
        """Compact-fetch batched encoder (ops/fetch.py): one device
        program over all slices, dense u16 token stream fetched in two
        calls. Returns (ids, starts, counts, table) or None (mesh,
        duplicate merges, or a wide symbol table — the legacy path
        then applies)."""
        import jax.numpy as jnp

        from ..benchmarks import profiling
        from ..core.dispatch import scan_device
        from ..ops.bpe_encode import bpe_encode_stacked
        from ..ops.fetch import fetch_compact, stack_sorted

        if self.mesh is not None or not words:
            return None
        import os

        import jax
        force = os.environ.get("SWT_COMPACT")
        if force == "0":
            return None
        if force != "1" and jax.default_backend() == "cpu":
            # The compact stream only pays where a transfer link exists:
            # on the local CPU backend the stacked single program runs
            # every slice at the global column width (no per-slice
            # col-quantize) and the scatter+cumsum compaction saves no
            # transfer — measured 0.76x the legacy sliced path for the
            # BPE merge-loop encoder (tools/compact_bisect.py, on the
            # CPU; the WP matchers are a wash on CPU and keep compact
            # on). GPU: not yet measured; compact stays on.
            return None
        inputs = self._encode_inputs(words)
        if inputs is None:
            return None
        table, dev_cache, max_probe, sym, wlen = inputs
        if (len(table) >= (1 << 16)
                # Small batches belong on the host executor (legacy
                # sliced path); see core/dispatch.py.
                or scan_device(int(sym.size)) is not None):
            return None
        hkeys, hrank, hout = dev_cache.get(None)
        (sym_s, _), order, pad, B, sr = stack_sorted(
            (sym, wlen), (-1, 0), wlen)
        # Static id-prefix: 6 tokens/word covers real vocabularies; an
        # overflow only costs a second fetch (ops/fetch.fetch_compact).
        nq = min(6 * B * sr, B * sr * sym_s.shape[2])
        with profiling.phase("encode.scan_dispatch"):
            pref_d, ids_d, out_n_d, flags_d, total_d = bpe_encode_stacked(
                jnp.asarray(sym_s), hkeys, hrank, hout, self._MONOTONE,
                max_probe, nq)
        with profiling.phase("encode.scan_fetch"):
            got = fetch_compact(pref_d, ids_d, out_n_d, flags_d, total_d,
                                order, pad)
        if got is None:
            return None
        ids, starts, counts = got
        return ids, starts, counts, table

    def _encode_unique_raw(self, words: List[str]):
        """Encode unique words to a token-id matrix in one batched call.

        Returns (merged i32[W, L], out_n i32[W], table), or None when
        this vocabulary needs the exact host fallback (duplicate merge
        pairs, where dict-rank overwrite semantics apply)."""
        import contextlib

        import jax
        from ..core.batching import sliced_rows
        from ..core.dispatch import scan_device
        from ..ops.bpe_encode import bpe_encode

        inputs = self._encode_inputs(words)
        if inputs is None:
            return None
        table, dev_cache, max_probe, sym, wlen = inputs
        dev = scan_device(int(sym.size), self.mesh)
        hkeys, hrank, hout = dev_cache.get(dev)
        ctx = jax.default_device(dev) if dev is not None else \
            contextlib.nullcontext()

        def fn(s):
            return (bpe_encode(s, hkeys, hrank, hout, self._MONOTONE,
                               max_probe),)

        with ctx:
            # The merge loop's per-trip cost is O(rows x width): quantize
            # each slice's width to its own max word length too.
            (merged,) = sliced_rows(fn, (sym,), (-1,), wlen, 1,
                                    col_quantize=True, out_col_pad=(-1,))
        out_n = np.count_nonzero(merged >= 0, axis=1).astype(np.int32)
        return merged, out_n, table

    def _encode_unique_device(self, words: List[str]) -> List[List[str]]:
        """Encode unique words as one batched device call (string rows)."""
        raw = self._encode_unique_raw(words)
        if raw is None:
            return [self.encode_word(w) for w in words]
        merged, out_n, table = raw
        results: List[List[str]] = []
        for i in range(len(words)):
            toks = [table.string(int(s)) for s in merged[i, :out_n[i]]]
            if not toks and not self._MONOTONE:
                toks = [""]
            if len(toks) > 1:
                toks[1:] = ["##" + t for t in toks[1:]]
            results.append(toks)
        return results

    def _alt_strings(self, table) -> List[str]:
        """'##'-prefixed rendering per id (continuation positions;
        reference source/bpe.py:129-131), cached per table state."""
        key = (id(table), len(table))
        if self._alt_cache is None or self._alt_cache[0] != key:
            self._alt_cache = (key, ["##" + s for s in table.strings()])
        return self._alt_cache[1]

    def tokenize_batch(self, corpus: List[str]) -> List[List[str]]:
        """Tokenize a corpus through the batched device encoder; output is
        identical to per-sentence `tokenize` but every unique word is
        encoded exactly once, on device, and the per-sentence token lists
        are assembled by the native stitch."""
        wb = self.preprocessing_batch(corpus)
        words, _, inverse = unique_words(wb)
        S = len(corpus)
        from .._native.binding import try_load
        binding = try_load()
        if binding is not None:
            bounds = np.searchsorted(
                wb.sent_id, np.arange(S + 1)).astype(np.int64)
            # Empty rows render as [""] on the FastBPE path (reference
            # source/bpe.py:207-208) — unreachable from the front end
            # (words are non-empty) but routed to the host assembly for
            # exactness.
            compact = self._encode_unique_compact(words)
            if compact is not None and (self._MONOTONE
                                        or not (compact[2] == 0).any()):
                ids, starts, counts, table = compact
                return binding.stitch_flat(table.strings(), ids, starts,
                                           counts,
                                           inverse.astype(np.int32),
                                           bounds,
                                           alt=self._alt_strings(table))
            raw = self._encode_unique_raw(words)
            if raw is not None and (self._MONOTONE
                                    or not (raw[1] == 0).any()):
                merged, out_n, table = raw
                return binding.stitch(table.strings(), merged, out_n,
                                      inverse.astype(np.int32), bounds,
                                      alt=self._alt_strings(table))
        encoded = self._encode_unique_device(words)
        out: List[List[str]] = [[] for _ in range(S)]
        for occ in range(wb.n_words):
            out[int(wb.sent_id[occ])].extend(encoded[inverse[occ]])
        return out

    # ------------------------------------------------------------- state io

    def reset(self) -> None:
        """Reset all learned state (reference: source/bpe.py:160-164)."""
        self.merges_list.clear()
        self.vocab.clear()
        self.corpus_as_symbols.clear()
        self._encode_cache = {}
        self._device_tables = None
        self._alt_cache = None
        self._host_ranks = None
        self._has_dups = None

    def save_resources(self, path: str) -> None:
        """Write ``merges.json`` (reference format, source/bpe.py:167-177).

        The write is atomic (tmp + rename) so a crash mid-save never
        leaves a truncated resource — the file doubles as the training
        checkpoint (see ``train``'s ``checkpoint_dir``)."""
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, "merges.json")
        tmp = target + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.merges_list, f, ensure_ascii=False)
        os.replace(tmp, target)

    def load_resources(self, path: str, strict: bool = False) -> None:
        """Load ``merges.json``. A missing file is a silent no-op for
        parity with the reference (quirk: source/bpe.py:179-189); pass
        ``strict=True`` to get a FileNotFoundError instead."""
        merges_file = os.path.join(path, "merges.json")
        if os.path.isfile(merges_file):
            with open(merges_file, "r", encoding="utf-8") as f:
                self.merges_list = [tuple(pair) for pair in json.load(f)]
            self._encode_cache = {}
            self._device_tables = None
            self._alt_cache = None
            self._host_ranks = None
            self._has_dups = None
        elif strict:
            raise FileNotFoundError(merges_file)


class FastBPE(NaiveBPE):
    """Inference-optimized BPE: greedy lowest-rank merging
    (reference: source/bpe.py:192-263)."""

    _MONOTONE = False

    def __init__(self, tokenizer: Optional[object] = None,
                 mesh: Optional[object] = None) -> None:
        super().__init__(tokenizer, mesh)
        self._bpe_ranks: Dict[Tuple[str, str], int] = {}

    def train(self, corpus: List[str], max_vocab: int = 30_000,
              **kwargs) -> None:
        super().train(corpus, max_vocab, **kwargs)
        self._bpe_ranks = {pair: i for i, pair in
                           enumerate(self.merges_list)}

    def _rank_map(self) -> Dict[Tuple[str, str], int]:
        # Dict comprehension semantics: later duplicates overwrite.
        return {pair: i for i, pair in enumerate(self.merges_list)}

    def _has_duplicate_merges(self) -> bool:
        # Greedy encoding uses dict ranks, so duplicates are harmless.
        return False

    def _encode_symbols(self, word: str) -> List[str]:
        """Greedy lowest-rank merge loop (reference: source/bpe.py:205-238)."""
        symbols = list(word)
        if len(symbols) < 2:
            return symbols  # caller handles the empty case
        ranks = self._bpe_ranks or self._rank_map()
        while len(symbols) > 1:
            best = None
            best_rank = None
            for i in range(len(symbols) - 1):
                r = ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best = r, (symbols[i], symbols[i + 1])
            if best is None:
                break
            symbols = _merge_pass(best, symbols)
        return symbols

    def encode_word(self, word: str) -> List[str]:
        symbols = self._encode_symbols(word)
        if not symbols:
            return [""]
        if len(symbols) > 1:
            symbols[1:] = ["##" + s for s in symbols[1:]]
        return symbols

    def load_resources(self, path: str, strict: bool = False) -> None:
        super().load_resources(path, strict=strict)
        self._bpe_ranks = {pair: i for i, pair in
                           enumerate(self.merges_list)}
