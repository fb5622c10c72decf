"""Device-side pair statistics and merge selection for trainers.

The reference's hottest loop recounts every adjacent symbol pair of the
corpus each merge step (source/bpe.py:90-95, source/wordpiece.py:70-73) and
selects the winner with Counter/dict-insertion-order tie-breaks. Here the
whole step is one fused XLA program over the padded symbol tensor:

1. pack each adjacent pair into a single integer key;
2. lexicographic ``lax.sort`` by (key, scan-position) — runs of equal keys
   end up contiguous with the *earliest scan position first*, which is
   exactly the Counter first-insertion order the reference tie-breaks on;
3. run aggregation with cumsum / reverse-cummin (no scatter needed):
   per-run total weight and first-seen position;
4. selection: BPE takes max count then min first-seen (reproducing
   ``Counter.most_common(1)``, source/bpe.py:102); WordPiece takes max
   *score* — the exact IEEE-double bits of ``pair/(fa*fb)`` computed with
   integer long division (see ops/bitmath.py) — then min first-seen
   (reproducing ``max(scores, key=scores.get)``, source/wordpiece.py:92).

Two key widths share the code: the **i32 fast path** packs pairs as
``a << 16 | b`` (valid while symbol ids < 2^16 and corpus weights <
2^31 — virtually every real training run; half the sort bytes of i64
keys), and the i64 path packs ``a << 21 | b`` for larger vocabularies.
The trainers choose once per run from static bounds. No floating point
touches the conformance path.

The weight dtype is decoupled from the key dtype: whenever the total
corpus weight fits i32 (``w32=True`` — any corpus under 2^31
occurrences), the cumsum/cummin run in i32 even when symbol ids need i64
keys. This was chosen for a backend whose emulated i64 scans failed to
compile at corpus sizes; whether the narrow scan still pays on the GPU
is unmeasured. Only corpora with ≥2^31 total occurrences use an i64
scan.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from .bitmath import (bitlen, bitlen128, div_double_bits,
                      div_double_bits_wide, mul_53x53)

# i64 path: symbol ids < 2^21 (≈2M distinct symbols).
SYM_BITS = 21
SYM_SPACE = 1 << SYM_BITS
KEY_SENTINEL = jnp.int64(1 << 62)

# i32 fast path: symbol ids < 2^16.
SYM_BITS32 = 16
SYM_SPACE32 = 1 << SYM_BITS32
KEY_SENTINEL32 = jnp.int32(2**31 - 1)

I64_MAX = jnp.iinfo(jnp.int64).max
I32_MAX = jnp.iinfo(jnp.int32).max


def _consts(narrow: bool):
    if narrow:
        return (jnp.int32, SYM_BITS32, SYM_SPACE32, KEY_SENTINEL32, I32_MAX)
    return (jnp.int64, SYM_BITS, SYM_SPACE, KEY_SENTINEL, I64_MAX)


def _wdtype(narrow: bool, w32: bool):
    """Weight dtype: i32 whenever the total corpus weight fits (see module
    docstring)."""
    return jnp.int32 if (narrow or w32) else jnp.int64


def pack_pairs(sym: jax.Array, narrow: bool) -> Tuple[jax.Array, jax.Array]:
    """Pack adjacent pairs of a padded i32 symbol tensor into keys.

    Returns (keys[n*(L-1)], pos[n*(L-1)]) flattened row-major — row-major
    order over (word, position) is the reference's scan order. Invalid
    slots (either side padded) get the sentinel key.
    """
    dt, bits, _, sentinel, _ = _consts(narrow)
    n, L = sym.shape
    a = sym[:, :-1].astype(dt)
    b = sym[:, 1:].astype(dt)
    valid = (a >= 0) & (b >= 0)
    keys = jnp.where(valid, (a << bits) | b, sentinel)
    pos = jnp.arange(n * (L - 1), dtype=dt)
    return keys.reshape(-1), pos


def _run_aggregate(keys, pos, w, narrow: bool, w_by_pos: bool = False):
    """Sort pairs and aggregate runs of equal keys.

    Returns (k_s, p_s, run_total, is_cand) where for every element of the
    sorted order: ``run_total`` is the full weight of its run (valid at any
    element), ``p_s`` at a run's first element is the run's minimum scan
    position, and ``is_cand`` marks run starts of real (non-sentinel) keys.

    ``w_by_pos=True`` routes the weights *around* the sort via a gather
    by sorted position. It lost to the extra sort operand on the backend
    this was built on (sorts fast, corpus-sized gathers slow); unmeasured
    on the GPU.

    The run aggregation (cumsum/cummin) runs in ``w``'s dtype — callers
    pass i32 weights whenever the total corpus weight fits (see module
    docstring).
    """
    _, _, _, sentinel, _ = _consts(narrow)
    if w_by_pos:
        k_s, p_s = jax.lax.sort((keys, pos), num_keys=2)
        w_s = w[p_s]
    else:
        k_s, p_s, w_s = jax.lax.sort((keys, pos, w), num_keys=2)
    one = jnp.ones((1,), dtype=bool)
    is_start = jnp.concatenate([one, k_s[1:] != k_s[:-1]])
    is_end = jnp.concatenate([is_start[1:], one])
    cw = jnp.cumsum(w_s)
    # Weight of the whole run, readable at the run's first element:
    # (cumsum at nearest run end >= i) - (cumsum before run start). cw is
    # strictly increasing, so the nearest masked value to the right is the
    # reverse running minimum.
    wmax = jnp.asarray(jnp.iinfo(w_s.dtype).max, dtype=w_s.dtype)
    end_cum = jax.lax.cummin(jnp.where(is_end, cw, wmax), axis=0,
                             reverse=True)
    run_total = end_cum - (cw - w_s)
    is_cand = is_start & (k_s != sentinel)
    return k_s, p_s, run_total, is_cand


def _select(k_s, p_s, metric, is_cand):
    """Winner = max metric, ties broken by min scan position (first-seen)."""
    neg = jnp.asarray(-1, dtype=metric.dtype)
    metric = jnp.where(is_cand, metric, neg)
    best_metric = jnp.max(metric)
    pos_max = jnp.iinfo(p_s.dtype).max
    fs = jnp.where(metric == best_metric, p_s,
                   jnp.asarray(pos_max, dtype=p_s.dtype))
    best_fs = jnp.min(fs)
    at = (metric == best_metric) & (p_s == best_fs)
    best_key = jnp.max(jnp.where(at, k_s, jnp.asarray(-1, dtype=k_s.dtype)))
    return best_key, best_metric, best_fs


@partial(jax.jit, static_argnames=("narrow", "w32"))
def bpe_select(sym: jax.Array, freq: jax.Array, narrow: bool = False,
               w32: bool = False):
    """One BPE selection: most frequent pair, first-seen tie-break.

    Returns (best_key, best_count, best_first_seen). ``best_count <= 0``
    means no pairs remain (reference exit: source/bpe.py:98-99).
    """
    wdt = _wdtype(narrow, w32)
    n, L = sym.shape
    keys, pos = pack_pairs(sym, narrow)
    w = jnp.broadcast_to(freq.astype(wdt)[:, None], (n, L - 1)).reshape(-1)
    k_s, p_s, run_total, is_cand = _run_aggregate(keys, pos, w, narrow)
    return _select(k_s, p_s, run_total, is_cand)


def compact_cands(k_s, p_s, run_total, is_cand, cap: int, narrow: bool):
    """Gather the (≤ ``cap``) run-start candidates into static-size arrays.

    Distinct pairs are typically ~100x fewer than positions, so compacting
    before the expensive exact-double scoring removes its dominant cost
    (the i64 long division runs per *candidate*, not per position). Returns (ck, cp, cc, cmask, ovf): keys, first-seen
    positions, counts, validity mask, and a scalar bool set when more than
    ``cap`` candidates exist — the compacted view is then incomplete and
    callers MUST fall back to the full-width arrays.
    """
    _, _, _, sentinel, vmax = _consts(narrow)
    # A cap beyond the array width is meaningless (callers size caps from
    # *estimated* position counts, which can slightly exceed the real
    # width — e.g. the shard-divisibility padding estimate in the model
    # layer); clamp so the static slice below matches the mask shape.
    cap = min(cap, k_s.shape[0])
    # Compaction by one more sort: candidates float to the front, then a
    # static slice takes the first ``cap``. The alternatives (jnp.nonzero,
    # or an i32 cumsum + corpus-sized scatter) lost on the backend this was
    # built on, where sorts were fast and scatters slow; unmeasured on the
    # GPU. Non-candidates are folded into the sentinel key (one
    # 3-operand unstable sort, not the 4-operand stable flag sort it used
    # to be): downstream selection is by (score bits, min position) and
    # positions are unique across runs, so the order of candidates within
    # the compacted prefix is irrelevant to the selected winner.
    kk = jnp.where(is_cand, k_s, sentinel)
    ks, ps, cs = jax.lax.sort((kk, p_s, run_total), num_keys=1)
    ncand = jnp.sum(is_cand.astype(jnp.int32))
    valid = jnp.arange(cap, dtype=jnp.int32) < ncand
    ck = jnp.where(valid, ks[:cap], sentinel)
    cp = jnp.where(valid, ps[:cap], vmax)
    cc = jnp.where(valid, cs[:cap], 0)
    ovf = ncand > cap
    return ck, cp, cc, valid, ovf


def symbol_freqs(sym_flat, w_flat, sym_cap: int):
    """Per-symbol total weights (reference: source/wordpiece.py:78-81).

    ``sym_flat``: flat symbol ids (PAD < 0); ``w_flat``: per-slot weight.
    """
    seg = jnp.where(sym_flat >= 0, sym_flat, sym_cap).astype(jnp.int32)
    return jax.ops.segment_sum(
        jnp.where(sym_flat >= 0, w_flat, 0), seg, num_segments=sym_cap + 1)


def wp_score_bits(ck, cc, cmask, sym_freq, narrow: bool,
                  wide_score: bool = False):
    """Exact IEEE-double bit patterns of ``count / (freq_a * freq_b)``
    per candidate (reference score: source/wordpiece.py:84-87). Stays in
    i64 regardless of ``narrow`` — the double domain needs 53 bits.

    ``wide_score`` switches to the 128-bit-denominator divider
    (ops/bitmath.div_double_bits_wide) for corpora with >= 2**26 total
    symbol occurrences, where ``fa * fb`` no longer fits the narrow
    domain; exactness holds up to ~2**52 total tokens (CPython's int/int
    division is correctly rounded at any size, so this still matches the
    reference bit-for-bit)."""
    _, bits, space, _, _ = _consts(narrow)
    a = jnp.where(cmask, (ck >> bits) & (space - 1), 0).astype(jnp.int32)
    b = jnp.where(cmask, ck & (space - 1), 0).astype(jnp.int32)
    c = jnp.maximum(cc, 1).astype(jnp.int64)
    fa = jnp.maximum(sym_freq[a].astype(jnp.int64), 1)
    fb = jnp.maximum(sym_freq[b].astype(jnp.int64), 1)
    if wide_score:
        d_hi, d_lo = mul_53x53(fa, fb)
        return div_double_bits_wide(c, d_hi, d_lo)
    return div_double_bits(c, fa * fb)


def _prefilter_cap(cand_cap: int) -> int:
    """Static capacity for the exponent-prefiltered scoring set."""
    return min(max(2048, -(-(cand_cap // 16) // 1024) * 1024), cand_cap)


def wp_select_core(k_s, p_s, run_total, is_cand, sym_freq, narrow: bool,
                   cand_cap=None, wide_score: bool = False,
                   tournament: bool = False):
    """Shared WordPiece winner selection over aggregated runs.

    The single body behind wp_select, the fused train loop, and the
    sharded path (they must never diverge — this is conformance-critical).
    With ``cand_cap`` set, scoring runs over compacted candidates and
    falls back to the full-width arrays inside ``lax.cond`` only when the
    cap overflows (both results are exact; the cap is purely a cost trade).
    ``wide_score`` selects the 128-bit-denominator scorer (corpora with
    >= 2**26 total tokens). Returns (best_key, best_bits, best_fs,
    best_count).

    ``tournament=True`` (narrow-score corpora only — it requires
    ``fa*fb < 2**52``) selects via the cross-multiplication tournament
    (ops/wp_tournament.py), with a ``lax.cond`` redo through this
    function's exact-double path whenever the tournament's near-tie flag
    fires — another pure cost trade, bit-exactness is unconditional.

    Exponent prefilter (r4): the exact-double long division is the
    dominant per-step cost and runs per candidate slot. A candidate's
    score c/d lies in [2^(e-1), 2^(e+1)) for e = bitlen(c) - bitlen(d)
    (a few shifts), so any candidate with e <= max_e - 2 has score
    strictly below some e = max_e candidate's — it can never be the max
    *value*. It could still TIE the winning *double* after rounding, but
    only when the winning double is exactly 2^(max_e - 1) (a dropped
    value < 2^(max_e-1) rounds to at most that; the winner rounds to at
    least it) — that one case falls back to scoring every candidate
    inside ``lax.cond``, as does prefilter overflow. Exactness is
    unconditional; the prefilter trades cost only.
    """
    def full(_):
        bits = wp_score_bits(k_s, run_total, is_cand, sym_freq, narrow,
                             wide_score)
        bk, bb, bf = _select(k_s, p_s, bits, is_cand)
        cnt = jnp.max(jnp.where((k_s == bk) & is_cand, run_total,
                                jnp.asarray(-1, dtype=run_total.dtype)))
        return bk, bb, bf, cnt

    if tournament:
        assert not wide_score, \
            "tournament selection requires the narrow score domain"
        from .wp_tournament import wp_tournament_select
        bk, bb, bf, bc, risky = wp_tournament_select(
            k_s, p_s, run_total, is_cand, sym_freq, narrow)

        def exact_redo(_):
            return wp_select_core(k_s, p_s, run_total, is_cand, sym_freq,
                                  narrow, cand_cap, wide_score)

        return jax.lax.cond(risky, exact_redo,
                            lambda _: (bk, bb, bf, bc), None)

    if cand_cap is None or cand_cap >= k_s.shape[0]:
        return full(None)

    ck, cp, cc, cmask, ovf = compact_cands(k_s, p_s, run_total, is_cand,
                                           cand_cap, narrow)

    def compacted(_):
        bits = wp_score_bits(ck, cc, cmask, sym_freq, narrow, wide_score)
        bk, bb, bf = _select(ck, cp, bits, cmask)
        cnt = jnp.max(jnp.where((ck == bk) & cmask, cc,
                                jnp.asarray(-1, dtype=cc.dtype)))
        return bk, bb, bf, cnt

    pf_cap = _prefilter_cap(cand_cap)
    if pf_cap >= cand_cap:
        return jax.lax.cond(ovf, full, compacted, None)

    def prefiltered(_):
        _, bits_c, space, sentinel, vmax = _consts(narrow)
        a = jnp.where(cmask, (ck >> bits_c) & (space - 1),
                      0).astype(jnp.int32)
        b = jnp.where(cmask, ck & (space - 1), 0).astype(jnp.int32)
        c = jnp.maximum(cc, 1).astype(jnp.int64)
        fa = jnp.maximum(sym_freq[a].astype(jnp.int64), 1)
        fb = jnp.maximum(sym_freq[b].astype(jnp.int64), 1)
        if wide_score:
            d_hi, d_lo = mul_53x53(fa, fb)
            ld = bitlen128(d_hi, d_lo)
        else:
            ld = bitlen(fa * fb)
        e = jnp.where(cmask, bitlen(c) - ld, jnp.int64(-(1 << 40)))
        max_e = jnp.max(e)
        keep = cmask & (e >= max_e - 1)

        # Same sentinel-key compaction trick as compact_cands: survivor
        # order is irrelevant to the (bits, unique-position) selection.
        kk2 = jnp.where(keep, ck, sentinel)
        ks2, ps2, cs2 = jax.lax.sort((kk2, cp, cc), num_keys=1)
        nkeep = jnp.sum(keep.astype(jnp.int32))
        kv = jnp.arange(pf_cap, dtype=jnp.int32) < nkeep
        ck2 = jnp.where(kv, ks2[:pf_cap], sentinel)
        cp2 = jnp.where(kv, ps2[:pf_cap], jnp.asarray(vmax, ps2.dtype))
        cc2 = jnp.where(kv, cs2[:pf_cap], 0)

        sbits = wp_score_bits(ck2, cc2, kv, sym_freq, narrow, wide_score)
        bk, bb, bf = _select(ck2, cp2, sbits, kv)
        cnt = jnp.max(jnp.where((ck2 == bk) & kv, cc2,
                                jnp.asarray(-1, dtype=cc2.dtype)))
        ovf2 = nkeep > pf_cap
        # Winning double exactly 2^m: a dropped candidate could round up
        # to tie it and win the insertion-order tie-break.
        boundary = (bb > 0) & ((bb & ((jnp.int64(1) << 52) - 1)) == 0)
        return jax.lax.cond(ovf2 | boundary, compacted,
                            lambda _: (bk, bb, bf, cnt), None)

    return jax.lax.cond(ovf, full, prefiltered, None)


@partial(jax.jit, static_argnames=("sym_cap", "narrow", "cand_cap",
                                   "wide_score", "w32"))
def wp_select(sym: jax.Array, freq: jax.Array, sym_cap: int,
              narrow: bool = False, cand_cap=None,
              wide_score: bool = False, w32: bool = False):
    """One WordPiece selection: max score ``pair/(fa*fb)``, first-seen
    tie-break, with score compared as the exact Python double.

    ``sym_cap`` is a static bound on the number of distinct symbol ids;
    ``cand_cap`` (static) bounds the candidate compaction (None = score
    every position). Returns (best_key, best_score_bits, best_first_seen,
    best_count).
    """
    wdt = _wdtype(narrow, w32)
    n, L = sym.shape
    keys, pos = pack_pairs(sym, narrow)
    w = jnp.broadcast_to(freq.astype(wdt)[:, None], (n, L - 1)).reshape(-1)
    k_s, p_s, run_total, is_cand = _run_aggregate(keys, pos, w, narrow)

    flat = sym.reshape(-1)
    wsym = jnp.broadcast_to(freq.astype(wdt)[:, None], (n, L)).reshape(-1)
    sym_freq = symbol_freqs(flat, wsym, sym_cap)

    return wp_select_core(k_s, p_s, run_total, is_cand, sym_freq, narrow,
                          cand_cap, wide_score)
