"""Device-resident multi-step merge loop.

The host-driven trainer costs one device round trip per merge. This loop
runs K merge steps in one jitted ``lax.scan``, which requires resolving the only host dependency —
*string interning* — on device:

- every symbol carries two independent 31-bit rolling hashes (mod the
  Mersenne prime 2^31-1) plus its length; the merged symbol's hashes are
  computed from its parts in O(1) (for WordPiece, the leading "##" of the
  right part is algebraically stripped: h(b[2:]) = h(b) - h("##")·B^(|b|-2));
- "already in vocab" (reference: the string-set membership of
  source/bpe.py:103 / source/wordpiece.py:96) becomes an exact
  (h1, h2, len) table match; a hit reuses the existing id, a miss appends.

A double-hash collision would silently merge two distinct strings, so the
host *verifies* every decoded merge record against real strings after each
K-block (models re-intern and compare ids); on the ~2^-62-probability
mismatch the caller falls back to the exact per-step path. Determinism is
unaffected — hashes only gate id reuse, never selection order.

Per-step records returned: (a_id, b_id, new_id, matched, active).
"""
from __future__ import annotations

import os
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..benchmarks import profiling
from .merge import apply_merge
from .pairstats import (_consts, _run_aggregate, _select, _wdtype,
                        pack_pairs, symbol_freqs, wp_select_core)

MOD = (1 << 31) - 1  # Mersenne prime; products stay exact in i64
HASH_B1 = 1_000_003
HASH_B2 = 805_306_457


def _mulmod(x, y):
    return (x * y) % MOD


def str_hashes(s: str) -> Tuple[int, int]:
    """Host-side reference implementation of the rolling hashes."""
    h1 = h2 = 0
    for c in s:
        v = (ord(c) + 1) % MOD
        h1 = (h1 * HASH_B1 + v) % MOD
        h2 = (h2 * HASH_B2 + v) % MOD
    return h1, h2


def pow_tables(max_len: int):
    """B^l mod M for l in [0, max_len], both bases (numpy int64)."""
    import numpy as np
    p1 = np.ones(max_len + 1, dtype=np.int64)
    p2 = np.ones(max_len + 1, dtype=np.int64)
    for l in range(1, max_len + 1):
        p1[l] = (p1[l - 1] * HASH_B1) % MOD
        p2[l] = (p2[l - 1] * HASH_B2) % MOD
    return p1, p2


def _select_and_unify(k_s, p_s, run_total, is_cand, sym_freq, h1, h2, slen,
                      n_sym, vocab_size, alive, pw1, pw2, sharp_h1,
                      sharp_h2, max_vocab, narrow, sym_cap, wordpiece,
                      cand_cap=None, wide_score=False, tournament=False):
    """Shared per-step core: winner selection + device string unification.

    ``sym_freq`` is the per-symbol frequency table (WordPiece scoring) or
    None (BPE). Returns (h1, h2, slen, n_sym, vocab_size, active, a, b,
    new_id, matched) — the caller applies the merge to its own corpus
    layout and records the step.
    """
    _, bits, space, _, _ = _consts(narrow)
    if wordpiece:
        best_key, _, _, count_at = wp_select_core(
            k_s, p_s, run_total, is_cand, sym_freq, narrow, cand_cap,
            wide_score, tournament)
    else:
        best_key, count_at, _ = _select(k_s, p_s, run_total, is_cand)

    active = alive & (count_at > 0) & (vocab_size < max_vocab)
    a = jnp.where(active, (best_key >> bits) & (space - 1),
                  0).astype(jnp.int32)
    b = jnp.where(active, best_key & (space - 1), 0).astype(jnp.int32)

    # Merged symbol hash/length from parts (O(1) string algebra).
    la = slen[a]
    lb = slen[b]
    if wordpiece:
        lbp = jnp.maximum(lb - 2, 0)
        hb1 = (h1[b] - _mulmod(sharp_h1, pw1[lbp])) % MOD
        hb2 = (h2[b] - _mulmod(sharp_h2, pw2[lbp])) % MOD
    else:
        lbp = lb
        hb1 = h1[b]
        hb2 = h2[b]
    m1 = (_mulmod(h1[a], pw1[lbp]) + hb1) % MOD
    m2 = (_mulmod(h2[a], pw2[lbp]) + hb2) % MOD
    lm = la + lbp

    # Exact (h1, h2, len) membership over the live table.
    ids = jnp.arange(sym_cap, dtype=jnp.int32)
    live = ids < n_sym
    hit = live & (h1 == m1) & (h2 == m2) & (slen == lm)
    matched = jnp.any(hit)
    matched_id = jnp.max(jnp.where(hit, ids, -1))
    new_id = jnp.where(matched, matched_id, n_sym).astype(jnp.int32)

    # Append on miss.
    grow = active & ~matched
    at = jnp.where(grow, n_sym, sym_cap - 1)
    h1 = h1.at[at].set(jnp.where(grow, m1, h1[at]))
    h2 = h2.at[at].set(jnp.where(grow, m2, h2[at]))
    slen = slen.at[at].set(jnp.where(grow, lm, slen[at]))
    n_sym = n_sym + grow.astype(jnp.int32)
    vocab_size = vocab_size + grow.astype(jnp.int32)
    return h1, h2, slen, n_sym, vocab_size, active, a, b, new_id, matched


@partial(jax.jit, static_argnames=("K", "narrow", "sym_cap", "wordpiece",
                                   "cand_cap", "wide_score", "w32",
                                   "tournament"))
def train_steps(sym, freq, h1, h2, slen, n_sym, vocab_size, pw1, pw2,
                sharp_h1, sharp_h2, max_vocab, K, narrow, sym_cap,
                wordpiece, cand_cap=None, wide_score=False, w32=False,
                tournament=False):
    """Run up to K merge steps on device (padded [n, L] corpus layout).

    sym: i32[n, L]; freq: weights; h1/h2/slen: i64[sym_cap] symbol hash
    tables and lengths (entries >= n_sym are zero); pw1/pw2: i64[P] hash
    base powers (P > max mergeable symbol length); sharp_h1/2: hashes of
    the literal "##". Returns (new state..., records dict of [K] arrays).
    """
    wdt = _wdtype(narrow, w32)

    def step(carry, _):
        sym, h1, h2, slen, n_sym, vocab_size, alive = carry
        n, L = sym.shape

        keys, pos = pack_pairs(sym, narrow)
        w = jnp.broadcast_to(freq.astype(wdt)[:, None],
                             (n, L - 1)).reshape(-1)
        k_s, p_s, run_total, is_cand = _run_aggregate(keys, pos, w, narrow)

        sym_freq = None
        if wordpiece:
            flat = sym.reshape(-1)
            wsym = jnp.broadcast_to(freq.astype(wdt)[:, None],
                                    (n, L)).reshape(-1)
            sym_freq = symbol_freqs(flat, wsym, sym_cap)

        (h1, h2, slen, n_sym, vocab_size, active, a, b, new_id,
         matched) = _select_and_unify(
            k_s, p_s, run_total, is_cand, sym_freq, h1, h2, slen, n_sym,
            vocab_size, alive, pw1, pw2, sharp_h1, sharp_h2, max_vocab,
            narrow, sym_cap, wordpiece, cand_cap, wide_score, tournament)

        new_sym = apply_merge(sym, jnp.where(active, a, -3),
                              jnp.where(active, b, -3), new_id)

        rec = {"a": a, "b": b, "new_id": new_id, "matched": matched,
               "active": active}
        return ((new_sym, h1, h2, slen, n_sym, vocab_size,
                 alive & active), rec)

    carry0 = (sym, h1, h2, slen, n_sym, vocab_size, jnp.bool_(True))
    carry, recs = jax.lax.scan(step, carry0, None, length=K)
    return carry, recs


@partial(jax.jit, static_argnames=("K", "narrow", "sym_cap", "wordpiece",
                                   "cand_cap", "wide_score", "w32",
                                   "skip", "count_ovf", "tournament"))
def flat_train_steps(fs, wid, wgt, sym_freq, h1, h2, slen, n_sym,
                     vocab_size, pw1, pw2, sharp_h1, sharp_h2, max_vocab,
                     K, narrow, sym_cap, wordpiece, cand_cap=None,
                     wide_score=False, w32=False, skip=0,
                     count_ovf=False, tournament=False):
    """K merge steps over the flat corpus layout (ops/flat.py) — same
    semantics as :func:`train_steps` with ~3x less sort volume (no
    intra-word padding).

    ``sym_freq`` is the per-symbol weight table ([sym_cap + 1], trailing
    trash bucket; see :func:`~.pairstats.symbol_freqs`). Instead of the
    per-step recount (a corpus-sized scatter-add), it is carried across
    steps and updated incrementally from the merge's replacement weight —
    exactly equal to the recount (each replacement consumes one ``a`` and
    one ``b`` and produces one merged token). BPE carries it untouched.

    ``skip > 0`` defers the per-step left-compaction (one of the two
    full-width sorts each step): consumed slots stay dead in place, pair
    adjacency is recovered by an ``skip+1``-slot select chain
    (ops/flat.skip_next), and tie-break positions come from a liveness
    cumsum, so selection is bit-identical to the compacted path. When a
    live gap would exceed the window (detected exactly, pre-step), the
    step compacts first inside ``lax.cond`` — correctness never depends
    on the window. The returned state is compacted (the host shrink
    slices a dead tail off between blocks).
    """
    from .flat import (compact_flat, flat_aggregate, flat_apply,
                       flat_skip_aggregate, flat_skip_apply, skip_next,
                       skip_overflow)

    if skip and skip + 1 >= fs.shape[0]:
        # The skip_next select chain shifts by up to skip+1 slots; a
        # window that large relative to the flat width would build
        # wrong-length concats deep inside the jit (opaque shape error).
        # run_fused clamps before dispatch — this guards direct callers.
        raise ValueError(
            f"skip window {skip} too large for flat width {fs.shape[0]} "
            f"(need skip + 1 < width)")

    def step(carry, _):
        (fs, wid, wgt, sym_freq, h1, h2, slen, n_sym, vocab_size,
         alive) = carry

        if skip:
            # One select chain; its not-found mask doubles as the
            # overflow predicate. On overflow (rare — zero triggers on
            # train-5K@1000 at skip=12, tools/skip_stats.py) compact and
            # re-chain inside the cond.
            nsym, nwid_nb = skip_next(fs, wid, skip)
            ovf = skip_overflow(fs, wid, skip, nsym=nsym)

            def _recompact(t):
                cfs, cwid, cwgt = compact_flat(*t)
                ns, nw = skip_next(cfs, cwid, skip)
                return cfs, cwid, cwgt, ns, nw

            fs, wid, wgt, nsym, nwid_nb = jax.lax.cond(
                ovf, _recompact, lambda t: t + (nsym, nwid_nb),
                (fs, wid, wgt))
            live32 = (fs >= 0).astype(jnp.int32)
            cpos = jnp.cumsum(live32) - 1
            k_s, p_s, run_total, is_cand = flat_skip_aggregate(
                fs, wid, wgt, nsym, nwid_nb, cpos, narrow, w32)
        else:
            k_s, p_s, run_total, is_cand = flat_aggregate(
                fs, wid, wgt, narrow, w32)

        (h1, h2, slen, n_sym, vocab_size, active, a, b, new_id,
         matched) = _select_and_unify(
            k_s, p_s, run_total, is_cand,
            sym_freq if wordpiece else None, h1, h2, slen, n_sym,
            vocab_size, alive, pw1, pw2, sharp_h1, sharp_h2, max_vocab,
            narrow, sym_cap, wordpiece, cand_cap, wide_score, tournament)

        if skip:
            nfs, nwid, nwgt, n_rep = flat_skip_apply(
                fs, wid, wgt, nsym, nwid_nb, cpos,
                jnp.where(active, a, -3), jnp.where(active, b, -3),
                new_id, skip)
        else:
            nfs, nwid, nwgt, n_rep = flat_apply(fs, wid, wgt,
                                                jnp.where(active, a, -3),
                                                jnp.where(active, b, -3),
                                                new_id)
        if wordpiece:
            upd = jnp.where(active, n_rep, 0).astype(sym_freq.dtype)
            sym_freq = sym_freq.at[a].add(-upd).at[b].add(-upd) \
                               .at[new_id].add(upd)

        rec = {"a": a, "b": b, "new_id": new_id, "matched": matched,
               "active": active,
               # live-slot count: lets the host shrink the flat arrays
               # between blocks (merges only ever consume slots)
               "n_live": jnp.sum((nfs >= 0).astype(jnp.int32))}
        if count_ovf:  # diagnostics only (changes record shapes)
            rec["ovf"] = ovf if skip else jnp.bool_(False)
        return ((nfs, nwid, nwgt, sym_freq, h1, h2, slen, n_sym,
                 vocab_size, alive & active), rec)

    carry0 = (fs, wid, wgt, sym_freq, h1, h2, slen, n_sym, vocab_size,
              jnp.bool_(True))
    carry, recs = jax.lax.scan(step, carry0, None, length=K)
    if skip:
        cfs, cwid, cwgt = compact_flat(carry[0], carry[1], carry[2])
        carry = (cfs, cwid, cwgt) + tuple(carry[3:])
    return carry, recs


class HashCollision(Exception):
    """Device hash unification disagreed with real string interning."""


# Floor for the between-block flat-array shrink: below this the sort is
# cheap and another compiled shape isn't worth it.
_FLAT_MIN = 8192


def _cand_cap(n_pairs: int):
    """Static capacity for candidate compaction (WordPiece scoring).

    Distinct pairs measure ~9x fewer than positions on real corpora
    (train-5K: 187,885 flat positions, 21,864 max distinct pairs over
    1,000 merges); an eighth of the positions bounds that with headroom
    (the exact-double long division prices every candidate slot), and
    wp_select_core falls back to full-width scoring inside lax.cond if it
    ever overflows — the cap trades cost only, never correctness.
    """
    if n_pairs < 16384:
        return None
    return max(-(-(n_pairs // 8) // 1024) * 1024, 16384)


def _default_skip() -> int:
    """Deferred-compaction window (``SWT_SKIP_COMPACT`` overrides; 0
    disables). See :func:`flat_train_steps` — cost-only, never
    correctness. run_fused additionally clamps the window to the flat
    width (the select chain needs skip + 1 < width)."""
    v = os.environ.get("SWT_SKIP_COMPACT")
    if v is not None:
        try:
            return max(int(v), 0)
        except ValueError:
            raise ValueError(
                f"SWT_SKIP_COMPACT must be an integer, got {v!r}") from None
    return 12


def run_fused(sym_dev, freq_dev, table, max_vocab, narrow, wordpiece,
              on_merge, K: int = 256, checkpoint_cb=None, progress_cb=None,
              flat: bool = True, wide_score: bool = False,
              w32: bool = False, skip: int = None):
    """Host driver for the K-step device loop.

    ``table`` is the live SymbolTable (vocabulary == its string set for
    both algorithms); ``on_merge(sa, sb, merged)`` is called per merge in
    order; ``checkpoint_cb(steps_done)`` after each block (the caller
    enforces its cadence). Every decoded record is verified against real
    interning — raises :class:`HashCollision` on any disagreement (caller
    falls back to the exact per-step path).

    ``flat=True`` (default) converts the padded tensor to the flat layout
    (ops/flat.py) — ~3x less sort volume per step. Returns the final
    *padded host* symbol tensor either way (rebuilt from the flat state).
    """
    import numpy as np

    if skip is None:
        skip = _default_skip() if flat else 0
    n, L = sym_dev.shape
    n0 = len(table)
    if n0 >= max_vocab:
        return np.asarray(sym_dev)
    sym_cap = max(max_vocab, n0) + 8
    if narrow and sym_cap >= (1 << 16):
        narrow = False

    h1 = np.zeros(sym_cap, dtype=np.int64)
    h2 = np.zeros(sym_cap, dtype=np.int64)
    sl = np.zeros(sym_cap, dtype=np.int64)
    for i, s in enumerate(table.strings()):
        h1[i], h2[i] = str_hashes(s)
        sl[i] = len(s)
    pw1, pw2 = pow_tables(L + 4)
    sh1, sh2 = str_hashes("##")
    pw1_d = jnp.asarray(pw1)
    pw2_d = jnp.asarray(pw2)

    if flat:
        from .flat import build_flat
        sym_host = np.asarray(sym_dev)
        freq_host = np.asarray(freq_dev)
        fs, wid, wgt = build_flat(sym_host, freq_host, w32=(narrow or w32))
        # Clamp the skip window: (a) to the smallest width any dispatch
        # can see (the between-block shrink floors at _FLAT_MIN;
        # build_flat pads to >= 1024) so an oversized SWT_SKIP_COMPACT
        # degrades to more compactions, not a shape error inside the
        # jit; (b) to 64 absolutely — the select chains unroll at trace
        # time (3 chains x window ops), and a window past 64 buys
        # nothing (overflow rate is already ~0 at the default 12).
        skip = min(skip, 64, max(min(fs.shape[0], _FLAT_MIN) - 2, 0))
        # Initial per-symbol weights (host, exact integers); carried and
        # updated incrementally on device thereafter.
        sfreq = np.zeros(sym_cap + 1,
                         dtype=np.int32 if (narrow or w32) else np.int64)
        np.add.at(sfreq, np.where(fs >= 0, fs, sym_cap),
                  np.where(fs >= 0, wgt, 0).astype(sfreq.dtype))
        carry = (jnp.asarray(fs), jnp.asarray(wid), jnp.asarray(wgt),
                 jnp.asarray(sfreq),
                 jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(sl),
                 jnp.int32(n0), jnp.int32(n0), jnp.bool_(True))
    else:
        carry = (sym_dev, jnp.asarray(h1), jnp.asarray(h2),
                 jnp.asarray(sl), jnp.int32(n0), jnp.int32(n0),
                 jnp.bool_(True))

    cand_cap = None
    use_cand_cap = True
    if wordpiece:
        # Candidate compaction trades a full-width sort for a narrow
        # exact-double scoring set. On the CPU backend that trade loses
        # (measured on the CPU: 35.0 -> 27.1 s on train-5K[:1500]@600
        # with compaction off), so scoring runs full-width there. GPU:
        # not yet measured; it keeps compaction on.
        # SWT_WP_CAND_CAP=1 forces it on, =0 forces it off.
        force = os.environ.get("SWT_WP_CAND_CAP")
        if force not in (None, "0", "1"):
            # Silent fall-through here would quietly invalidate an A/B
            # measurement ("true"/"2" looking like a forced setting).
            raise ValueError(
                f"SWT_WP_CAND_CAP must be '0' or '1', got {force!r}")
        if force == "0":
            use_cand_cap = False
        elif force != "1" and jax.default_backend() == "cpu":
            use_cand_cap = False
        if use_cand_cap:
            n_pairs = (int(carry[0].shape[0]) - 1 if flat
                       else n * max(L - 1, 1))
            cand_cap = _cand_cap(n_pairs)

    # Tournament selection (ops/wp_tournament.py): replaces candidate
    # compaction + bulk exact-double scoring with a cross-multiplication
    # halving reduction; near-tie steps redo through the exact-double
    # path inside lax.cond. Narrow-score corpora only (fa*fb < 2**52).
    # On the CPU backend it wins 29% (measured on the CPU: 71.5 -> 50.9 s
    # on train-5K[:1500]@600), so it is on there. GPU: not yet measured;
    # it stays off.
    # SWT_WP_TOURNAMENT=1 forces it on, =0 forces it off.
    tournament = False
    if wordpiece and not wide_score:
        t = os.environ.get("SWT_WP_TOURNAMENT")
        if t not in (None, "0", "1"):
            raise ValueError(
                f"SWT_WP_TOURNAMENT must be '0' or '1', got {t!r}")
        if t is None:
            tournament = jax.default_backend() == "cpu"
        else:
            tournament = t == "1"

    # SWT_BLOCK_LOG=1: per-dispatch stderr line (width, wall) — the raw
    # decomposition the speed-of-light analysis consumes
    # (tools/train_sol.py); off by default.
    block_log = os.environ.get("SWT_BLOCK_LOG") == "1"

    def _dispatch(c, ccap):
        if block_log:
            import sys
            import time as _time
            F_now = int(c[0].shape[0]) if flat else -1
            print(f"[block] dispatch F={F_now} t={_time.perf_counter():.4f}",
                  file=sys.stderr, flush=True)
        with profiling.phase("train.device_block"):
            if flat:
                return flat_train_steps(
                    c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8],
                    pw1_d, pw2_d, sh1, sh2, jnp.int32(max_vocab), K,
                    narrow, sym_cap, wordpiece, ccap, wide_score, w32,
                    skip, tournament=tournament)
            return train_steps(
                c[0], freq_dev, c[1], c[2], c[3], c[4], c[5], pw1_d,
                pw2_d, sh1, sh2, jnp.int32(max_vocab), K, narrow,
                sym_cap, wordpiece, ccap, wide_score, w32,
                tournament=tournament)

    # Pipeline depth 2: block k+1 is dispatched BEFORE block k's records
    # are fetched, so the fixed per-fetch latency overlaps block k+1's
    # device execution (the depth was sized for a remote link's fetch
    # latency; unmeasured on the GPU). Exact: every stop condition is enforced ON DEVICE
    # (``alive``/``max_vocab`` gating), so a block dispatched past
    # completion is a no-op continuation of identical state, and the
    # host-side record validation only gates id reuse, never selection.
    state, recs = _dispatch(carry, cand_cap)
    inflight = [(state, recs)]
    next_carry = state
    shrink_live = None  # newest fetched n_live (liveness only decreases)
    done = False
    while inflight:
        if not done:
            if flat and shrink_live is not None:
                # Merges only consume slots and flat_apply left-compacts
                # live slots every step, so the dead tail is sliced off
                # between blocks ON DEVICE (lazy slice of the in-flight
                # state — no host round trip; positions, the tie-break
                # key, are untouched). Halving grid: each distinct width
                # is a fresh XLA compile, so shrink at most one power of
                # two per dispatch (a limit sized for multi-minute
                # remote compiles; unmeasured with local compiles).
                F = int(next_carry[0].shape[0])
                if F >= 2 * _FLAT_MIN and shrink_live <= F // 2:
                    Fp = F // 2
                    with profiling.phase("train.shrink"):
                        next_carry = (next_carry[0][:Fp],
                                      next_carry[1][:Fp],
                                      next_carry[2][:Fp]) \
                            + tuple(next_carry[3:])
                    if wordpiece and use_cand_cap:
                        # The width change recompiles anyway; shrink the
                        # candidate buffer (exact-double scoring cost)
                        # with it. Cost-only — wp_select_core falls back
                        # to full width inside lax.cond on overflow.
                        cand_cap = _cand_cap(Fp - 1)
            nxt = _dispatch(next_carry, cand_cap)
            inflight.append(nxt)
            next_carry = nxt[0]
        state, recs = inflight.pop(0)
        with profiling.phase("train.fetch_records"):
            recs_np = jax.device_get(recs)
        if block_log:
            import sys
            import time as _time
            print(f"[block] fetched t={_time.perf_counter():.4f} "
                  f"n_live={int(recs_np['n_live'][-1]) if flat else -1}",
                  file=sys.stderr, flush=True)
        steps_done = 0
        for k in range(K):
            if not bool(recs_np["active"][k]):
                done = True
                break
            a = int(recs_np["a"][k])
            b = int(recs_np["b"][k])
            sa, sb = table.string(a), table.string(b)
            merged = sa + (sb[2:] if wordpiece else sb)
            nid = table.intern(merged)
            if nid != int(recs_np["new_id"][k]):
                raise HashCollision(
                    f"step {len(table)}: device id {recs_np['new_id'][k]} "
                    f"!= host id {nid} for {merged!r}")
            on_merge(sa, sb, merged)
            steps_done += 1
        carry = state
        if progress_cb is not None and steps_done:
            progress_cb(steps_done)
        if checkpoint_cb is not None and steps_done:
            checkpoint_cb(steps_done)
        if len(table) >= max_vocab:
            done = True
        if steps_done:
            shrink_live = int(recs_np["n_live"][steps_done - 1]) \
                if flat else None
        if done:
            # Drain without dispatching: in-flight blocks are no-op
            # continuations — their records are never needed.
            inflight.clear()

    if flat:
        fs_f, wid_f = jax.device_get((carry[0], carry[1]))
        return _flat_to_padded(fs_f, wid_f, n)
    return np.asarray(carry[0])


def _flat_to_padded(fs: "np.ndarray", wid: "np.ndarray", n_words: int):
    """Rebuild a padded [n_words, max_len] host tensor from flat state."""
    import numpy as np
    live = fs >= 0
    fs = fs[live]
    wid = wid[live]
    counts = np.bincount(wid, minlength=n_words)
    L = max(int(counts.max()) if counts.size else 1, 1)
    out = np.full((n_words, L), -1, dtype=np.int32)
    # flat order is word-major: position within word = running index
    offs = np.zeros(n_words + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    pos = np.arange(fs.size, dtype=np.int64) - offs[wid]
    out[wid, pos] = fs
    return out
