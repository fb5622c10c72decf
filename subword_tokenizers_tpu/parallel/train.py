"""Sharded (data-parallel) training steps via shard_map.

Word types shard across the ``data`` mesh axis; the per-step reduction
combines every shard's pair statistics into one global, *deterministic*
selection — identical to the single-device result bit-for-bit, because:

- pair counts are integers combined by summation (order-invariant),
- the tie-break key is the global scan position (min-reduced), computed
  from the shard's offset via ``axis_index`` — never from local order,
- WordPiece scores are exact IEEE-double bit patterns (ops/bitmath.py),
  so replicated selection is identical on every shard.

Reduction strategy (bandwidth-lean two-phase top-K):

1. every shard aggregates its local pairs (sort + run aggregation, the
   same kernel as single-device) and nominates its top-K runs by local
   count (BPE) / local exact-double score (WordPiece);
2. the K*D-key candidate union is all_gather'd (K*D elements — NOT the
   corpus), each shard looks up its exact local (count, min position) for
   every candidate by binary search into its sorted runs, and the lookups
   are psum/pmin-combined into exact global statistics;
3. the winner is selected over the candidates with the single-device
   selection core (ops/pairstats._select / wp_select_core semantics);
4. a Σ-threshold certificate proves no non-candidate can win: a pair
   outside every shard's top-K has local metric ≤ that shard's K-th best,
   so its global metric ≤ Σ_i T_i.  BPE compares integer counts exactly;
   WordPiece bounds the *rational* scores in scaled-integer arithmetic
   with explicit margins for double rounding (two distinct rationals can
   round to the same double, where the reference tie-breaks by insertion
   order — the margin forces a fallback whenever that could matter).

When the certificate fails (rare: flat count distributions late in
training), the caller falls back to the exact all_gather path
(:func:`sharded_bpe_select` / :func:`sharded_wp_select`) for that step —
the fallback trades bandwidth, never correctness.

Per-step communication: O(K * n_devices) for the two-phase path vs
O(corpus positions) for the exact path.  The merge *application* is
embarrassingly row-parallel and runs entirely shard-local.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.bitmath import bitlen
from ..ops.pairstats import (_consts, _run_aggregate, _select, _wdtype,
                             compact_cands, symbol_freqs, wp_score_bits,
                             wp_select_core)
from .mesh import DATA_AXIS

# Candidates nominated per shard per step. Measured on pan_tadeusz[:300]
# @ vocab 600 on 8 shards: K=64 proves 15% of steps, K=256 proves 26%,
# K=1024 proves 100% (complete nomination — every local run nominated).
# Unproven steps settle exactly at the compacted-runs tier; K trades the
# certificate hit-rate against phase-2 candidate traffic.
TOPK = 256


def run_gather_cap(n_local_pairs: int) -> int:
    """Distinct-run cap for the compacted-runs exact tier: a quarter of
    the local pair slots (distinct pairs measure ~9x fewer — see
    ops/train_loop._cand_cap), floored so tiny shards stay exact and
    clamped so the gather never exceeds the full position gather."""
    cap = max(n_local_pairs // 4, 1024)
    return min(-(-cap // 256) * 256, max(n_local_pairs, 1))

# Scaled-integer bound arithmetic for the WordPiece certificate.
_SCALE_BITS = 36          # kth_c < 2^26  ⇒  kth_c << 36 < 2^62 (no ovf)
_SAT = jnp.int64(1) << 55  # per-shard saturation; psum stays < 2^63 for
                           # any realistic device count


def _local_pairs(sym, freq, narrow: bool = False, w32: bool = False):
    """Local (keys, global_pos, weights) with shard-offset positions.

    Weights take :func:`~..ops.pairstats._wdtype` — i32 whenever the total
    corpus weight fits, so the downstream run aggregation scans i32 even
    with wide keys (ops/pairstats docstring)."""
    dt, bits, _, sentinel, _ = _consts(narrow)
    n, L = sym.shape
    a = sym[:, :-1].astype(dt)
    b = sym[:, 1:].astype(dt)
    valid = (a >= 0) & (b >= 0)
    keys = jnp.where(valid, (a << bits) | b, sentinel).reshape(-1)
    shard = jax.lax.axis_index(DATA_AXIS).astype(dt)
    pos = jnp.arange(n * (L - 1), dtype=dt) + shard * (n * (L - 1))
    w = jnp.broadcast_to(freq.astype(_wdtype(narrow, w32))[:, None],
                         (n, L - 1)).reshape(-1)
    return keys, pos, w


def _local_sym_freq(sym_l, freq_l, sym_cap, dt):
    n, L = sym_l.shape
    flat = sym_l.reshape(-1)
    wsym = jnp.broadcast_to(freq_l.astype(dt)[:, None], (n, L)).reshape(-1)
    local = symbol_freqs(flat, wsym, sym_cap)
    return jax.lax.psum(local, DATA_AXIS)


def _lookup_runs(k_s, p_s, run_total, cand, sentinel, pos_max):
    """Exact local (count, min position) of each candidate key, by binary
    search into this shard's sorted runs (0 / +inf when absent)."""
    j = jnp.searchsorted(k_s, cand)
    j = jnp.minimum(j, k_s.shape[0] - 1)
    found = (k_s[j] == cand) & (cand != sentinel)
    cnt = jnp.where(found, run_total[j], 0)
    pos = jnp.where(found, p_s[j], pos_max)
    return cnt, pos


# --------------------------------------------------------------- exact path

@partial(jax.jit, static_argnames=("mesh", "narrow", "w32"))
def sharded_bpe_select(mesh, sym, freq, narrow: bool = False,
                       w32: bool = False):
    """Exact global BPE selection: all_gather the full pair statistics
    (O(corpus) comm — the certificate-failure fallback).

    Returns replicated (best_key, best_count, best_first_seen)."""

    @partial(shard_map, mesh=mesh,
             in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
             out_specs=(P(), P(), P()), check_vma=False)
    def step(sym_l, freq_l):
        keys, pos, w = _local_pairs(sym_l, freq_l, narrow, w32)
        keys_g = jax.lax.all_gather(keys, DATA_AXIS, tiled=True)
        pos_g = jax.lax.all_gather(pos, DATA_AXIS, tiled=True)
        w_g = jax.lax.all_gather(w, DATA_AXIS, tiled=True)
        k_s, p_s, run_total, is_cand = _run_aggregate(keys_g, pos_g, w_g,
                                                      narrow)
        return _select(k_s, p_s, run_total, is_cand)

    return step(sym, freq)


@partial(jax.jit, static_argnames=("mesh", "sym_cap", "narrow", "cand_cap",
                                   "wide_score", "w32"))
def sharded_wp_select(mesh, sym, freq, sym_cap, narrow: bool = False,
                      cand_cap=None, wide_score: bool = False,
                      w32: bool = False):
    """Exact global WordPiece selection over all_gather'd pair statistics
    (the certificate-failure fallback). Scoring and tie-breaks go through
    the same :func:`~..ops.pairstats.wp_select_core` as every other path.

    Returns replicated (best_key, best_bits, best_first_seen, best_count).
    """
    wdt = _wdtype(narrow, w32)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
             out_specs=(P(), P(), P(), P()), check_vma=False)
    def step(sym_l, freq_l):
        sym_freq = _local_sym_freq(sym_l, freq_l, sym_cap, wdt)
        keys, pos, w = _local_pairs(sym_l, freq_l, narrow, w32)
        keys_g = jax.lax.all_gather(keys, DATA_AXIS, tiled=True)
        pos_g = jax.lax.all_gather(pos, DATA_AXIS, tiled=True)
        w_g = jax.lax.all_gather(w, DATA_AXIS, tiled=True)
        k_s, p_s, run_total, is_cand = _run_aggregate(keys_g, pos_g, w_g,
                                                      narrow)
        return wp_select_core(k_s, p_s, run_total, is_cand, sym_freq,
                              narrow, cand_cap, wide_score)

    return step(sym, freq)


# ---------------------------------------------- compacted-runs exact path

@partial(jax.jit, static_argnames=("mesh", "narrow", "cap", "w32"))
def sharded_bpe_select_compact(mesh, sym, freq, narrow: bool, cap: int,
                               w32: bool = False):
    """Exact global BPE selection over *compacted local runs*: every shard
    gathers only its distinct (key, count, min-position) runs (≤ ``cap``
    each — distinct pairs measure ~9x fewer than positions), and the
    gathered runs re-aggregate with the same sort/run kernel, weights now
    being local counts. O(cap * D) comm, exact whenever no shard
    overflowed ``cap``.

    Returns replicated (best_key, best_count, best_first_seen, exact);
    ``exact`` False ⇒ some shard had more than ``cap`` distinct runs and
    the caller must use :func:`sharded_bpe_select`."""
    dt, _, _, sentinel, pos_max = _consts(narrow)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
             out_specs=(P(), P(), P(), P()), check_vma=False)
    def step(sym_l, freq_l):
        keys, pos, w = _local_pairs(sym_l, freq_l, narrow, w32)
        k_s, p_s, run_total, is_cand = _run_aggregate(keys, pos, w, narrow)
        ck, cp, cc, cmask, ovf = compact_cands(k_s, p_s, run_total,
                                               is_cand, cap, narrow)
        gk = jax.lax.all_gather(ck, DATA_AXIS, tiled=True)
        gp = jax.lax.all_gather(cp, DATA_AXIS, tiled=True)
        gc = jax.lax.all_gather(cc, DATA_AXIS, tiled=True)
        K_s, P_s, tot, cand = _run_aggregate(gk, gp, gc, narrow)
        best_key, best_cnt, best_fs = _select(K_s, P_s, tot, cand)
        any_ovf = jax.lax.psum(ovf.astype(jnp.int32), DATA_AXIS) > 0
        return best_key, best_cnt, best_fs, ~any_ovf

    return step(sym, freq)


@partial(jax.jit, static_argnames=("mesh", "sym_cap", "narrow", "cap",
                                   "wide_score", "w32"))
def sharded_wp_select_compact(mesh, sym, freq, sym_cap, narrow: bool,
                              cap: int, wide_score: bool = False,
                              w32: bool = False):
    """Exact global WordPiece selection over compacted local runs (see
    :func:`sharded_bpe_select_compact`); scoring goes through the shared
    :func:`~..ops.pairstats.wp_select_core`.

    Returns replicated (best_key, best_bits, best_first_seen, best_count,
    exact)."""
    wdt = _wdtype(narrow, w32)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
             out_specs=(P(), P(), P(), P(), P()), check_vma=False)
    def step(sym_l, freq_l):
        sym_freq = _local_sym_freq(sym_l, freq_l, sym_cap, wdt)
        keys, pos, w = _local_pairs(sym_l, freq_l, narrow, w32)
        k_s, p_s, run_total, is_cand = _run_aggregate(keys, pos, w, narrow)
        ck, cp, cc, cmask, ovf = compact_cands(k_s, p_s, run_total,
                                               is_cand, cap, narrow)
        gk = jax.lax.all_gather(ck, DATA_AXIS, tiled=True)
        gp = jax.lax.all_gather(cp, DATA_AXIS, tiled=True)
        gc = jax.lax.all_gather(cc, DATA_AXIS, tiled=True)
        K_s, P_s, tot, cand = _run_aggregate(gk, gp, gc, narrow)
        # Zipf overlap keeps global distinct pairs near the per-shard
        # count (usually ≤ cap); compact once more so the exact-double
        # division runs per distinct pair, not per gathered slot —
        # wp_select_core cond-falls-back to full width if the union is
        # larger (exact either way).
        bk, bb, bf, bc = wp_select_core(K_s, P_s, tot, cand, sym_freq,
                                        narrow, cap, wide_score)
        any_ovf = jax.lax.psum(ovf.astype(jnp.int32), DATA_AXIS) > 0
        return bk, bb, bf, bc, ~any_ovf

    return step(sym, freq)


# ----------------------------------------------------------- two-phase path

@partial(jax.jit, static_argnames=("mesh", "narrow", "topk", "w32"))
def sharded_bpe_select_topk(mesh, sym, freq, narrow: bool = False,
                            topk: int = TOPK, w32: bool = False):
    """Two-phase BPE selection (O(K*D) comm) with a Σ-threshold
    certificate.

    Returns replicated (best_key, best_count, best_first_seen, proven).
    When ``proven`` is False the result may be wrong — the caller must
    redo the step with :func:`sharded_bpe_select`."""
    dt, _, _, sentinel, pos_max = _consts(narrow)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
             out_specs=(P(), P(), P(), P()), check_vma=False)
    def step(sym_l, freq_l):
        keys, pos, w = _local_pairs(sym_l, freq_l, narrow, w32)
        k_s, p_s, run_total, is_cand = _run_aggregate(keys, pos, w, narrow)

        # Phase 1: local top-K runs by count.
        metric = jnp.where(is_cand, run_total,
                           jnp.asarray(-1, run_total.dtype))
        k = min(topk, metric.shape[0])
        topv, topi = jax.lax.top_k(metric, k)
        cand_l = jnp.where(topv > 0, k_s[topi], sentinel)
        # K-th best local count: any non-nominated pair on this shard has
        # count <= t (0 when every local run was nominated).
        t = jnp.maximum(topv[k - 1], 0)

        # Phase 2: exact global stats for the candidate union.
        cand = jax.lax.all_gather(cand_l, DATA_AXIS, tiled=True)
        cnt_l, pos_l = _lookup_runs(k_s, p_s, run_total, cand, sentinel,
                                    pos_max)
        g_cnt = jax.lax.psum(cnt_l, DATA_AXIS)
        g_pos = jax.lax.pmin(pos_l, DATA_AXIS)
        sum_t = jax.lax.psum(t, DATA_AXIS)

        valid = (cand != sentinel) & (g_cnt > 0)
        best_key, best_cnt, best_fs = _select(cand, g_pos, g_cnt, valid)

        # Certificate: a pair outside every shard's top-K has global count
        # <= Σ t_i.  sum_t == 0 ⇔ every run everywhere was nominated (the
        # candidate set is complete).  Integer compare — exact.
        proven = (best_cnt > sum_t) | (sum_t == 0)
        return best_key, best_cnt, best_fs, proven

    return step(sym, freq)


@partial(jax.jit, static_argnames=("mesh", "sym_cap", "narrow", "topk",
                                   "cand_cap", "wide_score", "w32"))
def sharded_wp_select_topk(mesh, sym, freq, sym_cap, narrow: bool = False,
                           topk: int = TOPK, cand_cap=None,
                           wide_score: bool = False, w32: bool = False):
    """Two-phase WordPiece selection (O(K*D) comm) with a scaled-integer
    Σ-threshold certificate over the exact rational scores.

    Returns replicated (best_key, best_bits, best_first_seen, best_count,
    proven). When ``proven`` is False the caller must redo the step with
    :func:`sharded_wp_select`."""
    dt, bits, space, sentinel, pos_max = _consts(narrow)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
             out_specs=(P(), P(), P(), P(), P()), check_vma=False)
    def step(sym_l, freq_l):
        sym_freq = _local_sym_freq(sym_l, freq_l, sym_cap,
                                   _wdtype(narrow, w32))
        keys, pos, w = _local_pairs(sym_l, freq_l, narrow, w32)
        k_s, p_s, run_total, is_cand = _run_aggregate(keys, pos, w, narrow)

        # Phase 1: local top-K runs by local exact-double score (global
        # denominators — sym_freq is already psum'd, so local score =
        # local_count/(fa*fb) and global score = Σ_shards local score).
        # The expensive exact-double scoring runs over *compacted*
        # candidates; if the compaction cap ever overflows the nomination
        # is incomplete and this shard vetoes the certificate.
        if cand_cap is None or cand_cap >= k_s.shape[0]:
            ck, cp_, cc, cmask = k_s, p_s, run_total, is_cand
            c_ovf = jnp.bool_(False)
        else:
            ck, cp_, cc, cmask, c_ovf = compact_cands(
                k_s, p_s, run_total, is_cand, cand_cap, narrow)
        score = wp_score_bits(ck, cc, cmask, sym_freq, narrow, wide_score)
        metric = jnp.where(cmask, score, jnp.int64(-1))
        k = min(topk, metric.shape[0])
        topv, topi = jax.lax.top_k(metric, k)
        cand_l = jnp.where(topv >= 0, ck[topi], sentinel)

        # K-th best local score as an exact rational c/d for the bound.
        kth_i = topi[k - 1]
        kth_sel = topv[k - 1] >= 0
        kth_c = jnp.where(kth_sel, cc[kth_i], 0).astype(jnp.int64)
        ka = ((ck[kth_i] >> bits) & (space - 1)).astype(jnp.int32)
        kb = (ck[kth_i] & (space - 1)).astype(jnp.int32)
        kfa = sym_freq[ka].astype(jnp.int64)
        kfb = sym_freq[kb].astype(jnp.int64)
        if wide_score:
            # fa*fb can overflow i64 here; a shard whose K-th denominator
            # does cannot bound its tail -> veto the certificate (the
            # compact tier stays exact via the 128-bit scorer).
            kth_unsafe = bitlen(jnp.maximum(kfa, 1)) + \
                bitlen(jnp.maximum(kfb, 1)) > 62
            kfa = jnp.where(kth_unsafe, 1, kfa)
            kfb = jnp.where(kth_unsafe, 1, kfb)
            # Keep q = (kth_c << 36) // kth_d overflow-free under the
            # clamped denominator; t stays nonzero (sum_t != 0) and
            # ``saturated`` below vetoes the certificate anyway.
            kth_c = jnp.where(kth_unsafe, 1, kth_c)
        kth_d = jnp.maximum(kfa * kfb, 1)
        # Scaled ceil with margin: t >= r * 2^36 for ANY non-nominated
        # rational r on this shard.  A non-nominated pair's *double* is
        # <= the K-th double, so its rational can exceed kth_c/kth_d by
        # at most one part in 2^52 — the (q >> 50) + 2 margin covers it.
        q = (kth_c << _SCALE_BITS) // kth_d
        t = jnp.where(kth_sel, jnp.minimum(q + (q >> 50) + 2, _SAT), 0)
        saturated = (kth_sel & (q + (q >> 50) + 2 >= _SAT)) | c_ovf
        if wide_score:
            saturated = saturated | (kth_sel & kth_unsafe)

        # Phase 2: exact global stats for the candidate union.
        cand = jax.lax.all_gather(cand_l, DATA_AXIS, tiled=True)
        cnt_l, pos_l = _lookup_runs(k_s, p_s, run_total, cand, sentinel,
                                    pos_max)
        g_cnt = jax.lax.psum(cnt_l, DATA_AXIS)
        g_pos = jax.lax.pmin(pos_l, DATA_AXIS)
        sum_t = jax.lax.psum(t, DATA_AXIS)
        any_sat = jax.lax.psum(saturated.astype(jnp.int32), DATA_AXIS) > 0

        valid = (cand != sentinel) & (g_cnt > 0)
        g_bits = wp_score_bits(cand, g_cnt, valid, sym_freq, narrow,
                               wide_score)
        best_key, best_bits, best_fs = _select(cand, g_pos, g_bits, valid)
        best_cnt = jnp.max(jnp.where((cand == best_key) & valid, g_cnt,
                                     jnp.asarray(-1, dtype=g_cnt.dtype)))

        # Certificate: best rational must exceed Σ t_i / 2^36 by more than
        # one double-ulp so no non-candidate can even TIE after rounding
        # (ties would hand the win to an earlier-inserted non-candidate).
        ba = ((best_key >> bits) & (space - 1)).astype(jnp.int32)
        bb = (best_key & (space - 1)).astype(jnp.int32)
        bfa = sym_freq[ba].astype(jnp.int64)
        bfb = sym_freq[bb].astype(jnp.int64)
        best_unsafe = jnp.bool_(False)
        if wide_score:
            best_unsafe = bitlen(jnp.maximum(bfa, 1)) + \
                bitlen(jnp.maximum(bfb, 1)) > 62
            bfa = jnp.where(best_unsafe, 1, bfa)
            bfb = jnp.where(best_unsafe, 1, bfb)
        bd = jnp.maximum(bfa * bfb, 1)
        lhs = (jnp.maximum(best_cnt, 0).astype(jnp.int64)
               << _SCALE_BITS) // bd
        proven = ((lhs > sum_t + (sum_t >> 50) + 2) & ~any_sat
                  & ~best_unsafe) | (sum_t == 0)
        return best_key, best_bits, best_fs, best_cnt, proven

    return step(sym, freq)


# ------------------------------------------------------------- application

@partial(jax.jit, static_argnames=("mesh",))
def sharded_apply_merge(mesh, sym, a, b, new_id):
    """Row-local merge application on every shard."""
    from ..ops.merge import apply_merge

    @partial(shard_map, mesh=mesh,
             in_specs=(P(DATA_AXIS), P(), P(), P()),
             out_specs=P(DATA_AXIS), check_vma=False)
    def step(sym_l, a_, b_, n_):
        return apply_merge(sym_l, a_, b_, n_)

    return step(sym, jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32),
                jnp.asarray(new_id, jnp.int32))


def shard_corpus(mesh, sym, freq):
    """Pad rows to a multiple of the mesh size and device_put with
    row sharding. Padding rows are all-PAD with zero frequency — they
    contribute no pairs and no counts, and they are appended at the end
    so global scan positions of real rows are unchanged."""
    import numpy as np
    n_dev = mesh.devices.size
    n, L = sym.shape
    pad = (-n) % n_dev
    if pad:
        sym = np.concatenate(
            [sym, np.full((pad, L), -1, dtype=sym.dtype)], axis=0)
        freq = np.concatenate(
            [freq, np.zeros(pad, dtype=freq.dtype)], axis=0)
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    return (jax.device_put(jnp.asarray(sym), sharding),
            jax.device_put(jnp.asarray(freq), sharding))


def rows_per_device(arr) -> dict:
    """Rows of a row-sharded array held by each device, by device name."""
    return {str(s.device): int(s.data.shape[0])
            for s in arr.addressable_shards}
