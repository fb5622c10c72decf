"""Flat (non-padded) corpus representation for training.

The padded ``[n_words, max_len]`` tensor is mostly PAD (~70% for typical
corpora: mean word length ~6, max ~22+), and the per-step sort pays for
every slot. Here the corpus is a flat concatenation of word symbol
sequences:

- ``fs``  : i32[F] symbol ids, word-major (PAD -1 suffix),
- ``wid`` : i32[F] word index per slot (large sentinel on padding),
- ``wgt`` : weight per slot (the word's frequency).

The flat index *is* the reference's scan order (word-major, then position),
and the global left-compaction after a merge shifts positions exactly like
rebuilding the reference's Python lists — so first-seen tie-break
comparisons are unchanged. Pair validity additionally requires both slots
to belong to the same word.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .pairstats import _consts, _run_aggregate, _wdtype

WID_PAD = np.int32(2**30)


def build_flat(sym2d: np.ndarray, freq: np.ndarray, pad_to: int = 1024,
               w32: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten a padded host tensor into (fs, wid, wgt) with tail padding.

    ``w32`` stores weights as i32 (valid when the total corpus weight is
    < 2^31) — less sort traffic per step (see ops/pairstats docstring)."""
    mask = sym2d >= 0
    fs = sym2d[mask].astype(np.int32)
    wid = np.nonzero(mask)[0].astype(np.int32)
    wgt = freq[wid].astype(np.int32 if w32 else np.int64)
    n = fs.size
    F = -(-max(n, 2) // pad_to) * pad_to
    pad = F - n
    if pad:
        fs = np.concatenate([fs, np.full(pad, -1, np.int32)])
        wid = np.concatenate([wid, np.full(pad, WID_PAD, np.int32)])
        wgt = np.concatenate([wgt, np.zeros(pad, wgt.dtype)])
    return fs, wid, wgt


def flat_pairs(fs: jax.Array, wid: jax.Array, narrow: bool):
    """Packed pair keys over flat slots; invalid across word boundaries."""
    dt, bits, _, sentinel, _ = _consts(narrow)
    a = fs[:-1].astype(dt)
    b = fs[1:].astype(dt)
    valid = (a >= 0) & (b >= 0) & (wid[:-1] == wid[1:])
    keys = jnp.where(valid, (a << bits) | b, sentinel)
    pos = jnp.arange(fs.shape[0] - 1, dtype=dt)
    return keys, pos


def flat_aggregate(fs, wid, wgt, narrow: bool, w32: bool = False):
    """(k_s, p_s, run_total, is_cand) over flat pairs."""
    keys, pos = flat_pairs(fs, wid, narrow)
    w = wgt[:-1].astype(_wdtype(narrow, w32))
    return _run_aggregate(keys, pos, w, narrow)


def _shift_up(x, k, fill):
    """x[i + k] with out-of-range slots filled (static k)."""
    return jnp.concatenate(
        [x[k:], jnp.full((k,), fill, x.dtype)])


def _shift_down(x, k, fill):
    """x[i - k] with out-of-range slots filled (static k)."""
    return jnp.concatenate(
        [jnp.full((k,), fill, x.dtype), x[:-k]])


def compact_flat(fs, wid, wgt):
    """Left-compact live slots, preserving scan order (stable sort by
    liveness — payloads IN the sort; see the gather note in
    :func:`flat_apply`)."""
    livekey = jnp.where(fs >= 0, jnp.int32(0), jnp.int32(1))
    _, cfs, cwid, cwgt = jax.lax.sort((livekey, fs, wid, wgt),
                                      num_keys=1, is_stable=True)
    return cfs, cwid, cwgt


def skip_overflow(fs, wid, S: int, nsym=None):
    """True when some live slot's next live neighbour is further than
    ``S + 1`` slots away (and a later live slot exists at all) — the
    skip-window adjacency of :func:`skip_next` would then MISS a pair, so
    the caller must compact first. Conservative across words (a >S dead
    gap between words also triggers), which only costs an extra
    compaction, never correctness. Pass ``nsym`` (a :func:`skip_next`
    result for the same state) to reuse its found/not-found information
    instead of re-deriving it."""
    live = fs >= 0
    if nsym is not None:
        found = nsym >= 0
    else:
        found = jnp.zeros_like(live)
        for k in range(1, S + 2):
            found = found | _shift_up(live, k, False)
    suffix = jnp.flip(jax.lax.cummax(jnp.flip(live.astype(jnp.int32))))
    later = _shift_up(suffix, 1, jnp.int32(0)) > 0
    return jnp.any(live & later & ~found)


def skip_next(fs, wid, S: int):
    """(nsym, nwid): symbol/word of each slot's nearest LIVE successor
    within ``S + 1`` slots (-1 / WID_PAD when none). With per-step
    left-compaction deferred, dead slots accumulate between live
    neighbours; this select chain recovers pair adjacency without a
    gather (chosen where random gathers were slow; unmeasured on the
    GPU)."""
    F = fs.shape[0]
    nsym = jnp.full((F,), -1, jnp.int32)
    nwid = jnp.full((F,), WID_PAD, jnp.int32)
    for k in range(1, S + 2):
        cs = _shift_up(fs, k, jnp.int32(-1))
        cw = _shift_up(wid, k, WID_PAD)
        take = (nsym < 0) & (cs >= 0)
        nsym = jnp.where(take, cs, nsym)
        nwid = jnp.where(take, cw, nwid)
    return nsym, nwid


def skip_prev_select(fs, S: int, payload, fill):
    """payload value at each slot's nearest LIVE predecessor within
    ``S + 1`` slots (``fill`` when none)."""
    F = fs.shape[0]
    out = jnp.full((F,), fill, payload.dtype)
    done = jnp.zeros((F,), bool)
    for k in range(1, S + 2):
        cs = _shift_down(fs, k, jnp.int32(-1))
        cp = _shift_down(payload, k, fill)
        take = ~done & (cs >= 0)
        out = jnp.where(take, cp, out)
        done = done | (cs >= 0)
    return out


def flat_skip_aggregate(fs, wid, wgt, nsym, nwid, cpos, narrow: bool,
                        w32: bool = False):
    """(k_s, p_s, run_total, is_cand) over skip-window pairs.

    Pair position (the first-seen tie-break key) is ``cpos`` — the slot's
    COMPACTED index (cumsum of liveness) — so tie-break comparisons are
    bit-identical to the compact-every-step path: deletion never reorders
    surviving slots, it only shifts their indices, and ``cpos`` applies
    exactly that shift. Dead slots share their predecessor's cpos but
    carry sentinel keys and zero weight, so run aggregation is unaffected.
    """
    dt, bits, _, sentinel, _ = _consts(narrow)
    valid = (fs >= 0) & (nsym >= 0) & (nwid == wid)
    keys = jnp.where(valid,
                     (fs.astype(dt) << bits) | nsym.astype(dt), sentinel)
    pos = cpos.astype(dt)
    w = jnp.where(fs >= 0, wgt, 0).astype(_wdtype(narrow, w32))
    return _run_aggregate(keys, pos, w, narrow)


def flat_skip_apply(fs, wid, wgt, nsym, nwid, cpos, a, b, new_id, S: int):
    """Merge all non-overlapping (a, b) skip-adjacencies IN PLACE (the
    consumed right slot becomes dead; no compaction). Same merge
    semantics as :func:`flat_apply`; self-overlap parity runs on ``cpos``
    so equal-symbol runs spanning dead slots behave as if compacted."""
    live = fs >= 0
    a = jnp.asarray(a, jnp.int32)
    b = jnp.asarray(b, jnp.int32)
    new_id = jnp.asarray(new_id, jnp.int32)
    match = live & (fs == a) & (nsym == b) & (nwid == wid)

    def with_parity(m):
        # Self-merge (a == b) only: equal-symbol runs spanning dead slots
        # keep merges at even in-run offsets, computed on cpos. Steps
        # with a != b (the vast majority) skip these two select chains
        # entirely — the cond predicate is a scalar.
        psym = skip_prev_select(fs, S, fs, jnp.int32(-2))
        pwid = skip_prev_select(fs, S, wid, jnp.int32(-2))
        change = (fs != psym) | (wid != pwid)
        run_start_c = jax.lax.cummax(
            jnp.where(change & live, cpos, jnp.int32(0)))
        parity_ok = ((cpos - run_start_c) & 1) == 0
        return m & parity_ok

    match = jax.lax.cond(a == b, with_parity, lambda m: m, match)

    pmatch = skip_prev_select(fs, S, match, False)
    dead_new = live & pmatch
    nfs = jnp.where(match, new_id, fs)
    nfs = jnp.where(dead_new, jnp.int32(-1), nfs)
    nwid2 = jnp.where(dead_new, WID_PAD, wid)
    nwgt = jnp.where(dead_new, 0, wgt)
    n_rep = jnp.sum(jnp.where(match, wgt, 0))
    return nfs, nwid2, nwgt, n_rep


def flat_apply(fs, wid, wgt, a, b, new_id):
    """Merge all non-overlapping (a, b) adjacencies and left-compact.

    Same semantics as ops/merge.apply_merge, on the flat layout; the
    compaction is one stable 4-operand sort by liveness. Additionally
    returns ``n_rep`` — the total corpus *weight* of replacements
    performed (each replacement consumes one ``a`` and one ``b`` token and
    produces one ``new_id`` token, so symbol frequencies update exactly as
    ``freq[a] -= n_rep; freq[b] -= n_rep; freq[new_id] += n_rep`` — the
    incremental equivalent of the reference's per-step recount,
    source/wordpiece.py:78-81).
    """
    F = fs.shape[0]
    a = jnp.asarray(a, jnp.int32)
    b = jnp.asarray(b, jnp.int32)
    new_id = jnp.asarray(new_id, jnp.int32)
    neg1 = jnp.full((1,), -1, jnp.int32)
    neg2 = jnp.full((1,), -2, jnp.int32)
    nxt = jnp.concatenate([fs[1:], neg1])
    wnxt = jnp.concatenate([wid[1:], neg2])
    match = (fs == a) & (nxt == b) & (wid == wnxt)

    # Self-overlap parity within same-symbol runs of one word.
    prev = jnp.concatenate([neg2, fs[:-1]])
    wprev = jnp.concatenate([neg2, wid[:-1]])
    change = (fs != prev) | (wid != wprev)
    js = jnp.arange(F, dtype=jnp.int32)
    run_start = jax.lax.cummax(jnp.where(change, js, 0))
    parity_ok = ((js - run_start) & 1) == 0
    match = match & jnp.where(a == b, parity_ok, True)

    dead = jnp.concatenate([jnp.zeros((1,), bool), match[:-1]])
    keep = (fs >= 0) & ~dead
    nfs = jnp.where(match, new_id, fs)
    nfs = jnp.where(keep, nfs, jnp.int32(-1))
    nwid = jnp.where(keep, wid, jnp.int32(WID_PAD))
    nwgt = jnp.where(keep, wgt, 0)
    # Left-compact with the payloads IN the sort rather than a permutation
    # sort + gathers (chosen where corpus-sized gathers lost to extra sort
    # operands; unmeasured on the GPU).
    livekey = jnp.where(keep, jnp.int32(0), jnp.int32(1))
    _, cfs, cwid, cwgt = jax.lax.sort((livekey, nfs, nwid, nwgt),
                                      num_keys=1, is_stable=True)
    n_rep = jnp.sum(jnp.where(match, wgt, 0))
    return cfs, cwid, cwgt, n_rep
