"""Batched BPE encoding on device.

Two encoder semantics, both as one jitted while-loop over a padded
word-type tensor (every word of a corpus encodes simultaneously):

- **greedy** (FastBPE, reference: source/bpe.py:205-243): repeatedly merge
  the present pair with the lowest rank, ranks from a dict built over the
  merge list (later duplicates overwrite earlier ones).
- **monotone** (NaiveBPE, reference: source/bpe.py:124-127): the reference
  applies *every* merge once, in order. That is equivalent to repeatedly
  applying the lowest-ranked present pair whose rank is >= a per-word
  cursor that moves past each applied rank (a merged pair cannot re-form
  at the same rank: its output strictly grows). This turns the reference's
  O(#merges × len) scan into O(len) iterations — with identical output.

Rank lookup is an open-addressing hash table probed with a small static
unroll (host precomputes the worst-case probe length) — ~2 gathers per
pair per iteration instead of a log2(#merges)-step binary search.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .pairstats import SYM_BITS

I32_INF = jnp.int32(2**31 - 1)
PAD = jnp.int32(-1)

HASH_GOLD = np.int64(-7046029254386353131)  # 2^64 / golden ratio, signed
HASH_SHIFT = 29


def build_rank_hash(entries) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      int]:
    """Open-addressing table for (packed pair key) -> (rank, merged id).

    ``entries``: iterable of (key, rank, out_id). Returns
    (hkeys i64[H], hrank i32[H], hout i32[H], max_probe).
    """
    entries = list(entries)
    H = 8
    while H < 4 * max(len(entries), 1):
        H *= 2
    hkeys = np.full(H, -1, dtype=np.int64)
    hrank = np.zeros(H, dtype=np.int32)
    hout = np.zeros(H, dtype=np.int32)
    max_probe = 1
    keys_arr = np.asarray([e[0] for e in entries], dtype=np.int64)
    with np.errstate(over="ignore"):
        # Mirror the device hash exactly (signed wrap + arithmetic shift).
        bases = ((keys_arr * HASH_GOLD) >> HASH_SHIFT) & (H - 1)
    for (key, rank, out), h0 in zip(entries, bases.tolist()):
        h = h0
        probes = 1
        while hkeys[h] != -1:
            h = (h + 1) & (H - 1)
            probes += 1
        hkeys[h] = key
        hrank[h] = rank
        hout[h] = out
        max_probe = max(max_probe, probes)
    return hkeys, hrank, hout, max_probe


def _pack(sym: jax.Array):
    n, L = sym.shape
    a = sym[:, :-1].astype(jnp.int64)
    b = sym[:, 1:].astype(jnp.int64)
    valid = (a >= 0) & (b >= 0)
    keys = jnp.where(valid, (a << SYM_BITS) | b, jnp.int64(-1))
    return keys, valid


def _lookup(hkeys, hrank, hout, keys, valid, max_probe):
    """Probe the rank table; returns (rank or INF, out id)."""
    H = hkeys.shape[0]
    base = ((keys * HASH_GOLD) >> HASH_SHIFT) & (H - 1)
    rank = jnp.full(keys.shape, I32_INF, jnp.int32)
    out = jnp.zeros(keys.shape, jnp.int32)
    for p in range(max_probe):
        idx = ((base + p) & (H - 1)).astype(jnp.int32)
        hit = valid & (hkeys[idx] == keys) & (rank == I32_INF)
        rank = jnp.where(hit, hrank[idx], rank)
        out = jnp.where(hit, hout[idx], out)
    return rank, out


def _apply_rows(sym, a_row, b_row, new_row):
    """apply_merge with a distinct (a, b, new_id) per row."""
    n, L = sym.shape
    a = a_row[:, None]
    b = b_row[:, None]
    nxt = jnp.concatenate([sym[:, 1:], jnp.full((n, 1), PAD, jnp.int32)],
                          axis=1)
    match = (sym == a) & (nxt == b)
    js = jax.lax.broadcasted_iota(jnp.int32, (n, L), 1)
    prev = jnp.concatenate([jnp.full((n, 1), jnp.int32(-2)), sym[:, :-1]],
                           axis=1)
    change = sym != prev
    run_start = jax.lax.cummax(jnp.where(change, js, 0), axis=1)
    parity_ok = ((js - run_start) & 1) == 0
    match = match & jnp.where(a == b, parity_ok, True)
    dead = jnp.concatenate([jnp.zeros((n, 1), bool), match[:, :-1]], axis=1)
    keep = (sym >= 0) & ~dead
    newsym = jnp.where(match, new_row[:, None], sym)
    newsym = jnp.where(keep, newsym, PAD)
    sortkey = jnp.where(keep, 0, 1).astype(jnp.int32)
    _, compacted = jax.lax.sort((sortkey, newsym), dimension=1, num_keys=1,
                                is_stable=True)
    return compacted


@partial(jax.jit, static_argnames=("monotone", "max_probe"))
def bpe_encode(sym: jax.Array, hkeys: jax.Array, hrank: jax.Array,
               hout: jax.Array, monotone: bool, max_probe: int
               ) -> jax.Array:
    """Encode every row of ``sym`` (i32[W, L] char ids, PAD-filled).

    hkeys/hrank/hout: rank hash table (build_rank_hash); greedy uses dict
    ranks, monotone first-occurrence ranks. Returns merged i32[W, L].
    """
    W, L = sym.shape
    if W == 0 or L < 2 or hkeys.shape[0] == 0:
        return sym

    def body(state):
        cur_sym, cursor, _ = state
        keys, valid = _pack(cur_sym)
        rank, out_tab = _lookup(hkeys, hrank, hout, keys, valid, max_probe)
        if monotone:
            rank = jnp.where(rank >= cursor[:, None], rank, I32_INF)
        best = jnp.min(rank, axis=1)
        bi = jnp.argmin(rank, axis=1)
        active = best < I32_INF

        rows = jnp.arange(W, dtype=jnp.int32)
        sel_key = keys[rows, bi]
        a = jnp.where(active, (sel_key >> SYM_BITS).astype(jnp.int32),
                      jnp.int32(-3))
        b = jnp.where(active, (sel_key & ((1 << SYM_BITS) - 1))
                      .astype(jnp.int32), jnp.int32(-3))
        out = out_tab[rows, bi]
        new_sym = _apply_rows(cur_sym, a, b, out)
        new_cursor = jnp.where(active, best + 1, cursor) if monotone \
            else cursor
        return new_sym, new_cursor, jnp.any(active)

    def cond(state):
        return state[2]

    cursor0 = jnp.zeros((W,), dtype=jnp.int32)
    final_sym, _, _ = jax.lax.while_loop(cond, body,
                                         (sym, cursor0, jnp.bool_(True)))
    return final_sym


@partial(jax.jit, static_argnames=("monotone", "max_probe", "nq"))
def bpe_encode_stacked(sym, hkeys, hrank, hout, monotone: bool,
                       max_probe: int, nq: int = 0):
    """All length-sorted slices in one device program + compact output
    stream (see ops/fetch.py). sym: i32[B, S, L]. The per-slice column
    quantization of the host-sliced path is traded away (one width for
    all slices) for one dispatch instead of one per slice.
    Returns (ids_prefix u16[nq], ids u16 dense stream, out_n i32[B*S],
    flags u8[B*S] = 0, total); the static-size prefix rides in the same
    fetch call as the counts (see ops/fetch.fetch_compact)."""
    from .fetch import compact_ids

    def one(s):
        return bpe_encode(s, hkeys, hrank, hout, monotone, max_probe)

    merged = jax.lax.map(one, sym)
    B, S, L = merged.shape
    merged = merged.reshape(B * S, L)
    out_n = jnp.sum((merged >= 0).astype(jnp.int32), axis=1)
    ids, total = compact_ids(merged, out_n)
    flags = jnp.zeros(B * S, jnp.uint8)
    return ids[:nq], ids, out_n, flags, total
