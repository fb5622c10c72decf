"""Compact device->host fetch for row-batched encode kernels.

Fetching a padded [rows, CAP] i32 token matrix moves ~10x the bytes
of the dense token stream, over many calls; this was built for a
remote link that charged a fixed latency per transfer call (whether it
still pays over the GPU's local PCIe link is unmeasured). The pattern
here (shared by the FastWP
e2e path, the NaiveWP greedy matcher, and the BPE merge-loop encoder):

1. run ALL length-sorted row slices in ONE device program
   (``lax.map`` over the slice axis keeps each slice's lockstep
   while_loop exiting at its own max row length);
2. compact the per-row token prefixes into one dense u16 stream on
   device (:func:`compact_ids`);
3. fetch (static stream prefix, counts, flags, total) in ONE call
   (:func:`fetch_compact`) — ~0.4 MB in a single call instead of
   ~5 MB over dozens; only a prefix overflow (rare: the
   prefix budgets 6 tokens/word) pays a second call.

Rows whose ``flags`` byte is nonzero make the caller fall back to its
legacy padded path, which raises the reference-documented errors —
the compact path is a transfer-schedule optimization only, never a
semantic change.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def compact_ids(out2d, out_n):
    """Traced helper: dense u16 token stream from per-row prefixes.

    out2d: i32[R, CAP] token ids, valid as a prefix of each row;
    out_n: i32[R]. Returns (ids u16[R*CAP] with the first ``total``
    elements dense row-major, total i32). Ids must fit u16 — callers
    gate on their output-table size.
    """
    R, CAP = out2d.shape
    cols = jnp.arange(CAP, dtype=jnp.int32)[None, :]
    emitted = cols < out_n[:, None]
    cum = jnp.cumsum(out_n)
    offs = cum - out_n
    total = cum[-1] if R else jnp.int32(0)
    dest = jnp.where(emitted, offs[:, None] + cols, R * CAP)
    ids = jnp.zeros(R * CAP, jnp.uint16).at[dest.reshape(-1)].set(
        out2d.astype(jnp.uint16).reshape(-1), mode="drop")
    return ids, total


def stack_sorted(arrays, pad_values, lengths):
    """Length-sort rows, quantize the row count, and stack into
    [B, sr, ...] slices (the host half of the one-dispatch scan).

    Returns (stacked arrays, order, pad, B, sr). Padding rows sit at
    the FRONT of the sorted layout (shortest slice); ``pad_values``
    must make them no-ops for the kernel.
    """
    from ..core.batching import quantize_rows, slice_rows_for

    W = arrays[0].shape[0]
    order = np.argsort(lengths, kind="stable")
    R = quantize_rows(W)
    pad = R - W
    sr = min(R, slice_rows_for(R))
    B = R // sr
    stacked = []
    for arr, pv in zip(arrays, pad_values):
        out = np.full((R,) + arr.shape[1:], pv, dtype=arr.dtype)
        out[pad:] = arr[order]
        stacked.append(out.reshape((B, sr) + arr.shape[1:]))
    return stacked, order, pad, B, sr


def fetch_compact(pref_d, ids_d, out_n_d, flags_d, total_d, order, pad):
    """ONE-call fetch + original-row-order reassembly.

    ``pref_d`` is the kernel's static-size prefix of the dense stream —
    it rides in the same device_get as the counts, so the common case
    (total <= prefix size) costs a single transfer call; only an
    overflowing batch pays a second fetch of the full stream.

    Returns (ids i32[total], starts i64[W], counts i32[W]) with
    starts/counts indexed by ORIGINAL row id, or None when any row's
    flags byte is nonzero (caller falls back to its legacy path, which
    owns the error semantics). ``ids_d`` is the dense stream from
    :func:`compact_ids` (device), ``order``/``pad`` from
    :func:`stack_sorted`.
    """
    pref, out_n, flags, total = jax.device_get(
        (pref_d, out_n_d, flags_d, total_d))
    out_n = np.asarray(out_n).reshape(-1)
    if np.asarray(flags).any():
        return None
    total = int(total)
    R = out_n.size
    W = order.size
    if total == 0:
        ids = np.zeros(0, dtype=np.int32)
    elif total <= pref.size:
        ids = np.asarray(pref)[:total].astype(np.int32)
    else:
        n_max = int(ids_d.size)
        nq = min(n_max, max(4096, 1 << (total - 1).bit_length()))
        ids = np.asarray(jax.device_get(ids_d[:nq]))[:total].astype(
            np.int32)
    starts_sorted = np.zeros(R, dtype=np.int64)
    np.cumsum(out_n[:-1], out=starts_sorted[1:])
    starts = np.empty(W, dtype=np.int64)
    counts = np.empty(W, dtype=np.int32)
    starts[order] = starts_sorted[pad:]
    counts[order] = out_n[pad:]
    return ids, starts, counts
