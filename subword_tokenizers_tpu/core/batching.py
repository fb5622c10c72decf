"""Length-sorted sliced execution of row-batched device kernels.

Every batched encoder here is a ``while_loop`` whose trip count is set by
the *slowest row* of the batch (the loop runs in lockstep until all rows
finish), so one monolithic batch costs ~rows x max-length iterations.
Sorting rows by a length key and slicing into fixed-row batches makes each
slice's trip count its own max length (the loop conditions are dynamic),
cutting total element-iterations to ~sum-of-lengths; slices dispatch
back-to-back, so the transfer of slice k+1 overlaps the device scan of
slice k on asynchronous backends.

Row counts quantize (ROW_QUANTA / multiples of SLICE_ROWS) so compiled
shapes repeat across corpora — each new shape is another XLA compile.
Padding rows go at the FRONT of
the sorted order (the cheapest slice); callers provide per-array pad
values that make padded rows no-ops for their kernel.
"""
from __future__ import annotations

from typing import Callable, Sequence

ROW_QUANTA = (1024, 2048, 4096, 8192)
SLICE_ROWS = ROW_QUANTA[-1]
# Slices per batch (upper bound): finer slices track the length
# distribution more closely (a batch that fits one slice gets no
# length-homogeneity benefit at all), at ~one extra dispatch each.
MAX_SLICES = 8


def quantize_rows(u: int) -> int:
    for q in ROW_QUANTA:
        if u <= q:
            return q
    return -(-u // SLICE_ROWS) * SLICE_ROWS


def slice_rows_for(total: int) -> int:
    return min(max(ROW_QUANTA[0], total // MAX_SLICES), SLICE_ROWS)


def sliced_rows(fn: Callable, arrays: Sequence, pad_values: Sequence,
                lengths, n_out: int, col_quantize: bool = False,
                out_col_pad: Sequence = ()):
    """Run ``fn(*row_slices) -> tuple of row-aligned outputs`` over
    length-sorted quantized row slices of ``arrays`` (numpy, shared
    leading dim W). Returns ``n_out`` host arrays in the original row
    order.

    ``col_quantize``: additionally trim each 2-D input slice's trailing
    columns to the slice's own max row length (rounded up to a multiple
    of 8) — for kernels whose per-trip cost is O(rows x width), a slice
    of short rows then pays its own width, not the batch max. 2-D
    outputs are re-padded to a common width with ``out_col_pad[j]``
    (default 0) before reassembly. Only worth it when ``fn``'s body
    scales with width (e.g. the BPE merge loop); the e2e scan's body is
    O(rows) per trip and gains nothing.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    W = arrays[0].shape[0]
    order = np.argsort(lengths, kind="stable")
    R = quantize_rows(W)
    pad = R - W
    padded = []
    for arr, pv in zip(arrays, pad_values):
        out = np.full((R,) + arr.shape[1:], pv, dtype=arr.dtype)
        out[pad:] = arr[order]
        padded.append(out)
    sorted_lens = np.zeros(R, dtype=np.int64)
    sorted_lens[pad:] = np.asarray(lengths, dtype=np.int64)[order]
    sr = min(R, slice_rows_for(R))
    parts = []
    for k in range(R // sr):
        sl = slice(k * sr, (k + 1) * sr)
        ins = [a[sl] for a in padded]
        if col_quantize:
            lq = -(-max(int(sorted_lens[(k + 1) * sr - 1]), 2) // 8) * 8
            ins = [a[:, :min(lq, a.shape[1])] if a.ndim == 2 else a
                   for a in ins]
        parts.append(fn(*[jnp.asarray(a) for a in ins]))
    fetched = jax.device_get(parts)
    cat = []
    for j in range(n_out):
        outs = [f[j] for f in fetched]
        if col_quantize and outs[0].ndim == 2:
            wmax = max(o.shape[1] for o in outs)
            pv = out_col_pad[j] if j < len(out_col_pad) else 0
            outs = [o if o.shape[1] == wmax else
                    np.concatenate([o, np.full((o.shape[0],
                                                wmax - o.shape[1]), pv,
                                               o.dtype)], axis=1)
                    for o in outs]
        cat.append(np.concatenate(outs)[pad:])
    inv = np.empty(W, dtype=np.int64)
    inv[order] = np.arange(W, dtype=np.int64)
    return tuple(a[inv] for a in cat)
