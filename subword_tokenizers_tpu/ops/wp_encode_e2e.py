"""Packed end-to-end WordPiece scan automaton.

Same semantics as the reference's FastWP loop (source/wordpiece.py:233-316)
— see ops/wp_encode.py for the semantic map — but engineered for a
per-iteration cost dominated by gather/scatter op overhead, not FLOPs:

- one gather for the character: alphabet id + (space, punct, prev-punct)
  class bits packed into a single i32 per position on the host;
- one gather for the node: (fail, pop-count, pops...) packed into one
  ``node_info`` row, fetched as a contiguous slice;
- one gather for the goto transition;
- ONE scatter per iteration: all emission cases (failure pops, the
  "['UNK']" rollback, the root_sharp corner sequence) merge into a single
  masked flat scatter of K columns.

Everything is i32: half the bytes of i64 per gathered word (chosen where
i64 was emulated; unmeasured on the GPU).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# packed char word: aid | sp<<22 | pc<<23 | prev_pc<<24
SP_BIT = 1 << 22
PC_BIT = 1 << 23
PREV_PC_BIT = 1 << 24
AID_MASK = (1 << 22) - 1

# node_info columns: 0=fail, 1=pop count, 2..2+P-1 = pops
NODE_INFO_POPS = 2

# Scan-body compositions per while_loop trip (see _wp_e2e_scan_impl).
UNROLL = 4


def pack_chars(aid, is_sp, is_pc):
    """Host/device helper: pack per-position char word (numpy-compatible)."""
    import numpy as np
    prev_pc = np.zeros_like(is_pc)
    prev_pc[:, 1:] = is_pc[:, :-1]
    return (aid.astype(np.int32)
            | (is_sp.astype(np.int32) << 22)
            | (is_pc.astype(np.int32) << 23)
            | (prev_pc.astype(np.int32) << 24))


def pack_node_info(fail, pops_off, pops_flat, width):
    """Host helper: [n_nodes, 2+width] packed node table."""
    import numpy as np
    n = fail.shape[0]
    info = np.zeros((n, NODE_INFO_POPS + width), dtype=np.int32)
    info[:, 0] = fail
    cnt = pops_off[1:] - pops_off[:-1]
    info[:, 1] = cnt
    for j in range(width):
        has = j < cnt
        idx = np.minimum(pops_off[:-1] + j,
                         max(len(pops_flat) - 1, 0))
        info[:, NODE_INFO_POPS + j] = np.where(
            has, pops_flat[idx] if len(pops_flat) else 0, 0)
    return info


# u16 wire format for the host->device transfer (half the bytes of the
# i32 packed char matrix; sized for a slow remote link, unmeasured over
# local PCIe): aid in bits 0..12, (sp, pc, prev_pc) in bits 13..15. Only valid while
# the alphabet fits 13 bits — callers check ``n_alpha < 1 << 13``.
U16_AID_MASK = (1 << 13) - 1


def pack_u16(pchar):
    """Host: canonical i32 packed chars -> u16 wire words (numpy)."""
    return ((pchar & U16_AID_MASK)
            | ((pchar >> 9) & 0xE000)).astype("uint16")


@partial(jax.jit, static_argnames=("n_pops", "sharp_seq"))
def wp_e2e_scan_u16(pchar16, slen, goto_table, node_info, root_p,
                    root_sharp, unk_id, sharp_seq, n_pops):
    """u16-wire variant of :func:`wp_e2e_scan` (same results)."""
    cw = pchar16.astype(jnp.int32)
    pchar = (cw & U16_AID_MASK) | ((cw & 0xE000) << 9)
    return _wp_e2e_scan_impl(pchar, slen, goto_table, node_info, root_p,
                             root_sharp, unk_id, sharp_seq, n_pops)


@partial(jax.jit, static_argnames=("n_pops", "sharp_seq"))
def wp_e2e_scan(pchar, slen, goto_table, node_info, root_p, root_sharp,
                unk_id, sharp_seq, n_pops):
    """Scan padded rows of packed chars; see module docstring.

    pchar: i32[S, T] packed char words (positions >= slen are spaces);
    slen: i32[S] lengths including the appended trailing space — callers
    MUST pad so slen < T for every row (the boundary check at i == slen
    reads pchar[:, i], whose PREV_PC bit must describe position slen-1;
    the chunked caller pads +2). Returns (out i32[S, CAP], out_n i32[S],
    overflow bool[S], stuck bool[S], crash bool[S]); ``crash`` marks rows
    where the reference's iswdbndry would read past the end and raise
    IndexError (source/wordpiece.py:285) — only reachable with
    whitespace-bearing vocab tokens.
    """
    return _wp_e2e_scan_impl(pchar, slen, goto_table, node_info, root_p,
                             root_sharp, unk_id, sharp_seq, n_pops)


def _wp_e2e_scan_impl(pchar, slen, goto_table, node_info, root_p,
                      root_sharp, unk_id, sharp_seq, n_pops):
    S, T = pchar.shape
    CAP = T + 4
    MAXITER = 6 * T + 64
    K = max(n_pops, len(sharp_seq), 1)
    MATCH, VALIDATE, SKIP1, SKIP2, DONE = (jnp.int32(i) for i in range(5))
    rows = jnp.arange(S, dtype=jnp.int32)
    sharp = jnp.asarray(sharp_seq + (0,) * (K - len(sharp_seq)),
                        dtype=jnp.int32)
    OUTW = CAP + 1

    def bnd_of(cw, i, sl):
        # iswdbndry (source/wordpiece.py:272-285): prev char punct, or
        # current (in-range) char space/punct.
        in_rng = i < sl
        cur = in_rng & (((cw & (SP_BIT | PC_BIT))) != 0)
        prev = (i > 0) & ((cw & PREV_PC_BIT) != 0)
        return prev | cur

    def cond(st):
        return jnp.any(st["mode"] != DONE) & (st["it"] < MAXITER)

    def body(st):
        i, node, mode = st["i"], st["node"], st["mode"]
        ptr, seg_ptr, ovf = st["ptr"], st["seg_ptr"], st["ovf"]

        cw = pchar[rows, jnp.minimum(i, T - 1)]
        aid = cw & AID_MASK
        info = node_info[node]            # [S, 2+n_pops] one sliced gather
        f = info[:, 0]
        cnt = info[:, 1]
        child = goto_table[node, aid]

        # ---- MATCH ----
        m_act = mode == MATCH
        at_end = i >= slen
        step = m_act & ~at_end & (child >= 0)
        climb = m_act & ~at_end & (child < 0) & (f >= 0)
        to_val = m_act & (at_end | ((child < 0) & (f < 0)))

        # ---- VALIDATE ----
        v_act = mode == VALIDATE
        bnd = bnd_of(cw, i, slen)
        at_root = (node == 0) | (node == root_sharp) | (node == root_p)
        inval = v_act & (~bnd | ~at_root)
        corner = v_act & ~inval & (node == root_sharp) & (ptr == seg_ptr)
        prev_pc = (i > 0) & ((cw & PREV_PC_BIT) != 0)
        crash = st["crash"] | (v_act & (i >= slen) & ~prev_pc)

        # ---- emissions (mutually exclusive cases) -> ONE scatter ----
        ptr_eff = jnp.where(inval, seg_ptr, ptr)   # rollback before UNK
        emit_cnt = jnp.where(climb, cnt,
                             jnp.where(inval, 1,
                                       jnp.where(corner,
                                                 len(sharp_seq), 0)))
        cols = ptr_eff[:, None] + jnp.arange(K, dtype=jnp.int32)[None, :]
        jmask = (jnp.arange(K, dtype=jnp.int32)[None, :]
                 < emit_cnt[:, None])
        vals = jnp.where(climb[:, None], info[:, NODE_INFO_POPS:
                                              NODE_INFO_POPS + K],
                         jnp.where(inval[:, None], unk_id,
                                   sharp[None, :]))
        flat_idx = jnp.where(jmask & (cols < CAP),
                             rows[:, None] * OUTW + cols,
                             S * OUTW)  # out-of-bounds -> dropped
        out = st["out"].at[flat_idx.reshape(-1)].set(
            jnp.where(jmask, vals, 0).reshape(-1), mode="drop")
        ovf = ovf | (jmask & (cols >= CAP)).any(axis=1)
        n_ptr = ptr_eff + emit_cnt

        # ---- state updates ----
        n_node = jnp.where(step, child, jnp.where(climb, f, node))
        n_i = jnp.where(step, i + 1, i)
        n_mode = jnp.where(to_val, VALIDATE, mode)
        n_mode = jnp.where(v_act, SKIP1, n_mode)

        # SKIP1: advance to next boundary
        s1 = mode == SKIP1
        adv1 = s1 & (i < slen) & ~bnd
        n_i = jnp.where(adv1, i + 1, n_i)
        n_mode = jnp.where(s1 & ~adv1, SKIP2, n_mode)

        # SKIP2: skip whitespace
        s2 = mode == SKIP2
        sp = (cw & SP_BIT) != 0
        adv2 = s2 & (i < slen) & sp
        n_i = jnp.where(adv2, i + 1, n_i)
        s2_done = s2 & ~adv2
        restart = s2_done & (i < slen)
        finish = s2_done & (i >= slen)
        n_node = jnp.where(restart, 0, n_node)
        n_seg = jnp.where(restart, n_ptr, seg_ptr)
        n_mode = jnp.where(restart, MATCH,
                           jnp.where(finish, DONE, n_mode))

        return {"i": n_i, "node": n_node, "mode": n_mode, "ptr": n_ptr,
                "seg_ptr": n_seg, "out": out, "ovf": ovf,
                "crash": crash, "it": st["it"] + 1}

    zeros = jnp.zeros((S,), jnp.int32)
    init = {
        "i": zeros, "node": zeros,
        "mode": jnp.where(slen > 0, MATCH, DONE),
        "ptr": zeros, "seg_ptr": zeros,
        "out": jnp.zeros((S * OUTW,), jnp.int32),
        "ovf": jnp.zeros((S,), bool),
        "crash": jnp.zeros((S,), bool),
        "it": jnp.int32(0),
    }

    # A while_loop pays a fixed per-trip overhead (the predicate's
    # round trip) that can dominate the per-element work; the body is a
    # no-op on DONE rows (every action is mode-gated and emissions
    # scatter nothing), so composing it UNROLL times per trip is exact
    # and cuts the trip count. UNROLL = 4 is untuned on the GPU.
    def body_u(st):
        for _ in range(UNROLL):
            st = body(st)
        return st

    st = jax.lax.while_loop(cond, body_u, init)
    stuck = st["mode"] != DONE
    out2d = st["out"].reshape(S, OUTW)[:, :CAP]
    return out2d, st["ptr"], st["ovf"], stuck, st["crash"]


@partial(jax.jit, static_argnames=("n_pops", "sharp_seq"))
def wp_e2e_scan_u16_stacked(mat16, slen, goto_table, node_info, root_p,
                            root_sharp, unk_id, sharp_seq, n_pops):
    """All length-sorted slices in ONE device program, with the output
    compacted for a minimal device->host fetch.

    Fetching the padded [rows, CAP] i32 token matrix of a corpus-sized
    batch moves ~5 MB over ~40 buffers; this was built for a link that
    charged a fixed latency per transfer call (its cost on the GPU's
    PCIe link is unmeasured). Here the slices run sequentially inside
    one jit (``lax.map`` keeps each slice's lockstep while_loop exiting
    at its own max row length — the same early-exit the host-sliced
    driver had) and the token ids are compacted on device into one
    dense u16 stream; the caller fetches (counts, flags, total) in one
    call and then a quantized prefix of the stream in a second — ~0.4 MB
    in two calls instead of ~5 MB over dozens.

    mat16: u16[B, S, T] (B slices of S length-sorted rows); slen:
    i32[B, S]. Token ids must fit u16 (callers gate on vocab size).
    Returns (ids u16[B*S*(T+4)] dense row-major stream, out_n i32[B*S],
    flags u8[B*S] = ovf | stuck<<1 | crash<<2 | sawneg2<<3, total i32).
    """
    B, S, T = mat16.shape

    def one(args):
        m, l = args
        return wp_e2e_scan_u16(m, l, goto_table, node_info, root_p,
                               root_sharp, unk_id, sharp_seq, n_pops)

    out, out_n, ovf, stuck, crash = jax.lax.map(one, (mat16, slen))
    CAP = T + 4
    R = B * S
    out = out.reshape(R, CAP)
    out_n = out_n.reshape(R)
    # the _sharp_seq-is-None hang marker (models/wordpiece._finish_e2e)
    cols = jnp.arange(CAP, dtype=jnp.int32)[None, :]
    emitted = cols < out_n[:, None]
    sawneg2 = (emitted & (out == -2)).any(axis=1)
    flags = (ovf.reshape(R).astype(jnp.uint8)
             | (stuck.reshape(R).astype(jnp.uint8) << 1)
             | (crash.reshape(R).astype(jnp.uint8) << 2)
             | (sawneg2.astype(jnp.uint8) << 3))
    cum = jnp.cumsum(out_n)
    offs = cum - out_n
    total = cum[-1]
    dest = jnp.where(emitted, offs[:, None] + cols, R * CAP)
    ids = jnp.zeros(R * CAP, jnp.uint16).at[dest.reshape(-1)].set(
        out.astype(jnp.uint16).reshape(-1), mode="drop")
    return ids, out_n, flags, total


@partial(jax.jit, static_argnames=("n_pops", "sharp_seq", "nq"))
def wp_e2e_scan_u16_fused(matx, goto_table, node_info, root_p,
                          root_sharp, unk_id, sharp_seq, n_pops, nq):
    """One-put / one-fetch variant of :func:`wp_e2e_scan_u16_stacked`.

    The wire format folds everything into single calls each way (a
    per-call transfer latency, not bandwidth, bounded this on the link
    it was built for; the 85k corpus moves ~2 MB total):

    - host->device: ``matx`` u16[B, S, T+1] — the char matrix with each
      row's length packed into its LAST column (lengths < 2**16; the
      caller gates), so the put is one buffer instead of two;
    - device->host: the dense id stream's first ``nq`` elements ride in
      the same fetch as (out_n, flags, total). ``nq`` is static (a
      shape-derived bound, e.g. 4 tokens/row); when ``total > nq`` the
      caller fetches the full stream separately — a cost-only fallback.

    Returns (ids_prefix u16[nq], ids u16[B*S*(T+4)], out_n, flags,
    total)."""
    mat16 = matx[:, :, :-1]
    slen = matx[:, :, -1].astype(jnp.int32)
    ids, out_n, flags, total = wp_e2e_scan_u16_stacked(
        mat16, slen, goto_table, node_info, root_p, root_sharp, unk_id,
        sharp_seq, n_pops)
    return ids[:nq], ids, out_n, flags, total


def sliced_e2e_scan(pchar, slen, goto_table, node_info, root_p, root_sharp,
                    unk_id, sharp_seq, n_pops, n_alpha):
    """Host driver: length-sorted sliced scan (see core/batching.py) with
    the u16 wire format when the alphabet fits 13 bits (it always does for
    real vocabularies). Padding rows are zeros with slen = 0 — DONE at
    init. Returns host arrays in the caller's original row order.
    """
    if n_alpha < (1 << 13):
        return sliced_e2e_scan_u16(pack_u16(pchar), slen, goto_table,
                                   node_info, root_p, root_sharp, unk_id,
                                   sharp_seq, n_pops)
    from ..core.batching import sliced_rows

    def fn(ps, ls):
        return wp_e2e_scan(ps, ls, goto_table, node_info, root_p,
                           root_sharp, unk_id, sharp_seq, n_pops)

    return sliced_rows(fn, (pchar, slen), (0, 0), slen, 5)


def sliced_e2e_scan_u16(pchar16, slen, goto_table, node_info, root_p,
                        root_sharp, unk_id, sharp_seq, n_pops):
    """Sliced scan over an ALREADY-packed u16 wire matrix (the native
    front end packs rows directly; see _native/encode_prep.cpp)."""
    from ..core.batching import sliced_rows

    def fn(ps, ls):
        return wp_e2e_scan_u16(ps, ls, goto_table, node_info, root_p,
                               root_sharp, unk_id, sharp_seq, n_pops)

    return sliced_rows(fn, (pchar16, slen), (0, 0), slen, 5)
