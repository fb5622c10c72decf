"""Batched WordPiece encoding automatons on device.

Both encoders are expressed as data-parallel state machines: every word
(greedy matcher) or sentence (end-to-end matcher) advances one automaton
step per ``while_loop`` iteration, so a whole corpus encodes in one jitted
call. Trie transitions are single gathers into the dense goto tables
(models/trie.py); no Python objects or strings are touched on device.

- :func:`wp_match_encode` — greedy longest-match (NaiveWP semantics,
  reference: source/wordpiece.py:131-158): walk the vocab trie recording
  the deepest accepting node; on a dead end, emit that token and restart
  with an (implicitly injected) '##' prefix on the remainder; a segment
  with no accept makes the *whole word* ``[UNK]``.
- :func:`wp_e2e_encode` — LinMaxMatch end-to-end scan (FastWP semantics,
  reference: source/wordpiece.py:233-316): single pass over the sentence
  with failure links/pops, boundary validation against the Python
  isalnum/isspace character classes, the literal ``"['UNK']"`` token on
  invalid segments (quirk preserved: source/wordpiece.py:257), and the
  ``root_sharp``/"##" corner case (source/wordpiece.py:260-261).

Pathology guard: a vocabulary containing ``"#"`` but not ``"##"`` can make
the *reference's* greedy loop grow the remainder forever; we cap the
injected-hash counter and the iteration count and report overflow instead
of hanging.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

def _goto(goto_table, node, aid):
    """Trie transition via the dense table: child node id or -1.

    ``aid`` is an alphabet id in [0, A]; column A is the OOV class and is
    all -1 (models/trie.py:_dense_tables), so out-of-alphabet characters
    fall through with no branch.
    """
    return goto_table[node, aid]


MAX_INJECT = 16  # cap on pending '#' prefix chars (see pathology note)


@jax.jit
def wp_match_encode(words, wlen, goto_table, accept, hash_aid):
    """Greedy longest-match over padded words.

    words: i32[W, L] *alphabet ids* (host-translated via the trie's alpha
    map; OOV = A); wlen: i32[W]; hash_aid: alphabet id of '#' (for the
    injected '##' continuation prefix).
    Returns (out i32[W, L+4] token ids, out_n i32[W], unk bool[W],
    overflow bool[W]). ``unk`` rows must be rendered as ["[UNK]"].
    """
    W, L = words.shape
    CAP = L + 4
    # Greedy longest-match is O(len^2) worst case: every restart re-walks
    # the lookahead consumed past the accepted prefix (as does the
    # reference's shrinking-prefix loop, source/wordpiece.py:144-147).
    # The effective sequence can carry up to MAX_INJECT pending '#'
    # characters per restart ('#'-prefixed vocab tokens), so the cap must
    # budget for them — only genuinely diverging inputs may hit it.
    MAXITER = (L + MAX_INJECT + 2) * (L + MAX_INJECT + 6) + 32

    def cond(st):
        return jnp.any(st["mode"] == 0) & (st["it"] < MAXITER)

    def body(st):
        pos, inject, node = st["pos"], st["inject"], st["node"]
        acc_tok, acc_pos, acc_inj = st["acc_tok"], st["acc_pos"], st["acc_inj"]
        ptr, mode, out = st["ptr"], st["mode"], st["out"]
        unk, ovf = st["unk"], st["ovf"]

        active = mode == 0
        rows = jnp.arange(W)
        in_word = pos < wlen
        aid = jnp.where(inject > 0, hash_aid,
                        words[rows, jnp.minimum(pos, L - 1)])
        have_char = (inject > 0) | in_word
        child = _goto(goto_table, node, aid)
        can_step = active & have_char & (child >= 0)

        # Advance: consume one (possibly injected) char.
        n_inject = jnp.where(can_step & (inject > 0), inject - 1, inject)
        n_pos = jnp.where(can_step & (inject == 0), pos + 1, pos)
        n_node = jnp.where(can_step, child, node)
        acc_here = can_step & (accept[jnp.maximum(n_node, 0)] >= 0)
        n_acc_tok = jnp.where(acc_here, accept[jnp.maximum(n_node, 0)],
                              acc_tok)
        n_acc_pos = jnp.where(acc_here, n_pos, acc_pos)
        n_acc_inj = jnp.where(acc_here, n_inject, acc_inj)

        # Dead end (no transition or chars exhausted): emit / restart / fail.
        stuck = active & ~can_step
        has_acc = n_acc_tok >= 0
        emit = stuck & has_acc
        wptr = jnp.where(emit & (ptr < CAP), ptr, CAP)
        out = out.at[rows, wptr].set(jnp.where(emit, n_acc_tok, 0),
                                     mode="drop")
        ovf = ovf | (emit & (ptr >= CAP))
        n_ptr = jnp.where(emit, ptr + 1, ptr)
        finished = emit & (n_acc_pos >= wlen) & (n_acc_inj == 0)
        restart = emit & ~finished
        failed = stuck & ~has_acc

        n_inject2 = jnp.where(restart, jnp.minimum(2 + n_acc_inj,
                                                   MAX_INJECT), n_inject)
        ovf = ovf | (restart & (2 + n_acc_inj > MAX_INJECT))
        n_pos2 = jnp.where(restart, n_acc_pos, n_pos)
        n_node2 = jnp.where(restart, 0, n_node)
        n_acc_tok2 = jnp.where(restart, jnp.int32(-1), n_acc_tok)

        n_mode = jnp.where(finished | failed, 1, mode)
        n_unk = unk | failed

        return {"pos": n_pos2, "inject": n_inject2, "node": n_node2,
                "acc_tok": n_acc_tok2, "acc_pos": n_acc_pos,
                "acc_inj": n_acc_inj, "ptr": n_ptr, "mode": n_mode,
                "out": out, "unk": n_unk, "ovf": ovf, "it": st["it"] + 1}

    zeros = jnp.zeros((W,), jnp.int32)
    init = {
        "pos": zeros, "inject": zeros, "node": zeros,
        "acc_tok": zeros - 1, "acc_pos": zeros, "acc_inj": zeros,
        "ptr": zeros,
        # Empty words are immediately done (reference: encode_word("")
        # returns [] — the while loop never runs).
        "mode": jnp.where(wlen == 0, jnp.int32(1), jnp.int32(0)),
        "out": jnp.zeros((W, CAP + 1), jnp.int32),
        "unk": jnp.zeros((W,), bool),
        "ovf": jnp.zeros((W,), bool),
        "it": jnp.int32(0),
    }
    st = jax.lax.while_loop(cond, body, init)
    ovf = st["ovf"] | (st["mode"] == 0)  # iteration cap hit
    return st["out"][:, :CAP], st["ptr"], st["unk"], ovf


@partial(jax.jit, static_argnames=("max_pops", "sharp_seq"))
def wp_e2e_encode(acp, is_space, is_punc, slen, goto_table, fail,
                  pops_off, pops_flat, root_p, root_sharp, unk_id,
                  sharp_seq, max_pops):
    """End-to-end LinMaxMatch scan over padded sentences.

    acp: i32[S, T] lowered *alphabet ids* (host-translated; OOV = A)
    including the appended trailing space (reference:
    source/wordpiece.py:248); slen: i32[S] true lengths (with the space);
    is_space/is_punc: Python str.isspace / FastWP ispunc classes per char.
    ``sharp_seq``: static tuple of token ids emitted for the root_sharp
    corner case; ``unk_id``: id of the literal "['UNK']".

    Returns (out i32[S, CAP], out_n i32[S], overflow bool[S],
    stuck bool[S], crash bool[S]) — ``stuck`` marks sentences still
    unfinished at the iteration cap, which for legitimate inputs cannot
    happen (the cap is ~6x the amortized step bound); it indicates the
    no-progress pathology on which the reference implementation loops
    forever. ``crash`` marks a validation at i == slen with a non-punct
    previous char — there the reference's iswdbndry reads seq[len(seq)]
    and dies with IndexError (source/wordpiece.py:285); reachable only
    with whitespace-bearing vocab tokens.
    """
    S, T = acp.shape
    CAP = 2 * T + 4
    MAXITER = 6 * T + 64
    MATCH, VALIDATE, SKIP1, SKIP2, DONE = (jnp.int32(i) for i in range(5))

    def prev_punc(i, rows):
        return (i > 0) & is_punc[rows, jnp.clip(i - 1, 0, T - 1)]

    def bndry(i, slen_row, rows):
        """iswdbndry (reference: source/wordpiece.py:272-285) for i < slen;
        at i == slen only the prev-punct disjunct is defined (the reference
        crashes otherwise — callers flag that case via ``crash``)."""
        in_rng = i < slen_row
        ic = jnp.clip(i, 0, T - 1)
        cur = in_rng & (is_space[rows, ic] | is_punc[rows, ic])
        return prev_punc(i, rows) | cur

    def cond(st):
        return jnp.any(st["mode"] != DONE) & (st["it"] < MAXITER)

    def body(st):
        i, node, mode = st["i"], st["node"], st["mode"]
        ptr, seg_ptr, out, ovf = st["ptr"], st["seg_ptr"], st["out"], st["ovf"]
        rows = jnp.arange(S)

        # ---------------- MATCH ----------------
        m_act = mode == MATCH
        at_end = i >= slen
        aid = acp[rows, jnp.clip(i, 0, T - 1)]
        child = _goto(goto_table, node, aid)
        step = m_act & ~at_end & (child >= 0)
        f = fail[jnp.clip(node, 0, fail.shape[0] - 1)]
        climb = m_act & ~at_end & (child < 0) & (f >= 0)
        to_validate_m = m_act & (at_end | ((child < 0) & (f < 0)))

        # Emit failure pops on climb.
        off = pops_off[jnp.clip(node, 0, pops_off.shape[0] - 2)]
        cnt = pops_off[jnp.clip(node, 0, pops_off.shape[0] - 2) + 1] - off
        new_out = out
        for j in range(max_pops):
            w = climb & (j < cnt)
            wptr = jnp.where(w & (ptr + j < CAP), ptr + j, CAP)
            val = pops_flat[jnp.clip(off + j, 0, max(pops_flat.shape[0] - 1,
                                                     0))] \
                if pops_flat.shape[0] else jnp.int32(0)
            new_out = new_out.at[rows, wptr].set(jnp.where(w, val, 0),
                                                 mode="drop")
            ovf = ovf | (w & (ptr + j >= CAP))
        n_ptr = jnp.where(climb, ptr + cnt, ptr)
        n_node = jnp.where(step, child, jnp.where(climb, f, node))
        n_i = jnp.where(step, i + 1, i)
        n_mode = jnp.where(to_validate_m, VALIDATE, mode)

        # ---------------- VALIDATE ----------------
        v_act = mode == VALIDATE
        bnd = bndry(i, slen, rows)
        at_root = (node == 0) | (node == root_sharp) | (node == root_p)
        valid = bnd & at_root
        inval = v_act & ~valid
        crash = st["crash"] | (v_act & (i >= slen) & ~prev_punc(i, rows))
        # Invalid segment: roll back and emit the literal "['UNK']".
        n_ptr = jnp.where(inval, seg_ptr, n_ptr)
        wptr = jnp.where(inval & (n_ptr < CAP), n_ptr, CAP)
        new_out = new_out.at[rows, wptr].set(jnp.where(inval, unk_id, 0),
                                             mode="drop")
        n_ptr = jnp.where(inval, n_ptr + 1, n_ptr)
        # root_sharp with empty segment: emit encode_word("##").
        corner = v_act & valid & (node == root_sharp) & (ptr == seg_ptr)
        for j, tok in enumerate(sharp_seq):
            w = corner
            wptr = jnp.where(w & (n_ptr + j < CAP), n_ptr + j, CAP)
            new_out = new_out.at[rows, wptr].set(
                jnp.where(w, jnp.int32(tok), 0), mode="drop")
            ovf = ovf | (w & (n_ptr + j >= CAP))
        n_ptr = jnp.where(corner, n_ptr + len(sharp_seq), n_ptr)
        n_mode = jnp.where(v_act, SKIP1, n_mode)

        # ---------------- SKIP1: advance to next boundary ----------------
        s1 = mode == SKIP1
        adv1 = s1 & (i < slen) & ~bndry(i, slen, rows)
        n_i = jnp.where(adv1, i + 1, n_i)
        n_mode = jnp.where(s1 & ~adv1, SKIP2, n_mode)

        # ---------------- SKIP2: skip whitespace ----------------
        s2 = mode == SKIP2
        sp = is_space[rows, jnp.clip(i, 0, T - 1)]
        adv2 = s2 & (i < slen) & sp
        n_i = jnp.where(adv2, i + 1, n_i)
        s2_done = s2 & ~adv2
        restart = s2_done & (i < slen)
        finish = s2_done & (i >= slen)
        n_node = jnp.where(restart, 0, n_node)
        n_seg_ptr = jnp.where(restart, n_ptr, seg_ptr)
        n_mode = jnp.where(restart, MATCH,
                           jnp.where(finish, DONE, n_mode))

        return {"i": n_i, "node": n_node, "mode": n_mode, "ptr": n_ptr,
                "seg_ptr": n_seg_ptr, "out": new_out, "ovf": ovf,
                "crash": crash, "it": st["it"] + 1}

    zeros = jnp.zeros((S,), jnp.int32)
    init = {
        "i": zeros, "node": zeros,
        "mode": jnp.where(slen > 0, MATCH, DONE),
        "ptr": zeros, "seg_ptr": zeros,
        "out": jnp.zeros((S, CAP + 1), jnp.int32),
        "ovf": jnp.zeros((S,), bool),
        "crash": jnp.zeros((S,), bool),
        "it": jnp.int32(0),
    }
    st = jax.lax.while_loop(cond, body, init)
    stuck = st["mode"] != DONE
    return st["out"][:, :CAP], st["ptr"], st["ovf"], stuck, st["crash"]


@partial(jax.jit, static_argnames=("nq",))
def wp_match_encode_stacked(words, wlen, goto_table, accept, hash_aid,
                            nq: int = 0):
    """All length-sorted slices in one device program + compact output
    stream (see ops/fetch.py).

    words: i32[B, S, L]; wlen: i32[B, S]. UNK substitution happens ON
    DEVICE (out[0] = 0 == the UNK id interned first by
    models/wordpiece.NaiveWP._build_match_trie; count = 1), matching the
    host post-processing of :func:`wp_match_encode`. Returns
    (ids_prefix u16[nq], ids u16 dense stream, out_n i32[B*S],
    flags u8[B*S] = ovf, total) — the static prefix rides in the same
    fetch call as the counts (ops/fetch.fetch_compact).
    """
    from .fetch import compact_ids

    def one(args):
        m, l = args
        return wp_match_encode(m, l, goto_table, accept, hash_aid)

    out, out_n, unk, ovf = jax.lax.map(one, (words, wlen))
    B, S, CAP = out.shape
    out = out.reshape(B * S, CAP)
    out_n = out_n.reshape(-1)
    unk = unk.reshape(-1)
    out = jnp.where(unk[:, None]
                    & (jnp.arange(CAP, dtype=jnp.int32)[None, :] == 0),
                    0, out)
    out_n = jnp.where(unk, 1, out_n)
    flags = ovf.reshape(-1).astype(jnp.uint8)
    ids, total = compact_ids(out, out_n)
    return ids[:nq], ids, out_n, flags, total
