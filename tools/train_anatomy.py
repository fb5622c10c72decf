#!/usr/bin/env python3
"""Training-step anatomy: where a fused merge step's time actually goes.

Bounds the win available to incremental pair-count deltas (VERDICT r2
next #5) BEFORE paying its conformance risk: at the real train-5K flat
state and at shrunk widths, times the full K-step device block against
its parts — the aggregate sort, the apply-compaction sort, candidate
compaction — plus raw op costs (3/4-operand sort, i32 cumsum, F-sized
gather, F-sized scatter-add) at each width. If (agg sort + apply sort)
is a small share of the block, delta maintenance cannot pay; if the
block floors at fixed per-step overhead at small F, neither can
anything else per-step.

Run from the repo root, once per backend:
  JAX_PLATFORMS=cpu python tools/train_anatomy.py
  python tools/train_anatomy.py          # default backend (the GPU)
Prints one JSON dict.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def _bench(fn, reps=5):
    import jax
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from subword_tokenizers_tpu.core.corpus import (build_bpe_corpus,
                                                    unique_words)
    from subword_tokenizers_tpu.core.symbols import SymbolTable
    from subword_tokenizers_tpu.models.bpe import NaiveBPE
    from subword_tokenizers_tpu.ops.flat import (build_flat, flat_aggregate,
                                                 flat_apply)
    from subword_tokenizers_tpu.ops.pairstats import compact_cands
    from subword_tokenizers_tpu.ops.train_loop import (_cand_cap, pow_tables,
                                                       flat_train_steps,
                                                       str_hashes)

    res = {"backend": jax.default_backend()}
    print(f"devices: {jax.devices()}", file=sys.stderr, flush=True)

    with open("/root/reference/data/train-5K.json") as f:
        corpus = json.load(f)
    tok = NaiveBPE()
    wb = tok.preprocessing_batch(corpus)
    words, freq, _ = unique_words(wb)
    table = SymbolTable()
    arrs = build_bpe_corpus(words, freq, table)
    fs0, wid0, wgt0 = build_flat(np.asarray(arrs.sym), np.asarray(arrs.freq),
                                 w32=True)
    res["F_full"] = int(fs0.shape[0])
    narrow = True
    K = 64

    n0 = len(table)
    sym_cap = 1000 + 8
    h1 = np.zeros(sym_cap, dtype=np.int64)
    h2 = np.zeros(sym_cap, dtype=np.int64)
    sl = np.zeros(sym_cap, dtype=np.int64)
    for i, s in enumerate(table.strings()):
        h1[i], h2[i] = str_hashes(s)
        sl[i] = len(s)
    pw1, pw2 = pow_tables(64)
    sh1, sh2 = str_hashes("##")

    jit_agg = jax.jit(flat_aggregate, static_argnames=("narrow", "w32"))
    jit_apply = jax.jit(flat_apply)
    jit_compact = jax.jit(compact_cands, static_argnames=("cap", "narrow"))

    for F in (res["F_full"], res["F_full"] // 2, res["F_full"] // 4, 16384):
        F = -(-F // 1024) * 1024
        fs = jnp.asarray(fs0[:F])
        wid = jnp.asarray(wid0[:F])
        wgt = jnp.asarray(wgt0[:F])
        jax.block_until_ready((fs, wid, wgt))
        tag = f"F{F}"

        # full fused K-step BPE block (per-step = /K)
        sfreq = jnp.zeros(sym_cap + 1, dtype=jnp.int32)
        args = (fs, wid, wgt, sfreq, jnp.asarray(h1), jnp.asarray(h2),
                jnp.asarray(sl), jnp.int32(n0), jnp.int32(n0),
                jnp.asarray(pw1), jnp.asarray(pw2), sh1, sh2,
                jnp.int32(10**9))

        def block():
            st, recs = flat_train_steps(*args, K=K, narrow=narrow,
                                        sym_cap=sym_cap, wordpiece=False,
                                        w32=True)
            return recs["a"]
        res[f"{tag}_block_step_ms"] = _bench(block) / K * 1e3

        # the WordPiece block at the same width (extra costs per step:
        # candidate-compaction sort + exact-double scoring + the "##"
        # merged-hash branch); per-step WP/BPE ratio localizes the gap
        cap_wp = _cand_cap(F - 1)

        def wp_block():
            st, recs = flat_train_steps(*args, K=K, narrow=narrow,
                                        sym_cap=sym_cap, wordpiece=True,
                                        cand_cap=cap_wp, w32=True)
            return recs["a"]
        res[f"{tag}_wp_block_step_ms"] = _bench(wp_block) / K * 1e3

        # same blocks with the deferred-compaction window (r4): the
        # per-step sort4 is replaced by select chains + a liveness cumsum
        def block_skip():
            st, recs = flat_train_steps(*args, K=K, narrow=narrow,
                                        sym_cap=sym_cap, wordpiece=False,
                                        w32=True, skip=12)
            return recs["a"]
        res[f"{tag}_block_skip_step_ms"] = _bench(block_skip) / K * 1e3

        def wp_block_skip():
            st, recs = flat_train_steps(*args, K=K, narrow=narrow,
                                        sym_cap=sym_cap, wordpiece=True,
                                        cand_cap=cap_wp, w32=True, skip=12)
            return recs["a"]
        res[f"{tag}_wp_block_skip_step_ms"] = _bench(wp_block_skip) / K * 1e3

        # the two per-step sorts, timed standalone
        res[f"{tag}_agg_ms"] = _bench(
            lambda: jit_agg(fs, wid, wgt, narrow=narrow, w32=True)[0]) * 1e3
        res[f"{tag}_apply_ms"] = _bench(
            lambda: jit_apply(fs, wid, wgt, jnp.int32(1), jnp.int32(2),
                              jnp.int32(999))[0]) * 1e3
        k_s, p_s, rt, ic = jit_agg(fs, wid, wgt, narrow=narrow, w32=True)
        jax.block_until_ready(k_s)
        cap = min(_cand_cap(F - 1) or 16384, F - 1)
        res[f"{tag}_compact_ms"] = _bench(
            lambda: jit_compact(k_s, p_s, rt, ic, cap=cap,
                                narrow=narrow)[0]) * 1e3

        # exact-double scoring over the compacted candidates, standalone
        from subword_tokenizers_tpu.ops.pairstats import wp_score_bits
        ck, cp, cc, cmask, _ = jit_compact(k_s, p_s, rt, ic, cap=cap,
                                           narrow=narrow)
        sfq = jnp.ones(sym_cap + 1, dtype=jnp.int32) * 7
        jax.block_until_ready((ck, cc, cmask, sfq))
        jit_score = jax.jit(wp_score_bits, static_argnames=("narrow",
                                                            "wide_score"))
        res[f"{tag}_score_ms"] = _bench(
            lambda: jit_score(ck, cc, cmask, sfq, narrow=narrow)) * 1e3

        # raw op costs at width F
        ki = jnp.asarray(np.random.default_rng(0).integers(
            0, 1 << 30, size=F, dtype=np.int32))
        w3 = jnp.ones(F, jnp.int32)
        idx = jnp.asarray(np.random.default_rng(1).integers(
            0, F, size=F, dtype=np.int32))
        jax.block_until_ready((ki, w3, idx))
        s3 = jax.jit(lambda a, b, c: jax.lax.sort((a, b, c), num_keys=2)[0])
        s4 = jax.jit(lambda f, a, b, c: jax.lax.sort(
            (f, a, b, c), num_keys=1, is_stable=True)[1])
        res[f"{tag}_sort3_ms"] = _bench(lambda: s3(ki, idx, w3)) * 1e3
        res[f"{tag}_sort4stable_ms"] = _bench(
            lambda: s4(ki & 1, ki, idx, w3)) * 1e3
        res[f"{tag}_cumsum_ms"] = _bench(
            lambda: jax.jit(jnp.cumsum)(w3)) * 1e3
        res[f"{tag}_gather_ms"] = _bench(
            lambda: jax.jit(lambda k, i: k[i])(ki, idx)) * 1e3
        # F-wide gather into a SMALL (1k-entry) table — the op a
        # full-width WP exponent prefilter would need (sym_freq[a])
        small = jnp.arange(sym_cap + 1, dtype=jnp.int32)
        idx_small = jnp.asarray(np.random.default_rng(2).integers(
            0, sym_cap, size=F, dtype=np.int32))
        jax.block_until_ready((small, idx_small))
        res[f"{tag}_gather_small_ms"] = _bench(
            lambda: jax.jit(lambda k, i: k[i])(small, idx_small)) * 1e3
        res[f"{tag}_scatter_add_ms"] = _bench(
            lambda: jax.jit(lambda k, i, w: k.at[i].add(w))(ki, idx,
                                                            w3)) * 1e3

    print(json.dumps(res))


if __name__ == "__main__":
    main()
