"""Unit tests for the fused device training loop internals."""
import jax.numpy as jnp
import numpy as np

from subword_tokenizers_tpu.core.corpus import build_bpe_corpus
from subword_tokenizers_tpu.core.symbols import SymbolTable
from subword_tokenizers_tpu.ops.flat import build_flat, flat_apply
from subword_tokenizers_tpu.ops.merge import apply_merge
from subword_tokenizers_tpu.ops.train_loop import (pow_tables, run_fused,
                                                   str_hashes)

WORDS = ["aaa", "aab", "abab", "banana", "bandana", "ab", "cd", "a"]
FREQ = np.array([3, 1, 2, 1, 1, 5, 2, 7], dtype=np.int64)


def _table_and_arrays():
    table = SymbolTable()
    ca = build_bpe_corpus(WORDS, FREQ, table)
    return table, ca


def test_flat_apply_matches_padded_apply():
    table, ca = _table_and_arrays()
    a = table.get("a")
    b = table.get("b")
    new = len(table)
    ref = np.asarray(apply_merge(jnp.asarray(ca.sym), a, b, new))
    fs, wid, wgt = build_flat(ca.sym, ca.freq)
    nfs, nwid, _, n_rep = [np.asarray(x) for x in
                           flat_apply(jnp.asarray(fs), jnp.asarray(wid),
                                      jnp.asarray(wgt), a, b, new)]
    # replacement weight == weighted count of (a,b) matches actually taken
    want_rep = 0
    for w, f in zip(WORDS, FREQ):
        i = 0
        while i < len(w) - 1:
            if w[i] == "a" and w[i + 1] == "b":
                want_rep += int(f)
                i += 2
            else:
                i += 1
    assert int(n_rep) == want_rep
    # regroup flat result by word and compare against padded rows
    for w in range(len(WORDS)):
        row_flat = nfs[(nwid == w) & (nfs >= 0)].tolist()
        row_ref = [s for s in ref[w].tolist() if s >= 0]
        assert row_flat == row_ref, w


def test_fused_flat_and_padded_agree():
    results = {}
    for flat in (True, False):
        table, ca = _table_and_arrays()
        merges = []
        run_fused(jnp.asarray(ca.sym), jnp.asarray(ca.freq), table, 30,
                  True, False,
                  lambda sa, sb, m: merges.append((sa, sb)), K=8,
                  flat=flat)
        results[flat] = merges
    assert results[True] == results[False]
    assert len(results[True]) > 0


def test_hashes_roundtrip():
    p1, p2 = pow_tables(8)
    h_ab = str_hashes("ab")
    h_a = str_hashes("a")
    h_b = str_hashes("b")
    mod = (1 << 31) - 1
    assert (h_a[0] * p1[1] + h_b[0]) % mod == h_ab[0]
    assert (h_a[1] * p2[1] + h_b[1]) % mod == h_ab[1]


def test_no_i64_cumsum_in_narrow_wp_step():
    """The narrow-path WP training step must not contain an int64 cumsum
    (the narrow path scans i32 by design; jnp.nonzero under x64 would
    sneak an i64 one in via its internal index cumsum)."""
    import jax
    import jax.numpy as jnp
    from subword_tokenizers_tpu.ops.pairstats import wp_select

    def step(sym, freq):
        return wp_select(sym, freq, 64, narrow=True, cand_cap=32)

    sym = jnp.zeros((16, 8), jnp.int32)
    freq = jnp.ones((16,), jnp.int64)
    jaxpr = jax.make_jaxpr(step)(sym, freq)

    def walk(jp, out):
        for eqn in jp.eqns:
            if str(eqn.primitive) in ("cumsum", "cummax", "cummin",
                                      "cumlogsumexp", "cumprod"):
                out.append(eqn)
            for v in eqn.params.values():
                if hasattr(v, "jaxpr"):
                    walk(v.jaxpr, out)
                elif isinstance(v, (list, tuple)):
                    for x in v:
                        if hasattr(x, "jaxpr"):
                            walk(x.jaxpr, out)
        return out

    scans = walk(jaxpr.jaxpr, [])
    bad = [e for e in scans
           if any(getattr(iv.aval, "dtype", None) == jnp.int64
                  for iv in e.invars)]
    assert not bad, f"int64 scan ops in narrow WP step: {bad}"


def test_wp_select_core_compaction_exact():
    """Compacted candidate scoring must equal full-width scoring, and the
    lax.cond overflow fallback must fire when the cap is too small."""
    import jax.numpy as jnp
    import numpy as np
    from subword_tokenizers_tpu.ops.pairstats import (
        _run_aggregate, pack_pairs, symbol_freqs, wp_select_core)

    rng = np.random.default_rng(7)
    for narrow in (False, True):
        for trial in range(4):
            n, L = 40, 8
            sym = rng.integers(0, 12, size=(n, L)).astype(np.int32)
            lens = rng.integers(1, L + 1, size=n)
            sym[np.arange(L)[None, :] >= lens[:, None]] = -1
            freq = rng.integers(1, 5, size=n).astype(np.int64)

            sym_d = jnp.asarray(sym)
            keys, pos = pack_pairs(sym_d, narrow)
            dt = keys.dtype
            w = jnp.broadcast_to(jnp.asarray(freq, dt)[:, None],
                                 (n, L - 1)).reshape(-1)
            k_s, p_s, rt, cand = _run_aggregate(keys, pos, w, narrow)
            flat = sym_d.reshape(-1)
            wsym = jnp.broadcast_to(jnp.asarray(freq, dt)[:, None],
                                    (n, L)).reshape(-1)
            sf = symbol_freqs(flat, wsym, 16)

            want = wp_select_core(k_s, p_s, rt, cand, sf, narrow, None)
            for cap in (4, 64, 256):  # 4 always overflows -> cond fallback
                got = wp_select_core(k_s, p_s, rt, cand, sf, narrow, cap)
                assert [int(x) for x in got] == [int(x) for x in want], \
                    (narrow, trial, cap)


def test_flat_shrink_bit_exact(monkeypatch):
    """The between-block flat-array shrink (dead-tail slice on the halving
    grid) must not change a single merge: positions of live slots are
    untouched, so tie-breaks are identical. Forced here by dropping the
    shrink floor so the tiny corpus qualifies."""
    from subword_tokenizers_tpu.ops import train_loop

    def train(min_floor):
        monkeypatch.setattr(train_loop, "_FLAT_MIN", min_floor)
        table, ca = _table_and_arrays()
        merges = []
        run_fused(jnp.asarray(ca.sym), jnp.asarray(ca.freq), table, 30,
                  True, False,
                  lambda sa, sb, m: merges.append((sa, sb)), K=4,
                  flat=True)
        return merges

    no_shrink = train(1 << 30)
    shrunk = train(2)  # every block may halve
    assert shrunk == no_shrink
    assert len(shrunk) > 0


def test_no_i64_scan_in_wide_w32_step():
    """Wide keys (>=2^16 symbol ids) with i32 weights: the run aggregation
    must contain no int64 scan ops (the weight dtype is decoupled from
    the key dtype; ops/pairstats docstring). The i64 sort is fine."""
    import jax
    import jax.numpy as jnp
    from subword_tokenizers_tpu.ops.pairstats import wp_select

    def step(sym, freq):
        return wp_select(sym, freq, 1 << 17, narrow=False, cand_cap=32,
                         w32=True)

    sym = jnp.zeros((16, 8), jnp.int32)
    freq = jnp.ones((16,), jnp.int64)
    jaxpr = jax.make_jaxpr(step)(sym, freq)

    def walk(jp, out):
        for eqn in jp.eqns:
            if str(eqn.primitive) in ("cumsum", "cummax", "cummin",
                                      "cumlogsumexp", "cumprod"):
                out.append(eqn)
            for v in eqn.params.values():
                if hasattr(v, "jaxpr"):
                    walk(v.jaxpr, out)
                elif isinstance(v, (list, tuple)):
                    for x in v:
                        if hasattr(x, "jaxpr"):
                            walk(x.jaxpr, out)
        return out

    scans = walk(jaxpr.jaxpr, [])
    bad = [e for e in scans
           if any(getattr(iv.aval, "dtype", None) == jnp.int64
                  for iv in e.invars)]
    assert not bad, f"int64 scan ops in wide/w32 WP step: {bad}"


def test_wide_keys_training_matches_reference():
    """Force the wide-key path (max_vocab pushes sym_cap past 2^16) on a
    small corpus; BPE merges and WP vocab must match the live reference
    (which has no notion of key width)."""
    import pytest

    from ref_oracle import make_reference, reference_available
    if not reference_available():
        pytest.skip("reference repo not mounted")
    from subword_tokenizers_tpu import NaiveBPE, NaiveWP

    corpus = ["aaa aab abab banana bandana!", "ab ab ab cd cd c d aaaa",
              "sentence with more words to merge fully"]
    big = 70_000  # > 2^16: wide keys; corpus exhausts long before

    ref = make_reference("NaiveBPE")
    ref.train(corpus, big)
    mine = NaiveBPE()
    mine.train(corpus, big)
    assert mine.merges_list == [tuple(p) for p in ref.merges_list]

    wref = make_reference("NaiveWordPiece")
    wref.train(corpus, big)
    wmine = NaiveWP()
    wmine.train(corpus, big)
    assert wmine.vocab == wref.vocab
