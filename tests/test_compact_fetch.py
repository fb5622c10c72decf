"""Compact-fetch encode path (ops/wp_encode_e2e.wp_e2e_scan_u16_stacked +
models/wordpiece._run_e2e_compact + native stitch_flat).

The compact path exists to cut the remote link's device->host bytes
(~10x) and transfer calls; it must be invisible semantically — same
token streams as the legacy padded path, and the same
reference-documented errors on hang/crash inputs (via flag-triggered
fallback to the legacy path)."""
import json

import numpy as np
import pytest

from subword_tokenizers_tpu import FastWP
from subword_tokenizers_tpu._native import binding


@pytest.fixture(scope="module")
def fastwp():
    tok = FastWP()
    tok.load_resources("/root/reference/resources/pretrained/FastWordPiece")
    return tok


def _prep(tok, corpus):
    binding._load()
    prep = binding.encode_prep(corpus)
    inverse, bounds, uniq_buf, uniq_off, uniq_len = prep
    trie, _ = tok._trie()
    Lc = -(-(int(uniq_len.max()) + 2) // 8) * 8
    mat16 = binding.pack_u16_rows(uniq_buf, uniq_off, uniq_len, Lc,
                                  trie.alpha)
    return mat16, (uniq_len + 1).astype(np.int32)


def test_compact_equals_legacy(fastwp, pan_tadeusz):
    corpus = pan_tadeusz[:200]
    mat16, uslen = _prep(fastwp, corpus)
    compact = fastwp._run_e2e_compact(mat16, uslen)
    assert compact is not None
    ids, starts, counts, out_table = compact
    out_ids, out_n, out_table2 = fastwp._run_e2e_prepacked(mat16, uslen)
    assert (counts == out_n).all()
    for u in range(counts.size):
        got = ids[starts[u]:starts[u] + counts[u]]
        assert (got == out_ids[u, :out_n[u]]).all(), u


def test_compact_is_the_production_path(fastwp, pan_tadeusz,
                                        pan_tadeusz_golden, monkeypatch):
    corpus = pan_tadeusz[:60]
    golden = pan_tadeusz_golden["FastWordPiece"][:60]
    calls = []
    orig = FastWP._run_e2e_compact

    def spy(self, mat16, uslen):
        r = orig(self, mat16, uslen)
        calls.append(r is not None)
        return r

    monkeypatch.setattr(FastWP, "_run_e2e_compact", spy)
    assert fastwp.tokenize_batch(corpus) == golden
    assert calls == [True]


def test_stitch_flat_matches_stitch(fastwp, pan_tadeusz):
    corpus = pan_tadeusz[:150]
    binding._load()
    prep = binding.encode_prep(corpus)
    inverse, bounds, *_ = prep
    mat16, uslen = _prep(fastwp, corpus)
    ids, starts, counts, out_table = fastwp._run_e2e_compact(mat16, uslen)
    out_ids, out_n, _ = fastwp._run_e2e_prepacked(mat16, uslen)
    a = binding.stitch_flat(out_table.strings(), ids, starts, counts,
                            inverse, bounds)
    b = binding.stitch(out_table.strings(), out_ids, out_n, inverse, bounds)
    assert a == b


def test_hang_input_still_raises(fastwp):
    # an unknown punctuation-class char hangs the reference's E2E scan;
    # the compact path must flag the row, fall back, and raise the
    # documented RuntimeError (never return wrong tokens).
    with pytest.raises(RuntimeError, match="hang"):
        fastwp.tokenize_batch(["zwykly tekst", "☃¿ zlo"])


@pytest.mark.parametrize("model,res", [("NaiveWP", "NaiveWordPiece"),
                                       ("FastBPE", "FastBPE"),
                                       ("NaiveBPE", "NaiveBPE")])
def test_matcher_compact_is_production_and_exact(model, res, pan_tadeusz,
                                                 pan_tadeusz_golden,
                                                 monkeypatch):
    import subword_tokenizers_tpu as swt

    # The BPE merge-loop compact path is gated to non-CPU backends
    # (tools/compact_bisect.py: 0.76x on the local CPU); force it on so
    # its semantics are exercised under the test CPU backend the way the
    # GPU backend runs it.
    monkeypatch.setenv("SWT_COMPACT", "1")
    cls = getattr(swt, model)
    tok = cls()
    tok.load_resources(f"/root/reference/resources/pretrained/{res}")
    calls = []
    orig = cls._encode_unique_compact

    def spy(self, words):
        r = orig(self, words)
        calls.append(r is not None)
        return r

    monkeypatch.setattr(cls, "_encode_unique_compact", spy)
    corpus = pan_tadeusz[:80]
    assert tok.tokenize_batch(corpus) == \
        pan_tadeusz_golden[res][:80]
    assert calls == [True]


@pytest.mark.parametrize("model,res", [("NaiveWP", "NaiveWordPiece"),
                                       ("FastBPE", "FastBPE")])
def test_matcher_compact_equals_raw(model, res, pan_tadeusz, monkeypatch):
    """Span-level identity between the compact stream and the padded
    matrix for the greedy-matcher and merge-loop encoders."""
    import subword_tokenizers_tpu as swt

    monkeypatch.setenv("SWT_COMPACT", "1")
    cls = getattr(swt, model)
    tok = cls()
    tok.load_resources(f"/root/reference/resources/pretrained/{res}")
    words = sorted({w for s in pan_tadeusz[:120]
                    for w, _ in tok.preprocessing([s])[0]})
    compact = tok._encode_unique_compact(words)
    assert compact is not None
    ids, starts, counts, table = compact
    out, out_n, table2 = tok._encode_unique_raw(words)
    assert (counts == out_n).all()
    for u in range(counts.size):
        assert (ids[starts[u]:starts[u] + counts[u]]
                == out[u, :out_n[u]]).all(), words[u]


def test_bpe_compact_gated_off_on_cpu_backend(pan_tadeusz, monkeypatch):
    """On the local CPU backend the BPE merge-loop encoder must take the
    legacy sliced path (per-slice col-quantize beats the stacked compact
    program there — tools/compact_bisect.py), unless forced."""
    import jax

    from subword_tokenizers_tpu import FastBPE

    if jax.default_backend() != "cpu":
        pytest.skip("CPU-backend-specific gate")
    monkeypatch.delenv("SWT_COMPACT", raising=False)
    tok = FastBPE()
    tok.load_resources("/root/reference/resources/pretrained/FastBPE")
    words = sorted({w for s in pan_tadeusz[:40]
                    for w, _ in tok.preprocessing([s])[0]})
    assert tok._encode_unique_compact(words) is None
    monkeypatch.setenv("SWT_COMPACT", "0")
    assert tok._encode_unique_compact(words) is None


def test_compact_empty_and_tiny(fastwp):
    assert fastwp.tokenize_batch([""]) == [[]]
    assert fastwp.tokenize_batch(["  "]) == [[]]
    one = fastwp.tokenize_batch(["pan"])
    assert one == [["pan"]] or len(one[0]) >= 1


def test_prefix_overflow_falls_back_to_second_fetch(fastwp):
    """Rows emitting more than the static prefix budget (4 tokens/chunk
    for the e2e scan) must still return the full exact stream via the
    second fetch — the prefix is a transfer optimization only."""
    # single-char vocab fragments force ~1 token per character
    corpus = ["abcdefghij abcdefghijabcdefghij xyzxyzxyzxyz"] * 3
    legacy = [fastwp.tokenize(s) for s in corpus]
    got = fastwp.tokenize_batch(corpus)
    assert got == legacy
    assert all(len(r) >= 10 for r in got)  # well past 4 tokens/chunk


def test_oversized_skip_window_is_clamped():
    """SWT_SKIP_COMPACT larger than the flat width must degrade to more
    compactions, not to a shape error inside the jit (ADVICE r4)."""
    import os

    from subword_tokenizers_tpu.models.bpe import NaiveBPE

    old = os.environ.get("SWT_SKIP_COMPACT")
    os.environ["SWT_SKIP_COMPACT"] = "99999"
    try:
        tok = NaiveBPE()
        tok.train(["aaa aab abab banana!", "ab ab cd cd"], 40)
    finally:
        if old is None:
            del os.environ["SWT_SKIP_COMPACT"]
        else:
            os.environ["SWT_SKIP_COMPACT"] = old
    ref = NaiveBPE()
    ref.train(["aaa aab abab banana!", "ab ab cd cd"], 40)
    assert tok.merges_list == ref.merges_list


def test_bad_env_values_raise():
    import os

    import pytest as _pytest

    from subword_tokenizers_tpu.models.bpe import NaiveBPE
    from subword_tokenizers_tpu.models.wordpiece import NaiveWP

    for var, cls in (("SWT_SKIP_COMPACT", NaiveBPE),
                     ("SWT_WP_CAND_CAP", NaiveWP),
                     ("SWT_WP_TOURNAMENT", NaiveWP)):
        old = os.environ.get(var)
        os.environ[var] = "bogus"
        try:
            with _pytest.raises(ValueError, match=var):
                tok = cls()
                tok.train(["ab ab"], 30)
        finally:
            if old is None:
                del os.environ[var]
            else:
                os.environ[var] = old
