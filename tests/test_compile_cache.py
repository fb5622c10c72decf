"""Where the persistent compilation cache goes (ops/__init__.py), and the
native front end's visible fallback (_native/binding.py)."""
import os

import jax

from subword_tokenizers_tpu import ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_set_means_package_sets_no_cache_dir():
    assert ops.own_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}) is None


def test_env_var_unset_means_checkout_cache():
    want = os.path.join(ROOT, ".jax_cache")
    assert ops.own_cache_dir({}) == want
    assert ops.own_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == want


def test_cache_dir_in_effect():
    want = os.environ.get("JAX_COMPILATION_CACHE_DIR") or ops.CHECKOUT_CACHE
    assert jax.config.jax_compilation_cache_dir == want


def test_native_fallback_is_reported(monkeypatch, capsys):
    from subword_tokenizers_tpu._native import binding

    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("no toolchain in this test")

    monkeypatch.setattr(binding, "_load", boom)
    monkeypatch.setattr(binding, "_load_error", None)
    assert binding.try_load() is None
    assert "no toolchain in this test" in binding.load_error()
    assert "native front end unavailable" in capsys.readouterr().err
    # Only the first failure pays for a build attempt, and says so.
    assert binding.try_load() is None
    assert len(calls) == 1
    assert capsys.readouterr().err == ""
    monkeypatch.undo()
    assert binding.try_load() is binding


def test_encode_without_native_matches(monkeypatch):
    """With the native library unavailable, training and every batched
    encoder fall back to NumPy/Python and produce the same output."""
    import json

    from subword_tokenizers_tpu import FastBPE, FastWP, NaiveBPE, NaiveWP
    from subword_tokenizers_tpu._native import binding
    from subword_tokenizers_tpu.frontend import pretokenize

    with open(os.path.join(ROOT, "data", "train-85k.json")) as f:
        corpus = json.load(f)[:40]
    bpe = NaiveBPE()
    bpe.train(corpus, max_vocab=120)
    wp = NaiveWP()
    wp.train(corpus, max_vocab=110)
    classes = (NaiveBPE, FastBPE, NaiveWP, FastWP)

    def encode_all():
        out = []
        for cls in classes:
            tok = cls()
            if issubclass(cls, NaiveBPE):
                tok.merges_list = list(bpe.merges_list)
            else:
                tok.vocab = set(wp.vocab)
            out.append(tok.tokenize_batch(corpus))
        return out

    want = encode_all()

    def boom():
        raise RuntimeError("native disabled for test")

    monkeypatch.setattr(binding, "_load", boom)
    monkeypatch.setattr(binding, "_load_error", None)
    monkeypatch.setattr(pretokenize, "_native_checked", False)
    monkeypatch.setattr(pretokenize, "_native_split", None)
    bpe2 = NaiveBPE()
    bpe2.train(corpus, max_vocab=120)
    assert bpe2.merges_list == bpe.merges_list
    assert pretokenize._get_native_split() is None
    for cls, got, w in zip(classes, encode_all(), want):
        assert got == w, cls.__name__
