#!/usr/bin/env python3
"""Time NaiveBPE vs NaiveWP train-5K@1000 warm (golden-gated).

Measures the WP/BPE warm training-wall gap (the target was WP within
15% of BPE) on the default backend.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
from subword_tokenizers_tpu.models.bpe import NaiveBPE  # noqa: E402
from subword_tokenizers_tpu.models.wordpiece import NaiveWP  # noqa: E402

with open("/root/reference/data/train-5K.json") as f:
    train5k = json.load(f)
with open(os.path.join(ROOT, "tests/golden/train5k_v1000_merges.json")) as f:
    gold_merges = [tuple(p) for p in json.load(f)]
with open(os.path.join(ROOT, "tests/golden/train5k_v1000_wp_vocab.json")) as f:
    gold_vocab = set(json.load(f))

print(f"devices: {jax.devices()}", file=sys.stderr)


def run(cls, check):
    best = None
    for i in range(3):  # first run absorbs compiles
        tok = cls()
        t0 = time.perf_counter()
        tok.train(train5k, 1000)
        dt = time.perf_counter() - t0
        check(tok)
        print(f"  {cls.__name__} run {i}: {dt:.3f}s", file=sys.stderr)
        if best is None or dt < best:
            best = dt
    return best


bpe = run(NaiveBPE, lambda t: (_ for _ in ()).throw(AssertionError("bpe golden"))
          if t.merges_list != gold_merges else None)
wp = run(NaiveWP, lambda t: (_ for _ in ()).throw(AssertionError("wp golden"))
         if t.vocab != gold_vocab else None)
print(json.dumps({"backend": jax.default_backend(),
                  "bpe_train5k_s": round(bpe, 3),
                  "wp_train5k_s": round(wp, 3),
                  "wp_over_bpe": round(wp / bpe, 3)}))
