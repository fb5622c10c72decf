#!/usr/bin/env python3
"""Main-path smoke run on NVIDIA GPUs, in one process.

    python chip_smoke.py              # one GPU: train, encode, CLI
    python chip_smoke.py --four-gpus  # four GPUs: sharded train + encode

One GPU: trains NaiveBPE to a 32k vocabulary and NaiveWP to 8k on
data/train-85k.json; requires the first 500 BPE merges to equal the
reference's own output on that corpus (tests/golden/t85k_v578_merges.json)
and GPU training to equal CPU-backend training on a slice; encodes the
whole corpus with all four tokenizers loaded from the saved resources and
requires the output to equal the CPU backend's and, on a seeded sample,
the host path's; then drives the CLI in-process. Every comparison is exact
equality: the conformance path is integer arithmetic throughout.

Four GPUs: data-parallel NaiveBPE/NaiveWP training and sharded FastWP
encode over a 4-device mesh against one device
(``__graft_entry__.dryrun_multichip``), and nothing else.

Exits non-zero, without the result line, when the default JAX backend is
not a GPU or any check fails. The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import random
import subprocess
import sys
import tempfile
import time

import jax

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from subword_tokenizers_tpu import (FastBPE, FastWP, NaiveBPE,  # noqa: E402
                                    NaiveWP)
from subword_tokenizers_tpu.benchmarks import profiling  # noqa: E402

CORPUS = os.path.join(ROOT, "data", "train-85k.json")
ANCHOR = os.path.join(ROOT, "tests", "golden", "t85k_v578_merges.json")

# Full-size configuration: the deepest vocabularies the repo has trained
# on train-85k, and a slice the CPU backend trains in under a minute.
BPE_VOCAB = 32_000
WP_VOCAB = 8_000
SLICE_SENTENCES = 2_000
SLICE_VOCAB = 1_000
HOST_SAMPLE = 500
SEED = 0


class SmokeError(RuntimeError):
    """A check of the smoke run failed."""


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def on_cpu():
    """Default-device context of the host CPU backend."""
    return jax.default_device(jax.devices("cpu")[0])


def peak_bytes():
    stats = jax.devices()[0].memory_stats()
    return stats.get("peak_bytes_in_use") if stats else None


def phase_split() -> str:
    """:func:`profiling.take_split` as text, longest stage first."""
    rows = sorted(profiling.take_split().items(), key=lambda kv: -kv[1])
    return ", ".join(f"{name} {ms} ms" for name, ms in rows) or "not profiled"


def load_corpus(n=None):
    with open(CORPUS, encoding="utf-8") as f:
        corpus = json.load(f)
    return corpus if n is None else corpus[:n]


def trained_state(tok):
    """Everything training decides: vocabulary and merge order."""
    if isinstance(tok, NaiveBPE):
        return list(tok.merges_list), set(tok.vocab)
    return list(tok._merge_log), set(tok.vocab)


def card_line() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {type(e).__name__}: {e}"
    if smi.returncode != 0:
        return (f"nvidia-smi failed (rc {smi.returncode}): "
                f"{smi.stderr.strip()}")
    return " | ".join(line.strip() for line in smi.stdout.splitlines()
                      if line.strip())


def report_device() -> str:
    from subword_tokenizers_tpu._native import binding

    dev = jax.devices()[0]
    card = card_line()
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"visible={len(jax.devices())}")
    log(f"card (name, power limit): {card}")
    log(f"jax {jax.__version__}, x64={jax.config.jax_enable_x64}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    if binding.try_load() is not None:
        log("native front end: loaded")
    else:
        log(f"native front end: NOT loaded ({binding.load_error()}); "
            f"encode and front end run the NumPy/Python fallback")
    return card


def phase_train(corpus, bpe_vocab, wp_vocab, anchor=None, warm=True):
    """Train NaiveBPE and NaiveWP on ``corpus``; check the BPE merges
    against ``anchor`` (a merge-list prefix) and a warm rerun against the
    cold run. Returns the trained (bpe, wp)."""
    nbytes = sum(len(s.encode("utf-8")) for s in corpus)
    trained = []
    for cls, vocab in ((NaiveBPE, bpe_vocab), (NaiveWP, wp_vocab)):
        tok = cls()
        _, cold = timed(lambda: tok.train(corpus, max_vocab=vocab))
        state = trained_state(tok)
        require(state[0], f"{cls.__name__}: no merges")
        if cls is NaiveBPE and anchor is not None:
            got = [list(p) for p in tok.merges_list[:len(anchor)]]
            require(got == [list(p) for p in anchor],
                    f"NaiveBPE: first {len(anchor)} merges differ from "
                    f"the reference anchor")
            log(f"train NaiveBPE: first {len(anchor)} merges equal the "
                f"reference anchor")
        warm_s = None
        phase_split()
        if warm:
            again = cls()
            _, warm_s = timed(lambda: again.train(corpus, max_vocab=vocab))
            require(trained_state(again) == state,
                    f"{cls.__name__}: warm rerun differs from the cold run")
        log(f"train {cls.__name__} vocab={vocab} on {len(corpus)} "
            f"sentences ({nbytes} bytes): {len(state[0])} merges, "
            f"vocab {len(state[1])}, cold {cold:.3f} s, "
            f"warm {'not run' if warm_s is None else f'{warm_s:.3f} s'} "
            f"({phase_split()}), "
            f"peak device bytes since start {peak_bytes()}")
        trained.append(tok)
    return tuple(trained)


def phase_train_vs_cpu(corpus, vocab):
    """Default-device training == CPU-backend training, both models."""
    for cls in (NaiveBPE, NaiveWP):
        dev = cls()
        _, dev_s = timed(lambda: dev.train(corpus, max_vocab=vocab))
        with on_cpu():
            host = cls()
            _, cpu_s = timed(lambda: host.train(corpus, max_vocab=vocab))
        require(trained_state(dev) == trained_state(host),
                f"{cls.__name__}: default-device training differs from the "
                f"CPU backend on {len(corpus)} sentences @ {vocab}")
        log(f"train {cls.__name__} vocab={vocab} on {len(corpus)} "
            f"sentences: {len(trained_state(dev)[0])} merges identical on "
            f"{jax.devices()[0].platform} ({dev_s:.3f} s) and cpu "
            f"({cpu_s:.3f} s)")


def phase_encode(bpe, wp, corpus, workdir, card="", sample=HOST_SAMPLE,
                 seed=SEED):
    """Save the trained models, load them into all four tokenizers, and
    require tokenize_batch over ``corpus`` to be deterministic, equal to
    the CPU backend's output and, on a seeded sample, to the host path."""
    paths = {"bpe": os.path.join(workdir, "bpe"),
             "wp": os.path.join(workdir, "wp")}
    bpe.save_resources(paths["bpe"])
    wp.save_resources(paths["wp"])
    nbytes = sum(len(s.encode("utf-8")) for s in corpus)
    rng = random.Random(seed)
    idx = rng.sample(range(len(corpus)), min(sample, len(corpus)))

    def load(cls, key):
        tok = cls()
        tok.load_resources(paths[key], strict=True)
        src = bpe if key == "bpe" else wp
        if key == "bpe":
            require(tok.merges_list == src.merges_list,
                    f"{cls.__name__}: loaded merges differ")
        else:
            require(tok.vocab == src.vocab,
                    f"{cls.__name__}: loaded vocab differs")
        return tok

    for cls, key in ((NaiveBPE, "bpe"), (FastBPE, "bpe"),
                     (NaiveWP, "wp"), (FastWP, "wp")):
        name = cls.__name__
        tok = load(cls, key)
        first, cold = timed(lambda: tok.tokenize_batch(corpus))
        phase_split()
        second, warm = timed(lambda: tok.tokenize_batch(corpus))
        split = phase_split()
        require(len(first) == len(corpus), f"{name}: wrong row count")
        require(second == first, f"{name}: two runs of tokenize_batch differ")
        with on_cpu():
            ref = load(cls, key)
            on_host_backend, cpu_s = timed(lambda: ref.tokenize_batch(corpus))
        require(on_host_backend == first,
                f"{name}: tokenize_batch differs from the CPU backend")
        host = load(cls, key)
        for i in idx:
            require(host.tokenize(corpus[i]) == first[i],
                    f"{name}: batch row {i} differs from tokenize()")
        n_tok = sum(map(len, first))
        log(f"encode {name} on {len(corpus)} sentences ({nbytes} bytes, "
            f"{n_tok} tokens): equal to cpu backend and to {len(idx)} "
            f"host-path rows; cold {cold:.3f} s, warm {warm:.3f} s = "
            f"{nbytes / warm / 1e6:.3f} MB/s ({split}; cpu backend "
            f"{cpu_s:.3f} s); "
            f"peak device bytes since start {peak_bytes()}; card {card}")


def phase_cli(corpus, vocab, workdir):
    """CLI --train/--save, then --pretrained/--tokenize, in-process; the
    written token file must equal the library's own output."""
    from subword_tokenizers_tpu import TOKENIZERS
    from subword_tokenizers_tpu.cli import main as cli_main

    models = ["NaiveBPE", "FastWordPiece"]
    with open(os.path.join(workdir, "train.json"), "w",
              encoding="utf-8") as f:
        json.dump(corpus, f, ensure_ascii=False)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            cli_main(["--model", *models, "--train", "train.json",
                      "--max_vocab", str(vocab), "--save", "smoke"])
            cli_main(["--model", *models, "--pretrained", "smoke",
                      "--tokenize", "train.json"])
    finally:
        os.chdir(cwd)
    with open(os.path.join(workdir, "train.tokens.json"),
              encoding="utf-8") as f:
        written = json.load(f)
    for name in models:
        tok = TOKENIZERS[name]()
        tok.load_resources(os.path.join(workdir, "resources", "smoke", name),
                           strict=True)
        require(written[name] == tok.tokenize_batch(corpus),
                f"CLI {name}: written tokens differ from tokenize_batch")
    log(f"cli: --train/--save and --pretrained/--tokenize on "
        f"{len(corpus)} sentences @ vocab {vocab} for {', '.join(models)}: "
        f"output file equals tokenize_batch "
        f"({len(out.getvalue().splitlines())} lines of CLI output)")


def phase_four(n_devices, n_sentences=SLICE_SENTENCES, vocab=SLICE_VOCAB):
    """Data-parallel training and sharded encode over ``n_devices``
    against one device."""
    import __graft_entry__

    summary, wall = timed(lambda: __graft_entry__.dryrun_multichip(
        n_devices, n_sentences=n_sentences, vocab=vocab))
    log(f"corpus rows per device during sharded training: "
        f"{summary['corpus_rows_per_device']}")
    log(f"four-device phase: {wall:.3f} s")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only data-parallel training and sharded "
                         "encode over four GPUs against one")
    args = ap.parse_args(argv)

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: the default JAX backend is {backend!r}, not "
              f"'gpu'; nothing was run", file=sys.stderr)
        return 2
    need = 4 if args.four_gpus else 1
    if len(jax.devices()) < need:
        print(f"chip_smoke: need {need} GPUs, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    profiling.enable()
    card = report_device()
    if args.four_gpus:
        count = phase_four(4)["devices"]
    else:
        count = 1
        with open(ANCHOR, encoding="utf-8") as f:
            anchor = json.load(f)
        corpus = load_corpus()
        bpe, wp = phase_train(corpus, BPE_VOCAB, WP_VOCAB, anchor)
        part = corpus[:SLICE_SENTENCES]
        phase_train_vs_cpu(part, SLICE_VOCAB)
        with tempfile.TemporaryDirectory() as td:
            phase_encode(bpe, wp, corpus, td, card)
            phase_cli(part, SLICE_VOCAB, td)
    log(f"total wall {time.perf_counter() - t0:.3f} s; card {card}")
    # ``count`` is the number of devices the run used, not all JAX sees.
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
