"""chip_smoke.py's phases on the CPU backend at a tiny size: the same
code and comparisons the GPU run makes, on a few hundred train-85k
sentences and small vocabularies."""
import json
import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

N_SENT = 200


@pytest.fixture(scope="module")
def corpus():
    return chip_smoke.load_corpus(N_SENT)


@pytest.fixture(scope="module")
def trained(corpus):
    return chip_smoke.phase_train(corpus, 160, 140, warm=True)


def test_main_refuses_without_gpu(capsys):
    assert jax.default_backend() == "cpu"
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four-gpus"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out  # no result line


def test_bench_refuses_without_gpu(capsys):
    """bench.py has no CPU fallback: off the GPU it measures nothing."""
    import bench
    with pytest.raises(SystemExit, match="measures the GPU"):
        bench.main()
    assert '"metric"' not in capsys.readouterr().out


def test_report_device_lines(capsys):
    chip_smoke.report_device()
    out = capsys.readouterr().out
    assert "device: platform=cpu" in out
    assert "card (name, power limit):" in out
    assert "compile cache:" in out
    assert "native front end:" in out


def test_phase_train_and_anchor(corpus, trained, capsys):
    bpe, wp = trained
    assert len(bpe.merges_list) > 0 and len(wp._merge_log) > 0
    # The anchor check passes on a true prefix and fails on a wrong one.
    chip_smoke.phase_train(corpus, 120, 100,
                           anchor=[list(p) for p in bpe.merges_list[:20]],
                           warm=False)
    assert "first 20 merges equal the reference anchor" in \
        capsys.readouterr().out
    bad = [list(p) for p in bpe.merges_list[:20]]
    bad[5] = ["no", "such"]
    with pytest.raises(chip_smoke.SmokeError, match="reference anchor"):
        chip_smoke.phase_train(corpus, 120, 100, anchor=bad, warm=False)


def test_phase_train_vs_cpu(corpus, capsys):
    chip_smoke.phase_train_vs_cpu(corpus[:80], 120)
    out = capsys.readouterr().out
    assert out.count("identical on cpu") == 2


def test_phase_encode(corpus, trained, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(chip_smoke.profiling, "_enabled", True)
    bpe, wp = trained
    chip_smoke.phase_encode(bpe, wp, corpus, str(tmp_path), sample=40)
    out = capsys.readouterr().out
    for name in ("NaiveBPE", "FastBPE", "NaiveWP", "FastWP"):
        assert f"encode {name} on {N_SENT} sentences" in out
    # The warm run's per-stage walls (FastWP's fused native path).
    fastwp = [l for l in out.splitlines() if l.startswith("encode FastWP")]
    assert "native_prep" in fastwp[0] and "stitch" in fastwp[0]
    assert set(os.listdir(tmp_path)) == {"bpe", "wp"}


def test_phase_encode_detects_divergence(corpus, trained, tmp_path,
                                         monkeypatch):
    """A tokenizer whose host path disagrees with its batch path fails."""
    bpe, wp = trained
    real = chip_smoke.NaiveBPE.tokenize

    def off_by_one(self, text):
        return real(self, text) + ["X"]

    monkeypatch.setattr(chip_smoke.NaiveBPE, "tokenize", off_by_one)
    with pytest.raises(chip_smoke.SmokeError, match="differs from tokenize"):
        chip_smoke.phase_encode(bpe, wp, corpus[:30], str(tmp_path),
                                sample=5)


def test_phase_cli(corpus, tmp_path, capsys):
    cwd = os.getcwd()
    chip_smoke.phase_cli(corpus[:60], 120, str(tmp_path))
    assert os.getcwd() == cwd
    assert "output file equals tokenize_batch" in capsys.readouterr().out
    with open(tmp_path / "train.tokens.json") as f:
        assert set(json.load(f)) == {"NaiveBPE", "FastWordPiece"}


def test_phase_four_on_virtual_devices(capsys):
    assert len(jax.devices()) >= 8
    summary = chip_smoke.phase_four(4, n_sentences=60, vocab=200)
    assert summary["devices"] == 4
    rows = summary["corpus_rows_per_device"]
    assert sorted(rows) == sorted(str(d) for d in jax.devices()[:4])
    assert summary["bpe_tiers"]["full"] == 0
    out = capsys.readouterr().out
    assert "four-device phase" in out
    assert f"corpus rows per device during sharded training: {rows}" in out


def test_main_four_gpus_counts_the_mesh(monkeypatch, capsys):
    """With more devices visible than the mesh uses, the result line
    counts the devices the run used."""
    assert len(jax.devices()) > 4
    real = chip_smoke.phase_four
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(chip_smoke, "phase_four",
                        lambda n: real(n, n_sentences=60, vocab=200))
    monkeypatch.setattr(chip_smoke.profiling, "_enabled", False)
    assert chip_smoke.main(["--four-gpus"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    dev = jax.devices()[0]
    assert last == {"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": 4}}
