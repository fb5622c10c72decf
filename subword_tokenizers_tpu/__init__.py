"""subword_tokenizers_tpu — a subword tokenization framework whose training
and batched encoding run on an accelerator (an NVIDIA GPU) through JAX.

A from-scratch JAX/XLA implementation with the full capabilities of
phtryll/subword-tokenizers (see SURVEY.md): four tokenizer models
(NaiveBPE, FastBPE, NaiveWP, FastWP) with bit-exact conformance to the
reference on its golden corpora, an exact BERT-style pre-tokenization front
end (NumPy + C++), a benchmark suite, a CLI, and data-parallel multi-GPU
training via ``jax.sharding`` / ``shard_map``.

Device code requires 64-bit integer support: importing this package
enables JAX x64 mode and the persistent compilation cache (both configured
in ``ops/__init__.py``, imported below).
"""

from . import ops  # noqa: F401  (configures jax x64 + compilation cache)
from .models.bpe import FastBPE, NaiveBPE  # noqa: F401
from .models.wordpiece import FastWP, NaiveWP  # noqa: F401
from .models.base import SubwordTokenizer  # noqa: F401
from .models.trie import E2ETrie, MatchTrie  # noqa: F401
from .utils import recover_sentence  # noqa: F401

TOKENIZERS = {
    "NaiveBPE": NaiveBPE,
    "NaiveWordPiece": NaiveWP,
    "FastBPE": FastBPE,
    "FastWordPiece": FastWP,
}

__version__ = "0.1.0"
