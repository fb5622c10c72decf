"""Small host-side utilities (reference parity: source/utils.py:141-153)."""
from __future__ import annotations

import re
import sys
from typing import List


class Progress:
    """Training progress as one stderr line, rewritten in place: the
    reference's progress bar without a dependency."""

    def __init__(self, total: int, desc: str) -> None:
        self.total = max(int(total), 0)
        self.desc = desc
        self.done = 0
        self._show()

    def _show(self) -> None:
        print(f"\r{self.desc}: {self.done}/{self.total}", end="",
              file=sys.stderr, flush=True)

    def update(self, n: int = 1) -> None:
        self.done += n
        self._show()

    def close(self) -> None:
        print(file=sys.stderr, flush=True)

# Best-effort detokenizer. Whitespace is not recoverable from a token
# stream; this mirrors the reference's common-sense punctuation handling
# (source/utils.py:141-153 — dead code there, provided for API parity).
_JOIN_SHARP = re.compile(r"\s##(\S)")
_LEFT_PUNCT = re.compile(r"\s(\.|,|\)|\]|\\|’|-|\'|\\|/)")
_RIGHT_PUNCT = re.compile(r"(\(|\[|\\|’|-|\'|\\|/)\s")


def recover_sentence(tokens: List[str]) -> str:
    """Join tokens into a readable sentence (not a faithful inverse)."""
    out = " ".join(tokens)
    out = _JOIN_SHARP.sub(r"\g<1>", out)
    out = _LEFT_PUNCT.sub(r"\g<1>", out)
    out = _RIGHT_PUNCT.sub(r"\g<1>", out)
    return out
