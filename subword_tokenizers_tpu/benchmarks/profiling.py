"""Profiling / tracing hooks (SURVEY.md §5: the reference only has
wall-clock timers; here we add structured timing and XLA traces).

- :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable trace of the device work inside the block.
- :class:`StepTimer` — lightweight per-phase wall-clock accumulator used
  by benchmark scripts; emits a structured dict (JSON-ready).
- :func:`throughput_report` — canonical bytes/s / tokens/s summary in the
  shape BASELINE.md uses (MB/s per chip is the primary metric).
- :func:`phase` / :func:`report` / :func:`reset` — the *production* hook:
  the fused training loop (ops/train_loop.run_fused) and the sliced
  encode driver (ops/wp_encode_e2e) wrap their stages in
  ``profiling.phase("...")``. Off by default (a single module-bool check
  per block); enabled with ``SWT_PROFILE=1`` or :func:`enable`, after
  which :func:`report` returns per-phase totals/counts/means and bench.py
  prints them to stderr.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax profiler trace of the enclosed block."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Accumulates wall time per named phase.

    >>> t = StepTimer()
    >>> with t.phase("select"):
    ...     ...
    >>> t.report()["select"]["total_s"]
    """

    def __init__(self) -> None:
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self._total[name],
                "count": self._count[name],
                "mean_s": self._total[name] / max(self._count[name], 1),
            }
            for name in self._total
        }


# --------------------------------------------------- production phase hook

_enabled = os.environ.get("SWT_PROFILE", "") not in ("", "0")
_timer = StepTimer()


def enable(on: bool = True) -> None:
    """Turn the global phase profiler on/off programmatically."""
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Time a named stage of a production path; near-free when disabled."""
    if not _enabled:
        yield
        return
    with _timer.phase(name):
        yield


def reset() -> None:
    global _timer
    _timer = StepTimer()


def report() -> Dict[str, Dict[str, float]]:
    """Per-phase totals across everything run since :func:`reset`."""
    return _timer.report()


def take_split() -> Dict[str, float]:
    """Wall ms per stage since the last :func:`reset`, keyed by the name
    after its first dot (``train.fetch_records`` -> ``fetch_records``),
    then reset. Device time lands in whichever stage waits for the
    device; host work is native_prep / pack_u16 / stitch."""
    out: Dict[str, float] = {}
    for name, v in report().items():
        short = name.split(".", 1)[-1]
        out[short] = round(out.get(short, 0.0) + v["total_s"] * 1e3, 1)
    reset()
    return out


def report_str() -> str:
    """One-line-per-phase human summary (sorted by total time)."""
    rep = report()
    rows = sorted(rep.items(), key=lambda kv: -kv[1]["total_s"])
    return "\n".join(
        f"  {name:<28} {v['total_s']*1e3:10.1f} ms  x{v['count']:<6d} "
        f"mean {v['mean_s']*1e3:8.3f} ms" for name, v in rows)


def throughput_report(n_bytes: int, n_tokens: int, seconds: float,
                      n_chips: int = 1,
                      label: Optional[str] = None) -> Dict[str, float]:
    """Primary throughput metrics (BASELINE.json: MB/s per chip)."""
    seconds = max(seconds, 1e-12)
    rep = {
        "bytes": n_bytes,
        "tokens": n_tokens,
        "seconds": seconds,
        "MBps": n_bytes / seconds / 1e6,
        "MBps_per_chip": n_bytes / seconds / 1e6 / max(n_chips, 1),
        "tokens_per_s": n_tokens / seconds,
    }
    if label is not None:
        rep["label"] = label
    return rep
