"""Driver entry points: compile-check entry() and run the multichip
dryrun on the virtual device mesh."""
import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def test_entry_compiles_and_runs():
    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    shapes = [o.shape for o in out]
    assert shapes[0][0] == 3  # three example sentences


def test_dryrun_multichip():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    import __graft_entry__ as g
    summary = g.dryrun_multichip(8)
    assert len(summary["corpus_rows_per_device"]) == 8
    assert summary["bpe_tiers"]["proven"] > 0
