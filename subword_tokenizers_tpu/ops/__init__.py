"""Device ops. Importing this package enables JAX x64 mode — the
conformance-critical kernels are built on exact i64 arithmetic
(sort keys, cumulative sums, IEEE-double bit emulation) — and places the
persistent compilation cache (see :func:`own_cache_dir`)."""
from __future__ import annotations

import os
from typing import Mapping, Optional

import jax

CHECKOUT_CACHE = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", ".jax_cache"))


def own_cache_dir(environ: Mapping[str, str]) -> Optional[str]:
    """The compile-cache directory this package sets, or None.

    None when ``JAX_COMPILATION_CACHE_DIR`` is set: JAX reads that
    variable itself, and the deployment's choice stands. Otherwise the
    fixed path ``<checkout>/.jax_cache``, so every process of one checkout
    finds what an earlier one compiled."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CHECKOUT_CACHE


if not jax.config.jax_enable_x64:
    jax.config.update("jax_enable_x64", True)

_own = own_cache_dir(os.environ)
if _own is not None:
    jax.config.update("jax_compilation_cache_dir", _own)
