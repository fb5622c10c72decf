"""Optional host-CPU routing for small encode batches, and per-device
model-state caches.

A scan encoder's step costs microseconds of compute, but every device
program also pays a fixed launch and transfer cost; below some batch
size the host CPU backend can finish first. ``scan_device`` routes scans
below a slot threshold (rows x steps of the pending scan) to the local
CPU jax backend — the same jitted program compiled for the CPU target,
with bit-identical output (everything on the conformance path is integer
arithmetic).

Routing is OFF by default (threshold 0): every batch runs on the default
backend. The threshold is a cost-only knob, ``SWT_CPU_DISPATCH_SLOTS``
(char-slots), kept until a crossover is measured on the GPU.
"""
from __future__ import annotations

import os
from typing import Optional

CPU_DISPATCH_SLOTS = int(os.environ.get("SWT_CPU_DISPATCH_SLOTS", "0"))


def scan_device(n_slots: int, mesh=None, threshold: Optional[int] = None):
    """Return the host CPU ``jax.Device`` when an ``n_slots``-sized scan
    should run on host, else None (keep the default placement).

    None is returned when routing is off (threshold <= 0, the default),
    when the default backend already is the CPU, when an explicit device
    mesh is in force (the caller asked for sharded execution), or when
    the workload is at or above the threshold.
    """
    if mesh is not None:
        return None
    limit = CPU_DISPATCH_SLOTS if threshold is None else threshold
    if n_slots >= limit or limit <= 0:
        return None
    import jax
    if jax.default_backend() == "cpu":
        return None
    return jax.local_devices(backend="cpu")[0]


class DeviceCache:
    """Per-device cache of a model-state array bundle.

    ``build()`` returns a tuple of host (numpy) arrays; ``get(device)``
    returns the bundle uploaded to ``device`` (None = default device),
    uploading once per device — repeat calls reuse the resident copies
    (the bundles are tens of MB; re-uploading them per call would
    dominate the encode wall).
    """

    def __init__(self, build):
        self._build = build
        self._host = None
        self._per_dev = {}

    def host(self):
        if self._host is None:
            self._host = tuple(self._build())
        return self._host

    def get(self, device=None):
        key = device
        got = self._per_dev.get(key)
        if got is None:
            import jax
            import jax.numpy as jnp
            host = self.host()
            if device is None:
                got = tuple(jnp.asarray(a) for a in host)
            else:
                got = tuple(jax.device_put(a, device) for a in host)
            self._per_dev[key] = got
        return got
