"""Synchronized device timing (SURVEY.md SS6.1).

Device dispatch is async; wall-clock timing of a jitted call without a
synchronization barrier measures dispatch latency, not compute.  The
timers here materialize results to the host (jax.device_get), which also
covers the transfer a caller needs anyway.
"""

from __future__ import annotations

import time

import jax
import numpy as np


def materialize(tree) -> None:
    """Force a pytree of device arrays onto the host (a true sync barrier)."""
    for leaf in jax.tree_util.tree_leaves(tree):
        np.asarray(leaf)


class DeviceTimer:
    """Usage:
        with DeviceTimer() as t:
            out = fn(x)
            t.block_on(out)
        elapsed = t.elapsed_s
    """

    def __enter__(self) -> "DeviceTimer":
        self._outputs = []
        self.t0 = time.perf_counter()
        return self

    def block_on(self, *outputs) -> None:
        self._outputs.extend(outputs)

    def __exit__(self, *exc) -> bool:
        materialize(self._outputs)
        self.elapsed_s = time.perf_counter() - self.t0
        return False


def time_fn(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall-seconds per call of `fn(*args)`, post-compilation,
    including device->host result materialization."""
    for _ in range(warmup):
        materialize(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        materialize(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
