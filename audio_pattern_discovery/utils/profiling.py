"""Tracing / profiling hooks (SURVEY.md SS6.1).

The reference has nothing beyond `time` prints; this rebuild exposes XLA
profiler traces viewable in TensorBoard/Perfetto plus cheap annotation spans.

Usage:
    with trace_to("/tmp/apd_trace"):           # whole-region XLA trace
        D = all_pairs_distances(...)

    with annotate("dtw_block"):                # named span inside a trace
        ...

    prof = Profiler("/tmp/apd_trace"); prof.start(); ...; prof.stop()
"""

from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path

import jax


@contextmanager
def trace_to(log_dir: str | Path):
    """Capture an XLA device trace of the enclosed region into `log_dir`."""
    log_dir = str(log_dir)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with jax.profiler.trace(log_dir):
        yield log_dir


def annotate(name: str):
    """Named span that shows up on the trace timeline (host + device)."""
    return jax.profiler.TraceAnnotation(name)


class Profiler:
    """Start/stop profiler for driver loops that span multiple functions."""

    def __init__(self, log_dir: str | Path):
        self.log_dir = str(log_dir)
        self._active = False

    def start(self) -> None:
        Path(self.log_dir).mkdir(parents=True, exist_ok=True)
        jax.profiler.start_trace(self.log_dir)
        self._active = True

    def stop(self) -> None:
        if self._active:
            jax.profiler.stop_trace()
            self._active = False
