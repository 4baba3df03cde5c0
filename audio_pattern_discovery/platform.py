"""The one place that decides what the device can run.

Hand-written kernels (ops/dtw_tile.py) are compiled for CUDA GPUs only.
The pair router, the benchmark, `__graft_entry__.entry()` and
`chip_smoke.py` all ask `on_gpu()`; nothing else branches on the platform.
"""

from __future__ import annotations

import jax


def on_gpu() -> bool:
    """True when JAX's default device is a CUDA GPU."""
    return jax.devices()[0].platform == "gpu"


def require_gpu(what: str) -> None:
    """Exit non-zero with a message when there is no GPU: a measurement
    taken on another device would be reported under the wrong name."""
    if not on_gpu():
        dev = jax.devices()[0]
        raise SystemExit(
            f"{what}: needs a CUDA GPU, but JAX's default device is "
            f"{dev.platform!r} ({dev.device_kind}); not falling back"
        )
