"""audio_pattern_discovery: accelerated audio pattern discovery.

A JAX/XLA/Pallas framework with the capabilities of
dkohlsdorf/audio_pattern_discovery (Rust, CPU): unsupervised discovery of
recurring patterns in collections of audio recordings.  Public entry point
(preserved from the reference, BASELINE.json north_star): a directory of WAV
files in -> discovered pattern clusters + DTW alignments out.

See SURVEY.md for the structural analysis (and its SS0 provenance caveat:
the reference mount was empty at survey time, so reference citations are to
the capability spec in BASELINE.json, not file:line).
"""

__version__ = "0.1.0"

import os as _os
from pathlib import Path as _Path

# Fixed, so that the path (part of the cache key) is the same every run.
CHECKOUT_CACHE_DIR = _Path(__file__).resolve().parent.parent / ".jax_cache"


def _enable_compilation_cache() -> None:
    """Keep XLA's compiled programs across processes.

    JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is set, that
    directory is the cache and nothing here overrides it.  Otherwise the
    cache lives in `.jax_cache/` at the root of the checkout.  A process
    pinned to the CPU (JAX_PLATFORMS=cpu: the tests and the host-only
    tools) keeps no cache of its own: its compiles take well under a
    second, and XLA:CPU warns about its own entries when it reloads them.
    """
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        if _os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
            return
        jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_enable_compilation_cache()

from audio_pattern_discovery.config import PipelineConfig  # noqa: F401
