"""Profiler hooks produce trace artifacts (SURVEY.md SS6.1)."""

import jax.numpy as jnp
import pytest
import numpy as np

from audio_pattern_discovery.utils.profiling import annotate, trace_to


@pytest.mark.full
def test_trace_to_writes_artifacts(tmp_path):
    with trace_to(tmp_path / "trace"):
        with annotate("test_span"):
            x = jnp.ones((64, 64)) @ jnp.ones((64, 64))
            np.asarray(x)
    files = list((tmp_path / "trace").rglob("*"))
    assert any(f.is_file() for f in files), "no trace artifacts written"
