"""Pure-NumPy golden oracles for the device code (SURVEY.md SS5.2).

These are deliberately naive, loop-level implementations of the reference
pipeline's math (STFT, DTW, agglomerative clustering).  They stand in for the
Rust reference (mount empty at survey time, SURVEY.md SS0) as the source of
truth that the device code must match within float tolerance, and double as
the CPU baseline measurement for BASELINE.md.
"""

from audio_pattern_discovery.oracle.stft import stft_oracle  # noqa: F401
from audio_pattern_discovery.oracle.dtw import (  # noqa: F401
    dtw_oracle,
    dtw_path_oracle,
)
from audio_pattern_discovery.oracle.cluster import linkage_oracle  # noqa: F401
