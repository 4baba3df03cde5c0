import numpy as np

from audio_pattern_discovery.config import SegmentationConfig
from audio_pattern_discovery.ops.segmentation import (
    segment_corpus,
    segment_energy,
    segment_sliding,
)


def _energies_with_bursts(n=200, bursts=((30, 50), (100, 140))):
    e = np.full(n, -8.0)
    for s, t in bursts:
        e[s:t] = -1.0
    return e


def test_energy_segments_found():
    cfg = SegmentationConfig(threshold_db=-40.0, min_len_frames=5, merge_gap_frames=2)
    e = _energies_with_bursts()
    runs = segment_energy(e, len(e), cfg)
    assert runs == [(30, 50), (100, 140)]


def test_gap_merging():
    cfg = SegmentationConfig(threshold_db=-40.0, min_len_frames=5, merge_gap_frames=5)
    e = _energies_with_bursts(bursts=((30, 40), (43, 55)))
    runs = segment_energy(e, len(e), cfg)
    assert runs == [(30, 55)]


def test_min_and_max_len():
    cfg = SegmentationConfig(
        threshold_db=-40.0, min_len_frames=10, max_len_frames=20, merge_gap_frames=0
    )
    e = _energies_with_bursts(bursts=((5, 9), (50, 120)))  # 4 frames; 70 frames
    runs = segment_energy(e, len(e), cfg)
    assert (5, 9) not in runs          # too short, dropped
    assert all(t - s <= 20 for s, t in runs)
    covered = sum(t - s for s, t in runs)
    assert covered >= 60               # long burst mostly retained


def test_sliding_windows():
    cfg = SegmentationConfig(method="sliding", window_frames=32, stride_frames=16)
    runs = segment_sliding(100, cfg)
    assert runs[0] == (0, 32)
    assert runs[1] == (16, 48)
    assert all(t - s == 32 for s, t in runs)


def test_segment_corpus_respects_frame_counts():
    cfg = SegmentationConfig(threshold_db=-40.0, min_len_frames=5)
    e = np.stack([_energies_with_bursts(), _energies_with_bursts()])
    # Clip 1 has only 60 valid frames: the (100, 140) burst is padding.
    segs = segment_corpus(e, np.array([200, 60]), cfg)
    by_clip = {}
    for s in segs:
        by_clip.setdefault(s.clip, []).append((s.start_frame, s.end_frame))
    assert by_clip[0] == [(30, 50), (100, 140)]
    assert by_clip[1] == [(30, 50)]


def test_silent_clip_yields_no_segments():
    """A digitally silent clip must not flood the pipeline with junk runs."""
    import numpy as np

    from audio_pattern_discovery.config import SegmentationConfig
    from audio_pattern_discovery.ops.segmentation import segment_energy

    cfg = SegmentationConfig()
    silent = np.full(500, -10.0)  # all frames at the log floor
    assert segment_energy(silent, 500, cfg) == []
