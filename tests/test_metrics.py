"""Cluster-quality metrics (cluster/metrics.py) vs the sklearn oracle, and
their presence in the discovery manifest."""

import numpy as np
import pytest

from audio_pattern_discovery.cluster.metrics import (
    cluster_quality,
    silhouette_samples,
)


def _random_partition_problem(rng, k=40, c=4):
    pts = rng.normal(size=(k, 3)) + rng.integers(0, c, k)[:, None] * 4.0
    D = np.sqrt(((pts[:, None] - pts[None, :]) ** 2).sum(-1))
    labels = rng.integers(0, c, k)
    return D, labels


def test_matches_sklearn(rng):
    from sklearn.metrics import silhouette_samples as sk_samples
    from sklearn.metrics import silhouette_score as sk_score

    for trial in range(3):
        D, labels = _random_partition_problem(rng)
        s = silhouette_samples(D, labels)
        np.testing.assert_allclose(s, sk_samples(D, labels, metric="precomputed"),
                                   atol=1e-10)
        q = cluster_quality(D, labels)
        assert q["silhouette_mean"] == pytest.approx(
            float(sk_score(D, labels, metric="precomputed")), abs=1e-4
        )


def test_singletons_and_degenerate(rng):
    D, labels = _random_partition_problem(rng, k=10, c=3)
    labels = np.array([0, 1, 2, 3, 0, 0, 1, 1, 2, 2])  # cluster 3 singleton
    s = silhouette_samples(D, labels)
    assert s[3] == 0.0
    # Single-cluster partition: all zeros, not NaN.
    assert (silhouette_samples(D, np.zeros(10, int)) == 0).all()


def test_well_separated_beats_random(rng):
    pts = np.concatenate([rng.normal(0, 0.1, (20, 2)),
                          rng.normal(8, 0.1, (20, 2))])
    D = np.sqrt(((pts[:, None] - pts[None, :]) ** 2).sum(-1))
    good = cluster_quality(D, np.repeat([0, 1], 20))["silhouette_mean"]
    bad = cluster_quality(D, rng.integers(0, 2, 40))["silhouette_mean"]
    assert good > 0.9 > bad
    q = cluster_quality(D, np.repeat([0, 1], 20))
    assert set(q["clusters"]) == {0, 1}
    assert q["clusters"][0]["size"] == 20
    assert q["clusters"][0]["mean_intra_distance"] < 0.5


def test_manifest_carries_quality(tmp_path):
    from audio_pattern_discovery.config import PipelineConfig
    from audio_pattern_discovery.pipeline import discover
    from audio_pattern_discovery.synthetic import make_corpus

    corpus = tmp_path / "corpus"
    make_corpus(corpus, n_clips=6, n_motifs=2, occurrences_per_clip=2,
                clip_seconds=2.0, sample_rate=16_000, seed=3)
    cfg = PipelineConfig()
    cfg.spectrogram.sample_rate = 16_000
    cfg.spectrogram.win_length = 256
    cfg.spectrogram.hop_length = 128
    cfg.spectrogram.max_bins = 64
    cfg.segmentation.min_len_frames = 4
    cfg.autoencoder.enabled = False
    cfg.dtw.band = 16
    cfg.dtw.max_seq_len = 64
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    res = discover(corpus, cfg)
    m = res.manifest()
    assert -1.0 <= m["silhouette_mean"] <= 1.0
    for c in m["clusters"]:
        assert c["quality"]["size"] == len(c["members"])
        assert -1.0 <= c["quality"]["silhouette"] <= 1.0
