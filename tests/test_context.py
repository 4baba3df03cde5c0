"""Temporal-context slices for the embedder (ops/context.py,
autoencoder.context_frames): host/device parity, boundary clamping, the
fingerprint contract, and the e2e/update/query composition."""

import shutil

import numpy as np
import pytest

from audio_pattern_discovery.config import PipelineConfig
from audio_pattern_discovery.ops.context import (
    flat_context,
    stack_context_device,
    stack_context_frames,
    stack_context_host,
)
from audio_pattern_discovery.pipeline import _feature_fingerprint, discover
from audio_pattern_discovery.synthetic import make_corpus


def test_stack_frames_edge_clamp():
    fr = np.array([[0.0, 1.0], [10.0, 11.0], [20.0, 21.0]], np.float32)
    out = stack_context_frames(fr, 1)
    # Row t = [frame[max(t-1,0)], frame[t], frame[min(t+1,n-1)]].
    expected = np.array(
        [
            [0, 1, 0, 1, 10, 11],
            [0, 1, 10, 11, 20, 21],
            [10, 11, 20, 21, 20, 21],
        ],
        np.float32,
    )
    np.testing.assert_array_equal(out, expected)


def test_k0_identity():
    fr = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    assert stack_context_frames(fr, 0) is fr
    seg = fr[None]
    assert stack_context_host(seg, np.array([5]), 0) is seg


@pytest.mark.parametrize("k", [1, 2])
def test_host_device_parity(k):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    K, L, d = 6, 17, 5
    seg = rng.normal(size=(K, L, d)).astype(np.float32)
    lengths = np.array([17, 1, 3, 9, 17, 12], np.int32)
    # Zero pads first, as the pipeline's segment tensors are.
    seg *= (np.arange(L)[None, :, None] < lengths[:, None, None])
    host = stack_context_host(seg, lengths, k)
    dev = np.asarray(stack_context_device(jnp.asarray(seg), lengths, k))
    assert host.shape == (K, L, (2 * k + 1) * d)
    np.testing.assert_array_equal(host, dev)
    # Pad frames are exactly zero in both.
    for s in range(K):
        assert not host[s, lengths[s] :].any()


def test_flat_matches_per_segment_stack():
    rng = np.random.default_rng(4)
    K, L, d = 4, 11, 3
    seg = rng.normal(size=(K, L, d)).astype(np.float32)
    lengths = np.array([11, 2, 7, 5], np.int32)
    flat = flat_context(seg, lengths, 1)
    manual = np.concatenate(
        [stack_context_frames(seg[s, : lengths[s]], 1) for s in range(K)]
    )
    np.testing.assert_array_equal(flat, manual)
    assert flat.shape == (int(lengths.sum()), 3 * d)


def test_fingerprint_drops_default_but_tracks_changes():
    base = _feature_fingerprint(PipelineConfig())
    explicit = PipelineConfig()
    explicit.autoencoder.context_frames = 0
    assert _feature_fingerprint(explicit) == base
    changed = PipelineConfig()
    changed.autoencoder.context_frames = 1
    assert _feature_fingerprint(changed) != base


# ---------------------------------------------------------------- pipeline


def _cfg(method: str = "ae") -> PipelineConfig:
    cfg = PipelineConfig()
    cfg.spectrogram.sample_rate = 16_000
    cfg.spectrogram.win_length = 256
    cfg.spectrogram.hop_length = 128
    cfg.spectrogram.max_bins = 64
    cfg.segmentation.threshold_db = -25.0
    cfg.segmentation.min_len_frames = 6
    cfg.segmentation.merge_gap_frames = 3
    cfg.autoencoder.enabled = True
    cfg.autoencoder.method = method
    cfg.autoencoder.epochs = 6
    cfg.autoencoder.hidden_dims = (64,)
    cfg.autoencoder.latent_dim = 8
    cfg.autoencoder.context_frames = 1
    cfg.autoencoder.checkpoint = True
    cfg.dtw.max_seq_len = 64
    cfg.dtw.pair_batch = 128
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    cfg.output.write_snippets = False
    return cfg


def _purity(result, truth) -> float:
    from test_pipeline_e2e import _cluster_purity

    return _cluster_purity(result, truth)


@pytest.mark.full
def test_e2e_with_context_recovers_motifs(tmp_path):
    corpus = tmp_path / "corpus"
    truth = make_corpus(
        corpus, n_clips=10, n_motifs=3, occurrences_per_clip=2,
        clip_seconds=2.0, sample_rate=16_000, seed=7,
    )
    cfg = _cfg("ae")
    out = tmp_path / "out"
    result = discover(corpus, cfg, out_dir=out)
    assert len(result.clusters) >= 2
    assert _purity(result, truth) >= 0.9
    # Restored checkpoint (stacked input dim) reproduces the partition.
    again = discover(corpus, cfg, out_dir=out)
    assert sorted(sorted(r.members) for r in again.clusters) == sorted(
        sorted(r.members) for r in result.clusters
    )
    np.testing.assert_array_equal(again.distance_matrix, result.distance_matrix)


@pytest.mark.full
def test_update_with_context_is_exact(tmp_path):
    src = tmp_path / "src"
    make_corpus(
        src, n_clips=12, n_motifs=3, occurrences_per_clip=2,
        clip_seconds=2.0, sample_rate=16_000, seed=7,
    )
    grow = tmp_path / "corpus"
    grow.mkdir()
    wavs = sorted(src.glob("*.wav"))
    for p in wavs[:9]:
        shutil.copy(p, grow / p.name)
    cfg = _cfg("pca")  # deterministic embedder: update must be bit-exact
    out = tmp_path / "out"
    r0 = discover(grow, cfg, out_dir=out)
    k0 = len(r0.segments)
    for p in wavs[9:]:
        shutil.copy(p, grow / p.name)
    r_up = discover(grow, cfg, out_dir=tmp_path / "out2", update_from=out)
    np.testing.assert_array_equal(
        r_up.distance_matrix[:k0, :k0], r0.distance_matrix
    )


@pytest.mark.full
def test_query_with_context(tmp_path):
    from audio_pattern_discovery.query import query_corpus

    src = tmp_path / "src"
    make_corpus(
        src, n_clips=10, n_motifs=3, occurrences_per_clip=2,
        clip_seconds=2.0, sample_rate=16_000, seed=7,
    )
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    wavs = sorted(src.glob("*.wav"))
    for p in wavs[:9]:
        shutil.copy(p, corpus / p.name)
    cfg = _cfg("ae")
    out = tmp_path / "out"
    discover(corpus, cfg, out_dir=out)
    report = query_corpus(out, [wavs[9]], cfg, top_k=3)
    assert report["queries"] and report["queries"][0]["matches"]
