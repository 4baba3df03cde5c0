"""AE checkpoint/resume as one .npz file (SURVEY.md SS6.4)."""

import jax
import numpy as np
import pytest

from audio_pattern_discovery.config import AutoencoderConfig, PipelineConfig
from audio_pattern_discovery.models.autoencoder import (
    FeatureScaler,
    encode_frames,
    train_autoencoder,
)
from audio_pattern_discovery.pipeline import discover
from audio_pattern_discovery.synthetic import make_corpus
from audio_pattern_discovery.utils.checkpoint import (
    has_ae_checkpoint,
    restore_ae_checkpoint,
    save_ae_checkpoint,
)


def _cfg():
    return AutoencoderConfig(
        latent_dim=4, hidden_dims=(16,), epochs=3, batch_size=64
    )


def test_roundtrip_restores_exact_state(tmp_path, rng):
    frames = rng.normal(0, 1, (200, 12)).astype(np.float32)
    cfg = _cfg()
    scaler = FeatureScaler.fit(frames)
    model, state, _ = train_autoencoder(scaler.transform(frames), cfg)

    assert not has_ae_checkpoint(tmp_path)
    save_ae_checkpoint(tmp_path, state, scaler)
    assert has_ae_checkpoint(tmp_path)

    model2, state2, scaler2 = restore_ae_checkpoint(tmp_path, cfg, 12)
    assert state2.step == state.step
    for a, b in zip(
        jax.tree_util.tree_leaves(state.params),
        jax.tree_util.tree_leaves(state2.params),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(scaler2.mean, scaler.mean)
    np.testing.assert_array_equal(scaler2.std, scaler.std)

    # Encodings from restored state are bit-identical.
    x = scaler.transform(frames[:32]).astype(np.float32)
    z1 = encode_frames(model, state.params, x)
    z2 = encode_frames(model2, state2.params, x)
    np.testing.assert_array_equal(z1, z2)


def test_roundtrip_without_scaler(tmp_path, rng):
    frames = rng.normal(0, 1, (100, 8)).astype(np.float32)
    cfg = _cfg()
    _, state, _ = train_autoencoder(frames, cfg)
    save_ae_checkpoint(tmp_path, state)
    _, state2, scaler2 = restore_ae_checkpoint(tmp_path, cfg, 8)
    assert scaler2 is None
    assert state2.step == state.step


@pytest.mark.full
def test_pipeline_resume_skips_training(tmp_path):
    corpus = tmp_path / "corpus"
    out = tmp_path / "out"
    make_corpus(corpus, n_clips=6, n_motifs=2, clip_seconds=1.5, seed=3)

    cfg = PipelineConfig()
    cfg.spectrogram.sample_rate = 16_000
    cfg.spectrogram.win_length = 256
    cfg.spectrogram.hop_length = 128
    cfg.spectrogram.max_bins = 32
    cfg.segmentation.threshold_db = -25.0
    cfg.segmentation.min_len_frames = 6
    cfg.autoencoder.epochs = 2
    cfg.autoencoder.hidden_dims = (16,)
    cfg.autoencoder.latent_dim = 4
    cfg.autoencoder.checkpoint = True
    cfg.dtw.max_seq_len = 64
    cfg.dtw.pair_batch = 64

    r1 = discover(corpus, cfg, out_dir=out)
    assert has_ae_checkpoint(out / cfg.autoencoder.checkpoint_dir)
    assert r1.ae_losses  # trained

    r2 = discover(corpus, cfg, out_dir=out)
    assert not r2.ae_losses  # restored, not retrained
    np.testing.assert_array_equal(r1.labels, r2.labels)
    np.testing.assert_allclose(
        r1.distance_matrix, r2.distance_matrix, rtol=1e-5, atol=1e-6
    )


def test_optimizer_state_roundtrip_and_config_guard(tmp_path, rng):
    """The optax state comes back with its structure, and a checkpoint
    saved under another AE shape is refused with the rebuild hint."""
    frames = rng.normal(0, 1, (100, 8)).astype(np.float32)
    cfg = _cfg()
    _, state, _ = train_autoencoder(frames, cfg)
    save_ae_checkpoint(tmp_path, state)
    _, state2, _ = restore_ae_checkpoint(tmp_path, cfg, 8)
    assert jax.tree_util.tree_structure(state2.opt_state) == (
        jax.tree_util.tree_structure(state.opt_state)
    )
    for a, b in zip(jax.tree_util.tree_leaves(state.opt_state),
                    jax.tree_util.tree_leaves(state2.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="full discovery"):
        restore_ae_checkpoint(tmp_path, cfg, 9)          # other input width
    wider = AutoencoderConfig(latent_dim=4, hidden_dims=(16, 8), epochs=1)
    with pytest.raises(ValueError, match="full discovery"):
        restore_ae_checkpoint(tmp_path, wider, 8)        # other layer count


def test_legacy_checkpoint_directory_is_not_a_checkpoint(tmp_path):
    """An index from before the .npz format holds an `ae_state/` directory;
    it does not count, so update/query hit the run-a-full-discovery guard."""
    (tmp_path / "ae_state").mkdir()
    (tmp_path / "ae_state" / "_METADATA").write_text("{}")
    assert not has_ae_checkpoint(tmp_path)
