"""Incremental corpus update (SS6.4 extension): discover(update_from=...)
reuses a prior run's distance matrix for pairs among prior segments and
computes only the pairs touching newly added clips.

The contract under test: an update over corpus A+B equals a full run over
A+B that uses the same frozen embedding — exactly (raw features) or with
the same restored AE checkpoint (latent features)."""

import json
import shutil

import numpy as np
import pytest

from audio_pattern_discovery.config import PipelineConfig
from audio_pattern_discovery.pipeline import discover
from audio_pattern_discovery.synthetic import make_corpus


def _cfg(ae: bool = False) -> PipelineConfig:
    cfg = PipelineConfig()
    cfg.spectrogram.sample_rate = 16_000
    cfg.spectrogram.win_length = 256
    cfg.spectrogram.hop_length = 128
    cfg.spectrogram.max_bins = 64
    cfg.segmentation.threshold_db = -25.0
    cfg.segmentation.min_len_frames = 6
    cfg.segmentation.merge_gap_frames = 3
    cfg.autoencoder.enabled = ae
    cfg.autoencoder.epochs = 6
    cfg.autoencoder.hidden_dims = (64,)
    cfg.autoencoder.latent_dim = 8
    cfg.autoencoder.checkpoint = ae
    cfg.dtw.max_seq_len = 64
    cfg.dtw.pair_batch = 128
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    return cfg


def _split_corpus(tmp_path, n_total=12, n_initial=8, seed=7):
    """Planted corpus split into an initial prefix + later additions.

    Held-out clips are the alphabetically-LAST files, so the update run's
    clip order (stored order + new sorted) equals a fresh sorted glob of
    the grown directory — making full-run results index-comparable."""
    src = tmp_path / "src"
    make_corpus(
        src, n_clips=n_total, n_motifs=3, occurrences_per_clip=2,
        clip_seconds=2.0, sample_rate=16_000, seed=seed,
    )
    grow = tmp_path / "corpus"
    grow.mkdir()
    wavs = sorted(src.glob("*.wav"))
    for p in wavs[:n_initial]:
        shutil.copy(p, grow / p.name)
    return grow, wavs[n_initial:]


def _partition(labels):
    groups = {}
    for i, lab in enumerate(labels):
        groups.setdefault(int(lab), []).append(i)
    return sorted(tuple(g) for g in groups.values())


def test_update_matches_full_run_raw_features(tmp_path):
    grow, later = _split_corpus(tmp_path)
    cfg = _cfg(ae=False)
    out = tmp_path / "out"
    r_initial = discover(grow, cfg, out_dir=out)
    assert (out / "state.json").exists()

    for p in later:
        shutil.copy(p, grow / p.name)
    r_up = discover(grow, cfg, out_dir=tmp_path / "out2", update_from=out)
    r_full = discover(grow, cfg)

    k_old = len(r_initial.segments)
    assert len(r_up.segments) == len(r_full.segments) > k_old
    np.testing.assert_allclose(
        r_up.distance_matrix, r_full.distance_matrix, rtol=0, atol=1e-6
    )
    assert _partition(r_up.labels) == _partition(r_full.labels)
    # Only the new-pair share was computed; the old triangle was reused.
    K = len(r_full.segments)
    reused = k_old * (k_old - 1) // 2
    assert r_up.counters.counts["dtw_pairs_reused"] == reused
    assert r_up.counters.counts["dtw_pairs"] == K * (K - 1) // 2 - reused
    # The updated out_dir is itself a valid base for the NEXT update.
    state2 = json.loads((tmp_path / "out2" / "state.json").read_text())
    assert len(state2["segments"]) == len(r_up.segments)


def test_update_matches_full_run_with_frozen_ae(tmp_path):
    grow, later = _split_corpus(tmp_path)
    cfg = _cfg(ae=True)
    out = tmp_path / "out"
    discover(grow, cfg, out_dir=out)

    for p in later:
        shutil.copy(p, grow / p.name)
    r_up = discover(grow, cfg, out_dir=tmp_path / "out_up", update_from=out)

    # Reference: a full run over the grown corpus restoring the SAME frozen
    # checkpoint (copied in ahead of time) — identical embeddings, so the
    # update must reproduce its distances and partition.
    out_full = tmp_path / "out_full"
    out_full.mkdir()
    shutil.copytree(out / "ae_ckpt", out_full / "ae_ckpt")
    r_full = discover(grow, cfg, out_dir=out_full)

    np.testing.assert_allclose(
        r_up.distance_matrix, r_full.distance_matrix, rtol=0, atol=1e-6
    )
    assert _partition(r_up.labels) == _partition(r_full.labels)
    # Chained updates keep working: the update run re-saved the checkpoint.
    from audio_pattern_discovery.utils.checkpoint import has_ae_checkpoint

    assert has_ae_checkpoint(tmp_path / "out_up" / "ae_ckpt")


def test_update_rejects_feature_config_drift(tmp_path):
    grow, later = _split_corpus(tmp_path, n_total=8, n_initial=6)
    cfg = _cfg(ae=False)
    out = tmp_path / "out"
    discover(grow, cfg, out_dir=out)
    for p in later:
        shutil.copy(p, grow / p.name)
    drifted = _cfg(ae=False)
    drifted.dtw.band = 8
    with pytest.raises(ValueError, match="feature-affecting"):
        discover(grow, drifted, update_from=out)
    # Downstream-only knobs (clustering cut) may change freely.
    recut = _cfg(ae=False)
    recut.cluster.linkage = "complete"
    discover(grow, recut, update_from=out)


def test_update_rejects_band_mode_mismatch(tmp_path):
    """ADVICE r4: a banded index reused under a different band_mode must
    fail with a TARGETED error naming the stored mode (not the generic
    fingerprint/spot-check drift failure), and state.json must record the
    mode it was built under (None when band is None)."""
    grow, later = _split_corpus(tmp_path, n_total=8, n_initial=6)
    cfg = _cfg(ae=False)
    cfg.dtw.band = 8
    cfg.dtw.band_mode = "diag"
    out = tmp_path / "out"
    discover(grow, cfg, out_dir=out)
    assert json.loads((out / "state.json").read_text())["band_mode"] == "diag"
    for p in later:
        shutil.copy(p, grow / p.name)
    flipped = _cfg(ae=False)
    flipped.dtw.band = 8
    flipped.dtw.band_mode = "widen"
    with pytest.raises(ValueError, match="band_mode='diag'"):
        discover(grow, flipped, update_from=out)
    # Same mode still reuses the index.
    discover(grow, cfg, out_dir=tmp_path / "out2", update_from=out)

    # Unbanded indexes record None and are mode-agnostic.
    unb = _cfg(ae=False)
    out3 = tmp_path / "out3"
    discover(grow, unb, out_dir=out3)
    assert json.loads((out3 / "state.json").read_text())["band_mode"] is None


def test_update_rejects_removed_clip(tmp_path):
    grow, _ = _split_corpus(tmp_path, n_total=8, n_initial=8)
    cfg = _cfg(ae=False)
    out = tmp_path / "out"
    discover(grow, cfg, out_dir=out)
    next(iter(sorted(grow.glob("*.wav")))).unlink()
    with pytest.raises(ValueError, match="no longer under"):
        discover(grow, cfg, update_from=out)


def test_update_requires_prior_state(tmp_path):
    grow, _ = _split_corpus(tmp_path, n_total=6, n_initial=6)
    with pytest.raises(FileNotFoundError, match="state.json"):
        discover(grow, _cfg(), update_from=tmp_path / "nope")


def test_update_with_ae_requires_prior_checkpoint(tmp_path):
    grow, later = _split_corpus(tmp_path, n_total=8, n_initial=6)
    cfg = _cfg(ae=True)
    cfg.autoencoder.checkpoint = False  # prior run saves no ckpt
    out = tmp_path / "out"
    discover(grow, cfg, out_dir=out)
    for p in later:
        shutil.copy(p, grow / p.name)
    with pytest.raises(ValueError, match="no checkpoint"):
        discover(grow, cfg, update_from=out)


@pytest.mark.full
def test_cli_update_flag(tmp_path):
    from audio_pattern_discovery.cli import main

    grow, later = _split_corpus(tmp_path, n_total=8, n_initial=6)
    out = tmp_path / "out"
    common = [
        str(grow), "-o", str(out),
        "-s", "spectrogram.sample_rate=16000",
        "-s", "spectrogram.win_length=256",
        "-s", "spectrogram.hop_length=128",
        "-s", "segmentation.threshold_db=-25.0",
        "-s", "autoencoder.enabled=false",
        "-s", "dtw.max_seq_len=64",
        "-s", "output.write_images=false",
        "-s", "output.write_html_report=false",
    ]
    assert main(common) == 0
    for p in later:
        shutil.copy(p, grow / p.name)
    assert main(common + ["--update"]) == 0
    D = np.load(out / "distance_matrix.npy")
    state = json.loads((out / "state.json").read_text())
    assert D.shape == (len(state["segments"]),) * 2
