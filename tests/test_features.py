"""Mel / MFCC feature head (SpectrogramConfig.feature, SURVEY.md SS3 row 2
"additional modules" note): oracle parity, tile-vs-single-shot identity,
segmentation invariance, and e2e discovery on the new feature types."""

import numpy as np
import pytest

from audio_pattern_discovery.config import PipelineConfig, SpectrogramConfig
from audio_pattern_discovery.ops.spectrogram import (
    batched_spectrogram,
    dct_ortho,
    feature_pad_fill,
    mel_filterbank,
    spectrogram_corpus,
)
from audio_pattern_discovery.oracle.stft import (
    mel_filterbank_oracle,
    mel_oracle,
    mfcc_oracle,
    stft_oracle,
)

SR, NFFT = 16_000, 512


def test_filterbank_matches_oracle():
    fb = mel_filterbank(NFFT // 2 + 1, SR, NFFT, 40)
    ref = mel_filterbank_oracle(NFFT // 2 + 1, SR, NFFT, 40)
    assert fb.shape == (257, 40)
    np.testing.assert_allclose(fb, ref, atol=1e-6)
    # Triangles: nonneg, peak 1 somewhere near each center, full support.
    assert (fb >= 0).all() and (fb <= 1 + 1e-6).all()
    assert (fb.sum(axis=0) > 0).all()


def test_filterbank_capped_bins_and_range():
    # With max_bins capping the spectrum, the top edge clamps to the capped
    # Nyquist, and an explicit [fmin, fmax] restricts support to that range.
    fb = mel_filterbank(100, SR, NFFT, 20, fmin=300.0, fmax=2000.0)
    hz = np.arange(100) * SR / NFFT
    assert fb[hz <= 300.0].sum() == 0.0
    assert fb[hz >= 2000.0].sum() == 0.0


def test_filterbank_empty_filter_raises():
    with pytest.raises(ValueError, match="no FFT-bin support"):
        mel_filterbank(16, SR, NFFT, 64)


def test_dct_orthonormal():
    d = dct_ortho(40, 40)
    np.testing.assert_allclose(d.T @ d, np.eye(40), atol=1e-5)


@pytest.mark.parametrize("feature", ["mel", "mfcc"])
def test_device_matches_oracle(rng, feature):
    sig = rng.normal(0, 0.3, 6000).astype(np.float32)
    feats, counts = batched_spectrogram(
        sig[None],
        np.array([len(sig)], np.int32),
        win_length=NFFT,
        hop_length=128,
        sample_rate=SR,
        feature=feature,
        n_mels=40,
        n_mfcc=13,
    )
    lin = stft_oracle(sig, win_length=NFFT, hop_length=128, log_scale=False)
    if feature == "mel":
        ref = mel_oracle(lin, SR, NFFT, 40)
        assert feats.shape[-1] == 40
    else:
        ref = mfcc_oracle(lin, SR, NFFT, 40, 13)
        assert feats.shape[-1] == 13
    nf = int(counts[0])
    assert nf == ref.shape[0]
    np.testing.assert_allclose(np.asarray(feats[0, :nf]), ref, rtol=1e-3, atol=1e-3)


def test_mel_respects_max_bins(rng):
    """The filterbank is built over the CAPPED bins: parity against an
    oracle projection of the truncated spectrum."""
    sig = rng.normal(0, 0.3, 4000).astype(np.float32)
    feats, counts = batched_spectrogram(
        sig[None],
        np.array([len(sig)], np.int32),
        win_length=NFFT,
        hop_length=128,
        max_bins=100,
        sample_rate=SR,
        feature="mel",
        n_mels=24,
    )
    lin = stft_oracle(sig, win_length=NFFT, hop_length=128, log_scale=False)[:, :100]
    ref = mel_oracle(lin, SR, NFFT, 24)
    np.testing.assert_allclose(
        np.asarray(feats[0, : int(counts[0])]), ref, rtol=1e-3, atol=1e-3
    )


@pytest.mark.parametrize("feature", ["mel", "mfcc"])
def test_padding_fill(rng, feature):
    """Frames past a clip's true length hold exactly the documented fill."""
    sig = rng.normal(0, 0.3, 3000).astype(np.float32)
    padded = np.zeros((1, 8000), np.float32)
    padded[0, :3000] = sig
    feats, counts = batched_spectrogram(
        padded,
        np.array([3000], np.int32),
        win_length=NFFT,
        hop_length=128,
        sample_rate=SR,
        feature=feature,
        n_mels=40,
        n_mfcc=13,
    )
    nf = int(counts[0])
    fill = 0.0 if feature == "mfcc" else np.log10(np.float32(1e-10))
    assert np.allclose(np.asarray(feats[0, nf:]), fill)
    cfg = SpectrogramConfig(
        sample_rate=SR, win_length=NFFT, hop_length=128,
        feature=feature, n_mels=40, n_mfcc=13,
    )
    assert feature_pad_fill(cfg) == pytest.approx(float(fill))


@pytest.mark.parametrize("feature", ["mel", "mfcc"])
@pytest.mark.parametrize("return_device", [False, True])
def test_tile_vs_single_shot_identity(rng, feature, return_device):
    """The streaming tile path assembles to the single-shot values.

    Frame counts and energies (elementwise on the raw spectrum) are
    BIT-identical, like the bins path.  The projected features agree to
    float tolerance only: XLA tiles a matmul's reduction differently for
    different program shapes (measured: even a lone HIGHEST-precision
    einsum differs in the LSB between F=64 and F=16 inputs), so exact
    equality across tile shapes is not achievable for a contraction."""
    cfg = SpectrogramConfig(
        sample_rate=SR, win_length=NFFT, hop_length=128,
        feature=feature, n_mels=32, n_mfcc=12,
        clip_batch=2, chunk_frames=16,
    )
    clips = [rng.normal(0, 0.3, n).astype(np.float32) for n in (5000, 9000, 3100)]
    specs, fc, en = spectrogram_corpus(
        clips, cfg, clip_batch=2, chunk_frames=16, return_device=return_device
    )
    n_max = max(len(c) for c in clips)
    padded = np.zeros((len(clips), n_max), np.float32)
    for i, c in enumerate(clips):
        padded[i, : len(c)] = c
    lens = np.array([len(c) for c in clips], np.int32)
    ref, fc_ref, en_ref = batched_spectrogram(
        padded, lens,
        win_length=NFFT, hop_length=128, sample_rate=SR,
        feature=feature, n_mels=32, n_mfcc=12, return_energy=True,
    )
    np.testing.assert_array_equal(fc, np.asarray(fc_ref))
    F = np.asarray(specs).shape[1]
    np.testing.assert_allclose(
        np.asarray(specs), np.asarray(ref)[:, :F], rtol=1e-5, atol=1e-5
    )
    # Energies agree to the LSB across program shapes (the mean over bins
    # is itself a reduction, so XLA's shape-dependent tiling moves the
    # last bit); pad rows additionally hold the -10 prefill vs the
    # single-shot's 10^log10 round trip.  The invariant that matters —
    # the segment table is identical whatever the feature head — is
    # asserted exactly in test_segmentation_invariant_across_features.
    en_ref = np.asarray(en_ref)
    for i in range(len(clips)):
        nf = int(fc[i])
        np.testing.assert_allclose(en[i, :nf], en_ref[i, :nf], atol=2e-6)
    # Padding rows (past each clip's frame count) are exactly the fill.
    fill = 0.0 if feature == "mfcc" else np.log10(np.float32(1e-10))
    for i in range(len(clips)):
        assert np.allclose(np.asarray(specs)[i, int(fc[i]):], fill)


def test_segmentation_invariant_across_features(rng):
    """The energy gate sees the raw spectrum whatever the feature head, so
    the segment table is identical for bins / mel / mfcc."""
    from audio_pattern_discovery.config import SegmentationConfig
    from audio_pattern_discovery.ops.segmentation import segment_corpus

    # A clip with two loud bursts over quiet noise.
    n = 24_000
    sig = rng.normal(0, 0.01, n).astype(np.float32)
    for s in (4000, 14_000):
        t = np.arange(6000)
        sig[s : s + 6000] += (0.5 * np.sin(2 * np.pi * 900 * t / SR)).astype(
            np.float32
        )
    seg_cfg = SegmentationConfig(min_len_frames=4)
    tables = []
    for feature in ("bins", "mel", "mfcc"):
        cfg = SpectrogramConfig(
            sample_rate=SR, win_length=NFFT, hop_length=128,
            feature=feature, n_mels=40, n_mfcc=13,
        )
        _, fc, en = spectrogram_corpus([sig], cfg)
        segs = segment_corpus(en, fc, seg_cfg)
        tables.append([(s.clip, s.start_frame, s.end_frame) for s in segs])
    assert tables[0] == tables[1] == tables[2]
    assert len(tables[0]) >= 2


@pytest.mark.full
@pytest.mark.parametrize("feature", ["mel", "mfcc"])
def test_e2e_discovery_on_feature(tmp_path, feature):
    """Planted motifs are still discovered end-to-end with the mel/MFCC
    front end (AE consumes the lower-dim features directly)."""
    from audio_pattern_discovery.pipeline import discover
    from audio_pattern_discovery.synthetic import make_corpus
    from audio_pattern_discovery.config import (
        AutoencoderConfig, DTWConfig, SegmentationConfig,
    )

    corpus = tmp_path / "corpus"
    truth = make_corpus(str(corpus), n_clips=6, n_motifs=2, seed=11,
                        sample_rate=16_000, clip_seconds=4.0)
    cfg = PipelineConfig(
        spectrogram=SpectrogramConfig(
            sample_rate=16_000, win_length=256, hop_length=128,
            feature=feature, n_mels=32, n_mfcc=13,
        ),
        segmentation=SegmentationConfig(min_len_frames=4),
        autoencoder=AutoencoderConfig(latent_dim=8, hidden_dims=(32,), epochs=4),
        dtw=DTWConfig(band=16, use_pallas=False),
        seed=0,
    )
    res = discover(str(corpus), cfg)
    assert len(truth) > 0
    assert res.seg_features.shape[-1] == cfg.autoencoder.latent_dim
    # At least two clusters and no degenerate all-in-one partition.
    labels = set(int(l) for l in res.labels)
    assert len(labels) >= 2


def test_feature_config_validation():
    with pytest.raises(ValueError, match="spectrogram.feature"):
        PipelineConfig(
            spectrogram=SpectrogramConfig(feature="chroma")
        ).validate()
    with pytest.raises(ValueError, match="n_mfcc"):
        PipelineConfig(
            spectrogram=SpectrogramConfig(feature="mfcc", n_mels=20, n_mfcc=21)
        ).validate()
    with pytest.raises(ValueError, match="fmin"):
        PipelineConfig(
            spectrogram=SpectrogramConfig(feature="mel", fmin=9000.0, fmax=8000.0)
        ).validate()


@pytest.mark.gpu
def test_gpu_mfcc_head_compiled(rng):
    """The fused mel/MFCC head compiles and matches the float64 oracle on
    the card (the filterbank/DCT matmuls run in XLA's GPU precision there,
    unlike the CPU-suite runs)."""
    sig = rng.normal(0, 0.3, 6000).astype(np.float32)
    for feature in ("mel", "mfcc"):
        feats, counts = batched_spectrogram(
            sig[None],
            np.array([len(sig)], np.int32),
            win_length=NFFT,
            hop_length=128,
            sample_rate=SR,
            feature=feature,
            n_mels=40,
            n_mfcc=13,
        )
        lin = stft_oracle(sig, win_length=NFFT, hop_length=128, log_scale=False)
        ref = (
            mel_oracle(lin, SR, NFFT, 40)
            if feature == "mel"
            else mfcc_oracle(lin, SR, NFFT, 40, 13)
        )
        np.testing.assert_allclose(
            np.asarray(feats[0, : int(counts[0])]), ref, rtol=2e-3, atol=2e-3
        )
