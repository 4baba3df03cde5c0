"""Polyphase resampler (io/resample.py) and mixed-rate corpus handling
(spectrogram.resample="auto")."""

import numpy as np
import pytest

from audio_pattern_discovery.io.corpus import StreamingCorpus
from audio_pattern_discovery.io.resample import (
    polyphase_filter,
    resample,
    resampled_length,
)
from audio_pattern_discovery.io.wavio import read_wav, write_wav


@pytest.mark.parametrize("rf,rt", [(44_100, 16_000), (48_000, 16_000),
                                   (22_050, 44_100), (8_000, 11_025)])
def test_matches_scipy_resample_poly(rng, rf, rt):
    """Same filter design as scipy's default -> float32-LSB agreement with
    the reference implementation."""
    from math import gcd

    from scipy.signal import resample_poly

    x = rng.normal(0, 0.3, 30_000).astype(np.float32)
    y = resample(x, rf, rt)
    g = gcd(rf, rt)
    ref = resample_poly(x.astype(np.float64), rt // g, rf // g)
    assert len(y) == len(ref) == resampled_length(len(x), rf, rt)
    assert np.abs(y - ref).max() < 1e-6


def test_tone_survives_round_trip():
    """A 1 kHz tone keeps its frequency and amplitude through 44.1k -> 16k."""
    sr = 44_100
    t = np.arange(sr) / sr
    x = (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    y = resample(x, sr, 16_000)
    spec = np.abs(np.fft.rfft(y[1000:9000] * np.hanning(8000)))
    peak_hz = np.argmax(spec) * 16_000 / 8000
    assert abs(peak_hz - 1000.0) < 5.0
    assert abs(np.abs(y[2000:-2000]).max() - 0.5) < 0.01


def test_passthrough_and_validation(rng):
    x = rng.normal(0, 0.3, 1000).astype(np.float32)
    assert resample(x, 16_000, 16_000) is x
    with pytest.raises(ValueError, match="positive"):
        resample(x, 0, 16_000)
    with pytest.raises(ValueError):
        polyphase_filter(0, 3)


def test_short_input_still_yields_contract_length(rng):
    x = rng.normal(0, 0.3, 7).astype(np.float32)
    y = resample(x, 48_000, 16_000)
    assert len(y) == resampled_length(7, 48_000, 16_000)


def _mixed_rate_corpus(tmp_path, rng, n=4):
    """n clips at 16 kHz; the last two ALSO exist upsampled to 32 kHz."""
    d = tmp_path / "corpus"
    d.mkdir()
    sigs = []
    for i in range(n):
        # Bandlimited content only (tones well below Nyquist): full-band
        # noise would lose its transition-band energy to the anti-alias
        # filter and the round-trip comparison below would measure the
        # filter, not the corpus plumbing.
        t_all = np.arange(16_000) / 16_000
        x = sum(
            0.03 * np.sin(2 * np.pi * f * t_all + 0.7 * k)
            for k, f in enumerate((220.0, 470.0, 950.0, 1900.0))
        ).astype(np.float32)
        t = np.arange(6000) / 16_000
        x[4000:10_000] += (0.4 * np.sin(2 * np.pi * (500 + 200 * i) * t)).astype(
            np.float32
        )
        rate = 32_000 if i >= n - 2 else 16_000
        w = resample(x, 16_000, rate) if rate != 16_000 else x
        write_wav(d / f"clip_{i}.wav", w, rate)
        sigs.append(x)
    return d, sigs


def test_streaming_corpus_unifies_rates(tmp_path, rng):
    d, sigs = _mixed_rate_corpus(tmp_path, rng)
    stream = StreamingCorpus(d, resample_to=16_000)
    assert (stream.sample_rates == 16_000).all()
    assert sorted(np.unique(stream.original_rates).tolist()) == [16_000, 32_000]
    assert not stream.all_pcm16
    clips = stream.materialize()
    for i, c in enumerate(clips):
        assert c.sample_rate == 16_000
        # Header-probe planning length matches the actual loaded length.
        assert len(c.samples) == int(stream.sample_lengths[i])
        # The round trip 16k -> 32k -> 16k reconstructs the original signal
        # (write_wav quantizes to int16, so tolerance is ~2 LSB + filter).
        n = min(len(c.samples), len(sigs[i]))
        err = np.abs(c.samples[500 : n - 500] - sigs[i][500 : n - 500]).max()
        assert err < 2e-3, (i, err)


def test_e2e_mixed_rate_corpus_matches_native_rate_run(tmp_path, rng):
    """Discovery over a corpus with off-rate clips (resample=auto) finds the
    same partition as the same corpus natively at the analysis rate."""
    from audio_pattern_discovery.config import PipelineConfig
    from audio_pattern_discovery.pipeline import discover
    from audio_pattern_discovery.synthetic import make_corpus

    native_dir = tmp_path / "native"
    make_corpus(native_dir, n_clips=6, n_motifs=2, occurrences_per_clip=2,
                clip_seconds=2.0, sample_rate=16_000, seed=9)
    mixed_dir = tmp_path / "mixed"
    mixed_dir.mkdir()
    for j, p in enumerate(sorted(native_dir.glob("*.wav"))):
        x, r = read_wav(p)
        if j % 2:
            write_wav(mixed_dir / p.name, resample(x, r, 32_000), 32_000)
        else:
            write_wav(mixed_dir / p.name, x, r)

    def _cfg():
        cfg = PipelineConfig()
        cfg.spectrogram.sample_rate = 16_000
        cfg.spectrogram.win_length = 256
        cfg.spectrogram.hop_length = 128
        cfg.spectrogram.max_bins = 64
        cfg.spectrogram.resample = "auto"
        cfg.segmentation.min_len_frames = 4
        cfg.autoencoder.enabled = False
        cfg.dtw.band = 16
        cfg.dtw.max_seq_len = 64
        cfg.output.write_images = False
        cfg.output.write_html_report = False
        return cfg

    def _partition(labels):
        groups = {}
        for i, lab in enumerate(labels):
            groups.setdefault(int(lab), []).append(i)
        return sorted(tuple(g) for g in groups.values())

    r_native = discover(native_dir, _cfg())
    r_mixed = discover(mixed_dir, _cfg())
    assert len(r_native.segments) == len(r_mixed.segments)
    assert _partition(r_native.labels) == _partition(r_mixed.labels)


def test_config_validation():
    from audio_pattern_discovery.config import (
        PipelineConfig,
        SpectrogramConfig,
    )

    with pytest.raises(ValueError, match="spectrogram.resample"):
        PipelineConfig(
            spectrogram=SpectrogramConfig(resample="always")
        ).validate()
