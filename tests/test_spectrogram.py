import numpy as np
import pytest

from audio_pattern_discovery.io.corpus import pad_and_stack
from audio_pattern_discovery.ops.spectrogram import (
    batched_spectrogram,
    frame_energy,
    num_frames,
)
from audio_pattern_discovery.oracle.stft import stft_oracle


@pytest.mark.parametrize("window", ["hann", "hamming", "rect"])
def test_matches_oracle(rng, window):
    sig = rng.normal(0, 0.3, 4000).astype(np.float32)
    spec, counts = batched_spectrogram(
        sig[None],
        np.array([len(sig)], np.int32),
        win_length=512,
        hop_length=128,
        window=window,
    )
    ref = stft_oracle(sig, win_length=512, hop_length=128, window=window)
    assert int(counts[0]) == ref.shape[0]
    np.testing.assert_allclose(np.asarray(spec[0]), ref, rtol=1e-4, atol=1e-4)


def test_padding_invariance(rng):
    """Padded clips give identical spectra in their valid frames."""
    sig = rng.normal(0, 0.3, 3000).astype(np.float32)
    padded, lengths = pad_and_stack([sig], pad_to=8000)
    spec_p, counts_p = batched_spectrogram(
        padded, lengths, win_length=512, hop_length=128
    )
    spec_u, counts_u = batched_spectrogram(
        sig[None], np.array([3000], np.int32), win_length=512, hop_length=128
    )
    nf = int(counts_u[0])
    assert int(counts_p[0]) == nf
    np.testing.assert_allclose(
        np.asarray(spec_p[0, :nf]), np.asarray(spec_u[0, :nf]), rtol=1e-5, atol=1e-5
    )
    # Frames past the true length are exactly the log floor.
    assert np.allclose(np.asarray(spec_p[0, nf:]), np.log10(1e-10))


def test_batch_of_ragged_clips(rng):
    clips = [rng.normal(0, 0.3, n).astype(np.float32) for n in (2000, 3500, 5000)]
    padded, lengths = pad_and_stack(clips)
    spec, counts = batched_spectrogram(padded, lengths, win_length=512, hop_length=256)
    for i, c in enumerate(clips):
        ref = stft_oracle(c, win_length=512, hop_length=256)
        nf = int(counts[i])
        assert nf == ref.shape[0] == num_frames(len(c), 512, 256)
        np.testing.assert_allclose(np.asarray(spec[i, :nf]), ref, rtol=1e-4, atol=1e-4)


def test_tone_peak_bin():
    """A pure tone's energy lands in the right FFT bin."""
    sr, f = 16_000, 1000.0
    t = np.arange(sr) / sr
    sig = np.sin(2 * np.pi * f * t).astype(np.float32)
    spec, counts = batched_spectrogram(
        sig[None], np.array([sr], np.int32), win_length=1024, hop_length=512
    )
    mid = np.asarray(spec[0, int(counts[0]) // 2])
    expected_bin = round(f * 1024 / sr)
    assert abs(int(np.argmax(mid)) - expected_bin) <= 1


def test_frame_energy_shape(rng):
    sig = rng.normal(0, 0.3, 4000).astype(np.float32)
    spec, _ = batched_spectrogram(
        sig[None], np.array([4000], np.int32), win_length=512, hop_length=128
    )
    e = frame_energy(spec)
    assert e.shape == spec.shape[:2]


def test_corpus_tiling_matches_single_shot(rng):
    """Streaming [clip_batch, chunk] tiles == one padded batched call."""
    import jax.numpy as jnp

    from audio_pattern_discovery.config import SpectrogramConfig
    from audio_pattern_discovery.io.corpus import pad_and_stack
    from audio_pattern_discovery.ops.spectrogram import (
        batched_spectrogram,
        spectrogram_corpus,
    )

    cfg = SpectrogramConfig(win_length=64, hop_length=16)
    sigs = [
        rng.normal(0, 0.3, int(n)).astype(np.float32)
        for n in rng.integers(200, 2000, 7)
    ]
    specs, fcs, energies = spectrogram_corpus(
        sigs, cfg, clip_batch=3, chunk_frames=10
    )
    padded, lengths = pad_and_stack(sigs)
    want, want_fc = batched_spectrogram(
        jnp.asarray(padded),
        jnp.asarray(lengths),
        win_length=cfg.win_length,
        hop_length=cfg.hop_length,
    )
    want = np.asarray(want)
    np.testing.assert_array_equal(fcs, np.asarray(want_fc))
    for i, fc in enumerate(fcs):
        np.testing.assert_allclose(
            # 1e-4: the matmul-DFT contraction tiles differently at
            # different frame counts, shifting reductions by ~1e-5.
            specs[i, :fc], want[i, :fc], rtol=1e-4, atol=1e-4
        )
    assert specs.shape[1] == int(fcs.max())
    assert energies.shape == specs.shape[:2]


def test_corpus_tiling_short_clip_zero_frames(rng):
    from audio_pattern_discovery.config import SpectrogramConfig
    from audio_pattern_discovery.ops.spectrogram import spectrogram_corpus

    cfg = SpectrogramConfig(win_length=64, hop_length=16)
    sigs = [
        rng.normal(0, 0.3, 500).astype(np.float32),
        rng.normal(0, 0.3, 10).astype(np.float32),  # shorter than win
    ]
    specs, fcs, _ = spectrogram_corpus(sigs, cfg, clip_batch=4, chunk_frames=8)
    assert fcs[1] == 0 and fcs[0] > 0


def test_matmul_dft_matches_rfft(rng):
    """The matmul DFT path == the library rfft within float tolerance."""
    import jax.numpy as jnp

    from audio_pattern_discovery.ops.spectrogram import batched_spectrogram

    sig = rng.normal(0, 0.3, (3, 4000)).astype(np.float32)
    lens = np.array([4000, 3000, 700], np.int32)
    kw = dict(win_length=256, hop_length=64, log_scale=False)
    a, fa = batched_spectrogram(jnp.asarray(sig), jnp.asarray(lens), fft_impl="rfft", **kw)
    b, fb = batched_spectrogram(jnp.asarray(sig), jnp.asarray(lens), fft_impl="matmul", **kw)
    np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_matmul_dft_zero_pad_and_truncate(rng):
    import jax.numpy as jnp

    from audio_pattern_discovery.ops.spectrogram import batched_spectrogram

    sig = rng.normal(0, 0.3, (2, 2000)).astype(np.float32)
    lens = np.array([2000, 1500], np.int32)
    for n_fft in (512, 128):  # zero-pad and truncate vs win=256
        kw = dict(win_length=256, hop_length=128, n_fft=n_fft, log_scale=False)
        a, _ = batched_spectrogram(jnp.asarray(sig), jnp.asarray(lens), fft_impl="rfft", **kw)
        b, _ = batched_spectrogram(jnp.asarray(sig), jnp.asarray(lens), fft_impl="matmul", **kw)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_device_assembly_matches_host(rng):
    """return_device=True corpus == host-assembled corpus (the oracle)."""
    import jax.numpy as jnp  # noqa: F401

    from audio_pattern_discovery.config import SpectrogramConfig
    from audio_pattern_discovery.ops.spectrogram import spectrogram_corpus

    cfg = SpectrogramConfig(win_length=64, hop_length=16)
    sigs = [
        rng.normal(0, 0.3, int(n)).astype(np.float32)
        for n in rng.integers(100, 1500, 9)
    ]
    host, fc_h, en_h = spectrogram_corpus(sigs, cfg, clip_batch=4, chunk_frames=8)
    dev, fc_d, en_d = spectrogram_corpus(
        sigs, cfg, clip_batch=4, chunk_frames=8, return_device=True
    )
    np.testing.assert_array_equal(fc_h, fc_d)
    np.testing.assert_allclose(en_h, en_d, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(host, np.asarray(dev), rtol=1e-5, atol=1e-5)


def test_device_segment_extraction_matches_host(rng):
    """extract_segment_features_device == the host slicer (the oracle)."""
    import jax.numpy as jnp

    from audio_pattern_discovery.ops.segmentation import Segment
    from audio_pattern_discovery.pipeline import (
        extract_segment_features,
        extract_segment_features_device,
    )

    B, F, bins, L = 4, 50, 16, 12
    specs = rng.normal(0, 1, (B, F, bins)).astype(np.float32)
    segments = [
        Segment(clip=0, start_frame=3, end_frame=9),
        Segment(clip=1, start_frame=0, end_frame=30),   # longer than L: clamp
        Segment(clip=2, start_frame=45, end_frame=50),  # touches the end
        Segment(clip=3, start_frame=10, end_frame=12),
    ]
    want, want_len = extract_segment_features(specs, segments, L)
    got, got_len = extract_segment_features_device(jnp.asarray(specs), segments, L)
    np.testing.assert_array_equal(want_len, got_len)
    np.testing.assert_allclose(want, np.asarray(got), rtol=1e-6, atol=1e-6)


def test_int16_upload_is_bit_exact(rng):
    """int16 device upload + on-device decode/normalize == f32 host path."""
    from audio_pattern_discovery.config import SpectrogramConfig
    from audio_pattern_discovery.ops.spectrogram import spectrogram_corpus

    cfg = SpectrogramConfig(win_length=64, hop_length=16)
    raw = [
        (rng.integers(-30000, 30000, int(n)).astype(np.int16))
        for n in rng.integers(300, 1200, 5)
    ]
    f32 = [r.astype(np.float32) / 32768.0 for r in raw]
    peaks = np.array([max(np.abs(s).max(), 1e-9) for s in f32], np.float32)
    normed = [s / p for s, p in zip(f32, peaks)]
    want, fc_w, en_w = spectrogram_corpus(normed, cfg, clip_batch=3, chunk_frames=8)
    got, fc_g, en_g = spectrogram_corpus(
        raw, cfg, clip_batch=3, chunk_frames=8, scales=peaks
    )
    np.testing.assert_array_equal(fc_w, fc_g)
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(en_w, en_g)


@pytest.mark.gpu
def test_gpu_compiled_dft_precision_vs_oracle():
    """Compiled DFT matmul at each precision tier vs the float64 oracle on
    the card, scaled by this file's tolerance (rtol = atol = 1e-4): the
    default "highest" stays inside it; "high" and "default" run reduced-
    precision passes and miss it by orders of magnitude (PERF.md), which
    is why they are not the default."""
    sig = np.random.default_rng(7).normal(0, 0.3, 44_100).astype(np.float32)
    ref = stft_oracle(sig, win_length=1024, hop_length=256)
    for prec, bound in (("highest", 1.0), ("high", 1e3), ("default", 1e3)):
        spec, counts = batched_spectrogram(
            sig[None],
            np.array([len(sig)], np.int32),
            win_length=1024,
            hop_length=256,
            fft_precision=prec,
        )
        nf = int(counts[0])
        assert nf == ref.shape[0]
        got = np.asarray(spec[0, :nf])
        err = np.max(np.abs(got - ref) / (1e-4 + 1e-4 * np.abs(ref)))
        assert err < bound, f"{prec}: {err:.3f} x the tolerance >= {bound}"


@pytest.mark.full
def test_corpus_multi_device_round_robin_bit_identical(rng):
    """Clip-group round-robin over the virtual 8-device mesh == the
    single-device path, bit for bit (same tile program per device), for
    both the host and the device-resident collection paths, float32 and
    int16(+scales) uploads.  This is the spectrogram stage's DP story for
    BASELINE config 5 (sharded across the devices of one host)."""
    import jax

    from audio_pattern_discovery.config import SpectrogramConfig
    from audio_pattern_discovery.ops.spectrogram import spectrogram_corpus

    devices = jax.devices()
    assert len(devices) >= 2, "suite runs with 8 virtual devices"
    cfg = SpectrogramConfig(win_length=64, hop_length=16)
    sigs = [
        rng.normal(0, 0.3, int(n)).astype(np.float32)
        for n in rng.integers(200, 1500, 11)
    ]
    # clip_batch=2 -> 6 groups round-robining over 8 devices.
    kw = dict(clip_batch=2, chunk_frames=10)
    for return_device in (False, True):
        one = spectrogram_corpus(sigs, cfg, return_device=return_device, **kw)
        rr = spectrogram_corpus(
            sigs, cfg, return_device=return_device, devices=devices, **kw
        )
        for a, b, name in zip(one, rr, ("specs", "frame_counts", "energies")):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=name
            )
        if return_device:
            assert rr[0].devices() == {devices[0]}, (
                "resident corpus must collect onto the primary device"
            )

    # int16 upload with device-side decode + per-clip normalization.
    isigs = [
        (np.clip(s, -1, 1) * 32767).astype(np.int16) for s in sigs
    ]
    scales = np.array(
        [max(abs(s).max() / 32768.0, 1e-9) for s in isigs], np.float32
    )
    one = spectrogram_corpus(isigs, cfg, scales=scales, **kw)
    rr = spectrogram_corpus(isigs, cfg, scales=scales, devices=devices, **kw)
    for a, b in zip(one, rr):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_threaded_collection_identical(rng, monkeypatch):
    """Tile collection on the worker thread (round 4) must be a pure
    implementation detail: bitwise-identical specs/energies/frame counts
    to the APD_SYNC_SPECTRO=1 inline path, host and device-resident."""
    from audio_pattern_discovery.config import SpectrogramConfig
    from audio_pattern_discovery.ops.spectrogram import spectrogram_corpus

    cfg = SpectrogramConfig(win_length=64, hop_length=16)
    sigs = [
        rng.normal(0, 0.3, int(n)).astype(np.float32)
        for n in rng.integers(200, 2000, 7)
    ]
    kw = dict(clip_batch=3, chunk_frames=10)
    s_thr, fc_thr, en_thr = spectrogram_corpus(sigs, cfg, **kw)
    d_thr, dfc_thr, den_thr = spectrogram_corpus(
        sigs, cfg, return_device=True, **kw
    )
    monkeypatch.setenv("APD_SYNC_SPECTRO", "1")
    s_syn, fc_syn, en_syn = spectrogram_corpus(sigs, cfg, **kw)
    d_syn, dfc_syn, den_syn = spectrogram_corpus(
        sigs, cfg, return_device=True, **kw
    )
    np.testing.assert_array_equal(s_thr, s_syn)
    np.testing.assert_array_equal(fc_thr, fc_syn)
    np.testing.assert_array_equal(en_thr, en_syn)
    np.testing.assert_array_equal(np.asarray(d_thr), np.asarray(d_syn))
    np.testing.assert_array_equal(dfc_thr, dfc_syn)
    np.testing.assert_array_equal(den_thr, den_syn)


def test_threaded_collection_no_leak_on_error(rng):
    """An error escaping the tile loop must join the collector thread on
    the way out (the scatter-worker leak lesson, ADVICE r3)."""
    import threading
    import unittest.mock as mock

    from audio_pattern_discovery.config import SpectrogramConfig
    from audio_pattern_discovery.ops import spectrogram as sp

    cfg = SpectrogramConfig(win_length=64, hop_length=16)
    sigs = [rng.normal(0, 0.3, 500).astype(np.float32) for _ in range(4)]

    def boom(*a, **k):
        raise RuntimeError("tile boom")

    before = {t.name for t in threading.enumerate()}
    with mock.patch.object(sp, "_spectrogram_energy_tile", side_effect=boom):
        for _ in range(3):
            with pytest.raises(RuntimeError, match="tile boom"):
                sp.spectrogram_corpus(sigs, cfg, clip_batch=2, chunk_frames=8)
    leaked = [
        t.name
        for t in threading.enumerate()
        if t.name.startswith("apd-spectro-collect") and t.name not in before
    ]
    assert not leaked, f"leaked collector threads: {leaked}"
