import numpy as np
import pytest

from audio_pattern_discovery.io.wavio import read_wav, write_wav


def test_write_read_roundtrip(tmp_path, rng):
    x = rng.uniform(-0.9, 0.9, 16_000).astype(np.float32)
    path = tmp_path / "a.wav"
    write_wav(path, x, 16_000)
    y, sr = read_wav(path)
    assert sr == 16_000
    assert y.shape == x.shape
    assert y.dtype == np.float32
    np.testing.assert_allclose(y, x, atol=0.51 / 32768)


def test_read_stdlib_written_stereo(tmp_path, rng):
    # Cross-check against the stdlib `wave` writer, stereo 16-bit.
    import wave

    left = (rng.uniform(-0.5, 0.5, 1000) * 32767).astype("<i2")
    right = (rng.uniform(-0.5, 0.5, 1000) * 32767).astype("<i2")
    inter = np.empty(2000, dtype="<i2")
    inter[0::2], inter[1::2] = left, right
    path = tmp_path / "st.wav"
    with wave.open(str(path), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(8000)
        f.writeframes(inter.tobytes())
    y, sr = read_wav(path)
    assert sr == 8000
    expected = (left.astype(np.float32) + right.astype(np.float32)) / 2.0 / 32768.0
    np.testing.assert_allclose(y, expected, atol=1e-6)


@pytest.mark.parametrize("bits", [8, 24, 32])
def test_read_other_depths(tmp_path, rng, bits):
    import struct

    n = 500
    x = rng.uniform(-0.8, 0.8, n)
    if bits == 8:
        data = (np.clip(x, -1, 1) * 127 + 128).astype(np.uint8).tobytes()
        expected = (np.frombuffer(data, np.uint8).astype(np.float32) - 128) / 128
    elif bits == 24:
        vals = (np.clip(x, -1, 1) * (1 << 23 - 1)).astype(np.int32)
        b = np.zeros((n, 3), dtype=np.uint8)
        b[:, 0] = vals & 0xFF
        b[:, 1] = (vals >> 8) & 0xFF
        b[:, 2] = (vals >> 16) & 0xFF
        data = b.tobytes()
        expected = vals.astype(np.float32) / (1 << 23)
    else:
        vals = (np.clip(x, -1, 1) * 2147483647).astype("<i4")
        data = vals.tobytes()
        expected = vals.astype(np.float32) / 2147483648.0
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, 1, 1, 8000, 8000 * bits // 8, bits // 8, bits
    )
    hdr += b"data" + struct.pack("<I", len(data))
    path = tmp_path / f"{bits}.wav"
    path.write_bytes(hdr + data)
    y, sr = read_wav(path)
    np.testing.assert_allclose(y, expected, atol=1e-6)


def test_native_batch_loader_matches_python(tmp_path, rng):
    """The C++ parallel demuxer and the Python reader agree bit-for-bit."""
    import pytest

    from audio_pattern_discovery import native
    from audio_pattern_discovery.io.corpus import load_corpus
    from audio_pattern_discovery.io.wavio import write_wav

    if not native.available():
        pytest.skip("native library unavailable")
    for i in range(5):
        n = int(rng.integers(1000, 5000))
        write_wav(tmp_path / f"c{i}.wav", rng.normal(0, 0.2, n), 16000)
    fast = load_corpus(tmp_path, use_native=True)
    slow = load_corpus(tmp_path, use_native=False)
    assert len(fast) == len(slow) == 5
    for f, s in zip(fast, slow):
        assert f.path == s.path and f.sample_rate == s.sample_rate
        np.testing.assert_array_equal(f.samples, s.samples)


def test_native_loader_falls_back_on_nonpcm16(tmp_path, rng):
    """A float32 WAV in the corpus routes the whole load to the Python path."""
    import struct

    from audio_pattern_discovery.io.corpus import load_corpus
    from audio_pattern_discovery.io.wavio import write_wav

    write_wav(tmp_path / "a.wav", rng.normal(0, 0.2, 2000), 16000)
    # Hand-rolled IEEE float32 WAV.
    x = rng.normal(0, 0.2, 1500).astype(np.float32)
    pcm = x.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, 16000, 64000, 4, 32)
    hdr += b"data" + struct.pack("<I", len(pcm))
    (tmp_path / "b.wav").write_bytes(hdr + pcm)
    clips = load_corpus(tmp_path, use_native=True)
    assert len(clips) == 2
    np.testing.assert_allclose(clips[1].samples, x, atol=1e-7)


def test_extensible_int32_pcm(tmp_path, rng):
    """WAVE_FORMAT_EXTENSIBLE must honor the SubFormat GUID, not bit depth."""
    import struct

    from audio_pattern_discovery.io.wavio import read_wav

    x = (rng.normal(0, 0.1, 1000) * 2**31).clip(-(2**31), 2**31 - 1).astype("<i4")
    pcm = x.tobytes()
    # fmt chunk: extensible (0xFFFE), 1ch, 16kHz, 32-bit int PCM SubFormat.
    guid = struct.pack("<H", 1) + b"\x00\x00" + bytes(
        [0x00, 0x00, 0x10, 0x00, 0x80, 0x00, 0x00, 0xAA, 0x00, 0x38, 0x9B, 0x71]
    )
    fmt = struct.pack("<HHIIHH", 0xFFFE, 1, 16000, 64000, 4, 32)
    fmt += struct.pack("<HHI", 22, 32, 0x4) + guid
    hdr = b"RIFF" + struct.pack("<I", 12 + 8 + len(fmt) + 8 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<I", len(fmt)) + fmt
    hdr += b"data" + struct.pack("<I", len(pcm))
    (tmp_path / "ext.wav").write_bytes(hdr + pcm)
    samples, rate = read_wav(tmp_path / "ext.wav")
    assert rate == 16000
    np.testing.assert_allclose(samples, x / 2**31, atol=1e-6)


def test_read_wav_info_matches_read_wav(tmp_path, rng):
    """Header probe must agree with the full reader on length/rate for
    every supported layout (mono/stereo, PCM16/float32, truncated data)."""
    import struct
    import wave

    from audio_pattern_discovery.io.wavio import read_wav_info

    # mono PCM16 via our writer
    x = rng.uniform(-0.9, 0.9, 12_345).astype(np.float32)
    p1 = tmp_path / "m.wav"
    write_wav(p1, x, 16_000)
    # stereo PCM16 via stdlib
    inter = (rng.uniform(-0.5, 0.5, 2468) * 32767).astype("<i2")
    p2 = tmp_path / "s.wav"
    with wave.open(str(p2), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(8000)
        f.writeframes(inter.tobytes())
    # mono IEEE float32
    fl = rng.uniform(-1, 1, 777).astype("<f4")
    data = fl.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, 22_050, 22_050 * 4, 4, 32)
    hdr += b"data" + struct.pack("<I", len(data))
    p3 = tmp_path / "f.wav"
    p3.write_bytes(hdr + data)
    # truncated: header declares more data than the file holds
    p4 = tmp_path / "t.wav"
    full = p1.read_bytes()
    p4.write_bytes(full[: len(full) - 500])

    for p in (p1, p2, p3, p4):
        samples, rate = read_wav(p)
        n, r, fmt_tag, bits, n_ch = read_wav_info(p)
        assert n == len(samples), p.name
        assert r == rate, p.name
    n, r, fmt_tag, bits, n_ch = read_wav_info(p1)
    assert (fmt_tag, bits, n_ch) == (1, 16, 1)
    n, r, fmt_tag, bits, n_ch = read_wav_info(p2)
    assert n_ch == 2
    n, r, fmt_tag, bits, n_ch = read_wav_info(p3)
    assert (fmt_tag, bits, n_ch) == (3, 32, 1)


def test_streaming_corpus_lazy_and_equivalent(tmp_path, rng):
    """StreamingCorpus: headers without sample IO, chunked loading on
    access, and clip-for-clip equality with the eager loader."""
    from audio_pattern_discovery.io.corpus import StreamingCorpus, load_corpus

    for i in range(7):
        x = rng.uniform(-0.9, 0.9, 1000 + 100 * i).astype(np.float32)
        write_wav(tmp_path / f"c{i}.wav", x, 16_000)

    sc = StreamingCorpus(tmp_path, chunk=3)
    assert len(sc) == 7
    assert sc.all_pcm16
    assert list(sc.sample_lengths) == [1000 + 100 * i for i in range(7)]
    assert sc._loaded == 0          # nothing read yet
    first = sc[0]
    assert sc._loaded == 3          # one chunk
    clips = load_corpus(tmp_path)
    np.testing.assert_array_equal(first.samples, clips[0].samples)
    for got, want in zip(sc.materialize(), clips):
        assert got.path == want.path
        assert got.sample_rate == want.sample_rate
        np.testing.assert_array_equal(got.samples, want.samples)


def test_streaming_corpus_empty_dir(tmp_path):
    from audio_pattern_discovery.io.corpus import StreamingCorpus

    import pytest as _pytest

    with _pytest.raises(FileNotFoundError, match=str(tmp_path)):
        StreamingCorpus(tmp_path / "nope_dir_missing_ok_parent")
    (tmp_path / "empty").mkdir()
    with _pytest.raises(FileNotFoundError):
        StreamingCorpus(tmp_path / "empty")


def test_streaming_corpus_stereo_pcm16_not_int16_exact(tmp_path, rng):
    """Stereo PCM16 must NOT qualify for the int16 upload path: the mono
    downmix averages channels into half-LSB values that int16
    re-quantization would round (code-review round-3 finding)."""
    import wave

    from audio_pattern_discovery.io.corpus import StreamingCorpus

    inter = (rng.uniform(-0.5, 0.5, 2000) * 32767).astype("<i2")
    with wave.open(str(tmp_path / "st.wav"), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(8000)
        f.writeframes(inter.tobytes())
    sc = StreamingCorpus(tmp_path)
    assert not sc.all_pcm16
    # and a mono file still qualifies
    x = rng.uniform(-0.9, 0.9, 1000).astype(np.float32)
    write_wav(tmp_path / "mono.wav", x, 8000)
    sc2 = StreamingCorpus(tmp_path)    # mixed dir: still excluded
    assert not sc2.all_pcm16


def test_corrupt_wav_fails_fast_with_filename(tmp_path, rng):
    """A non-RIFF file in the corpus raises at HEADER-PROBE time (before
    any samples load or device work starts) and names the bad file."""
    import pytest

    from audio_pattern_discovery.io.corpus import StreamingCorpus
    from audio_pattern_discovery.io.wavio import write_wav

    write_wav(tmp_path / "good.wav", rng.normal(0, 0.1, 4000).astype("float32"),
              16_000)
    (tmp_path / "bad.wav").write_bytes(b"not a riff file at all")
    with pytest.raises(ValueError, match="bad.wav"):
        StreamingCorpus(tmp_path)
