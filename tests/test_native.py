"""C++ native components vs Python/NumPy oracles (SURVEY.md SS3 row 11)."""

import numpy as np
import pytest

from audio_pattern_discovery import native
from audio_pattern_discovery.cluster.agglomerative import (
    _sort_and_relabel,
    nn_chain_linkage,
)
from audio_pattern_discovery.io.corpus import pad_and_stack
from audio_pattern_discovery.io.wavio import read_wav, write_wav
from audio_pattern_discovery.oracle.cluster import linkage_oracle
from audio_pattern_discovery.oracle.dtw import dtw_oracle



@pytest.fixture(autouse=True)
def _native_lib():
    if not native.available():
        pytest.skip("native library unavailable")


def test_native_dtw_matches_oracle(rng):
    sa = [rng.normal(0, 1, (rng.integers(5, 30), 6)).astype(np.float32) for _ in range(6)]
    sb = [rng.normal(0, 1, (rng.integers(5, 30), 6)).astype(np.float32) for _ in range(6)]
    a, la = pad_and_stack(sa, pad_to=32)
    b, lb = pad_and_stack(sb, pad_to=32)
    for metric in ("euclidean", "sqeuclidean", "cosine"):
        got = native.dtw_batch_cpu(a, b, la, lb, metric=metric)
        for p in range(6):
            want = dtw_oracle(sa[p], sb[p], metric=metric)
            np.testing.assert_allclose(got[p], want, rtol=1e-4, atol=1e-4)


def test_native_dtw_banded_and_normalized(rng):
    sa = [rng.normal(0, 1, (rng.integers(10, 40), 4)).astype(np.float32) for _ in range(4)]
    sb = [rng.normal(0, 1, (rng.integers(10, 40), 4)).astype(np.float32) for _ in range(4)]
    a, la = pad_and_stack(sa, pad_to=40)
    b, lb = pad_and_stack(sb, pad_to=40)
    got = native.dtw_batch_cpu(a, b, la, lb, band=5, normalize="path_len")
    for p in range(4):
        want = dtw_oracle(sa[p], sb[p], band=5, normalize="path_len")
        np.testing.assert_allclose(got[p], want, rtol=1e-4, atol=1e-4)


def test_native_dtw_multithreaded_identical(rng):
    sa = [rng.normal(0, 1, (20, 4)).astype(np.float32) for _ in range(32)]
    a, la = pad_and_stack(sa)
    d1 = native.dtw_batch_cpu(a, a, la, la, n_threads=1)
    dn = native.dtw_batch_cpu(a, a, la, la, n_threads=0)
    np.testing.assert_array_equal(d1, dn)


@pytest.mark.parametrize("method", ["single", "complete", "average", "weighted"])
def test_native_nn_chain_matches_python_and_scipy(rng, method):
    x = rng.normal(0, 1, (40, 6))
    d = np.linalg.norm(x[:, None] - x[None, :], axis=-1)
    Z_cpp = _sort_and_relabel(native.nn_chain_cpp(d, method), 40)
    Z_py = nn_chain_linkage(d, method)
    np.testing.assert_allclose(Z_cpp, Z_py, rtol=1e-12)
    Z_ref = linkage_oracle(d, method)
    np.testing.assert_allclose(Z_cpp[:, 2], Z_ref[:, 2], rtol=1e-9)
    np.testing.assert_array_equal(Z_cpp[:, :2], Z_ref[:, :2])


def test_native_wav_demux_matches_python(tmp_path, rng):
    x = rng.uniform(-0.9, 0.9, 8000).astype(np.float32)
    path = tmp_path / "t.wav"
    write_wav(path, x, 16_000)
    got = native.read_wav_pcm16(path)
    assert got is not None
    samples, rate = got
    ref, ref_rate = read_wav(path)
    assert rate == ref_rate
    np.testing.assert_allclose(samples, ref, atol=1e-6)


def test_truncated_wav_does_not_crash(tmp_path, rng):
    """Corrupt/truncated WAVs must be rejected or clamped, never OOB-read."""
    import struct

    from audio_pattern_discovery import native
    from audio_pattern_discovery.io.wavio import write_wav

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    write_wav(tmp_path / "ok.wav", rng.normal(0, 0.2, 4000), 16000)
    raw = (tmp_path / "ok.wav").read_bytes()
    # Truncate mid-data: declared size exceeds the bytes present.
    (tmp_path / "trunc.wav").write_bytes(raw[: len(raw) // 2])
    res = native.read_wav_pcm16(tmp_path / "trunc.wav")
    assert res is not None
    samples, rate = res
    assert rate == 16000 and 0 < len(samples) < 4000
    # Streaming-style bogus data size 0xFFFFFFFF.
    bogus = bytearray(raw)
    di = raw.index(b"data")
    bogus[di + 4 : di + 8] = struct.pack("<I", 0xFFFFFFFF)
    (tmp_path / "bogus.wav").write_bytes(bytes(bogus))
    res = native.read_wav_pcm16(tmp_path / "bogus.wav")
    assert res is not None and len(res[0]) == 4000


def test_nn_chain_all_inf_distances():
    """All-infinite rows (infeasible banded pairs) must not crash NN-chain."""
    from audio_pattern_discovery import native
    from audio_pattern_discovery.cluster.agglomerative import linkage

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    D = np.full((4, 4), np.inf)
    np.fill_diagonal(D, 0.0)
    D[0, 1] = D[1, 0] = 1.0  # one finite pair; the rest infeasible
    Z = linkage(D, "average", use_native=True)
    assert Z.shape == (3, 4) and np.isfinite(Z[0, 2])


def test_dtw_batch_cpu_rejects_mismatched_shapes(rng):
    from audio_pattern_discovery import native

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    a = rng.normal(0, 1, (2, 16, 3)).astype(np.float32)
    b = rng.normal(0, 1, (2, 20, 3)).astype(np.float32)
    la = np.array([16, 16], np.int32)
    with np.testing.assert_raises(ValueError):
        native.dtw_batch_cpu(a, b, la, la)
    with np.testing.assert_raises(ValueError):
        native.dtw_batch_cpu(a, a, np.array([17, 16], np.int32), la)


def test_dtw_batch_cpu_empty_sequence_is_inf(rng):
    from audio_pattern_discovery import native

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    a = rng.normal(0, 1, (1, 8, 2)).astype(np.float32)
    out = native.dtw_batch_cpu(
        a, a, np.array([0], np.int32), np.array([8], np.int32)
    )
    assert np.isinf(out[0])


def test_native_dtw_diag_matches_oracle():
    native = pytest.importorskip("audio_pattern_discovery.native")
    if not native.available():
        pytest.skip("native lib unavailable")
    from audio_pattern_discovery.oracle.dtw import dtw_oracle

    rng = np.random.default_rng(21)
    B, S, d = 12, 40, 4
    a = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    b = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    la = rng.integers(1, S + 1, B).astype(np.int32)
    lb = rng.integers(1, S + 1, B).astype(np.int32)
    got = native.dtw_batch_cpu(
        a, b, la, lb, band=4, normalize="path_len", n_threads=1,
        band_mode="diag",
    )
    for k in range(B):
        ref = dtw_oracle(
            a[k, : la[k]], b[k, : lb[k]], band=4, band_mode="diag",
            normalize="path_len",
        )
        assert np.isclose(got[k], ref, rtol=1e-4, atol=1e-5), (
            k, la[k], lb[k], got[k], ref,
        )
