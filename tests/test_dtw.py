import numpy as np
import pytest

from audio_pattern_discovery.io.corpus import pad_and_stack
from audio_pattern_discovery.ops.backtrace import paths_from_dirs
from audio_pattern_discovery.ops.dtw import (
    dtw_batch,
    dtw_batch_with_dirs,
    dtw_pair,
    pairwise_cost,
)
from audio_pattern_discovery.oracle.dtw import dtw_oracle, dtw_path_oracle


def _random_pairs(rng, n_pairs, len_range=(5, 40), d=6):
    seqs_a = [
        rng.normal(0, 1, (rng.integers(*len_range), d)).astype(np.float32)
        for _ in range(n_pairs)
    ]
    seqs_b = [
        rng.normal(0, 1, (rng.integers(*len_range), d)).astype(np.float32)
        for _ in range(n_pairs)
    ]
    return seqs_a, seqs_b


def _batchify(seqs_a, seqs_b, pad_to=None):
    a, la = pad_and_stack(seqs_a, pad_to=pad_to)
    b, lb = pad_and_stack(seqs_b, pad_to=pad_to)
    return a, b, la, lb


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine"])
def test_matches_oracle(rng, metric):
    seqs_a, seqs_b = _random_pairs(rng, 8)
    a, b, la, lb = _batchify(seqs_a, seqs_b)
    got = np.asarray(dtw_batch(a, b, la, lb, metric=metric))
    for p in range(8):
        want = dtw_oracle(seqs_a[p], seqs_b[p], metric=metric)
        np.testing.assert_allclose(got[p], want, rtol=1e-3, atol=1e-3)


def test_banded_matches_oracle(rng):
    seqs_a, seqs_b = _random_pairs(rng, 8, len_range=(10, 50))
    a, b, la, lb = _batchify(seqs_a, seqs_b)
    got = np.asarray(dtw_batch(a, b, la, lb, band=5))
    for p in range(8):
        want = dtw_oracle(seqs_a[p], seqs_b[p], band=5)
        np.testing.assert_allclose(got[p], want, rtol=1e-3, atol=1e-3)


def test_band_wider_than_grid_equals_unbanded(rng):
    seqs_a, seqs_b = _random_pairs(rng, 4, len_range=(8, 20))
    a, b, la, lb = _batchify(seqs_a, seqs_b)
    full = np.asarray(dtw_batch(a, b, la, lb, band=None))
    wide = np.asarray(dtw_batch(a, b, la, lb, band=100))
    np.testing.assert_allclose(full, wide, rtol=1e-5)


def test_identity_and_symmetry(rng):
    seqs_a, seqs_b = _random_pairs(rng, 6)
    a, b, la, lb = _batchify(seqs_a, seqs_b)
    # d(x, x) == 0 up to the Gram-trick floor: |a|^2+|b|^2-2ab cancels to
    # ~f32-eps, and sqrt amplifies that to ~1e-3 per path cell.
    self_d = np.asarray(dtw_batch(a, a, la, la))
    np.testing.assert_allclose(self_d, 0.0, atol=0.05)
    # sqeuclidean has no sqrt amplification and is near-exact.
    self_sq = np.asarray(dtw_batch(a, a, la, la, metric="sqeuclidean"))
    np.testing.assert_allclose(self_sq, 0.0, atol=1e-4)
    # d(a, b) == d(b, a)
    ab = np.asarray(dtw_batch(a, b, la, lb))
    ba = np.asarray(dtw_batch(b, a, lb, la))
    np.testing.assert_allclose(ab, ba, rtol=1e-3, atol=1e-3)


def test_padding_invariance(rng):
    """Results must not depend on padded capacity."""
    seqs_a, seqs_b = _random_pairs(rng, 5)
    a1, b1, la, lb = _batchify(seqs_a, seqs_b, pad_to=48)
    a2, b2, _, _ = _batchify(seqs_a, seqs_b, pad_to=96)
    d1 = np.asarray(dtw_batch(a1, b1, la, lb))
    d2 = np.asarray(dtw_batch(a2, b2, la, lb))
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)


def test_path_len_normalization(rng):
    seqs_a, seqs_b = _random_pairs(rng, 3)
    a, b, la, lb = _batchify(seqs_a, seqs_b)
    raw = np.asarray(dtw_batch(a, b, la, lb))
    norm = np.asarray(dtw_batch(a, b, la, lb, normalize="path_len"))
    np.testing.assert_allclose(norm, raw / (la + lb), rtol=1e-5)


def test_single_frame_sequences(rng):
    a = rng.normal(0, 1, (1, 4)).astype(np.float32)
    b = rng.normal(0, 1, (7, 4)).astype(np.float32)
    got = float(dtw_pair(a, b))
    want = dtw_oracle(a, b)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_backtrace_paths_match_oracle(rng):
    seqs_a, seqs_b = _random_pairs(rng, 6, len_range=(4, 20))
    a, b, la, lb = _batchify(seqs_a, seqs_b)
    dist, dirs = dtw_batch_with_dirs(a, b, la, lb)
    paths = paths_from_dirs(np.asarray(dirs), np.asarray(la), np.asarray(lb))
    for p in range(6):
        want_d, want_path = dtw_path_oracle(seqs_a[p], seqs_b[p])
        np.testing.assert_allclose(float(dist[p]), want_d, rtol=1e-3, atol=1e-3)
        assert paths[p] == want_path
        # Path validity: starts at (0,0), ends at (n-1,m-1), monotone steps.
        assert paths[p][0] == (0, 0)
        assert paths[p][-1] == (len(seqs_a[p]) - 1, len(seqs_b[p]) - 1)
        for (i0, j0), (i1, j1) in zip(paths[p], paths[p][1:]):
            assert (i1 - i0, j1 - j0) in {(1, 0), (0, 1), (1, 1)}


def test_pairwise_cost_euclidean(rng):
    a = rng.normal(0, 1, (2, 5, 3)).astype(np.float32)
    b = rng.normal(0, 1, (2, 7, 3)).astype(np.float32)
    C = np.asarray(pairwise_cost(a, b, "euclidean"))
    for p in range(2):
        want = np.linalg.norm(a[p][:, None, :] - b[p][None, :, :], axis=-1)
        np.testing.assert_allclose(C[p], want, rtol=1e-3, atol=1e-3)


def test_bf16_matmul_close_to_f32(rng):
    seqs_a, seqs_b = _random_pairs(rng, 4)
    a, b, la, lb = _batchify(seqs_a, seqs_b)
    f32 = np.asarray(dtw_batch(a, b, la, lb))
    bf16 = np.asarray(dtw_batch(a, b, la, lb, matmul_dtype="bfloat16"))
    np.testing.assert_allclose(bf16, f32, rtol=5e-2, atol=5e-2)
