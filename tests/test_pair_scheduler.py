import numpy as np
import pytest

from audio_pattern_discovery.config import DTWConfig
from audio_pattern_discovery.oracle.dtw import dtw_oracle
from audio_pattern_discovery.parallel.pair_scheduler import (
    all_pairs_distances,
    bucket_lengths,
    enumerate_pair_blocks,
)


def _features(rng, K=10, L=64, d=5):
    lengths = rng.integers(8, L, K).astype(np.int32)
    feats = rng.normal(0, 1, (K, L, d)).astype(np.float32)
    for k in range(K):
        feats[k, lengths[k]:] = 0.0
    return feats, lengths


def test_bucket_lengths():
    np.testing.assert_array_equal(
        bucket_lengths(np.array([1, 31, 32, 33, 200]), 32, 128),
        [32, 32, 32, 64, 128],
    )


def test_blocks_cover_upper_triangle(rng):
    _, lengths = _features(rng, K=17)
    seen = set()
    for row_cap, bucket, mld, ii, jj in enumerate_pair_blocks(
        lengths, pair_batch=7, bucket_step=16, max_len=64
    ):
        assert row_cap <= bucket <= 64
        for i, j in zip(ii, jj):
            # Pairs are oriented shorter-first; canonicalize for coverage.
            assert lengths[i] <= lengths[j]
            assert lengths[i] <= row_cap
            assert lengths[j] <= bucket
            assert lengths[j] - lengths[i] <= mld
            key = (min(int(i), int(j)), max(int(i), int(j)))
            assert key not in seen
            seen.add(key)
    assert len(seen) == 17 * 16 // 2


def test_blocks_len_diff_classes(rng):
    """With a band, pairs are grouped by |len_i-len_j| scan class and every
    pair's diff respects its block's static bound (a violated bound would be
    a silent correctness error in the seam-free kernel)."""
    lengths = rng.integers(8, 128, 40).astype(np.int32)
    bounds_seen = set()
    covered = 0
    for row_cap, bucket, mld, ii, jj in enumerate_pair_blocks(
        lengths, pair_batch=64, bucket_step=32, max_len=128,
        band=16, auto_widen=True,
    ):
        dd = lengths[jj] - lengths[ii]
        assert (dd >= 0).all() and (dd <= mld).all()
        bounds_seen.add((bucket, mld))
        covered += len(ii)
    assert covered == 40 * 39 // 2
    # Canonical bounds only: few distinct static values per bucket.
    from collections import defaultdict
    per_bucket = defaultdict(set)
    for b, m in bounds_seen:
        per_bucket[b].add(m)
    assert all(len(v) <= 4 for v in per_bucket.values())


def test_matrix_matches_oracle(rng):
    feats, lengths = _features(rng, K=8, L=32)
    cfg = DTWConfig(pair_batch=5, max_seq_len=32, use_pallas=False)
    D = all_pairs_distances(feats, lengths, cfg, bucket_step=8)
    assert D.shape == (8, 8)
    np.testing.assert_array_equal(np.diag(D), 0.0)
    np.testing.assert_allclose(D, D.T)
    for i in range(8):
        for j in range(i + 1, 8):
            want = dtw_oracle(
                feats[i, : lengths[i]], feats[j, : lengths[j]], normalize="path_len"
            )
            np.testing.assert_allclose(D[i, j], want, rtol=1e-3, atol=1e-3)


def test_block_checkpoint_resume(rng, tmp_path):
    feats, lengths = _features(rng, K=8, L=32)
    cfg = DTWConfig(pair_batch=5, max_seq_len=32)
    D1 = all_pairs_distances(feats, lengths, cfg, block_dir=tmp_path)
    blocks_before = {p.name: p.stat().st_mtime for p in tmp_path.glob("*.npz")}
    assert blocks_before
    # Second run with identical inputs resumes entirely from blocks: results
    # equal and no block file is rewritten.
    D2 = all_pairs_distances(feats, lengths, cfg, block_dir=tmp_path)
    np.testing.assert_array_equal(D1, D2)
    blocks_after = {p.name: p.stat().st_mtime for p in tmp_path.glob("*.npz")}
    assert blocks_after == blocks_before


def test_block_checkpoint_invalidated_by_feature_change(rng, tmp_path):
    """Same indices but different upstream features must NOT reuse blocks."""
    feats, lengths = _features(rng, K=8, L=32)
    cfg = DTWConfig(pair_batch=5, max_seq_len=32, use_pallas=False)
    D1 = all_pairs_distances(feats, lengths, cfg, block_dir=tmp_path)
    other = feats * 2.0
    D2 = all_pairs_distances(other, lengths, cfg, block_dir=tmp_path)
    assert not np.allclose(D1, D2), "feature change must invalidate blocks"
    D2_fresh = all_pairs_distances(other, lengths, cfg)
    np.testing.assert_allclose(D2, D2_fresh, rtol=1e-6)


@pytest.mark.parametrize("band_mode", ["widen", "diag"])
def test_banded_all_pairs(rng, band_mode):
    feats, lengths = _features(rng, K=6, L=40)
    cfg = DTWConfig(pair_batch=4, max_seq_len=40, band=6, band_mode=band_mode)
    D = all_pairs_distances(feats, lengths, cfg, bucket_step=8)
    for i in range(6):
        for j in range(i + 1, 6):
            want = dtw_oracle(
                feats[i, : lengths[i]],
                feats[j, : lengths[j]],
                band=6,
                normalize="path_len",
                band_mode=band_mode,
            )
            np.testing.assert_allclose(D[i, j], want, rtol=1e-3, atol=1e-3)


def test_block_retry_on_transient_failure(rng, monkeypatch):
    """A block whose materialization raises once is retried (SS6.3)."""
    import audio_pattern_discovery.parallel.pair_scheduler as ps

    feats, lengths = _features(rng, K=6, L=32)
    cfg = DTWConfig(pair_batch=4, max_seq_len=32, use_pallas=False)
    want = all_pairs_distances(feats, lengths, cfg, bucket_step=8)

    real_asarray = np.asarray
    fails = {"left": 1}

    def flaky_asarray(x, *a, **kw):
        # Fail exactly once, only for device futures (jax arrays).
        if fails["left"] and hasattr(x, "addressable_shards"):
            fails["left"] -= 1
            raise RuntimeError("injected transient device failure")
        return real_asarray(x, *a, **kw)

    monkeypatch.setattr(ps.np, "asarray", flaky_asarray)
    got = all_pairs_distances(feats, lengths, cfg, bucket_step=8)
    monkeypatch.undo()
    assert fails["left"] == 0, "fault was never injected"
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_block_retry_exhausted_raises(rng, monkeypatch):
    import audio_pattern_discovery.parallel.pair_scheduler as ps
    import pytest

    feats, lengths = _features(rng, K=6, L=32)
    cfg = DTWConfig(pair_batch=4, max_seq_len=32, use_pallas=False)

    def always_fail(x, *a, **kw):
        if hasattr(x, "addressable_shards"):
            raise RuntimeError("injected permanent device failure")
        return np.ndarray.__array__(np.empty(0)) if False else np.array(x, *a, **kw)

    monkeypatch.setattr(ps.np, "asarray", always_fail)
    with pytest.raises(RuntimeError, match="permanent"):
        all_pairs_distances(feats, lengths, cfg, bucket_step=8, max_retries=1)


@pytest.mark.full
@pytest.mark.parametrize("band_mode", ["widen", "diag"])
def test_overlong_bucket_routes_to_blocked_path(rng, band_mode):
    """Buckets beyond LONG_BUCKET frames use the blocked long-DTW
    (both band semantics: the diag corridor mask lives in dtw_long too)."""
    K, L = 5, 1088  # > LONG_BUCKET = 1024
    lengths = rng.integers(1040, L + 1, K).astype(np.int32)
    feats = rng.normal(0, 1, (K, L, 3)).astype(np.float32)
    cfg = DTWConfig(pair_batch=4, max_seq_len=L, band=24, use_pallas=False,
                    length_bucketing=False, band_mode=band_mode)
    D = all_pairs_distances(feats, lengths, cfg)
    for i in range(K):
        for j in range(i + 1, K):
            want = dtw_oracle(
                feats[i, : lengths[i]], feats[j, : lengths[j]],
                band=24, normalize="path_len", band_mode=band_mode,
            )
            np.testing.assert_allclose(D[i, j], want, rtol=1e-3, atol=1e-3)


def test_overlong_odd_bucket_pads_to_healthy_block(rng):
    """An odd over-long bucket (1101) must not degrade to 1-element blocks."""
    from audio_pattern_discovery.parallel.pair_scheduler import _long_block_shape

    blk, padded = _long_block_shape(1101)
    assert blk >= 128 and padded % blk == 0 and padded >= 1101

    K, L = 4, 1101
    lengths = rng.integers(1040, L + 1, K).astype(np.int32)
    feats = rng.normal(0, 1, (K, L, 3)).astype(np.float32)
    cfg = DTWConfig(pair_batch=4, max_seq_len=L, band=24, use_pallas=False,
                    length_bucketing=False)
    D = all_pairs_distances(feats, lengths, cfg)
    want = dtw_oracle(feats[0, : lengths[0]], feats[1, : lengths[1]],
                      band=24, normalize="path_len")
    np.testing.assert_allclose(D[0, 1], want, rtol=1e-3, atol=1e-3)


def test_block_checkpoint_invalidated_by_config_change(rng, tmp_path):
    """Persisted blocks must not be reused under a different DTW config."""
    feats, lengths = _features(rng, K=6, L=32)
    cfg1 = DTWConfig(pair_batch=4, max_seq_len=32, use_pallas=False)
    D1 = all_pairs_distances(feats, lengths, cfg1, block_dir=tmp_path)
    cfg2 = DTWConfig(pair_batch=4, max_seq_len=32, use_pallas=False, band=3)
    D2 = all_pairs_distances(feats, lengths, cfg2, block_dir=tmp_path)
    # Banded distances differ from unbanded for at least one pair; if stale
    # blocks were reused D2 would equal D1 exactly.
    assert not np.allclose(D1, D2), "config change must invalidate blocks"
    D2_fresh = all_pairs_distances(feats, lengths, cfg2)
    np.testing.assert_allclose(D2, D2_fresh, rtol=1e-6)


def test_with_retries_success_after_retry():
    from audio_pattern_discovery.parallel.pair_scheduler import _with_retries

    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise RuntimeError("transient")
        return "ok"

    assert _with_retries(flaky, 3, RuntimeError("initial")) == "ok"
    assert calls["n"] == 2


def test_with_retries_exhaustion_raises_last():
    from audio_pattern_discovery.parallel.pair_scheduler import _with_retries

    def always_fail():
        raise RuntimeError("persistent")

    with pytest.raises(RuntimeError, match="persistent"):
        _with_retries(always_fail, 2, RuntimeError("initial"))


def test_with_retries_zero_budget_raises_pending():
    """max_retries < 1 must raise the PENDING exception (not a bare
    `raise`, which outside an except block is a RuntimeError itself)."""
    from audio_pattern_discovery.parallel.pair_scheduler import _with_retries

    with pytest.raises(ValueError, match="the original failure"):
        _with_retries(lambda: "never called", 0, ValueError("the original failure"))


def test_known_pairs_update_matches_full(rng):
    """Incremental update (SS6.4): known=(k_old, D_old) computes only pairs
    touching new sequences and reproduces the full-run matrix exactly."""
    feats, lengths = _features(rng, K=13, L=48)
    cfg = DTWConfig(pair_batch=6, max_seq_len=48, use_pallas=False)
    D_full = all_pairs_distances(feats, lengths, cfg, bucket_step=16)
    k_old = 8
    stats: dict = {}
    D_up = all_pairs_distances(
        feats, lengths, cfg, bucket_step=16,
        known=(k_old, D_full[:k_old, :k_old]), stats=stats,
    )
    np.testing.assert_allclose(D_up, D_full, rtol=0, atol=1e-6)
    # Only the new-pair share of the triangle was computed.
    n_new = 13 * 12 // 2 - k_old * (k_old - 1) // 2
    assert stats["pairs"] == n_new


def test_known_pairs_no_new_sequences(rng):
    """k_old == K: nothing to compute; D is the prior matrix verbatim."""
    feats, lengths = _features(rng, K=6, L=32)
    cfg = DTWConfig(pair_batch=4, max_seq_len=32, use_pallas=False)
    D_full = all_pairs_distances(feats, lengths, cfg, bucket_step=8)
    D_up = all_pairs_distances(
        feats, lengths, cfg, bucket_step=8, known=(6, D_full)
    )
    np.testing.assert_array_equal(D_up, D_full)


def test_known_pairs_validates_shape(rng):
    feats, lengths = _features(rng, K=6, L=32)
    cfg = DTWConfig(use_pallas=False)
    with pytest.raises(ValueError, match="known"):
        all_pairs_distances(
            feats, lengths, cfg, known=(4, np.zeros((3, 3), np.float32))
        )


def test_known_pairs_with_block_checkpoint(rng, tmp_path):
    """Update + crash-resume compose: an interrupted update job resumes
    from its persisted blocks (keys cover only the computed new pairs)."""
    feats, lengths = _features(rng, K=10, L=32)
    cfg = DTWConfig(pair_batch=5, max_seq_len=32, use_pallas=False)
    D_full = all_pairs_distances(feats, lengths, cfg, bucket_step=8)
    known = (6, D_full[:6, :6])
    D1 = all_pairs_distances(
        feats, lengths, cfg, bucket_step=8, known=known, block_dir=tmp_path
    )
    blocks = {p.name: p.stat().st_mtime for p in tmp_path.glob("*.npz")}
    assert blocks
    stats: dict = {}
    D2 = all_pairs_distances(
        feats, lengths, cfg, bucket_step=8, known=known, block_dir=tmp_path,
        stats=stats,
    )
    np.testing.assert_array_equal(D1, D2)
    np.testing.assert_allclose(D1, D_full, rtol=0, atol=1e-6)
    assert {p.name: p.stat().st_mtime for p in tmp_path.glob("*.npz")} == blocks
    assert stats["dispatch_s"] == 0.0  # second run came entirely from disk
