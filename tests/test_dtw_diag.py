"""Diag-corridor band semantics (band_mode="diag"; oracle/dtw.py docstring).

Covers the semantic invariants (symmetry, corner reachability without
widening, equal-length equivalence with "widen", degenerate lengths), the
pure-JAX dtw_batch implementation, and the lane-packed diag kernel
(interpret mode) against the NumPy oracle, including the static class
bounds (wv_req, kmax) that the scheduler computes via diag_class_bounds.
"""

from __future__ import annotations

import numpy as np
import pytest

from audio_pattern_discovery.oracle.dtw import (
    band_valid,
    dtw_oracle,
)

BAND = 4


def _seqs(rng, n, m, d=3):
    return (
        rng.normal(0, 1, (n, d)).astype(np.float32),
        rng.normal(0, 1, (m, d)).astype(np.float32),
    )


# ------------------------------------------------------------------ semantics
def test_diag_symmetric():
    rng = np.random.default_rng(0)
    for n, m in [(7, 23), (16, 16), (1, 9), (31, 8), (2, 40)]:
        a, b = _seqs(rng, n, m)
        dab = dtw_oracle(a, b, band=BAND, band_mode="diag")
        dba = dtw_oracle(b, a, band=BAND, band_mode="diag")
        assert np.isclose(dab, dba), (n, m, dab, dba)


def test_diag_corners_always_reachable():
    # No widening needed: a finite distance for ANY length combination,
    # including the length-1 degenerates where "widen" needs wv = |n-m|.
    rng = np.random.default_rng(1)
    for n, m in [(1, 1), (1, 50), (50, 1), (2, 39), (5, 80), (64, 64)]:
        a, b = _seqs(rng, n, m)
        d = dtw_oracle(a, b, band=1, band_mode="diag")
        assert np.isfinite(d), (n, m)


def test_diag_equals_widen_for_equal_lengths():
    # For n == m the corridor |j - i| <= band is exactly the Sakoe-Chiba
    # band, and "widen" does not widen: the two modes must agree.
    rng = np.random.default_rng(2)
    for n in [1, 2, 9, 33]:
        a, b = _seqs(rng, n, n)
        dd = dtw_oracle(a, b, band=BAND, band_mode="diag")
        dw = dtw_oracle(a, b, band=BAND, band_mode="widen")
        assert np.isclose(dd, dw), n


def test_diag_large_band_equals_unbanded():
    rng = np.random.default_rng(3)
    a, b = _seqs(rng, 12, 29)
    d1 = dtw_oracle(a, b, band=100, band_mode="diag")
    d0 = dtw_oracle(a, b, band=None)
    assert np.isclose(d1, d0)


def test_diag_degenerate_is_full_row_sum():
    # n == 1: the only path visits every cell of row 0 regardless of band.
    rng = np.random.default_rng(4)
    a, b = _seqs(rng, 1, 17)
    d = dtw_oracle(a, b, band=1, band_mode="diag")
    full = sum(float(np.linalg.norm(a[0] - b[j])) for j in range(17))
    assert np.isclose(d, full)


def test_diag_corridor_cell_counts_stay_narrow():
    # The point of the corridor: its per-row live width is O(band * ratio),
    # independent of |n - m| — vs the widened band's O(|n - m|).  Count
    # valid cells per row for a strongly length-mismatched pair.
    n, m = 50, 120
    widest_diag = 0
    for i in range(n):
        width = sum(
            band_valid(i, j, n, m, BAND, band_mode="diag") for j in range(m)
        )
        widest_diag = max(widest_diag, width)
    # ratio m/n < 2.5 -> corridor rows hold <= 2*band*ratio + O(1) cells,
    # far below the widen band's 2*max(band, 70) + 1 = 141.
    assert widest_diag <= 2 * BAND * 3 + 3, widest_diag


def test_diag_connected_random_lengths():
    # Step-connectivity: finite for ANY (n, m) at band >= 1 without
    # widening — the property that lets classes stay narrow.
    rng = np.random.default_rng(6)
    for _ in range(25):
        n = int(rng.integers(1, 60))
        m = int(rng.integers(1, 60))
        a, b = _seqs(rng, n, m)
        assert np.isfinite(dtw_oracle(a, b, band=1, band_mode="diag"))


# ------------------------------------------------------------------ pure JAX
def test_dtw_batch_diag_vs_oracle():
    from audio_pattern_discovery.ops.dtw import dtw_batch

    rng = np.random.default_rng(7)
    B, S, d = 12, 40, 4
    a = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    b = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    la = rng.integers(1, S + 1, B).astype(np.int32)
    lb = rng.integers(1, S + 1, B).astype(np.int32)
    out = np.asarray(
        dtw_batch(a, b, la, lb, band=BAND, band_mode="diag")
    )
    for k in range(B):
        ref = dtw_oracle(
            a[k, : la[k]], b[k, : lb[k]], band=BAND, band_mode="diag"
        )
        assert np.isclose(out[k], ref, rtol=1e-4, atol=1e-4), (
            k, la[k], lb[k], out[k], ref,
        )


def test_dtw_batch_diag_normalized():
    from audio_pattern_discovery.ops.dtw import dtw_batch

    rng = np.random.default_rng(8)
    a = rng.normal(0, 1, (3, 20, 3)).astype(np.float32)
    b = rng.normal(0, 1, (3, 20, 3)).astype(np.float32)
    la = np.array([20, 7, 1], np.int32)
    lb = np.array([10, 20, 20], np.int32)
    out = np.asarray(
        dtw_batch(a, b, la, lb, band=BAND, band_mode="diag",
                  normalize="path_len")
    )
    for k in range(3):
        ref = dtw_oracle(a[k, : la[k]], b[k, : lb[k]], band=BAND,
                         band_mode="diag", normalize="path_len")
        assert np.isclose(out[k], ref, rtol=1e-4, atol=1e-4)


def test_validity_grid_rejects_unknown_mode():
    from audio_pattern_discovery.ops.dtw import dtw_batch

    a = np.zeros((1, 4, 2), np.float32)
    with pytest.raises(ValueError, match="band_mode"):
        dtw_batch(a, a, np.array([4], np.int32), np.array([4], np.int32),
                  band=2, band_mode="nope")


# ------------------------------------------------------------- tile kernel
def _tile_diag_case(rng, K, S, d, ti, len_lo, len_hi, band):
    """Random sorted corpus + all tile-pairs through the tile kernel in
    diag mode (interpret)."""
    import jax.numpy as jnp

    from audio_pattern_discovery.ops.dtw_tile import dtw_tile_pairs

    lens = np.sort(rng.integers(len_lo, len_hi + 1, K)).astype(np.int32)
    feats = rng.normal(0, 1, (K, S, d)).astype(np.float32)
    for k in range(K):
        feats[k, lens[k]:] = 0.0
    nT = K // ti
    pairs = [(I, J) for I in range(nT) for J in range(I, nT)]
    out = np.asarray(dtw_tile_pairs(
        jnp.asarray(feats), jnp.asarray(lens),
        jnp.asarray([p[0] for p in pairs], np.int32),
        jnp.asarray([p[1] for p in pairs], np.int32),
        ti=ti, band=band, interpret=True,
    ))
    return feats, lens, {p: out[u] for u, p in enumerate(pairs)}


def _scan_ref(feats, lens, ia, ib, band):
    """Reference through the pure-JAX diag path (dtw_batch's own oracle
    parity is pinned above)."""
    from audio_pattern_discovery.ops.dtw import dtw_batch

    return float(
        np.asarray(
            dtw_batch(
                feats[ia][None], feats[ib][None],
                np.array([lens[ia]], np.int32), np.array([lens[ib]], np.int32),
                band=band, band_mode="diag",
            )
        )[0]
    )


def test_lane_diag_kernel_vs_scan_path():
    rng = np.random.default_rng(9)
    K, S, d, ti, band = 12, 16, 3, 4, 3
    feats, lens, blocks = _tile_diag_case(rng, K, S, d, ti, 4, 16, band)
    for (I, J), blk in blocks.items():
        for r in range(ti):
            for c in range(ti):
                ia, ib = I * ti + r, J * ti + c
                if ia == ib:
                    # Self-pairs: the kernel's direct differences give 0,
                    # the scan path's Gram form a cancellation residue; the
                    # scheduler never scatters the diagonal.
                    assert blk[r, c] == 0.0
                    continue
                ref = _scan_ref(feats, lens, ia, ib, band)
                assert np.isclose(blk[r, c], ref, rtol=1e-4, atol=1e-4), (
                    (I, J, r, c), lens[ia], lens[ib], blk[r, c], ref,
                )


@pytest.mark.full
def test_lane_diag_kernel_wide_length_spread():
    # Length ratio up to ~4x across tiles: the corridor's slope ranges from
    # 1/4 to 4, so each strip's row window spans several strips' width.
    rng = np.random.default_rng(10)
    K, S, d, ti, band = 12, 24, 3, 4, 2
    feats, lens, blocks = _tile_diag_case(rng, K, S, d, ti, 6, 24, band)
    checked = 0
    for (I, J), blk in blocks.items():
        if I == J:
            continue
        for r in range(ti):
            for c in range(ti):
                ia, ib = I * ti + r, J * ti + c
                want = dtw_oracle(
                    feats[ia, : lens[ia]], feats[ib, : lens[ib]], band=band,
                    band_mode="diag",
                )
                assert np.isclose(blk[r, c], want, rtol=1e-5, atol=1e-5), (
                    (I, J, r, c), lens[ia], lens[ib], blk[r, c], want,
                )
                checked += 1
    assert checked >= 48


@pytest.mark.parametrize(
    "la, lb, band",
    [(2, 16, 1), (16, 2, 1), (1, 16, 3), (16, 1, 3), (3, 16, 0), (16, 5, 16)],
)
def test_diag_kernel_extreme_slopes(la, lb, band):
    # Steep and flat corridors, length-1 degenerates and band 0 (treated as
    # 1): the in-kernel row windows must cover every corridor cell.
    import jax.numpy as jnp

    from audio_pattern_discovery.ops.dtw_tile import dtw_tile_pairs

    rng = np.random.default_rng(la * 100 + lb)
    ti, S, d = 2, 16, 3
    lens = np.array([la, la, lb, lb], np.int32)
    feats = rng.normal(0, 1, (4, S, d)).astype(np.float32)
    out = np.asarray(dtw_tile_pairs(
        jnp.asarray(feats), jnp.asarray(lens), jnp.asarray([0, 1], np.int32),
        jnp.asarray([1, 0], np.int32), ti=ti, band=band, strip=4,
        interpret=True,
    ))
    for r in range(ti):
        for c in range(ti):
            want = dtw_oracle(
                feats[r, :la], feats[ti + c, :lb], band=band, band_mode="diag"
            )
            assert np.isclose(out[0, r, c], want, rtol=1e-5, atol=1e-5)
            assert np.isclose(out[1, c, r], want, rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- scheduler
def test_diag_tiled_scheduler_matches_legacy():
    # Full tiled scheduler in diag mode (sorted tiles, class merging,
    # scatter) vs the legacy per-pair path, both band_mode="diag".
    import audio_pattern_discovery.parallel.pair_scheduler as ps
    from audio_pattern_discovery.config import DTWConfig

    rng = np.random.default_rng(12)
    K, L, d = 20, 16, 3
    feats = rng.normal(0, 1, (K, L, d)).astype(np.float32)
    lens = rng.integers(4, 17, K).astype(np.int32)
    cfg = DTWConfig(band=3, band_mode="diag", normalize="path_len")
    D_tile = ps.all_pairs_distances_tiled(
        feats, lens, cfg, interpret=True, ti=8, chunk_programs=4,
    )
    D_ref = ps.all_pairs_distances(feats, lens, cfg, tiled=False)
    np.testing.assert_allclose(D_tile, D_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.diag(D_tile), 0.0, atol=1e-6)


@pytest.mark.full
def test_diag_tiled_scheduler_resume(tmp_path):
    # Block persistence + resume under diag classes.
    import audio_pattern_discovery.parallel.pair_scheduler as ps
    from audio_pattern_discovery.config import DTWConfig

    rng = np.random.default_rng(13)
    K, L, d = 12, 16, 3
    feats = rng.normal(0, 1, (K, L, d)).astype(np.float32)
    lens = rng.integers(4, 17, K).astype(np.int32)
    cfg = DTWConfig(band=3, band_mode="diag", normalize="path_len")
    kw = dict(interpret=True, ti=4, chunk_programs=2, block_dir=tmp_path)
    D1 = ps.all_pairs_distances_tiled(feats, lens, cfg, **kw)
    stats: dict = {}
    D2 = ps.all_pairs_distances_tiled(feats, lens, cfg, stats=stats, **kw)
    np.testing.assert_array_equal(D1, D2)
    assert sum(stats["device_blocks"]) == 0  # all blocks reused


def test_diag_router_prefers_lane_then_legacy(monkeypatch):
    # On a GPU, band_mode="diag" takes the tile route; "widen" bands stay on
    # the plain path, and the tiled scheduler refuses them outright.
    import audio_pattern_discovery.parallel.pair_scheduler as ps
    from audio_pattern_discovery.config import DTWConfig

    rng = np.random.default_rng(14)
    feats = rng.normal(0, 1, (10, 16, 3)).astype(np.float32)
    lens = rng.integers(4, 17, 10).astype(np.int32)
    monkeypatch.setattr(ps, "on_gpu", lambda: True)
    routed = []
    real_tiled = ps.all_pairs_distances_tiled

    def spy(*a, **k):
        routed.append(True)
        return real_tiled(*a, interpret=True, ti=8, **k)

    monkeypatch.setattr(ps, "all_pairs_distances_tiled", spy)
    D = ps.all_pairs_distances(feats, lens, DTWConfig(band=2, band_mode="diag"))
    assert routed and D.shape == (10, 10)
    routed.clear()
    ps.all_pairs_distances(feats, lens, DTWConfig(band=2, band_mode="widen"))
    assert not routed
    with pytest.raises(ValueError, match="diag"):
        real_tiled(
            feats, lens, DTWConfig(band=2, band_mode="widen"),
            interpret=True, ti=8,
        )
