"""Unbanded tile kernel (ops/dtw_tile.py, band=None): oracle parity at
extreme lengths, symmetry, the tiled scheduler, and the router's choice of
route by shape.  The kernel runs in interpret mode on the CPU suite.
"""

from __future__ import annotations

import numpy as np
import pytest

from audio_pattern_discovery.oracle.dtw import dtw_oracle

TI = 4


def _mk(K, S=16, d=3, seed=0, lo=5):
    rng = np.random.default_rng(seed)
    lens = np.sort(rng.integers(lo, S + 1, K)).astype(np.int32)
    feats = rng.normal(0, 1, (K, S, d)).astype(np.float32)
    return feats, lens


def _run(feats, lens, ii, jj, **kw):
    import jax.numpy as jnp

    from audio_pattern_discovery.ops.dtw_tile import dtw_tile_pairs

    kw.setdefault("ti", TI)
    kw.setdefault("interpret", True)
    return np.asarray(
        dtw_tile_pairs(
            jnp.asarray(feats), jnp.asarray(lens),
            jnp.asarray(ii, np.int32), jnp.asarray(jj, np.int32), **kw,
        )
    )


def _check_oracle(out, feats, lens, pairs, metric="euclidean"):
    for u, (I, J) in enumerate(pairs):
        for p in range(TI):
            for q in range(TI):
                ia, ib = I * TI + p, J * TI + q
                ref = dtw_oracle(
                    feats[ia, : lens[ia]], feats[ib, : lens[ib]],
                    metric=metric, band=None,
                )
                np.testing.assert_allclose(
                    out[u, p, q], ref, rtol=1e-5, atol=1e-5,
                    err_msg=f"pair ({ia},{ib}) metric={metric}",
                )


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine"])
def test_full_kernel_matches_oracle(metric):
    feats, lens = _mk(8, seed=11)
    pairs = [(0, 0), (0, 1), (1, 1)]
    out = _run(feats, lens, [p[0] for p in pairs], [p[1] for p in pairs],
               metric=metric)
    _check_oracle(out, feats, lens, pairs, metric)


def test_full_kernel_self_pairs_exact_zero():
    # Frame costs are direct differences, so D(x, x) is exactly 0.
    feats, lens = _mk(4, seed=3)
    out = _run(feats, lens, [0], [0])
    assert np.all(np.diag(out[0]) == 0.0)


def test_full_kernel_length1_and_pad_entries():
    # length-1 degenerates = the full-row/col sum path; pad entries
    # (length 1) produce finite values that are never extracted upstream.
    feats, lens = _mk(8, seed=5)
    lens[0] = 1
    out = _run(feats, lens, [0], [1])
    _check_oracle(out, feats, lens, [(0, 1)])


def test_full_kernel_rows_follow_longest_lane():
    # Loop bounds come from the lengths inside the kernel: a tile mixing a
    # length-1 lane with full-length lanes is exact for every lane.
    feats, lens = _mk(8, seed=9, lo=1)
    lens[TI] = 1
    lens[-1] = feats.shape[1]
    out = _run(feats, lens, [0, 1], [1, 1])
    _check_oracle(out, feats, lens, [(0, 1), (1, 1)])


def test_full_kernel_short_row_sequence():
    # A length-1 shared (row-side) sequence against long lanes: one strip,
    # one column, every lane row valid.
    feats, lens = _mk(8, seed=15, lo=8)
    lens[0] = 1
    out = _run(feats, lens, [0], [1], strip=2)
    _check_oracle(out, feats, lens, [(0, 1)])


def test_full_kernel_swap_symmetry():
    # DTW(a, b) == DTW(b, a): blocks of (I, J) and (J, I) are transposes.
    feats, lens = _mk(8, seed=13)
    out = _run(feats, lens, [0, 1], [1, 0])
    np.testing.assert_allclose(out[0], out[1].T, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "seq_len, band, band_mode, gpu, want",
    [
        (128, 16, "diag", True, True),
        (128, None, "diag", True, True),
        (512, None, "diag", True, True),
        (2048, 16, "diag", True, True),
        (2049, None, "diag", True, False),   # past the tile route's ceiling
        (128, 16, "widen", True, False),     # widen bands stay plain
        (128, 16, "diag", False, False),     # no GPU: no compiled kernel
        (128, None, "widen", True, True),    # band_mode is moot unbanded
    ],
)
def test_router_choice(monkeypatch, seq_len, band, band_mode, gpu, want):
    """all_pairs_distances takes the tile route exactly when a GPU is
    present and tile_kernel_wins(S, d, band) holds."""
    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel import pair_scheduler as ps

    taken = []
    monkeypatch.setattr(ps, "on_gpu", lambda: gpu)
    monkeypatch.setattr(
        ps, "all_pairs_distances_tiled",
        lambda *a, **k: taken.append(True) or np.zeros((2, 2), np.float32),
    )
    monkeypatch.setattr(
        ps, "enumerate_pair_blocks", lambda *a, **k: iter(())
    )
    cfg = DTWConfig(band=band, band_mode=band_mode)
    feats = np.zeros((2, seq_len, 3), np.float32)
    ps.all_pairs_distances(feats, np.array([2, 3], np.int32), cfg)
    assert bool(taken) == want
    assert ps.tile_kernel_wins(seq_len, 3, cfg) == (want or not gpu)


@pytest.mark.full
def test_full_scheduler_matches_legacy():
    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel.pair_scheduler import (
        all_pairs_distances,
        all_pairs_distances_tiled,
    )

    feats, lengths = _mk(10, seed=7)
    cfg = DTWConfig(band=None, normalize="path_len")
    D_legacy = all_pairs_distances(
        np.asarray(feats), np.asarray(lengths), cfg, tiled=False,
    )
    stats: dict = {}
    D_tiled = all_pairs_distances_tiled(
        np.asarray(feats), np.asarray(lengths), cfg, interpret=True,
        ti=TI, stats=stats,
    )
    assert stats["tiled"] is True
    np.testing.assert_allclose(D_tiled, D_legacy, rtol=1e-4, atol=1e-4)
    assert np.allclose(D_tiled, D_tiled.T)
    np.testing.assert_allclose(np.diag(D_tiled), 0.0, atol=1e-6)


@pytest.mark.full
def test_full_scheduler_resume(tmp_path):
    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel.pair_scheduler import (
        all_pairs_distances_tiled,
    )

    feats, lengths = _mk(12, seed=21)
    cfg = DTWConfig(band=None, normalize="path_len")
    kw = dict(interpret=True, ti=TI, block_dir=tmp_path)
    D1 = all_pairs_distances_tiled(
        np.asarray(feats), np.asarray(lengths), cfg, **kw,
    )
    stats: dict = {}
    D2 = all_pairs_distances_tiled(
        np.asarray(feats), np.asarray(lengths), cfg, stats=stats, **kw,
    )
    np.testing.assert_array_equal(D1, D2)
    assert stats["dispatch_s"] == 0.0  # every block replayed from disk
