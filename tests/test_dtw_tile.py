"""All-pairs tile kernel (ops/dtw_tile.py): parity with the scan path,
tile-pair indexing, the tile-pair classes, and the tiled scheduler.

Runs the kernel in interpret mode on the CPU suite at small tiles; the
compiled kernel is checked on the card by the `gpu`-marked test below and
by chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from audio_pattern_discovery.ops.dtw import dtw_batch
from audio_pattern_discovery.ops.dtw_tile import dtw_tile_pairs

TI = 8
S, D = 12, 3


def _mk(K, seed=0, min_len=3):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, (K, S, D)).astype(np.float32)
    lengths = rng.integers(min_len, S + 1, K).astype(np.int32)
    return jnp.asarray(feats), jnp.asarray(lengths)


def _ref_block(feats, lengths, rows, cols, **kw):
    ii = np.repeat(rows, len(cols))
    jj = np.tile(cols, len(rows))
    d = dtw_batch(
        feats[ii], feats[jj], lengths[ii], lengths[jj], normalize="none",
        band_mode="diag", **kw
    )
    return np.asarray(d).reshape(len(rows), len(cols)).copy()


def _compare_self_block(got, ref):
    # The kernel takes frame differences directly, so self-pairs are 0 up
    # to the cosine metric's 1 - |x|^2 rounding; the scan path's
    # |a|^2+|b|^2-2ab form leaves a larger cancellation residue there.  The
    # scheduler never consumes self-pairs (diagonal forced to 0).
    assert np.all(np.abs(np.diag(got)) <= 1e-5)
    np.fill_diagonal(ref, 0.0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "kw",
    [
        dict(band=3, metric="euclidean"),
        dict(band=1, metric="euclidean"),
        dict(band=None, metric="euclidean"),
        dict(band=3, metric="sqeuclidean"),
        dict(band=3, metric="cosine"),
    ],
)
def test_tile_kernel_matches_scan_path(kw):
    feats, lengths = _mk(2 * TI, seed=1)
    blocks = np.asarray(
        dtw_tile_pairs(
            feats, lengths,
            jnp.asarray([0, 0, 1], jnp.int32),
            jnp.asarray([0, 1, 1], jnp.int32),
            ti=TI, interpret=True, **kw,
        )
    )
    r0 = np.arange(TI)
    r1 = np.arange(TI, 2 * TI)
    for u, (rows, cols) in enumerate([(r0, r0), (r0, r1), (r1, r1)]):
        ref = _ref_block(np.asarray(feats), np.asarray(lengths), rows, cols,
                         **kw)
        got = blocks[u].copy()
        if rows[0] == cols[0]:
            _compare_self_block(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_tile_kernel_extreme_lengths():
    """Shortest legal sequences (length 1-2, the padding convention) and
    full-length ones in the same tile."""
    feats, lengths = _mk(TI, seed=2)
    lengths = np.asarray(lengths).copy()
    lengths[0] = 1
    lengths[1] = 2
    lengths[2] = S
    lengths = jnp.asarray(lengths)
    for band in (3, None):
        blocks = np.asarray(
            dtw_tile_pairs(
                feats, lengths, jnp.asarray([0], jnp.int32),
                jnp.asarray([0], jnp.int32),
                ti=TI, band=band, interpret=True,
            )
        )
        ref = _ref_block(np.asarray(feats), np.asarray(lengths),
                         np.arange(TI), np.arange(TI), band=band)
        _compare_self_block(blocks[0].copy(), ref)


def test_tiled_scheduler_matches_legacy():
    """all_pairs_distances_tiled == the per-pair scheduler's D."""
    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel.pair_scheduler import (
        all_pairs_distances,
        all_pairs_distances_tiled,
    )

    feats, lengths = _mk(20, seed=3)
    feats_np = np.asarray(feats)
    lengths_np = np.asarray(lengths)
    cfg = DTWConfig(band=3, normalize="path_len")
    D_legacy = all_pairs_distances(feats_np, lengths_np, cfg, tiled=False)
    D_tiled = all_pairs_distances_tiled(
        feats_np, lengths_np, cfg, interpret=True, ti=TI,
    )
    np.testing.assert_allclose(D_tiled, D_legacy, rtol=1e-4, atol=1e-4)
    assert np.allclose(D_tiled, D_tiled.T)
    np.testing.assert_allclose(np.diag(D_tiled), 0.0, atol=1e-6)


def test_tiled_scheduler_rejects_widen_band():
    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel.pair_scheduler import (
        all_pairs_distances_tiled,
    )

    feats, lengths = _mk(20, seed=3)
    with pytest.raises(ValueError, match="diag"):
        all_pairs_distances_tiled(
            np.asarray(feats), np.asarray(lengths),
            DTWConfig(band=3, band_mode="widen"), interpret=True, ti=TI,
        )


def test_tiled_scheduler_resume(tmp_path):
    """Chunk persistence: a second run reuses saved blocks bit-for-bit."""
    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel.pair_scheduler import (
        all_pairs_distances_tiled,
    )

    feats, lengths = _mk(20, seed=4)
    cfg = DTWConfig(band=3)
    stats1: dict = {}
    D1 = all_pairs_distances_tiled(
        np.asarray(feats), np.asarray(lengths), cfg, interpret=True,
        ti=TI, block_dir=tmp_path, stats=stats1, chunk_programs=2,
    )
    stats2: dict = {}
    D2 = all_pairs_distances_tiled(
        np.asarray(feats), np.asarray(lengths), cfg, interpret=True,
        ti=TI, block_dir=tmp_path, stats=stats2, chunk_programs=2,
    )
    np.testing.assert_array_equal(D1, D2)
    assert stats2["dispatch_s"] == 0.0  # everything came from disk


def test_tile_block_transpose_symmetry():
    """Block (I, J) must equal block (J, I) transposed — catches any
    row/column orientation bug in the tile indexing or extraction."""
    feats, lengths = _mk(2 * TI, seed=5)
    for band in (3, None):
        blocks = np.asarray(
            dtw_tile_pairs(
                feats, lengths,
                jnp.asarray([0, 1], jnp.int32), jnp.asarray([1, 0], jnp.int32),
                ti=TI, band=band, interpret=True,
            )
        )
        np.testing.assert_allclose(blocks[0], blocks[1].T, rtol=1e-5,
                                   atol=1e-5)


def test_tile_strip_width_bitwise_identical():
    """The strip width only regroups the same cell updates: results must be
    bitwise identical across widths (and across strip boundaries)."""
    feats, lengths = _mk(TI, seed=6)
    ii = jnp.asarray([0], jnp.int32)
    for band in (2, None):
        outs = [
            np.asarray(dtw_tile_pairs(feats, lengths, ii, ii, ti=TI,
                                      band=band, strip=w, interpret=True))
            for w in (1, 4, 16)
        ]
        np.testing.assert_array_equal(outs[0], outs[1])
        np.testing.assert_array_equal(outs[0], outs[2])


def test_tile_kernel_rejects_bad_shapes():
    feats, lengths = _mk(12, seed=7)
    ii = jnp.asarray([0], jnp.int32)
    with pytest.raises(ValueError, match="multiple"):
        dtw_tile_pairs(feats, lengths, ii, ii, ti=8, interpret=True)
    feats, lengths = _mk(12, seed=7)
    with pytest.raises(ValueError, match="power of two"):
        dtw_tile_pairs(feats, lengths, ii, ii, ti=6, interpret=True)
    with pytest.raises(ValueError, match="metric"):
        dtw_tile_pairs(feats, lengths, ii, ii, ti=4, metric="l1",
                       interpret=True)


@pytest.mark.gpu
def test_gpu_tile_kernel_compiled():
    """The compiled kernel at the production tile width vs the scan path,
    for every metric and both band modes (self-pairs excepted, see
    _compare_self_block)."""
    rng = np.random.default_rng(13)
    S_, d, ti = 128, 16, 128
    K = 2 * ti
    feats = jnp.asarray(rng.normal(0, 1, (K, S_, d)).astype(np.float32))
    lengths = jnp.asarray(rng.integers(S_ // 2, S_ + 1, K).astype(np.int32))
    ii = jnp.asarray([0], jnp.int32)
    jj = jnp.asarray([1], jnp.int32)
    feats_np = np.asarray(feats)
    lengths_np = np.asarray(lengths)
    sample = np.random.default_rng(14).integers(0, ti, (64, 2))
    for metric in ("euclidean", "sqeuclidean", "cosine"):
        for band in (16, None):
            blocks = np.asarray(dtw_tile_pairs(
                feats, lengths, ii, jj, ti=ti, band=band, metric=metric,
            ))
            gi = sample[:, 0]
            gj = ti + sample[:, 1]
            ref = np.asarray(dtw_batch(
                feats_np[gi], feats_np[gj], lengths_np[gi], lengths_np[gj],
                band=band, band_mode="diag", metric=metric, normalize="none",
            ))
            got = blocks[0][sample[:, 0], sample[:, 1]]
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_tile_class_contracts():
    """make_tile_class_fn's keys bound both tiles' real lengths, stay
    within L, and ignore pad entries."""
    from audio_pattern_discovery.parallel.pair_scheduler import (
        make_tile_class_fn,
    )

    rng = np.random.default_rng(7)
    ti_, nT, L = 16, 6, 128
    n_real = nT * ti_ - 5
    lens = np.ones(nT * ti_, np.int32)
    lens[:n_real] = np.sort(rng.integers(1, L + 1, n_real))
    fn = make_tile_class_fn(lens, nT, ti_, L, n_real)
    for i in range(nT):
        for j in range(i, nT):
            rows_cls, width_cls = fn(i, j)
            li = lens[i * ti_ : min((i + 1) * ti_, n_real)]
            lj = lens[j * ti_ : min((j + 1) * ti_, n_real)]
            assert li.max() <= rows_cls <= L
            assert lj.max() <= width_cls <= L


def test_merge_thin_classes():
    """Thin (rows, width) classes merge monotonically: tile-pairs are
    preserved, every tile-pair's merged class dominates its original one
    pointwise, and no surviving class is thin (unless only one class
    remains)."""
    from audio_pattern_discovery.parallel.pair_scheduler import (
        _merge_thin_classes,
    )

    by = {}
    orig = {}
    uid = 0
    for cls, n in [((64, 6), 38), ((80, 6), 70), ((96, 7), 3),
                   ((112, 6), 1), ((128, 7), 2)]:
        # unique pairs across ALL classes, so orig[p] is unambiguous
        pairs = [(uid + k, 1000 + uid + k) for k in range(n)]
        uid += n
        by[cls] = list(pairs)
        for p in pairs:
            orig[p] = cls
    total = sum(len(v) for v in by.values())
    _merge_thin_classes(by, min_programs=16)
    assert sum(len(v) for v in by.values()) == total
    assert all(len(v) >= 16 for v in by.values()) or len(by) == 1
    for cls, plist in by.items():
        for p in plist:
            r0, s0 = orig[p]
            assert cls[0] >= r0 and cls[1] >= s0


def test_merge_single_class_untouched():
    from audio_pattern_discovery.parallel.pair_scheduler import (
        _merge_thin_classes,
    )

    by = {(96, 6): [(0, 1)]}
    _merge_thin_classes(by)
    assert by == {(96, 6): [(0, 1)]}


def test_merge_cost_ceiling_keeps_skewed_thin_class():
    """A thin class whose only neighbors are huge cheap-rows bulk classes
    must keep its own chunks: upgrading 10k tile-pairs to rows=128 costs
    far more device time than one poorly filled call."""
    from audio_pattern_discovery.parallel.pair_scheduler import (
        _merge_thin_classes,
    )

    bulk = [(k, 20000 + k) for k in range(10000)]
    thin = [(99999, 199999)]
    by = {(16, 7): list(bulk), (128, 7): list(thin)}
    _merge_thin_classes(by)
    assert by == {(16, 7): bulk, (128, 7): thin}


def test_scatter_strategies_identical(monkeypatch):
    """The size-based hybrid (direct original-order scatter vs sorted-space
    + final gather) must be a pure implementation detail: same D either
    side of the threshold."""
    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel import pair_scheduler as ps

    feats, lengths = _mk(20, seed=9)
    cfg = DTWConfig(band=3, normalize="path_len")
    D_direct = ps.all_pairs_distances_tiled(
        np.asarray(feats), np.asarray(lengths), cfg, interpret=True, ti=TI,
    )
    monkeypatch.setattr(ps, "_DIRECT_SCATTER_BYTES", 0)
    D_sorted = ps.all_pairs_distances_tiled(
        np.asarray(feats), np.asarray(lengths), cfg, interpret=True, ti=TI,
    )
    np.testing.assert_array_equal(D_direct, D_sorted)


def test_native_scatter_identical(monkeypatch):
    """The fused C++ scatter (native/apd_native.cc) must be a pure
    implementation detail: bitwise-identical D to the NumPy chain on BOTH
    the direct and the strip-buffered assembly paths, normalized or not."""
    from audio_pattern_discovery import native
    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel import pair_scheduler as ps

    if not native.available():
        pytest.skip("native library unavailable")
    # 21 = 2 full tiles + a 5-row partial: exercises the nr/nc < ti edge
    feats, lengths = _mk(21, seed=13)
    for norm in ("path_len", "none"):
        cfg = DTWConfig(band=3, normalize=norm)
        kw = dict(interpret=True, ti=TI)
        monkeypatch.delenv("APD_NO_NATIVE_SCATTER", raising=False)
        D_nat = ps.all_pairs_distances_tiled(
            np.asarray(feats), np.asarray(lengths), cfg, **kw
        )
        monkeypatch.setenv("APD_NO_NATIVE_SCATTER", "1")
        D_np = ps.all_pairs_distances_tiled(
            np.asarray(feats), np.asarray(lengths), cfg, **kw
        )
        np.testing.assert_array_equal(D_nat, D_np)
        monkeypatch.setattr(ps, "_DIRECT_SCATTER_BYTES", 0)
        D_np_strip = ps.all_pairs_distances_tiled(
            np.asarray(feats), np.asarray(lengths), cfg, **kw
        )
        monkeypatch.delenv("APD_NO_NATIVE_SCATTER")
        D_nat_strip = ps.all_pairs_distances_tiled(
            np.asarray(feats), np.asarray(lengths), cfg, **kw
        )
        np.testing.assert_array_equal(D_np_strip, D_nat_strip)
        np.testing.assert_array_equal(D_nat, D_nat_strip)
        monkeypatch.setattr(
            ps, "_DIRECT_SCATTER_BYTES", 2 * 1024**3
        )


def test_threaded_scatter_identical(monkeypatch, tmp_path):
    """Matrix assembly on the scatter worker thread must be a pure
    implementation detail: same D (bitwise) as the APD_SYNC_SCATTER=1
    inline path, on both the fresh-run and the block-resume route."""
    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel import pair_scheduler as ps

    feats, lengths = _mk(20, seed=11)
    cfg = DTWConfig(band=3, normalize="path_len")
    kw = dict(interpret=True, ti=TI)
    bdir = tmp_path / "blocks"
    D_thr = ps.all_pairs_distances_tiled(
        np.asarray(feats), np.asarray(lengths), cfg, block_dir=bdir, **kw
    )
    # resume entirely from persisted blocks, still through the worker
    D_res = ps.all_pairs_distances_tiled(
        np.asarray(feats), np.asarray(lengths), cfg, block_dir=bdir, **kw
    )
    monkeypatch.setenv("APD_SYNC_SCATTER", "1")
    D_sync = ps.all_pairs_distances_tiled(
        np.asarray(feats), np.asarray(lengths), cfg, **kw
    )
    np.testing.assert_array_equal(D_thr, D_sync)
    np.testing.assert_array_equal(D_res, D_sync)


def test_threaded_scatter_error_propagates(monkeypatch):
    """A failure inside the scatter worker (e.g. a corrupt block shape)
    must surface as an exception on the caller's thread, not hang or pass
    silently.  (np.triu lives on the NumPy scatter path only, so the
    native fast path is disabled for the injection.)"""
    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel import pair_scheduler as ps

    monkeypatch.setenv("APD_NO_NATIVE_SCATTER", "1")
    feats, lengths = _mk(20, seed=12)
    cfg = DTWConfig(band=3, normalize="path_len")

    def boom(*a, **k):
        raise RuntimeError("scatter boom")

    import unittest.mock as mock

    with mock.patch.object(
        ps.np, "triu", side_effect=boom
    ):
        with pytest.raises(RuntimeError, match="scatter boom"):
            ps.all_pairs_distances_tiled(
                np.asarray(feats), np.asarray(lengths), cfg,
                interpret=True, ti=TI,
            )


def test_tiled_scheduler_known_pairs_update():
    """Incremental update on the tiled path: pure-old tile-pairs are skipped
    (old sequences group into leading tiles) and the result matches the full
    run.  The boundary tile mixing old/new recomputes some old x old pairs;
    identical features make that overwrite a numerical no-op."""
    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel.pair_scheduler import (
        all_pairs_distances_tiled,
    )

    feats, lengths = _mk(20, seed=5)
    feats_np, lengths_np = np.asarray(feats), np.asarray(lengths)
    cfg = DTWConfig(band=None, normalize="path_len")
    D_full = all_pairs_distances_tiled(
        feats_np, lengths_np, cfg, interpret=True, ti=TI,
    )
    k_old = 12
    stats: dict = {}
    D_up = all_pairs_distances_tiled(
        feats_np, lengths_np, cfg, interpret=True, ti=TI,
        known=(k_old, D_full[:k_old, :k_old]), stats=stats,
    )
    np.testing.assert_allclose(D_up, D_full, rtol=1e-5, atol=1e-5)
    # 20 seqs pad to 24 = 3 tiles of TI=8; old (12) fills tile 0 and half
    # of tile 1, so exactly the (0, 0) pure-old tile-pair is skipped.
    assert stats["tile_programs"] == 5
    assert stats["pairs"] == 20 * 19 // 2 - k_old * (k_old - 1) // 2


def test_tile_class_non_monotone_lengths():
    """Update-mode grouped permutations are not globally length-sorted: a
    NEW tile of short sequences can pair with a longer OLD tile.  The class
    key must take each tile's own maximum, in either orientation."""
    from audio_pattern_discovery.parallel.pair_scheduler import (
        make_tile_class_fn,
    )

    # tile 0 = old/long (100-110 frames), tile 1 = new/short (18-20).
    lens = np.array([100] * 8 + [110] * 8 + [20] * 8 + [18] * 8, np.int32)
    fn = make_tile_class_fn(lens, nT=2, ti=16, L=128, n_real=32)
    rows01, width01 = fn(0, 1)
    assert rows01 >= 110 and width01 >= 20
    rows10, width10 = fn(1, 0)
    assert rows10 >= 20 and width10 >= 110


def test_failed_tiled_job_does_not_leak_scatter_thread(monkeypatch):
    """A dispatch failure escaping the chunk loop must still join the
    scatter worker (each leaked daemon thread pins the full K x K D
    closure).  Three failed calls -> zero live apd-scatter threads."""
    import threading

    import audio_pattern_discovery.parallel.pair_scheduler as ps
    from audio_pattern_discovery.config import DTWConfig

    feats, lengths = _mk(20, seed=5)
    feats_np, lengths_np = np.asarray(feats), np.asarray(lengths)
    cfg = DTWConfig(band=3)

    def boom(*a, **kw):
        raise RuntimeError("injected dispatch failure")

    monkeypatch.setattr(ps, "dtw_tile_pairs", boom)
    for _ in range(3):
        with pytest.raises(RuntimeError, match="injected"):
            ps.all_pairs_distances_tiled(
                feats_np, lengths_np, cfg, interpret=True, ti=TI,
                max_retries=0,
            )
    leaked = [
        t for t in threading.enumerate() if t.name.startswith("apd-scatter")
    ]
    assert leaked == []


def test_scratch_budget_caps_chunk_size(monkeypatch):
    """Long sequences shrink the tile-pairs per call so the kernel's
    boundary scratch stays under its budget; the matrix is unchanged."""
    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.ops.dtw_tile import scratch_bytes
    from audio_pattern_discovery.parallel import pair_scheduler as ps

    feats, lengths = _mk(20, seed=14)
    cfg = DTWConfig(band=None, normalize="path_len")
    kw = dict(interpret=True, ti=TI, chunk_programs=64)
    stats_big: dict = {}
    D_big = ps.all_pairs_distances_tiled(
        np.asarray(feats), np.asarray(lengths), cfg, stats=stats_big, **kw
    )
    monkeypatch.setattr(ps, "_TILE_SCRATCH_BUDGET", scratch_bytes(2, TI, S))
    stats_small: dict = {}
    D_small = ps.all_pairs_distances_tiled(
        np.asarray(feats), np.asarray(lengths), cfg, stats=stats_small, **kw
    )
    np.testing.assert_array_equal(D_big, D_small)
    assert stats_small["blocks"] >= stats_small["tile_programs"] // 2
    assert stats_small["blocks"] > stats_big["blocks"]


@pytest.mark.parametrize(
    "band, d, want", [(16, 16, 8), (None, 16, 16), (None, 513, 32), (4, 513, 8)]
)
def test_default_strip_by_shape(band, d, want):
    from audio_pattern_discovery.ops.dtw_tile import default_strip

    assert default_strip(band, d) == want
