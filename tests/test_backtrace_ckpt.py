"""Checkpointed backtrace vs the one-shot dirs walk: paths must be
IDENTICAL (bitwise-equal cell values -> same tie-breaks)."""

import numpy as np
import pytest

from audio_pattern_discovery.io.corpus import pad_and_stack
from audio_pattern_discovery.ops.backtrace import paths_from_dirs
from audio_pattern_discovery.ops.backtrace_ckpt import dtw_paths_checkpointed
from audio_pattern_discovery.ops.dtw import dtw_batch_with_dirs


def _one_shot_paths(a, b, la, lb, **kw):
    import jax.numpy as jnp

    _, dirs = dtw_batch_with_dirs(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb), **kw
    )
    return paths_from_dirs(np.asarray(dirs), la, lb)


@pytest.mark.parametrize("band", [None, 6])
def test_paths_identical_to_one_shot(rng, band):
    d = 5
    sa = [rng.normal(0, 1, (rng.integers(10, 60), d)).astype(np.float32) for _ in range(6)]
    sb = [rng.normal(0, 1, (rng.integers(10, 60), d)).astype(np.float32) for _ in range(6)]
    a, la = pad_and_stack(sa, pad_to=64)
    b, lb = pad_and_stack(sb, pad_to=64)
    want = _one_shot_paths(a, b, la, lb, band=band)
    got = dtw_paths_checkpointed(a, b, la, lb, band=band, row_chunk=16)
    for p in range(6):
        assert got[p] == want[p], f"pair {p} diverged"


def test_paths_single_segment_and_tiny_chunk(rng):
    """row_chunk >= N (one segment) and row_chunk=8 (many) both match."""
    d = 4
    sa = [rng.normal(0, 1, (rng.integers(5, 30), d)).astype(np.float32) for _ in range(4)]
    sb = [rng.normal(0, 1, (rng.integers(5, 30), d)).astype(np.float32) for _ in range(4)]
    a, la = pad_and_stack(sa, pad_to=32)
    b, lb = pad_and_stack(sb, pad_to=32)
    want = _one_shot_paths(a, b, la, lb)
    assert dtw_paths_checkpointed(a, b, la, lb, row_chunk=32) == want
    assert dtw_paths_checkpointed(a, b, la, lb, row_chunk=8) == want


def test_paths_monotone_unit_steps(rng):
    d = 3
    sa = [rng.normal(0, 1, (40, d)).astype(np.float32)]
    sb = [rng.normal(0, 1, (55, d)).astype(np.float32)]
    a, la = pad_and_stack(sa, pad_to=64)
    b, lb = pad_and_stack(sb, pad_to=64)
    (path,) = dtw_paths_checkpointed(a, b, la, lb, band=10, row_chunk=16)
    assert path[0] == (0, 0) and path[-1] == (39, 54)
    steps = np.diff(np.asarray(path), axis=0)
    assert (steps >= 0).all() and (steps <= 1).all() and (steps.sum(1) >= 1).all()


def test_pipeline_uses_checkpointed_path_for_long_sequences(rng, monkeypatch):
    """_cluster_alignments must route L >= 512 through the checkpointed
    backtrace and still return the one-shot-identical paths."""
    import audio_pattern_discovery.pipeline as pl
    from audio_pattern_discovery.config import PipelineConfig

    K, L, d = 5, 600, 4
    lengths = rng.integers(520, 601, K).astype(np.int32)
    feats = rng.normal(0, 1, (K, L, d)).astype(np.float32)
    for k in range(K):
        feats[k, lengths[k]:] = 0.0
    cfg = PipelineConfig()
    cfg.dtw.band = 16

    called = {"n": 0}
    import audio_pattern_discovery.ops.backtrace_ckpt as bc

    real = bc.dtw_paths_checkpointed

    def spy(*a, **kw):
        called["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(bc, "dtw_paths_checkpointed", spy)
    got = pl._cluster_alignments(0, [1, 2, 3, 4], feats, lengths, cfg)
    assert called["n"] == 1
    la = lengths[np.full(4, 0)]
    lb = lengths[np.asarray([1, 2, 3, 4])]
    want = _one_shot_paths(
        feats[np.full(4, 0)], feats[[1, 2, 3, 4]], la, lb,
        band=16, band_mode=cfg.dtw.band_mode,
    )
    for m, p in zip([1, 2, 3, 4], want):
        assert got[m] == p


@pytest.mark.full
def test_paths_identical_property(rng):
    """Randomized shapes/chunks: checkpointed paths == one-shot paths for
    every drawn configuration (lengths, dims, band, row_chunk)."""
    for trial in range(6):
        d = int(rng.integers(2, 9))
        pad = int(rng.integers(12, 49))
        band = None if trial % 2 else int(rng.integers(3, 9))
        chunk = int(rng.integers(5, pad + 8))
        n = int(rng.integers(1, 5))
        sa = [rng.normal(0, 1, (rng.integers(3, pad + 1), d)).astype(np.float32) for _ in range(n)]
        sb = [rng.normal(0, 1, (rng.integers(3, pad + 1), d)).astype(np.float32) for _ in range(n)]
        a, la = pad_and_stack(sa, pad_to=pad)
        b, lb = pad_and_stack(sb, pad_to=pad)
        want = _one_shot_paths(a, b, la, lb, band=band)
        got = dtw_paths_checkpointed(a, b, la, lb, band=band, row_chunk=chunk)
        assert got == want, f"trial {trial}: d={d} pad={pad} band={band} chunk={chunk}"
