"""PCA(-whitening) embedder (models/pca.py, autoencoder.method="pca"):
oracle parity, whitening property, determinism, checkpoint roundtrip, and
the e2e + incremental-update contracts shared with the AE."""

import shutil

import numpy as np
import pytest

from audio_pattern_discovery.models.autoencoder import FeatureScaler
from audio_pattern_discovery.models.pca import PCAState, encode_pca, fit_pca


def _lowrank_frames(rng, n=2000, d=24, k=4):
    """Frames with k dominant directions + small isotropic noise."""
    basis = np.linalg.qr(rng.normal(size=(d, d)))[0][:, :k]
    z = rng.normal(size=(n, k)) * np.array([5.0, 4.0, 3.0, 2.0])[:k]
    return (z @ basis.T + 0.05 * rng.normal(size=(n, d))).astype(np.float32)


def test_matches_numpy_oracle(rng):
    x = _lowrank_frames(rng)
    st = fit_pca(x, 4, whiten=False)
    # Independent oracle: eigh of np.cov in float64.
    w, v = np.linalg.eigh(np.cov(x.astype(np.float64), rowvar=False))
    order = np.argsort(w)[::-1][:4]
    proj_dev = encode_pca(st, x[:100])
    proj_ref = (x[:100].astype(np.float64) - x.astype(np.float64).mean(0)) @ v[:, order]
    # Components are defined up to sign; compare per-column with the best sign.
    for j in range(4):
        d_plus = np.abs(proj_dev[:, j] - proj_ref[:, j]).max()
        d_minus = np.abs(proj_dev[:, j] + proj_ref[:, j]).max()
        assert min(d_plus, d_minus) < 1e-3
    # Explained variance concentrates in the planted rank.
    assert float(st.explained.sum()) > 0.98


def test_whitening_unit_variance(rng):
    x = _lowrank_frames(rng)
    st = fit_pca(x, 4, whiten=True)
    y = encode_pca(st, x)
    np.testing.assert_allclose(y.std(axis=0), 1.0, atol=0.05)
    # Components are decorrelated.
    c = np.corrcoef(y, rowvar=False)
    assert np.abs(c - np.eye(4)).max() < 0.05


def test_fit_deterministic(rng):
    x = _lowrank_frames(rng)
    a, b = fit_pca(x, 6), fit_pca(x, 6)
    np.testing.assert_array_equal(a.components, b.components)
    np.testing.assert_array_equal(a.scale, b.scale)


def test_fit_validates(rng):
    x = _lowrank_frames(rng, n=10, d=8, k=2)
    with pytest.raises(ValueError, match="n_components"):
        fit_pca(x, 9)
    with pytest.raises(ValueError, match="frames"):
        fit_pca(x[:1], 2)


def test_checkpoint_roundtrip(tmp_path, rng):
    from audio_pattern_discovery.utils.checkpoint import (
        has_pca_checkpoint,
        restore_pca_checkpoint,
        save_pca_checkpoint,
    )

    x = _lowrank_frames(rng)
    st = fit_pca(x, 4)
    scaler = FeatureScaler.fit(x)
    assert not has_pca_checkpoint(tmp_path)
    save_pca_checkpoint(tmp_path, st, scaler)
    assert has_pca_checkpoint(tmp_path)
    st2, scaler2 = restore_pca_checkpoint(tmp_path)
    assert isinstance(st2, PCAState)
    np.testing.assert_array_equal(st.components, st2.components)
    np.testing.assert_array_equal(st.mean, st2.mean)
    np.testing.assert_array_equal(st.scale, st2.scale)
    np.testing.assert_array_equal(scaler.mean, scaler2.mean)
    np.testing.assert_array_equal(scaler.std, scaler2.std)


def _pca_cfg():
    from tests.test_update import _cfg

    cfg = _cfg(ae=True)
    cfg.autoencoder.method = "pca"
    return cfg


@pytest.mark.full
def test_e2e_discover_with_pca(tmp_path):
    from audio_pattern_discovery.pipeline import discover
    from audio_pattern_discovery.synthetic import make_corpus

    corpus = tmp_path / "corpus"
    make_corpus(corpus, n_clips=8, n_motifs=2, occurrences_per_clip=2,
                clip_seconds=2.0, sample_rate=16_000, seed=5)
    cfg = _pca_cfg()
    cfg.autoencoder.checkpoint = False
    res = discover(corpus, cfg)
    assert res.seg_features.shape[-1] == cfg.autoencoder.latent_dim
    assert len(set(int(l) for l in res.labels)) >= 2
    assert "embedding_fit" in res.counters.timings_s
    # Deterministic: a second run reproduces the partition exactly.
    res2 = discover(corpus, cfg)
    np.testing.assert_array_equal(res.labels, res2.labels)
    np.testing.assert_array_equal(res.distance_matrix, res2.distance_matrix)


def test_update_matches_full_run_with_frozen_pca(tmp_path):
    from tests.test_update import _partition, _split_corpus
    from audio_pattern_discovery.pipeline import discover

    grow, later = _split_corpus(tmp_path)
    cfg = _pca_cfg()
    out = tmp_path / "out"
    discover(grow, cfg, out_dir=out)

    for p in later:
        shutil.copy(p, grow / p.name)
    r_up = discover(grow, cfg, out_dir=tmp_path / "out_up", update_from=out)

    # Full run restoring the SAME frozen projection must match exactly.
    out_full = tmp_path / "out_full"
    out_full.mkdir()
    shutil.copytree(out / "ae_ckpt", out_full / "ae_ckpt")
    r_full = discover(grow, cfg, out_dir=out_full)

    np.testing.assert_allclose(
        r_up.distance_matrix, r_full.distance_matrix, rtol=0, atol=1e-6
    )
    assert _partition(r_up.labels) == _partition(r_full.labels)
    # The update re-saved the checkpoint, so chained updates keep working.
    from audio_pattern_discovery.utils.checkpoint import has_pca_checkpoint

    assert has_pca_checkpoint(tmp_path / "out_up" / "ae_ckpt")


def test_update_with_pca_requires_prior_checkpoint(tmp_path):
    from tests.test_update import _split_corpus
    from audio_pattern_discovery.pipeline import discover

    grow, later = _split_corpus(tmp_path, n_total=8, n_initial=6)
    cfg = _pca_cfg()
    cfg.autoencoder.checkpoint = False
    out = tmp_path / "out"
    discover(grow, cfg, out_dir=out)
    for p in later:
        shutil.copy(p, grow / p.name)
    with pytest.raises(ValueError, match="no checkpoint"):
        discover(grow, cfg, update_from=out)
