"""End-to-end behavioral contract test (SURVEY.md SS5.2): a synthesized
corpus with planted motifs must come back out as clusters grouping the
planted occurrences — the proxy for 'identical cluster assignments on the
reference corpus' while the reference mount is empty (SS0)."""

import json

import numpy as np
import pytest

from audio_pattern_discovery.config import PipelineConfig
from audio_pattern_discovery.pipeline import discover
from audio_pattern_discovery.synthetic import make_corpus


def _small_config(ae: bool) -> PipelineConfig:
    cfg = PipelineConfig()
    cfg.spectrogram.sample_rate = 16_000
    cfg.spectrogram.win_length = 256
    cfg.spectrogram.hop_length = 128
    cfg.spectrogram.max_bins = 64
    cfg.segmentation.threshold_db = -25.0
    cfg.segmentation.min_len_frames = 6
    cfg.segmentation.merge_gap_frames = 3
    cfg.autoencoder.enabled = ae
    cfg.autoencoder.epochs = 8
    cfg.autoencoder.hidden_dims = (64,)
    cfg.autoencoder.latent_dim = 8
    cfg.dtw.max_seq_len = 64
    cfg.dtw.pair_batch = 128
    cfg.cluster.linkage = "average"
    return cfg


def _cluster_purity(result, truth) -> float:
    """Match each discovered segment to the planted motif whose occurrence it
    overlaps; purity = fraction of cluster members agreeing with the cluster
    majority motif."""
    hop = result.config.spectrogram.hop_length
    win = result.config.spectrogram.win_length

    def motif_of(seg):
        s0 = seg.start_frame * hop
        s1 = (seg.end_frame - 1) * hop + win
        best, best_ov = None, 0
        for occ in truth:
            if occ.clip != seg.clip:
                continue
            ov = min(s1, occ.start + occ.length) - max(s0, occ.start)
            if ov > best_ov:
                best, best_ov = occ.motif, ov
        return best

    agree = total = 0
    for rep in result.clusters:
        motifs = [motif_of(result.segments[m]) for m in rep.members]
        motifs = [m for m in motifs if m is not None]
        if not motifs:
            continue
        majority = max(set(motifs), key=motifs.count)
        agree += sum(1 for m in motifs if m == majority)
        total += len(motifs)
    return agree / max(total, 1)


@pytest.mark.parametrize("use_ae", [False, True])
def test_discovery_recovers_planted_motifs(tmp_path, use_ae):
    corpus_dir = tmp_path / "corpus"
    truth = make_corpus(
        corpus_dir,
        n_clips=10,
        n_motifs=3,
        occurrences_per_clip=2,
        clip_seconds=2.0,
        sample_rate=16_000,
        seed=7,
    )
    cfg = _small_config(use_ae)
    out_dir = tmp_path / "out"
    result = discover(corpus_dir, cfg, out_dir=out_dir)

    # Segmentation found most planted occurrences.
    assert len(result.segments) >= 0.7 * len(truth)
    # Clusters group same-motif occurrences: purity well above chance (1/3).
    purity = _cluster_purity(result, truth)
    assert purity >= 0.9, f"cluster purity {purity:.2f}"

    # Artifacts exist and are well-formed.
    manifest = json.loads((out_dir / "clusters.json").read_text())
    assert manifest["n_clusters"] == len(result.clusters)
    assert (out_dir / "distance_matrix.npy").exists()
    D = np.load(out_dir / "distance_matrix.npy")
    assert D.shape == (len(result.segments),) * 2
    snippets = list((out_dir / "snippets").glob("*.wav"))
    assert len(snippets) == sum(len(r.members) for r in result.clusters)
    # Alignment paths are monotone warping paths.
    for cl in manifest["clusters"]:
        for path in cl["alignments"].values():
            assert path[0] == [0, 0]
            for (i0, j0), (i1, j1) in zip(path, path[1:]):
                assert (i1 - i0, j1 - j0) in {(1, 0), (0, 1), (1, 1)}


@pytest.mark.parametrize(
    "metric,linkage",
    [("cosine", "complete"), ("sqeuclidean", "weighted"),
     ("euclidean", "single")],
)
def test_discovery_config_matrix(tmp_path, metric, linkage):
    """Non-default metric x linkage combos through the PRODUCT path (the
    op layer covers each knob in isolation; this pins that discover()
    plumbs them together without degrading the planted-motif recovery)."""
    corpus_dir = tmp_path / "corpus"
    truth = make_corpus(
        corpus_dir, n_clips=8, n_motifs=2, occurrences_per_clip=2,
        clip_seconds=2.0, sample_rate=16_000, seed=11,
    )
    cfg = _small_config(ae=False)
    cfg.dtw.metric = metric
    cfg.cluster.linkage = linkage
    result = discover(corpus_dir, cfg)
    purity = _cluster_purity(result, truth)
    assert purity >= 0.9, f"{metric}/{linkage} purity {purity:.2f}"


def test_deterministic_end_to_end(tmp_path):
    corpus_dir = tmp_path / "corpus"
    make_corpus(corpus_dir, n_clips=6, n_motifs=2, clip_seconds=1.5, seed=3)
    cfg = _small_config(False)
    r1 = discover(corpus_dir, cfg)
    r2 = discover(corpus_dir, cfg)
    np.testing.assert_array_equal(r1.labels, r2.labels)
    np.testing.assert_array_equal(r1.distance_matrix, r2.distance_matrix)


@pytest.mark.full
def test_cluster_images_written(tmp_path):
    from audio_pattern_discovery.config import PipelineConfig
    from audio_pattern_discovery.pipeline import discover
    from audio_pattern_discovery.synthetic import make_corpus

    make_corpus(tmp_path / "corpus", n_clips=6, n_motifs=2, seed=3)
    cfg = PipelineConfig()
    cfg.autoencoder.enabled = False
    cfg.dtw.band = 16
    cfg.dtw.use_pallas = False
    out = tmp_path / "out"
    result = discover(tmp_path / "corpus", cfg, out_dir=out)
    pngs = sorted((out / "images").glob("*.png"))
    assert len(pngs) == len(result.clusters)
    assert all(p.stat().st_size > 500 for p in pngs)


def test_config_validation_rejects_bad_knobs():
    import pytest

    from audio_pattern_discovery.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.dtw.metric = "manhattan"
    with pytest.raises(ValueError, match="dtw.metric"):
        cfg.validate()
    cfg = PipelineConfig()
    cfg.spectrogram.hop_length = 4096
    with pytest.raises(ValueError, match="hop_length"):
        cfg.validate()
    cfg = PipelineConfig()
    cfg.cluster.linkage = "ward"
    with pytest.raises(ValueError, match="linkage"):
        cfg.validate()
    assert PipelineConfig().validate() is not None


@pytest.mark.full
def test_html_report_and_eval(tmp_path):
    import json
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent / "tools"))
    from eval_clusters import evaluate

    from audio_pattern_discovery.config import PipelineConfig
    from audio_pattern_discovery.pipeline import discover
    from audio_pattern_discovery.synthetic import make_corpus

    make_corpus(tmp_path / "corpus", n_clips=8, n_motifs=2, seed=9)
    cfg = PipelineConfig()
    cfg.autoencoder.enabled = False
    cfg.dtw.band = 16
    cfg.dtw.use_pallas = False
    out = tmp_path / "out"
    discover(tmp_path / "corpus", cfg, out_dir=out)
    html_doc = (out / "index.html").read_text()
    assert "Discovered patterns" in html_doc
    assert "data:image/png;base64," in html_doc

    manifest = json.load(open(out / "clusters.json"))
    truth = json.load(open(tmp_path / "corpus" / "truth.json"))
    scores = evaluate(manifest, truth)
    assert scores["purity"] >= 0.9, scores
    assert scores["coverage"] >= 0.7, scores


@pytest.mark.full
def test_golden_harness_roundtrip(tmp_path, monkeypatch):
    import subprocess
    import sys

    from audio_pattern_discovery.synthetic import make_corpus

    make_corpus(tmp_path / "corpus", n_clips=6, n_motifs=2, seed=13)
    base = [
        sys.executable, "tools/golden.py",
    ]
    common = [
        str(tmp_path / "corpus"), str(tmp_path / "golden.npz"),
        "-s", "autoencoder.enabled=false", "-s", "dtw.band=16",
        "-s", "dtw.use_pallas=false",
    ]
    env = {**__import__("os").environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(base + ["save"] + common, capture_output=True, text=True,
                       cwd="/root/repo", env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    r = subprocess.run(base + ["check"] + common, capture_output=True, text=True,
                       cwd="/root/repo", env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "partition identical" in r.stdout


def test_config_from_dict_rejects_unknown_section():
    import pytest

    from audio_pattern_discovery.config import PipelineConfig

    with pytest.raises(ValueError, match="spectogram"):
        PipelineConfig.from_dict({"spectogram": {"hop_length": 128}})
    with pytest.raises(TypeError):
        PipelineConfig.from_dict({"dtw": {"bandd": 3}})


@pytest.mark.full
def test_cluster_alignments_chunked_matches_one_shot(monkeypatch):
    """The alignment memory guard (chunked with-dirs dispatches) must return
    byte-identical warping paths to an unguarded one-shot dispatch."""
    import jax.numpy as jnp
    import numpy as np

    import audio_pattern_discovery.pipeline as pl
    from audio_pattern_discovery.ops.backtrace import paths_from_dirs
    from audio_pattern_discovery.ops.dtw import dtw_batch_with_dirs

    rng = np.random.default_rng(7)
    K, L, d = 9, 48, 6
    lengths = rng.integers(10, 41, K).astype(np.int32)
    feats = rng.normal(0, 1, (K, L, d)).astype(np.float32)
    for k in range(K):
        feats[k, lengths[k]:] = 0.0
    cfg = _small_config(ae=False)

    exemplar, others = 0, list(range(1, K))
    # Force chunking: budget fits ~2 pairs per dispatch at the trimmed L.
    lmax = int(lengths.max())
    Lt = 1 << (lmax - 1).bit_length()
    monkeypatch.setattr(pl, "_ALIGN_BYTES_BUDGET", 2 * 16 * (2 * Lt) * Lt)
    got = pl._cluster_alignments(exemplar, others, feats, lengths, cfg)

    idx = np.asarray(others)
    la = lengths[np.full(len(others), exemplar)]
    lb = lengths[idx]
    _, dirs = dtw_batch_with_dirs(
        jnp.asarray(feats[np.full(len(others), exemplar)]),
        jnp.asarray(feats[idx]),
        jnp.asarray(la),
        jnp.asarray(lb),
        metric=cfg.dtw.metric,
        band=cfg.dtw.band,
        auto_widen=cfg.dtw.auto_widen_band,
        band_mode=cfg.dtw.band_mode,
    )
    want = paths_from_dirs(np.asarray(dirs), la, lb)
    assert set(got) == set(others)
    for m, p in zip(others, want):
        assert got[m] == p


def test_behavior_matches_committed_golden(tmp_path):
    """Cross-ROUND behavioral anchor: discovery on the deterministic seed-7
    corpus must reproduce the committed golden fingerprint (distances to
    float tolerance, cluster partition exactly).  The anchor is recorded
    under THIS suite's environment (8-virtual-device CPU mesh — the
    device count changes AE gradient-reduction order, so a single-device
    recording does not match).  If a change legitimately alters behavior,
    re-record by running discover() under the suite env on the seed-7
    corpus, overwrite tests/golden/GOLDEN_cpu_seed7.npz, and justify the
    behavioral change in the commit message."""
    import pathlib

    import numpy as np

    from audio_pattern_discovery.config import PipelineConfig
    from audio_pattern_discovery.pipeline import discover
    from audio_pattern_discovery.synthetic import make_corpus

    golden_path = (
        pathlib.Path(__file__).parent / "golden" / "GOLDEN_cpu_seed7.npz"
    )
    make_corpus(tmp_path / "corpus", n_clips=12, n_motifs=3, seed=7)
    cfg = PipelineConfig()
    cfg.dtw.band = 16
    cfg.output.write_snippets = False
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    result = discover(tmp_path / "corpus", cfg)

    ref = np.load(golden_path)
    assert result.distance_matrix.shape == ref["D"].shape
    np.testing.assert_allclose(
        result.distance_matrix, ref["D"], rtol=1e-4, atol=1e-5
    )

    def partition(labels):
        groups = {}
        for i, lab in enumerate(labels):
            groups.setdefault(int(lab), []).append(i)
        return sorted(tuple(g) for g in groups.values())

    assert partition(result.labels) == partition(ref["labels"])


def test_behavior_matches_committed_golden_mfcc_pca(tmp_path):
    """Second cross-round anchor covering the round-3 front-end variants:
    MFCC features + the PCA embedder on the same seed-7 corpus.  Recorded
    under the suite env (8-virtual-device CPU mesh); re-record
    tests/golden/GOLDEN_cpu_seed7_mfcc_pca.npz and justify in the commit
    message if a change legitimately alters behavior."""
    import pathlib

    import numpy as np

    from audio_pattern_discovery.config import PipelineConfig
    from audio_pattern_discovery.pipeline import discover
    from audio_pattern_discovery.synthetic import make_corpus

    golden_path = (
        pathlib.Path(__file__).parent / "golden" / "GOLDEN_cpu_seed7_mfcc_pca.npz"
    )
    make_corpus(tmp_path / "corpus", n_clips=12, n_motifs=3, seed=7)
    cfg = PipelineConfig()
    cfg.dtw.band = 16
    cfg.spectrogram.feature = "mfcc"
    cfg.spectrogram.n_mels = 48
    cfg.spectrogram.n_mfcc = 16
    cfg.autoencoder.method = "pca"
    cfg.autoencoder.latent_dim = 8
    cfg.output.write_snippets = False
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    result = discover(tmp_path / "corpus", cfg)

    ref = np.load(golden_path)
    assert result.distance_matrix.shape == ref["D"].shape
    np.testing.assert_allclose(
        result.distance_matrix, ref["D"], rtol=1e-4, atol=1e-5
    )

    def partition(labels):
        groups = {}
        for i, lab in enumerate(labels):
            groups.setdefault(int(lab), []).append(i)
        return sorted(tuple(g) for g in groups.values())

    assert partition(result.labels) == partition(ref["labels"])


def test_behavior_matches_committed_golden_lenvar(tmp_path):
    """Third cross-round anchor (VERDICT r4 item 3): a LENGTH-VARIED corpus
    (motif durations 0.15-0.6 s, segment lengths spanning >= 2x) pins the
    round-4 band_mode="diag" DEFAULT exactly where it DIFFERS from the
    rounds-1-3 "widen" semantics — both seed-7 anchors are unchanged across
    that flip precisely because their pairs are mode-identical, so without
    this anchor no committed artifact covers the changed semantics.  The
    test also PROVES the coverage: diag and widen disagree on at least one
    segment pair of this corpus.  Recorded under the suite env (8-virtual-
    device CPU mesh); re-record tests/golden/GOLDEN_cpu_lenvar_seed11.npz
    via tools/record_golden_anchors.py and justify in the commit message if
    a change legitimately alters behavior."""
    import pathlib

    import jax.numpy as jnp
    import numpy as np

    from audio_pattern_discovery.config import PipelineConfig
    from audio_pattern_discovery.ops.dtw import dtw_batch
    from audio_pattern_discovery.pipeline import discover
    from audio_pattern_discovery.synthetic import make_corpus

    golden_path = (
        pathlib.Path(__file__).parent / "golden" / "GOLDEN_cpu_lenvar_seed11.npz"
    )
    make_corpus(
        tmp_path / "corpus", n_clips=10, n_motifs=3,
        motif_seconds=(0.15, 0.6), seed=11,
    )
    cfg = PipelineConfig()
    cfg.dtw.band = 16
    cfg.output.write_snippets = False
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    assert cfg.dtw.band_mode == "diag"  # pinning the DEFAULT semantics
    result = discover(tmp_path / "corpus", cfg)

    # Coverage proof 1: the corpus actually spans >= 2x segment lengths.
    lens = np.asarray(result.seg_lengths)
    assert int(lens.max()) >= 2 * int(lens.min()), (lens.min(), lens.max())

    # Coverage proof 2: diag != widen on at least one pair of THIS corpus.
    # All pairs are probed: EXTREME skew pairs agree (both corridors cover
    # the whole rectangle there) — the divergence lives at moderate ratios
    # (recorded: 15/153 pairs differ, max |delta| 41.2, argmax at lengths
    # 184 x 32), so a corner-pairs-only probe would falsely fail.
    ia, ib = np.triu_indices(len(lens), 1)
    feats = jnp.asarray(result.seg_features)
    la = jnp.asarray(lens[ia])
    lb = jnp.asarray(lens[ib])
    d_diag = np.asarray(dtw_batch(
        feats[ia], feats[ib], la, lb, band=16, band_mode="diag"))
    d_widen = np.asarray(dtw_batch(
        feats[ia], feats[ib], la, lb, band=16, band_mode="widen"))
    assert np.max(np.abs(d_diag - d_widen)) > 1e-3, (
        "diag and widen agree on every pair — the anchor would not "
        "cover the changed semantics"
    )

    ref = np.load(golden_path)
    assert result.distance_matrix.shape == ref["D"].shape
    np.testing.assert_allclose(
        result.distance_matrix, ref["D"], rtol=1e-4, atol=1e-5
    )

    def partition(labels):
        groups = {}
        for i, lab in enumerate(labels):
            groups.setdefault(int(lab), []).append(i)
        return sorted(tuple(g) for g in groups.values())

    assert partition(result.labels) == partition(ref["labels"])


@pytest.mark.full
def test_mulaw8_upload_quality_parity(tmp_path):
    """upload_codec="mulaw8" (half-of-int16 bandwidth) must preserve
    discovery quality on a planted corpus: same purity gate and the same
    label partition as the default int16 path (VERDICT r2 item 3)."""
    corpus_dir = tmp_path / "corpus"
    truth = make_corpus(
        corpus_dir, n_clips=10, n_motifs=3, occurrences_per_clip=2,
        clip_seconds=2.0, sample_rate=16_000, seed=7,
    )
    cfg_ref = _small_config(False)
    cfg_mu = _small_config(False)
    cfg_mu.spectrogram.upload_codec = "mulaw8"
    r_ref = discover(corpus_dir, cfg_ref)
    r_mu = discover(corpus_dir, cfg_mu)

    assert _cluster_purity(r_mu, truth) >= 0.9
    assert len(r_mu.segments) == len(r_ref.segments)

    def partition(res):
        groups = {}
        for seg, lab in enumerate(res.labels):
            groups.setdefault(int(lab), []).append(seg)
        return sorted(tuple(g) for g in groups.values())

    assert partition(r_mu) == partition(r_ref)


def test_mulaw_codec_roundtrip():
    """Companding accuracy: ~38 dB SNR on full-scale content and exact zero
    preservation (silence stays silence through the segmentation gate)."""
    from audio_pattern_discovery.ops.spectrogram import (
        mulaw_decode_device,
        mulaw_encode_host,
    )

    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, 20_000).astype(np.float32)
    q = mulaw_encode_host(x)
    assert q.dtype == np.int8
    y = np.asarray(mulaw_decode_device(q))
    snr_db = 10 * np.log10(np.mean(x**2) / np.mean((x - y) ** 2))
    assert snr_db >= 30.0, f"mu-law SNR {snr_db:.1f} dB"
    assert mulaw_encode_host(np.zeros(8, np.float32)).tolist() == [0] * 8
    assert np.asarray(mulaw_decode_device(np.zeros(8, np.int8))).tolist() == [0.0] * 8


def test_mixed_sample_rate_warning(tmp_path):
    """Mixed-rate corpora silently mix time scales; the pipeline must warn.
    (The apd logger doesn't propagate, so capture via an injected logger.)"""
    import logging

    from audio_pattern_discovery.io.wavio import write_wav

    rng = np.random.default_rng(0)
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    write_wav(corpus / "a.wav", rng.uniform(-0.5, 0.5, 8000).astype(np.float32), 16_000)
    write_wav(corpus / "b.wav", rng.uniform(-0.5, 0.5, 8000).astype(np.float32), 8_000)
    cfg = _small_config(False)
    records: list[str] = []
    lg = logging.getLogger("apd_test_mixed_rate")
    lg.setLevel(logging.INFO)
    lg.propagate = False
    h = logging.Handler()
    h.emit = lambda r: records.append(r.getMessage())
    lg.addHandler(h)
    try:
        discover(corpus, cfg, logger=lg)
    except Exception:
        pass  # quality of results on a junk corpus is not the point
    assert any("mixes sample rates" in m for m in records)


def test_features_export(tmp_path):
    """output.write_features=true dumps the embedded segment features for
    downstream analysis, consistent with the result object."""
    import numpy as np

    corpus = tmp_path / "corpus"
    make_corpus(corpus, n_clips=6, n_motifs=2, occurrences_per_clip=2,
                clip_seconds=2.0, sample_rate=16_000, seed=4)
    cfg = _small_config(ae=False)
    cfg.output.write_features = True
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    cfg.output.write_snippets = False
    out = tmp_path / "out"
    res = discover(corpus, cfg, out_dir=out)
    z = np.load(out / "features.npz")
    np.testing.assert_array_equal(z["features"], res.seg_features)
    np.testing.assert_array_equal(z["lengths"], res.seg_lengths)
    np.testing.assert_array_equal(z["labels"], res.labels)


def test_all_new_frontends_compose(tmp_path):
    """Round-3 front-end options all at once: mixed-rate corpus +
    resample=auto + MFCC features + PCA embedding still recovers the
    planted motifs with high purity."""
    from audio_pattern_discovery.io.resample import resample
    from audio_pattern_discovery.io.wavio import read_wav, write_wav

    src = tmp_path / "src"
    truth = make_corpus(src, n_clips=8, n_motifs=2, occurrences_per_clip=2,
                        clip_seconds=2.0, sample_rate=16_000, seed=13)
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for j, p in enumerate(sorted(src.glob("*.wav"))):
        x, r = read_wav(p)
        if j % 2:
            write_wav(corpus / p.name, resample(x, r, 32_000), 32_000)
        else:
            write_wav(corpus / p.name, x, r)

    cfg = _small_config(ae=True)
    cfg.spectrogram.resample = "auto"
    cfg.spectrogram.feature = "mfcc"
    cfg.spectrogram.n_mels = 32
    cfg.spectrogram.n_mfcc = 13
    cfg.autoencoder.method = "pca"
    res = discover(corpus, cfg)
    assert res.seg_features.shape[-1] == cfg.autoencoder.latent_dim
    purity = _cluster_purity(res, truth)
    assert purity >= 0.9, f"composed front-end purity {purity:.2f}"


def test_label_tracks_written(tmp_path):
    """labels/<clip>.txt are Audacity-importable: sorted, tab-separated
    start/end seconds within the clip, cluster names matching the manifest."""
    corpus = tmp_path / "corpus"
    make_corpus(corpus, n_clips=6, n_motifs=2, occurrences_per_clip=2,
                clip_seconds=2.0, sample_rate=16_000, seed=6)
    cfg = _small_config(ae=False)
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    cfg.output.write_snippets = False
    out = tmp_path / "out"
    res = discover(corpus, cfg, out_dir=out)
    tracks = sorted((out / "labels").glob("*.txt"))
    assert tracks, "no label tracks written"
    n_rows = 0
    for t in tracks:
        prev_start = -1.0
        for line in t.read_text().splitlines():
            s, e, lab = line.split("\t")
            s, e = float(s), float(e)
            assert 0.0 <= s < e <= 2.0 + 0.1
            assert s >= prev_start
            prev_start = s
            assert lab.startswith("cluster")
            n_rows += 1
    assert n_rows == sum(len(r.members) for r in res.clusters)


@pytest.mark.full
def test_overlap_training_quality_parity(tmp_path):
    """autoencoder.overlap_clip_fraction (config-5 upload/training overlap,
    round 4) must preserve discovery quality: the AE trains on the first
    half's segments only, but the segment TABLE is identical to the
    single-phase run (per-clip segmentation) and the planted motifs still
    cluster cleanly."""
    corpus_dir = tmp_path / "corpus"
    truth = make_corpus(
        corpus_dir, n_clips=10, n_motifs=3, occurrences_per_clip=2,
        clip_seconds=2.0, sample_rate=16_000, seed=7,
    )
    cfg_ref = _small_config(True)
    cfg_ov = _small_config(True)
    cfg_ov.autoencoder.overlap_clip_fraction = 0.5
    cfg_ov.validate()
    r_ref = discover(corpus_dir, cfg_ref)
    r_ov = discover(corpus_dir, cfg_ov)

    # segment derivation is phase-split-invariant (index-reuse contract)
    assert [
        (s.clip, s.start_frame, s.end_frame) for s in r_ov.segments
    ] == [(s.clip, s.start_frame, s.end_frame) for s in r_ref.segments]
    assert [c.path for c in r_ov.clips] == [c.path for c in r_ref.clips]
    assert _cluster_purity(r_ov, truth) >= 0.9
    # AE losses materialized from the in-flight futures
    assert r_ov.ae_losses and all(np.isfinite(r_ov.ae_losses))
