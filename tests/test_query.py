"""Query-by-example (query.py): segments of a query WAV must rank corpus
segments of their own planted motif first, via the frozen-embedding +
known-pairs machinery shared with update mode."""

import json
import shutil

import numpy as np
import pytest

from audio_pattern_discovery.config import PipelineConfig
from audio_pattern_discovery.pipeline import discover
from audio_pattern_discovery.query import query_corpus
from audio_pattern_discovery.synthetic import make_corpus


def _cfg(ae: bool = False) -> PipelineConfig:
    cfg = PipelineConfig()
    cfg.spectrogram.sample_rate = 16_000
    cfg.spectrogram.win_length = 256
    cfg.spectrogram.hop_length = 128
    cfg.spectrogram.max_bins = 64
    cfg.segmentation.threshold_db = -25.0
    cfg.segmentation.min_len_frames = 6
    cfg.segmentation.merge_gap_frames = 3
    cfg.autoencoder.enabled = ae
    cfg.autoencoder.epochs = 6
    cfg.autoencoder.hidden_dims = (64,)
    cfg.autoencoder.latent_dim = 8
    cfg.autoencoder.checkpoint = ae
    cfg.dtw.max_seq_len = 64
    cfg.dtw.pair_batch = 128
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    cfg.output.write_snippets = False
    return cfg


def _setup(tmp_path, ae: bool):
    """Index 10 planted clips; hold out clip 10 as the query source."""
    src = tmp_path / "src"
    truth = make_corpus(
        src, n_clips=11, n_motifs=3, occurrences_per_clip=2,
        clip_seconds=2.0, sample_rate=16_000, seed=7,
    )
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    wavs = sorted(src.glob("*.wav"))
    for p in wavs[:10]:
        shutil.copy(p, corpus / p.name)
    cfg = _cfg(ae)
    out = tmp_path / "out"
    result = discover(corpus, cfg, out_dir=out)
    return truth, wavs[10], cfg, out, result


def _motif_of(truth, clip, start_sample, end_sample):
    best, best_ov = None, 0
    for occ in truth:
        if occ.clip != clip:
            continue
        ov = min(end_sample, occ.start + occ.length) - max(start_sample, occ.start)
        if ov > best_ov:
            best, best_ov = occ.motif, ov
    return best


@pytest.mark.parametrize("ae", [False, True])
def test_query_ranks_own_motif_first(tmp_path, ae):
    truth, query_wav, cfg, out, result = _setup(tmp_path, ae)
    hop = cfg.spectrogram.hop_length
    win = cfg.spectrogram.win_length

    report = query_corpus(out, [query_wav], cfg, top_k=5)
    assert report["n_query_segments"] >= 1
    assert report["n_corpus_segments"] == len(result.segments)
    json.dumps(report)

    checked = 0
    for q in report["queries"]:
        q_motif = _motif_of(
            truth, 10, q["start_frame"] * hop, (q["end_frame"] - 1) * hop + win
        )
        if q_motif is None:
            continue
        top = q["matches"][0]
        m_motif = _motif_of(
            truth,
            result.segments[top["segment"]].clip,
            top["start_sample"],
            top["end_sample"],
        )
        assert m_motif == q_motif, (
            f"query motif {q_motif}: top match is motif {m_motif} "
            f"(d={top['distance']})"
        )
        assert top["cluster"] is not None
        checked += 1
    assert checked >= 1


def test_query_rejects_config_drift(tmp_path):
    _, query_wav, cfg, out, _ = _setup(tmp_path, ae=False)
    drifted = _cfg(ae=False)
    drifted.dtw.band = 8
    with pytest.raises(ValueError, match="feature-affecting"):
        query_corpus(out, [query_wav], drifted)


def test_query_detects_stale_distances(tmp_path):
    """The spot check catches a distance matrix that no longer matches the
    recomputed features (here: corrupted on disk)."""
    _, query_wav, cfg, out, _ = _setup(tmp_path, ae=False)
    d_path = out / "distance_matrix.npy"
    np.save(d_path, np.load(d_path) * 3.0 + 1.0)
    with pytest.raises(ValueError, match="drifted"):
        query_corpus(out, [query_wav], cfg)


def test_query_missing_wav_and_state(tmp_path):
    _, query_wav, cfg, out, _ = _setup(tmp_path, ae=False)
    with pytest.raises(FileNotFoundError, match="query wav"):
        query_corpus(out, [tmp_path / "nope.wav"], cfg)
    with pytest.raises(FileNotFoundError, match="state.json"):
        query_corpus(tmp_path / "empty", [query_wav], cfg)


def test_cli_query_flag(tmp_path, capsys):
    from audio_pattern_discovery.cli import main

    _, query_wav, cfg, out, _ = _setup(tmp_path, ae=False)
    cfg_path = tmp_path / "cfg.json"
    cfg.to_json(cfg_path)  # the indexed config, exactly
    args = ["--query", str(query_wav), "-o", str(out), "--top-k", "3",
            "-c", str(cfg_path)]
    assert main(args) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["queries"][0]["matches"]
    assert len(report["queries"][0]["matches"]) <= 3


def test_query_rejects_mismatched_sample_rate(tmp_path):
    """win/hop are in samples: a query at another rate is meaningless and
    must be rejected, not silently ranked."""
    from audio_pattern_discovery.io.wavio import write_wav

    _, _, cfg, out, _ = _setup(tmp_path, ae=False)
    rng = np.random.default_rng(0)
    bad = tmp_path / "q44k.wav"
    write_wav(bad, rng.uniform(-0.5, 0.5, 44_100).astype(np.float32), 44_100)
    with pytest.raises(ValueError, match="sample rate"):
        query_corpus(out, [bad], cfg)


def test_cli_query_conflicts_rejected(tmp_path, capsys):
    from audio_pattern_discovery.cli import main

    with pytest.raises(SystemExit):
        main(["somedir", "--query", "q.wav", "-o", str(tmp_path)])
    assert "--query cannot be combined" in capsys.readouterr().err


def test_scheduling_knobs_not_in_fingerprint(tmp_path):
    """Pure dispatch-size knobs act downstream of distance values; tuning
    them between runs must not force a full recompute."""
    _, query_wav, cfg, out, _ = _setup(tmp_path, ae=False)
    tuned = _cfg(ae=False)
    tuned.dtw.pair_batch = 64          # scheduling only
    tuned.spectrogram.chunk_frames = 1024  # tile size, bit-identical output
    report = query_corpus(out, [query_wav], tuned, top_k=3)
    assert report["queries"][0]["matches"]


def test_query_off_rate_wav_accepted_with_resample_auto(tmp_path):
    """With spectrogram.resample=auto an off-rate query WAV is unified to
    the analysis rate instead of rejected, and still ranks its own motif's
    corpus segments first."""
    from audio_pattern_discovery.io.resample import resample
    from audio_pattern_discovery.io.wavio import read_wav, write_wav

    truth, query_wav, cfg, out, result = _setup(tmp_path, ae=False)
    # Re-encode the held-out query clip at 32 kHz.
    x, r = read_wav(query_wav)
    q32 = tmp_path / "q32k.wav"
    write_wav(q32, resample(x, r, 32_000), 32_000)

    with pytest.raises(ValueError, match="resample"):
        query_corpus(out, [q32], cfg)          # default: rejected, with a hint

    # Following the error's advice works DIRECTLY against the warn-built
    # index: resample is excluded from the feature fingerprint (the corpus
    # clips are already at the analysis rate, so its features are
    # unchanged; the segment-table and spot-check guards would catch any
    # actual drift), and only the query wav gets resampled.
    cfg.spectrogram.resample = "auto"
    report = query_corpus(out, [q32], cfg)
    assert report["n_query_segments"] >= 1
    hop, win = cfg.spectrogram.hop_length, cfg.spectrogram.win_length
    q = report["queries"][0]
    q_motif = _motif_of(
        truth, 10, q["start_frame"] * hop, (q["end_frame"] - 1) * hop + win
    )
    hit = q["matches"][0]
    hit_motif = _motif_of(
        truth, result.segments[hit["segment"]].clip,
        hit["start_sample"], hit["end_sample"],
    )
    assert q_motif is not None and q_motif == hit_motif


def test_fingerprint_forward_compatible_with_default_knobs():
    """Default-valued knobs are dropped from the feature fingerprint, so
    (a) adding a future knob with a behavior-preserving default cannot
    invalidate existing indexes, and (b) the fingerprint still moves when
    a feature-affecting knob actually changes."""
    from audio_pattern_discovery.pipeline import _feature_fingerprint

    base = _feature_fingerprint(_cfg(ae=False))
    # resample is excluded entirely (dynamic guards cover it).
    cfg = _cfg(ae=False)
    cfg.spectrogram.resample = "auto"
    assert _feature_fingerprint(cfg) == base
    # A real feature knob changes the hash.
    cfg = _cfg(ae=False)
    cfg.spectrogram.feature = "mfcc"
    assert _feature_fingerprint(cfg) != base
    cfg = _cfg(ae=False)
    cfg.spectrogram.n_mels = 32
    # n_mels is feature-affecting only when a mel head is on, but it is
    # hashed unconditionally (cheap and conservative).
    assert _feature_fingerprint(cfg) != base
