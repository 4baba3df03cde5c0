"""Query-by-example over an indexed corpus (builds on the SS6.4 update
machinery): given WAV(s) containing a sound of interest, rank the corpus
segments of a prior `discover` run by DTW distance and report their
clusters.

Design: the prior out_dir's `state.json` + `distance_matrix.npy` identify
the corpus and its segmentation; the linear stages re-run deterministically
over corpus + query clips with the embedding model FROZEN from the prior
checkpoint (exactly the update-mode contract, pipeline.discover), and the
pair scheduler's `known=` path computes only query x corpus distances.  A
spot check recomputes a few stored corpus pairs from the fresh features and
compares against the stored matrix, so silent feature drift (modified
files, changed environment) fails loudly instead of returning garbage
rankings.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from audio_pattern_discovery.config import PipelineConfig
from audio_pattern_discovery.io.corpus import StreamingCorpus
from audio_pattern_discovery.utils.logging import get_logger


def spot_check_prior_distances(
    features: np.ndarray,
    lengths: np.ndarray,
    cfg,
    D_old: np.ndarray,
    k_old: int,
    n_pairs: int = 8,
    rtol: float = 5e-3,
    atol: float = 5e-3,
) -> None:
    """Recompute a few prior-pair distances from freshly derived features
    and compare to the stored matrix (scan path, so the check is backend-
    independent; tolerance covers scan-vs-tile kernel float differences).
    Raises ValueError on drift."""
    if k_old < 2:
        return
    import jax.numpy as jnp

    from audio_pattern_discovery.ops.dtw import dtw_batch

    rng = np.random.default_rng(0)
    ii = rng.integers(0, k_old, n_pairs).astype(np.int32)
    jj = rng.integers(0, k_old - 1, n_pairs).astype(np.int32)
    jj = np.where(jj >= ii, jj + 1, jj)  # i != j
    got = np.asarray(
        dtw_batch(
            jnp.asarray(features[ii]),
            jnp.asarray(features[jj]),
            jnp.asarray(lengths[ii]),
            jnp.asarray(lengths[jj]),
            metric=cfg.metric,
            band=cfg.band,
            auto_widen=cfg.auto_widen_band,
            normalize=cfg.normalize,
            band_mode=getattr(cfg, "band_mode", "widen"),
        )
    )
    want = D_old[ii, jj]
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        worst = float(np.abs(got - want).max())
        hint = ""
        if cfg.band is not None:
            hint = (
                "  If the index predates round 5 and was built under the "
                "old banded default, its distances used "
                "dtw.band_mode=widen — try -s dtw.band_mode=widen."
            )
        raise ValueError(
            f"stored distances drifted from recomputed features (max "
            f"|delta| = {worst:.3g} over {n_pairs} spot pairs) — were corpus "
            f"files or the environment modified?  Run a full discovery.{hint}"
        )


def query_corpus(
    prior_out_dir: str | Path,
    query_wavs: list[str | Path],
    config: PipelineConfig | None = None,
    top_k: int = 10,
    logger=None,
) -> dict:
    """Rank a prior run's corpus segments by DTW distance to each segment
    of the query WAV(s).  Returns a JSON-serializable report."""
    from audio_pattern_discovery.models.autoencoder import encode_frames
    from audio_pattern_discovery.parallel.pair_scheduler import (
        all_pairs_distances,
    )
    from audio_pattern_discovery.pipeline import (
        _feature_fingerprint,
        _load_update_state,
        _prepare_corpus,
        _validate_prior_segments,
    )
    from audio_pattern_discovery.utils.logging import StageCounters

    cfg = (config or PipelineConfig()).validate()
    log = logger or get_logger()
    prior = Path(prior_out_dir)
    state, D_old = _load_update_state(prior)
    from audio_pattern_discovery.pipeline import _check_band_mode

    _check_band_mode(state, cfg, "query")
    if state["feature_fingerprint"] != _feature_fingerprint(cfg):
        raise ValueError(
            "query: a feature-affecting config section differs from the "
            "indexed run's — distances would not be comparable"
        )
    if cfg.autoencoder.enabled:
        from audio_pattern_discovery.utils.checkpoint import (
            has_ae_checkpoint,
            has_pca_checkpoint,
            restore_ae_checkpoint,
        )

        _has = (
            has_pca_checkpoint
            if cfg.autoencoder.method == "pca"
            else has_ae_checkpoint
        )
        if not _has(prior / cfg.autoencoder.checkpoint_dir):
            raise ValueError(
                "query: the embedding is enabled but the indexed run "
                "saved no checkpoint (rerun it with "
                "-s autoencoder.checkpoint=true)"
            )

    stored = [Path(p) for p in state["clip_paths"]]
    qpaths = [Path(p) for p in query_wavs]
    for p in qpaths:
        if not p.exists():
            raise FileNotFoundError(f"query wav not found: {p}")
    stream = StreamingCorpus(
        stored[0].parent,
        paths=stored + qpaths,
        resample_to=(
            cfg.spectrogram.sample_rate
            if cfg.spectrogram.resample == "auto"
            else None
        ),
    )

    # win/hop are in SAMPLES: a query recorded at a different rate than the
    # indexed corpus lands its frames on a different time/frequency scale
    # and every distance is meaningless — reject, don't warn (with
    # resample=auto the stream has already unified the rates instead).
    corpus_rates = set(int(r) for r in state["sample_rates"])
    bad = [
        f"{p} ({int(r)} Hz)"
        for p, r in zip(qpaths, stream.sample_rates[len(stored):])
        if int(r) not in corpus_rates
    ]
    if bad:
        raise ValueError(
            f"query wav sample rate differs from the indexed corpus "
            f"({sorted(corpus_rates)} Hz): {', '.join(bad)}; re-run with "
            "-s spectrogram.resample=auto (sound against any index whose "
            "clips are already at the analysis rate — resample is excluded "
            "from the feature fingerprint and drift is caught dynamically) "
            "or resample the query wav yourself first"
        )

    # One shared linear-stage implementation with discover() — index reuse
    # depends on fresh features reproducing the stored derivation exactly.
    segments_counters = StageCounters()
    _, _, segments, seg_frames, seg_frames_dev, seg_lengths = _prepare_corpus(
        cfg, stream, segments_counters, log
    )
    try:
        k_old = _validate_prior_segments(state, segments)
    except ValueError as e:
        raise ValueError(f"query: {e}") from None
    q_segments = segments[k_old:]
    if not q_segments:
        raise ValueError(
            "query: no segments found in the query wav(s); loosen the "
            "segmentation config or check the recording level"
        )

    # Context stacking mirrors discover() exactly (ops/context.py): the
    # fingerprint carries context_frames, so a context-built index is only
    # ever queried with the same k.
    ctx = cfg.autoencoder.context_frames if cfg.autoencoder.enabled else 0

    def _emb_src():
        import jax.numpy as jnp

        src = seg_frames_dev if seg_frames_dev is not None else jnp.asarray(seg_frames)
        if ctx > 0:
            from audio_pattern_discovery.ops.context import stack_context_device

            src = stack_context_device(src, seg_lengths, ctx)
        return src

    if cfg.autoencoder.enabled and cfg.autoencoder.method == "pca":
        from audio_pattern_discovery.models.pca import encode_pca
        from audio_pattern_discovery.utils.checkpoint import (
            restore_pca_checkpoint,
        )

        pca_state, scaler = restore_pca_checkpoint(
            prior / cfg.autoencoder.checkpoint_dir
        )
        features = encode_pca(pca_state, scaler.transform(_emb_src()))
    elif cfg.autoencoder.enabled:
        model, ae_state, scaler = restore_ae_checkpoint(
            prior / cfg.autoencoder.checkpoint_dir,
            cfg.autoencoder,
            seg_frames.shape[-1] * (2 * ctx + 1),
        )
        if scaler is None:
            raise ValueError(
                "query: the indexed checkpoint has no saved feature scaler"
            )
        features = encode_frames(model, ae_state.params, scaler.transform(_emb_src()))
    else:
        features = seg_frames

    feats_np = np.asarray(features)
    spot_check_prior_distances(feats_np, seg_lengths, cfg.dtw, D_old, k_old)

    D = all_pairs_distances(
        feats_np, seg_lengths, cfg.dtw, known=(k_old, D_old)
    )
    log.info(
        f"query: {len(q_segments)} query segment(s) against {k_old} corpus "
        f"segments"
    )

    # Cluster ids from the indexed manifest (segments the prior run dropped
    # as noise carry cluster None).
    seg2cluster: dict[int, int] = {}
    manifest_path = prior / cfg.output.manifest_name
    if manifest_path.exists():
        man = json.loads(manifest_path.read_text())
        for c in man.get("clusters", []):
            for m in c["members"]:
                seg2cluster[int(m["segment"])] = int(c["cluster_id"])

    hop = cfg.spectrogram.hop_length
    win = cfg.spectrogram.win_length
    queries = []
    for qi, seg in enumerate(q_segments):
        dists = D[k_old + qi, :k_old]
        order = np.argsort(dists, kind="stable")[: min(top_k, k_old)]
        matches = []
        for m in order:
            ms = tuple(state["segments"][int(m)])
            matches.append(
                {
                    "segment": int(m),
                    "distance": round(float(dists[m]), 6),
                    "cluster": seg2cluster.get(int(m)),
                    "file": state["clip_paths"][ms[0]],
                    "start_sample": ms[1] * hop,
                    "end_sample": (ms[2] - 1) * hop + win,
                }
            )
        clusters = [m["cluster"] for m in matches if m["cluster"] is not None]
        queries.append(
            {
                "file": str(stream.paths[seg.clip]),
                "start_frame": seg.start_frame,
                "end_frame": seg.end_frame,
                "best_cluster": (
                    max(set(clusters), key=clusters.count) if clusters else None
                ),
                "matches": matches,
            }
        )
    return {
        "n_corpus_segments": k_old,
        "n_query_segments": len(q_segments),
        "queries": queries,
    }
