"""End-to-end discovery pipeline (SURVEY.md SS4.1) — the public entry point.

Preserved interface (BASELINE.json north_star): a directory of WAV files in,
discovered pattern clusters + DTW alignments out.

Host/device split: file I/O, segmentation run-lengths, clustering, and
report writing stay on host; the batched STFT, AE train/encode steps, and
the batched wavefront DTW cross the host<->device boundary once per batch
(SURVEY.md SS4.1 'process/device boundaries').
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from audio_pattern_discovery.cluster.agglomerative import cluster_distance_matrix
from audio_pattern_discovery.config import PipelineConfig
from audio_pattern_discovery.io.corpus import (
    Clip,
    StreamingCorpus,
    load_corpus,
    pad_and_stack,
)
from audio_pattern_discovery.io.wavio import write_wav
from audio_pattern_discovery.models.autoencoder import (
    FeatureScaler,
    encode_frames,
    train_autoencoder,
)
from audio_pattern_discovery.ops.backtrace import paths_from_dirs
from audio_pattern_discovery.ops.dtw import dtw_batch_with_dirs
from audio_pattern_discovery.ops.segmentation import Segment, segment_corpus
from audio_pattern_discovery.ops.spectrogram import spectrogram_corpus
from audio_pattern_discovery.parallel.pair_scheduler import all_pairs_distances
from audio_pattern_discovery.utils.logging import StageCounters, get_logger


class _PreparedSignals:
    """Lazy per-clip upload preparation over a StreamingCorpus.

    Element i is clip i's samples ready for the device tile buffer, per
    `codec`: "int16" for all-PCM16 corpora (exact by the header check —
    read_wav is raw/32768 for PCM16, so round(s*32768) round-trips
    bit-identically), "mulaw8" for 8-bit mu-law of the peak-normalized
    signal (half of int16 again; upload-bandwidth-bound corpora), "f32"
    otherwise (peak-normalized here when the device isn't doing it).
    Peaks record (in place, into .peaks) as clips load; spectrogram_corpus
    always pulls a tile group before slicing its scales, so passing .peaks
    directly as the scales array is safe."""

    def __init__(self, stream: StreamingCorpus, codec: str, normalize: bool):
        self._stream = stream
        self._codec = codec
        self._normalize = normalize
        self._cache: list[np.ndarray | None] = [None] * len(stream)
        self.peaks = np.ones(len(stream), np.float32)

    def __len__(self) -> int:
        return len(self._cache)

    def _get(self, i: int) -> np.ndarray:
        v = self._cache[i]
        if v is None:
            from audio_pattern_discovery.ops.spectrogram import (
                mulaw_encode_host,
            )

            s = self._stream[i].samples
            peak = max(float(np.abs(s).max()) if len(s) else 0.0, 1e-9)
            self.peaks[i] = peak
            if self._codec == "int16":
                v = np.round(s * 32768.0).astype(np.int16)
            elif self._codec == "mulaw8":
                v = mulaw_encode_host(s / peak)
            elif self._normalize:
                v = (s / peak).astype(np.float32)
            else:
                v = s
            self._cache[i] = v
        return v

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(len(self._cache))
            return [self._get(i) for i in range(start, stop, step)]
        return self._get(idx)


@dataclass
class ClusterReport:
    cluster_id: int
    exemplar: int                      # segment index of the medoid
    members: list[int]                 # segment indices
    alignments: dict[int, list[tuple[int, int]]] = field(default_factory=dict)


@dataclass
class DiscoveryResult:
    config: PipelineConfig
    clips: list[Clip]
    segments: list[Segment]
    seg_features: np.ndarray           # [K, L, d] padded DTW features
    seg_spectrograms: np.ndarray       # [K, L, bins] raw (log) spectrogram cuts
    seg_lengths: np.ndarray            # [K]
    distance_matrix: np.ndarray        # [K, K]
    labels: np.ndarray                 # [K] flat cluster labels (0-based)
    clusters: list[ClusterReport]
    ae_losses: list[float]
    counters: StageCounters

    def manifest(self) -> dict:
        """The cluster+alignment manifest (SS3 row 8)."""
        hop = self.config.spectrogram.hop_length
        win = self.config.spectrogram.win_length
        clusters = []
        for rep in self.clusters:
            members = []
            for m in rep.members:
                seg = self.segments[m]
                clip = self.clips[seg.clip]
                members.append(
                    {
                        "segment": m,
                        "file": clip.path,
                        "sample_rate": clip.sample_rate,
                        "start_frame": seg.start_frame,
                        "end_frame": seg.end_frame,
                        "start_sample": seg.start_frame * hop,
                        "end_sample": (seg.end_frame - 1) * hop + win,
                        "is_exemplar": m == rep.exemplar,
                    }
                )
            clusters.append(
                {
                    "cluster_id": rep.cluster_id,
                    "exemplar": rep.exemplar,
                    "members": members,
                    "alignments": {
                        str(m): path for m, path in rep.alignments.items()
                    },
                }
            )
        from audio_pattern_discovery.cluster.metrics import cluster_quality

        quality = cluster_quality(self.distance_matrix, self.labels)
        for c in clusters:
            c["quality"] = quality["clusters"].get(
                int(self.labels[c["exemplar"]]), {}
            )
        return {
            "n_clips": len(self.clips),
            "n_segments": len(self.segments),
            "n_clusters": len(self.clusters),
            "silhouette_mean": quality["silhouette_mean"],
            "clusters": clusters,
            "ae_losses": [round(x, 6) for x in self.ae_losses],
            "counters": self.counters.to_dict(),
        }


def _flat_frames(
    seg_frames: np.ndarray,        # [K, L, bins]
    seg_lengths: np.ndarray,
    n_segments: int,
    ctx: int,
) -> np.ndarray:
    """All real (unpadded) segment frames as one [N, dim] training pool —
    (2k+1)-frame context slices when ctx > 0 (ops/context.py)."""
    if ctx > 0:
        from audio_pattern_discovery.ops.context import flat_context

        return flat_context(seg_frames, seg_lengths, ctx)
    return np.concatenate(
        [seg_frames[k, : seg_lengths[k]] for k in range(n_segments)]
    )


def extract_segment_features(
    spectrograms: np.ndarray,      # [B, F, bins]
    segments: list[Segment],
    max_len: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Cut per-segment frame sequences and pad to [K, L, bins]."""
    seqs = [
        spectrograms[s.clip, s.start_frame : min(s.end_frame, s.start_frame + max_len)]
        for s in segments
    ]
    return pad_and_stack(seqs, pad_to=max_len)


def extract_segment_features_device(
    specs_dev,                     # [B, F, bins] device-resident
    segments: list[Segment],
    max_len: int,
):
    """Device-side equivalent of extract_segment_features: one batched
    gather + mask, so the full spectrogram corpus never crosses to host
    (only segments do, and only when the caller asks)."""
    F = specs_dev.shape[1]
    clip_idx = np.array([s.clip for s in segments], np.int32)
    starts = np.array([s.start_frame for s in segments], np.int32)
    lengths = np.minimum(
        np.array([s.end_frame - s.start_frame for s in segments], np.int32),
        max_len,
    )
    frame_idx = np.minimum(
        starts[:, None] + np.arange(max_len, dtype=np.int32)[None, :], F - 1
    )                                                            # [K, L]
    seg = specs_dev[jnp.asarray(clip_idx)[:, None], jnp.asarray(frame_idx)]
    mask = np.arange(max_len, dtype=np.int32)[None, :] < lengths[:, None]
    seg = jnp.where(jnp.asarray(mask)[:, :, None], seg, 0.0)
    return seg, lengths


def _medoid(D: np.ndarray, members: list[int]) -> int:
    sub = D[np.ix_(members, members)]
    return members[int(np.argmin(sub.sum(axis=1)))]


def _feature_fingerprint(cfg: PipelineConfig) -> str:
    """Hash of the config knobs that determine segment features and DTW
    distance VALUES.  Incremental update/query reuse a prior run's distance
    matrix, which is only sound while these are unchanged.  Excluded on
    purpose: cluster/output/parallel sections (downstream of D), pure
    scheduling knobs (dtw.pair_batch, dtw.length_bucketing; spectrogram
    clip_batch/chunk_frames/max_resident_bytes — tile-vs-single-shot bit
    identity is a tested invariant), AE checkpointing flags, and the whole
    AE section when the AE is disabled — so tuning dispatch sizes between
    runs does not force a full K^2 recompute.

    Forward compatibility: keys whose value equals the dataclass DEFAULT
    are dropped from the payload, so adding a new feature knob (with a
    default that preserves behavior) does not invalidate every existing
    index — only actually-changed knobs enter the hash.  spectrogram.
    resample is excluded entirely: it only affects features through the
    clips' actual rates, and real drift is caught by the stronger dynamic
    guards (the stored segment-table comparison and the spot-check
    re-computation of stored distances)."""
    import dataclasses
    import hashlib

    def nondefault(section) -> dict:
        d = dataclasses.asdict(section)
        for f in dataclasses.fields(section):
            default = (
                f.default_factory()
                if f.default_factory is not dataclasses.MISSING
                else f.default
            )
            if f.name in d and d[f.name] == default:
                d.pop(f.name)
        return d

    sp = nondefault(cfg.spectrogram)
    for k in ("clip_batch", "chunk_frames", "max_resident_bytes", "resample"):
        sp.pop(k, None)
    dt = nondefault(cfg.dtw)
    for k in ("pair_batch", "length_bucketing"):
        dt.pop(k, None)
    ae = nondefault(cfg.autoencoder)
    if cfg.autoencoder.enabled:
        for k in ("checkpoint", "checkpoint_dir"):
            ae.pop(k, None)
    else:
        ae = {"enabled": False}
    payload = repr((sp, nondefault(cfg.segmentation), ae, dt))
    return hashlib.sha1(payload.encode()).hexdigest()


def _check_band_mode(state: dict, cfg: PipelineConfig, what: str) -> None:
    """Targeted band-semantics guard for index reuse (ADVICE r4).

    The prior run's state.json records the band_mode its distances were
    computed under (None when band was None).  A banded job whose current
    mode differs gets an actionable error naming the fix, instead of the
    generic spot-check drift failure it would otherwise hit.  Pre-round-5
    indexes lack the key — those fall through to the dynamic spot check,
    whose message names band_mode as a plausible cause for banded jobs.
    """
    if cfg.dtw.band is None or "band_mode" not in state:
        return
    stored = state["band_mode"]
    current = cfg.dtw.band_mode
    if stored is not None and stored != current:
        raise ValueError(
            f"{what}: the prior index was computed with "
            f"dtw.band_mode={stored!r} but this run uses "
            f"dtw.band_mode={current!r} — banded distances are not "
            f"comparable across modes.  Re-run with "
            f"-s dtw.band_mode={stored} to reuse the index, or run a "
            f"full discovery to rebuild it under the new mode."
        )


def _prepare_corpus(
    cfg: PipelineConfig,
    stream: StreamingCorpus,
    counters: StageCounters,
    log,
    devices=None,
):
    """Codec selection -> streaming spectrogram tiles -> energy
    segmentation -> per-segment frame extraction.

    Shared by discover() and query.query_corpus: index reuse (SS6.4) rests
    on fresh features reproducing the stored distances byte-for-byte, so
    this derivation must have exactly ONE implementation.

    Returns (clips, frame_counts, segments, seg_frames, seg_frames_dev,
    seg_lengths); seg_frames_dev is the device-resident copy and is None
    unless the AE will consume it (cfg.autoencoder.enabled).
    """
    # PCM16 sources ship to the device as int16 (half the upload
    # bandwidth — the dominant cost for long recordings on a remote
    # backend); decode + per-clip normalization happen on device with
    # bit-identical results (x/32768 is a power-of-two scale, and the
    # /peak division matches the host's).  Plain 16-bit PCM is exactly
    # int16-representable by construction (read_wav = raw/32768), so
    # the header check suffices; anything else keeps the f32 path.
    if cfg.spectrogram.upload_codec == "mulaw8":
        codec = "mulaw8"
    elif stream.all_pcm16:
        codec = "int16"
    else:
        codec = "f32"
    sigs = _PreparedSignals(
        stream, codec=codec, normalize=cfg.spectrogram.normalize_signal
    )
    # scales semantics follow the codec (ops/spectrogram tile decode):
    # int16 DIVIDES by peak (device-side normalization); mulaw8 signals
    # are already peak-normalized, so scales MULTIPLY to restore
    # amplitude only when the pipeline is NOT normalizing.
    # sigs.peaks is filled lazily as clips load; spectrogram_corpus
    # always pulls a tile group before slicing its scales, so passing
    # the (in-place mutated) array directly is safe.
    if codec == "int16" and cfg.spectrogram.normalize_signal:
        scales = sigs.peaks
    elif codec == "mulaw8" and not cfg.spectrogram.normalize_signal:
        scales = sigs.peaks
    else:
        scales = None
    rates = np.unique(stream.sample_rates)
    n_resampled = int(getattr(stream, "_resample_mask", np.zeros(0, bool)).sum())
    if n_resampled:
        orig = np.unique(stream.original_rates)
        log.info(
            f"resampling {n_resampled}/{len(stream)} clip(s) "
            f"{sorted(int(r) for r in orig if r != cfg.spectrogram.sample_rate)}"
            f" Hz -> {cfg.spectrogram.sample_rate} Hz (spectrogram.resample="
            "auto)"
        )
    elif len(rates) > 1:
        log.warning(
            f"corpus mixes sample rates {rates.tolist()}: frame times and "
            "DTW distances are not comparable across rates — set "
            "spectrogram.resample=auto or resample to one rate (config "
            f"expects {cfg.spectrogram.sample_rate} Hz)"
        )
    elif int(rates[0]) != cfg.spectrogram.sample_rate:
        log.warning(
            f"corpus sample rate {int(rates[0])} != configured "
            f"spectrogram.sample_rate {cfg.spectrogram.sample_rate}; "
            "window/hop lengths are in samples, so frame durations will "
            "differ from the configured intent (spectrogram.resample=auto "
            "converts instead)"
        )
    log.info(
        f"probed headers of {len(stream)} clips"
        + ({"int16": " (PCM16: int16 device upload)",
            "mulaw8": " (mu-law int8 device upload)"}.get(codec, ""))
    )

    # The full spectrogram corpus stays device-resident when it fits HBM;
    # only the (tiny) energy matrix crosses to host for segmentation, and
    # later only the segment cuts (SS4.1 host<->device boundary note).
    # Corpora too large for a resident [B, F_max, bins] tensor (hours-long
    # recordings, BASELINE config 5) fall back to host assembly, which is
    # bounded by host RAM, not HBM.
    from audio_pattern_discovery.ops.spectrogram import num_frames

    f_max_est = max(
        num_frames(int(n), cfg.spectrogram.win_length, cfg.spectrogram.hop_length)
        for n in stream.sample_lengths
    )
    resident_bytes = 4 * len(stream) * f_max_est * cfg.spectrogram.feature_dim
    on_device = resident_bytes <= cfg.spectrogram.max_resident_bytes
    with counters.time_stage("spectrogram"):
        specs_any, frame_counts, energies = spectrogram_corpus(
            sigs,
            cfg.spectrogram,
            clip_batch=cfg.spectrogram.clip_batch,
            chunk_frames=cfg.spectrogram.chunk_frames,
            return_device=on_device,
            scales=scales,
            sig_lengths=stream.sample_lengths,
            # Clip groups round-robin over the data-axis devices (DFT
            # compute scales with the slice; bit-identical results — see
            # spectrogram_corpus).  The resident corpus collects onto
            # devices[0], whose HBM feeds the segment gather.
            devices=devices,
        )
    # All clips have been pulled through the stream by now; the full list
    # backs snippet extraction and the result object.
    clips = stream.materialize()

    with counters.time_stage("segmentation"):
        segments = segment_corpus(energies, frame_counts, cfg.segmentation)

    if on_device:
        seg_frames_dev, seg_lengths = extract_segment_features_device(
            specs_any, segments, cfg.dtw.max_seq_len
        )
        # One download of the segment cuts (AE scaler/train + cluster
        # images); the device copy feeds encode without a re-upload.
        seg_frames = np.asarray(seg_frames_dev)
    else:
        seg_frames, seg_lengths = extract_segment_features(
            specs_any, segments, cfg.dtw.max_seq_len
        )
        # Only the AE encode consumes the device copy; don't upload it
        # (or keep it resident through DTW) in raw-feature mode.
        seg_frames_dev = (
            jnp.asarray(seg_frames) if cfg.autoencoder.enabled else None
        )
    if not cfg.autoencoder.enabled:
        seg_frames_dev = None
    # The resident corpus is not needed past the segment gather; free the
    # HBM before the AE/DTW stages (the real HBM consumers).
    del specs_any
    return clips, frame_counts, segments, seg_frames, seg_frames_dev, seg_lengths


def _validate_prior_segments(
    update_state: dict, segments: list[Segment]
) -> int:
    """The corpus prefix must reproduce the stored segment table exactly —
    at the same indices (prior clips lead the clip order, and segmentation
    is per-clip and deterministic).  A mismatch means a prior file's
    CONTENT changed.  Returns k_old."""
    n_old_clips = len(update_state["clip_paths"])
    old_table = [tuple(s) for s in update_state["segments"]]
    k_old = len(old_table)
    got = [(s.clip, s.start_frame, s.end_frame) for s in segments[:k_old]]
    if got != old_table or any(
        s.clip < n_old_clips for s in segments[k_old:]
    ):
        raise ValueError(
            "the prior clips segment differently than the stored table — "
            "were their files modified?  Stored distances would not match; "
            "run a full discovery instead"
        )
    return k_old


def _load_update_state(update_from: Path) -> tuple[dict, np.ndarray]:
    state_path = update_from / "state.json"
    d_path = update_from / "distance_matrix.npy"
    if not state_path.exists() or not d_path.exists():
        raise FileNotFoundError(
            f"--update needs a prior run's state.json + distance_matrix.npy "
            f"under {update_from}; run a full discovery there first"
        )
    state = json.loads(state_path.read_text())
    D_old = np.load(d_path)
    if D_old.shape != (len(state["segments"]),) * 2:
        raise ValueError(
            f"{d_path}: shape {D_old.shape} does not match the "
            f"{len(state['segments'])} segments recorded in state.json"
        )
    return state, D_old


def discover(
    wav_dir: str | Path,
    config: PipelineConfig | None = None,
    out_dir: str | Path | None = None,
    logger=None,
    update_from: str | Path | None = None,
) -> DiscoveryResult:
    """Run the full discovery pipeline over a directory of WAV files.

    `update_from`: incremental corpus growth (SS6.4) — point at a prior
    run's out_dir (state.json + distance_matrix.npy) and only DTW pairs
    touching clips added since that run are computed; the quadratic stage's
    cost scales with the new-pair share instead of K^2.  The linear stages
    (spectrogram, segmentation, AE *encode*) re-run over the whole corpus —
    they are deterministic, so prior distances stay byte-valid — and the
    embedding model is FROZEN from the prior run (its checkpoint is
    restored, never retrained), which is what makes distance reuse sound.
    Requires: the feature-affecting config sections unchanged, all prior
    WAVs still present, and (with the AE enabled) a prior run that saved
    its checkpoint (autoencoder.checkpoint=true).
    """
    cfg = (config or PipelineConfig()).validate()
    log = logger or get_logger()
    counters = StageCounters()

    update_state: dict | None = None
    D_old: np.ndarray | None = None
    k_old = 0
    if update_from is not None:
        update_from = Path(update_from)
        update_state, D_old = _load_update_state(update_from)
        _check_band_mode(update_state, cfg, "update_from")
        fp = _feature_fingerprint(cfg)
        if update_state["feature_fingerprint"] != fp:
            raise ValueError(
                "update_from: a feature-affecting config section "
                "(spectrogram/segmentation/autoencoder/dtw) differs from the "
                "prior run's — the stored distances would not match; run a "
                "full discovery instead"
            )
        if cfg.autoencoder.enabled:
            from audio_pattern_discovery.utils.checkpoint import (
                has_ae_checkpoint,
                has_pca_checkpoint,
            )

            has_ckpt = (
                has_pca_checkpoint(update_from / cfg.autoencoder.checkpoint_dir)
                if cfg.autoencoder.method == "pca"
                else has_ae_checkpoint(update_from / cfg.autoencoder.checkpoint_dir)
            )
            if not has_ckpt:
                raise ValueError(
                    "update_from: the embedding is enabled but the prior "
                    "run saved no checkpoint — the frozen embedding model is "
                    "required to reuse its distances (rerun the full "
                    "discovery with -s autoencoder.checkpoint=true)"
                )

    # Multi-chip (SS3 rows 9-10): pair blocks round-robin across all data-
    # axis devices; AE minibatches shard over the same axis (the gradient
    # all-reduce is an XLA collective).  Single-device runs are unaffected.
    import jax

    all_devices = jax.devices()
    n_data = (
        len(all_devices)
        if cfg.parallel.data_axis < 0
        else min(cfg.parallel.data_axis * max(cfg.parallel.model_axis, 1), len(all_devices))
    )
    dtw_devices = list(all_devices[:n_data]) if n_data > 1 else None
    ae_sharding = None
    ae_param_fn = None
    if n_data > 1:
        from audio_pattern_discovery.parallel.mesh import (
            ae_param_sharding,
            data_sharding,
            make_mesh,
        )

        mesh = make_mesh(cfg.parallel, devices=all_devices)
        ae_sharding = data_sharding(mesh)
        if cfg.parallel.model_axis > 1:
            # TP over the AE hidden dim: initial params are placed with the
            # "model"-axis layout; optimizer state and the scan carry inherit
            # it, so XLA keeps activations sharded through the hidden layers
            # (exercised multi-virtual-device in tests/test_sharding.py and
            # __graft_entry__.dryrun_multichip).
            ae_param_fn = lambda p: ae_param_sharding(mesh, p)  # noqa: E731
            log.info(
                f"mesh {dict(zip(mesh.axis_names, mesh.devices.shape))}: "
                "DP over data axis, AE TP over model axis"
            )
        else:
            log.info(f"data-parallel over {n_data} devices")

    # ---- L0: ingest (streaming: headers now, samples as tiles consume) ---
    # WAV headers are probed up front (milliseconds — lengths, rates, and
    # format tags are all the tile scheduler needs); sample data then loads
    # chunk-by-chunk exactly when the spectrogram stage's next tile group
    # needs it, hiding file IO behind the device upload/compute pipeline
    # instead of serializing ~O(corpus) seconds in front of it (VERDICT r2
    # missing #3).  The ingest stage timer therefore covers only header
    # probing; clip IO lands inside the (overlapped) spectrogram stage.
    with counters.time_stage("ingest"):
        ordered_paths = None
        if update_state is not None:
            # Prior clips keep their original indices (stored order); new
            # files append after them in sorted order.  A plain re-sorted
            # glob would interleave new files and shift every old index.
            stored = [Path(p) for p in update_state["clip_paths"]]
            listing = sorted(Path(wav_dir).glob("*.wav"))
            listing_resolved = {p.resolve() for p in listing}
            missing = [str(p) for p in stored if p.resolve() not in listing_resolved]
            if missing:
                raise ValueError(
                    f"update_from: {len(missing)} clip(s) from the prior run "
                    f"are no longer under {wav_dir} (e.g. {missing[0]}); "
                    "removing clips invalidates the stored distances — run a "
                    "full discovery instead"
                )
            old_resolved = {p.resolve() for p in stored}
            new_paths = [p for p in listing if p.resolve() not in old_resolved]
            ordered_paths = stored + new_paths
            log.info(
                f"update: {len(stored)} prior clips, {len(new_paths)} new"
            )
        stream = StreamingCorpus(
            wav_dir,
            paths=ordered_paths,
            resample_to=(
                cfg.spectrogram.sample_rate
                if cfg.spectrogram.resample == "auto"
                else None
            ),
        )
    counters.add("clips", len(stream))

    # ---- L1+L4: spectrograms -> segmentation -> segment frames ----------
    # (one shared implementation with query.query_corpus — index reuse
    # depends on this derivation being identical; see _prepare_corpus)
    #
    # Upload/training overlap (autoencoder.overlap_clip_fraction, BASELINE
    # config 5): the corpus runs through the SAME derivation in two
    # contiguous phases; after phase 1 the AE launches asynchronously on
    # the first clips' segment frames (whole-epoch dispatches, nothing
    # materialized), so the device interleaves epoch programs with phase
    # 2's spectrogram tiles and training hides inside the upload-bound
    # stage.  Segmentation is per-clip, so the merged segment table is
    # identical to the single-phase run; only the AE's training pool (and
    # therefore the learned embedding) differs — the knob is opt-in and
    # quality-gated, not bit-identical (config.py docstring).
    pre_train = None          # (model, state, loss_futs, scaler)
    frac = cfg.autoencoder.overlap_clip_fraction
    two_phase = (
        0.0 < frac < 1.0
        and cfg.autoencoder.enabled
        and cfg.autoencoder.method == "ae"
        and update_state is None
        and len(stream) >= 2
    )
    if two_phase and cfg.autoencoder.checkpoint and out_dir is not None:
        from audio_pattern_discovery.utils.checkpoint import (
            has_ae_checkpoint,
        )

        # A restorable checkpoint means training never runs — keep the
        # cheaper single-phase derivation.
        if has_ae_checkpoint(Path(out_dir) / cfg.autoencoder.checkpoint_dir):
            two_phase = False
    if two_phase:
        m = max(1, min(len(stream) - 1, int(np.ceil(frac * len(stream)))))
        c1, fc1, segs1, sf1, sfd1, sl1 = _prepare_corpus(
            cfg, stream.view(0, m), counters, log, devices=dtw_devices
        )
        if len(segs1) >= 2:
            ctx0 = cfg.autoencoder.context_frames
            flat1 = _flat_frames(sf1, sl1, len(segs1), ctx0)
            scaler1 = FeatureScaler.fit(flat1)
            model1, state1, loss_futs = train_autoencoder(
                scaler1.transform(flat1).astype(np.float32),
                cfg.autoencoder,
                logger=None,          # logging would sync mid-overlap
                data_sharding=ae_sharding,
                param_shardings=ae_param_fn,
                sync_losses=False,
            )
            pre_train = (model1, state1, loss_futs, scaler1)
            log.info(
                f"overlap: AE training launched on {len(segs1)} segments "
                f"from the first {m}/{len(stream)} clips; remaining "
                "spectrogram uploads proceed under it"
            )
        else:
            log.warning(
                f"overlap: only {len(segs1)} segment(s) in the first "
                f"{m} clips — training deferred to the full corpus"
            )
        c2, fc2, segs2, sf2, sfd2, sl2 = _prepare_corpus(
            cfg, stream.view(m, len(stream)), counters, log,
            devices=dtw_devices,
        )
        clips = c1 + c2
        frame_counts = np.concatenate([fc1, fc2])
        segments = segs1 + [
            Segment(s.clip + m, s.start_frame, s.end_frame) for s in segs2
        ]
        # Both phases pad to the static cfg.dtw.max_seq_len, so the
        # segment tensors concatenate directly (host and device copies).
        seg_frames = np.concatenate([sf1, sf2])
        seg_lengths = np.concatenate([sl1, sl2])
        seg_frames_dev = (
            jnp.concatenate([sfd1, sfd2])
            if sfd1 is not None and sfd2 is not None
            else None
        )
        del sf1, sf2, sfd1, sfd2
    else:
        clips, frame_counts, segments, seg_frames, seg_frames_dev, seg_lengths = (
            _prepare_corpus(cfg, stream, counters, log, devices=dtw_devices)
        )
    counters.add("frames", float(frame_counts.sum()))
    counters.add("segments", len(segments))
    log.info(f"segmented into {len(segments)} candidates")
    if len(segments) < 2:
        raise ValueError(
            f"only {len(segments)} segments found; loosen segmentation config"
        )
    if update_state is not None:
        try:
            k_old = _validate_prior_segments(update_state, segments)
        except ValueError as e:
            raise ValueError(f"update_from: {e}") from None

    # ---- L3: embedding (device) -----------------------------------------
    # Temporal context (autoencoder.context_frames): the embedder consumes
    # (2k+1)-frame spectrogram SLICES instead of single frames — stacked on
    # device from the resident segment tensor; seg_frames itself stays raw
    # (it also feeds images/snippets).  ops/context.py for the boundary rule.
    ctx = cfg.autoencoder.context_frames if cfg.autoencoder.enabled else 0
    emb_frames_dev = seg_frames_dev
    if ctx > 0:
        from audio_pattern_discovery.ops.context import (
            flat_context,
            stack_context_device,
        )

        with counters.time_stage("context_stack"):
            emb_frames_dev = stack_context_device(seg_frames_dev, seg_lengths, ctx)
    ae_losses: list[float] = []
    if cfg.autoencoder.enabled and cfg.autoencoder.method == "pca":
        # Linear PCA(-whitening) embedder: covariance on device, eigensolve
        # on host, projection on device (models/pca.py).  Shares the AE's
        # checkpoint/update contract — the frozen projection is what keeps
        # reused distances valid.
        from audio_pattern_discovery.models.pca import encode_pca, fit_pca
        from audio_pattern_discovery.utils.checkpoint import (
            has_pca_checkpoint,
            restore_pca_checkpoint,
            save_pca_checkpoint,
        )

        ckpt_dir = None
        if cfg.autoencoder.checkpoint and out_dir is not None:
            ckpt_dir = Path(out_dir) / cfg.autoencoder.checkpoint_dir
        restore_dir = (
            update_from / cfg.autoencoder.checkpoint_dir
            if update_state is not None
            else ckpt_dir
        )
        with counters.time_stage("embedding_fit"):
            if restore_dir is not None and has_pca_checkpoint(restore_dir):
                pca_state, scaler = restore_pca_checkpoint(restore_dir)
                log.info(f"restored PCA embedding from {restore_dir}")
                if (
                    ckpt_dir is not None
                    and Path(ckpt_dir).resolve() != Path(restore_dir).resolve()
                ):
                    save_pca_checkpoint(ckpt_dir, pca_state, scaler)
            else:
                if ctx > 0:
                    flat = flat_context(seg_frames, seg_lengths, ctx)
                else:
                    flat = np.concatenate(
                        [seg_frames[k, : seg_lengths[k]] for k in range(len(segments))]
                    )
                scaler = FeatureScaler.fit(flat)
                pca_state = fit_pca(
                    scaler.transform(flat).astype(np.float32),
                    cfg.autoencoder.latent_dim,
                    whiten=cfg.autoencoder.pca_whiten,
                )
                log.info(
                    f"PCA embedding: {cfg.autoencoder.latent_dim} components "
                    f"capture {100 * float(pca_state.explained.sum()):.1f}% "
                    "of frame variance"
                )
                if ckpt_dir is not None:
                    save_pca_checkpoint(ckpt_dir, pca_state, scaler)
        with counters.time_stage("embedding_encode"):
            features = encode_pca(pca_state, scaler.transform(emb_frames_dev))
        seg_frames_dev = emb_frames_dev = None
    elif cfg.autoencoder.enabled:
        ckpt_dir = None
        if cfg.autoencoder.checkpoint and out_dir is not None:
            ckpt_dir = Path(out_dir) / cfg.autoencoder.checkpoint_dir
        # Update mode restores the PRIOR run's checkpoint regardless of this
        # run's checkpoint flag: the frozen embedding (params + scaler) is
        # what keeps the reused distances valid.
        restore_dir = (
            update_from / cfg.autoencoder.checkpoint_dir
            if update_state is not None
            else ckpt_dir
        )
        with counters.time_stage("autoencoder_train"):
            # Train on the real (unpadded) frames of all segments.  Built
            # lazily: a restored checkpoint with its saved scaler (the
            # normal restore and ALWAYS the update path) never consumes it,
            # and at contract scale the concatenation is hundreds of MB of
            # dead host work on the one-core machine.
            def _flat() -> np.ndarray:
                return _flat_frames(seg_frames, seg_lengths, len(segments), ctx)

            restored = False
            if restore_dir is not None:
                from audio_pattern_discovery.utils.checkpoint import (
                    has_ae_checkpoint,
                    restore_ae_checkpoint,
                    save_ae_checkpoint,
                )

                if has_ae_checkpoint(restore_dir):
                    model, state, saved_scaler = restore_ae_checkpoint(
                        restore_dir,
                        cfg.autoencoder,
                        seg_frames.shape[-1] * (2 * ctx + 1),
                    )
                    if update_state is not None and saved_scaler is None:
                        raise ValueError(
                            "update_from: the prior checkpoint has no saved "
                            "feature scaler; refitting on the grown corpus "
                            "would shift every embedding — run a full "
                            "discovery instead"
                        )
                    scaler = saved_scaler or FeatureScaler.fit(_flat())
                    restored = True
                    log.info(f"restored AE checkpoint from {restore_dir}")
                    if (
                        ckpt_dir is not None
                        and Path(ckpt_dir).resolve() != Path(restore_dir).resolve()
                    ):
                        save_ae_checkpoint(ckpt_dir, state, scaler)
            if not restored and pre_train is not None:
                # Overlap mode: training launched mid-corpus; the stage
                # timer below measures only the residual drain — epochs
                # already retired under phase 2's uploads cost nothing
                # here (that delta IS the overlap, visible in the stage
                # table).
                model, state, loss_futs, scaler = pre_train
                ae_losses = [float(x) for x in loss_futs]
                if ckpt_dir is not None:
                    from audio_pattern_discovery.utils.checkpoint import (
                        save_ae_checkpoint as _save_ae,
                    )

                    _save_ae(ckpt_dir, state, scaler)
            elif not restored:
                flat = _flat()
                scaler = FeatureScaler.fit(flat)
                model, state, ae_losses = train_autoencoder(
                    scaler.transform(flat).astype(np.float32),
                    cfg.autoencoder,
                    logger=log,
                    data_sharding=ae_sharding,
                    param_shardings=ae_param_fn,
                )
                if ckpt_dir is not None:
                    save_ae_checkpoint(ckpt_dir, state, scaler)
        with counters.time_stage("autoencoder_encode"):
            # Standardize on device from the resident segment tensor — no
            # re-upload of [K, L, bins] (transform works on jax arrays).
            features = encode_frames(model, state.params, scaler.transform(emb_frames_dev))
        seg_frames_dev = emb_frames_dev = None
    else:
        features = seg_frames
    counters.add("feature_dim", features.shape[-1])

    if update_state is not None:
        # Cheap drift guard before committing to reuse: recompute a few
        # stored pairs from the fresh features and compare to D_old
        # (catches environment/backend drift the segment-table check
        # can't — same guard the query path uses).
        from audio_pattern_discovery.query import (
            spot_check_prior_distances,
        )

        spot_check_prior_distances(
            np.asarray(features), seg_lengths, cfg.dtw, D_old, k_old
        )

    # ---- L2: all-pairs wavefront DTW (device, the hot loop) -------------
    with counters.time_stage("dtw"):
        block_dir = None
        if cfg.parallel.checkpoint_blocks and out_dir is not None:
            block_dir = Path(out_dir) / cfg.parallel.block_dir
        D = all_pairs_distances(
            features, seg_lengths, cfg.dtw, block_dir=block_dir,
            devices=dtw_devices,
            known=None if update_state is None else (k_old, D_old),
        )
    n_pairs = len(segments) * (len(segments) - 1) // 2
    if update_state is not None:
        reused = k_old * (k_old - 1) // 2
        n_pairs -= reused
        counters.add("dtw_pairs_reused", reused)
    counters.add("dtw_pairs", n_pairs)
    dtw_s = counters.timings_s.get("dtw", 0.0)
    if dtw_s > 0:
        counters.add("dtw_pairs_per_sec", n_pairs / dtw_s)

    # ---- L2: clustering (host) ------------------------------------------
    with counters.time_stage("clustering"):
        ccfg = cfg.cluster
        thr = ccfg.distance_threshold
        if thr is None and ccfg.n_clusters is None:
            # Default data-driven cut (deterministic; explicit threshold /
            # n_clusters override): first-relative-gap-over-threshold rule
            # with quantile fallback — see
            # cluster.agglomerative.auto_cut_threshold.  One linkage pass
            # serves both the cut choice and the labels.
            from audio_pattern_discovery.cluster.agglomerative import (
                auto_cut_threshold,
                cut_linkage,
                linkage,
            )

            Z = linkage(D, ccfg.linkage, use_native=ccfg.use_native)
            thr = auto_cut_threshold(
                Z,
                quantile=ccfg.auto_cut_quantile,
                min_rel_gap=(
                    ccfg.auto_cut_min_rel_gap if ccfg.auto_cut == "gap" else np.inf
                ),
            )
            labels = cut_linkage(Z, D.shape[0], distance_threshold=thr)
        else:
            labels, _ = cluster_distance_matrix(
                D,
                ccfg.linkage,
                distance_threshold=thr,
                n_clusters=ccfg.n_clusters,
                use_native=ccfg.use_native,
            )
    counters.add("clusters_raw", len(np.unique(labels)))

    # ---- L5: motif extraction + alignments ------------------------------
    with counters.time_stage("extraction"):
        clusters = _extract_clusters(
            D, labels, features, seg_lengths, cfg
        )
    counters.add("clusters", len(clusters))
    log.info(f"discovered {len(clusters)} pattern clusters")

    result = DiscoveryResult(
        config=cfg,
        clips=clips,
        segments=segments,
        seg_features=features,
        seg_spectrograms=seg_frames,
        seg_lengths=seg_lengths,
        distance_matrix=D,
        labels=labels,
        clusters=clusters,
        ae_losses=ae_losses,
        counters=counters,
    )
    if out_dir is not None:
        write_artifacts(result, out_dir)
    return result


def _extract_clusters(
    D: np.ndarray,
    labels: np.ndarray,
    features: np.ndarray,
    seg_lengths: np.ndarray,
    cfg: PipelineConfig,
) -> list[ClusterReport]:
    """Medoid exemplars + exemplar<->member alignments per cluster."""
    reports: list[ClusterReport] = []
    order = []
    for lab in np.unique(labels):
        members = np.flatnonzero(labels == lab).tolist()
        if len(members) < cfg.cluster.min_cluster_size:
            continue
        order.append((len(members), -int(lab), members))
    # Stable output ids: biggest clusters first (reference-style reporting).
    order.sort(reverse=True)

    for new_id, (_, _, members) in enumerate(order):
        exemplar = _medoid(D, members)
        rep = ClusterReport(cluster_id=new_id, exemplar=exemplar, members=members)
        if cfg.output.write_alignments and len(members) > 1:
            others = [m for m in members if m != exemplar]
            rep.alignments = _cluster_alignments(
                exemplar, others, features, seg_lengths, cfg
            )
        reports.append(rep)
    return reports


# The with-dirs DTW materializes O(B * (N+M) * M) device bytes (uint8 dirs +
# f32 cost/skew intermediates, ~16 bytes per DP cell all told).  Without a
# guard a 64-member cluster at max_seq_len=1024 silently dispatches a
# multi-GiB program; chunking keeps every dispatch under this budget
# (SURVEY.md SS8 'backtrace memory').
_ALIGN_BYTES_BUDGET = 512 * 1024 * 1024


def _cluster_alignments(
    exemplar: int,
    others: list[int],
    features: np.ndarray,
    seg_lengths: np.ndarray,
    cfg: PipelineConfig,
) -> dict[int, list[tuple[int, int]]]:
    """Exemplar<->member warping paths in bounded device memory.

    Sequences are trimmed to the cluster's next-pow2 length (alignments run
    once per cluster over a handful of shapes, but full max_seq_len padding
    would square into the dirs tensor), and the member batch is chunked so
    each dispatch stays under _ALIGN_BYTES_BUDGET.  Chunks are padded to one
    power-of-two size so the whole loop reuses a single XLA program.  Long
    sequences (L >= 512) switch to the checkpointed O(B*sqrt(N)*M) exact
    backtrace (ops.backtrace_ckpt), which produces identical paths without
    ever materializing a [B, N, M] dirs tensor.
    """
    idx_all = np.asarray(others)
    la_all = seg_lengths[np.full(len(others), exemplar)]
    lb_all = seg_lengths[idx_all]
    lmax = int(max(int(la_all.max()), int(lb_all.max()), 8))
    L = min(features.shape[1], 1 << (lmax - 1).bit_length())

    if L >= 512:
        from audio_pattern_discovery.ops.backtrace_ckpt import (
            dtw_paths_checkpointed,
        )

        paths = dtw_paths_checkpointed(
            features[np.full(len(others), exemplar), :L],
            features[idx_all, :L],
            la_all,
            lb_all,
            metric=cfg.dtw.metric,
            band=cfg.dtw.band,
            auto_widen=cfg.dtw.auto_widen_band,
            band_mode=cfg.dtw.band_mode,
        )
        return {m: p for m, p in zip(others, paths)}

    bytes_per_pair = 16 * (2 * L) * L
    chunk = max(1, _ALIGN_BYTES_BUDGET // bytes_per_pair)
    n = len(others)
    # Round DOWN to a power of two: rounding up (e.g. chunk=5 -> 8) could
    # overshoot _ALIGN_BYTES_BUDGET by nearly 2x; pow2 keeps shape reuse.
    n_chunk = 1 << (min(chunk, n).bit_length() - 1)

    paths: list[list[tuple[int, int]]] = []
    for s in range(0, n, n_chunk):
        sel = idx_all[s : s + n_chunk]
        m = len(sel)
        # Pad partial chunks with exemplar self-alignments (discarded below)
        # so every dispatch shares the same compiled shape.
        pad_idx = np.concatenate([sel, np.full(n_chunk - m, exemplar)])
        a = features[np.full(n_chunk, exemplar), :L]
        b = features[pad_idx, :L]
        la = seg_lengths[np.full(n_chunk, exemplar)]
        lb = seg_lengths[pad_idx]
        _, dirs = dtw_batch_with_dirs(
            jnp.asarray(a),
            jnp.asarray(b),
            jnp.asarray(la),
            jnp.asarray(lb),
            metric=cfg.dtw.metric,
            band=cfg.dtw.band,
            auto_widen=cfg.dtw.auto_widen_band,
            band_mode=cfg.dtw.band_mode,
        )
        paths.extend(paths_from_dirs(np.asarray(dirs)[:m], la[:m], lb[:m]))
    return {m: p for m, p in zip(others, paths)}


def write_artifacts(result: DiscoveryResult, out_dir: str | Path) -> None:
    """Cluster manifest + optional per-cluster audio snippets (SS3 row 8)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = result.config
    # manifest() runs the O(K^2) silhouette pass — compute once, reuse for
    # both the JSON manifest and the HTML report.
    manifest = result.manifest()
    (out / cfg.output.manifest_name).write_text(json.dumps(manifest, indent=2))
    np.save(out / "distance_matrix.npy", result.distance_matrix)
    # Incremental-update state (SS6.4): with distance_matrix.npy this is
    # everything a later `discover(update_from=...)` needs to validate that
    # the stored distances still describe the corpus prefix — clip identity
    # + order, the exact segment table, and a fingerprint of the feature-
    # affecting config sections.  Tiny (no features; the update re-derives
    # them deterministically), so it is always written.
    state = {
        "version": 1,
        "clip_paths": [str(Path(c.path).resolve()) for c in result.clips],
        "sample_rates": [c.sample_rate for c in result.clips],
        "segments": [
            [s.clip, s.start_frame, s.end_frame] for s in result.segments
        ],
        "feature_fingerprint": _feature_fingerprint(cfg),
        # Band semantics are persisted explicitly (ADVICE r4): the diag
        # default arrived in round 4, so the fingerprint's drop-defaults
        # rule alone cannot distinguish a widen-era index from a diag one —
        # update/query check this key for a TARGETED error instead of a
        # generic spot-check drift failure.  None when band is None (the
        # mode has no effect there).
        "band_mode": cfg.dtw.band_mode if cfg.dtw.band is not None else None,
    }
    (out / "state.json").write_text(json.dumps(state))
    if cfg.output.write_features:
        np.savez_compressed(
            out / "features.npz",
            features=result.seg_features,
            lengths=result.seg_lengths,
            labels=result.labels,
        )
    if cfg.output.write_label_tracks and result.clusters:
        # Audacity label tracks: per-clip "start_s\tend_s\tclusterNNN" rows,
        # importable by Audacity/Sonic Visualiser style editors to overlay
        # the discovered patterns on the original recording.
        lab_dir = out / "labels"
        lab_dir.mkdir(exist_ok=True)
        hop = cfg.spectrogram.hop_length
        win = cfg.spectrogram.win_length
        per_clip: dict[int, list[tuple[float, float, str]]] = {}
        for rep in result.clusters:
            for m in rep.members:
                seg = result.segments[m]
                sr = result.clips[seg.clip].sample_rate
                per_clip.setdefault(seg.clip, []).append(
                    (
                        seg.start_frame * hop / sr,
                        ((seg.end_frame - 1) * hop + win) / sr,
                        f"cluster{rep.cluster_id:03d}",
                    )
                )
        for ci, rows in per_clip.items():
            stem = Path(result.clips[ci].path).stem
            (lab_dir / f"{stem}.txt").write_text(
                "".join(
                    f"{s:.6f}\t{e:.6f}\t{lab}\n" for s, e, lab in sorted(rows)
                )
            )
    if cfg.output.write_images and result.clusters:
        from audio_pattern_discovery.io.images import write_cluster_images

        write_cluster_images(
            out / "images",
            result.clusters,
            result.seg_spectrograms,
            result.seg_lengths,
            max_per_cluster=cfg.output.max_images_per_cluster,
        )
    if cfg.output.write_html_report:
        from audio_pattern_discovery.io.report import write_html_report

        write_html_report(out, manifest)
    if cfg.output.write_snippets:
        hop = cfg.spectrogram.hop_length
        win = cfg.spectrogram.win_length
        snip_dir = out / "snippets"
        snip_dir.mkdir(exist_ok=True)
        for rep in result.clusters:
            for m in rep.members:
                seg = result.segments[m]
                clip = result.clips[seg.clip]
                s0 = seg.start_frame * hop
                s1 = min((seg.end_frame - 1) * hop + win, len(clip.samples))
                write_wav(
                    snip_dir / f"cluster{rep.cluster_id:03d}_seg{m:05d}.wav",
                    clip.samples[s0:s1],
                    clip.sample_rate,
                )
