"""Windowed-FFT spectrogram extraction on the device (SURVEY.md SS3 row 2).

Design: the whole chain
    frame -> window -> rFFT -> |.|^p -> log10
is one jitted function over a *batch* of padded clips, so XLA fuses the
elementwise stages into the FFT's prologue/epilogue and the host<->device
boundary is crossed once per corpus batch (SURVEY.md SS4.1 boundary note).
Framing is a static gather (frame index matrix built at trace time), which
XLA lowers to an efficient strided window load; all shapes static, ragged
clip lengths handled with a frame-validity mask (SS8 P1).
"""

from __future__ import annotations

import os
import queue
import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from audio_pattern_discovery.config import SpectrogramConfig


def window_array(name: str, win_length: int) -> np.ndarray:
    """Periodic windows matching oracle/stft.py (reference-style)."""
    n = np.arange(win_length, dtype=np.float32)
    if name == "hann":
        return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)
    if name == "hamming":
        return (0.54 - 0.46 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)
    if name == "rect":
        return np.ones(win_length, dtype=np.float32)
    raise ValueError(f"unknown window {name!r}")


def num_frames(n_samples: int, win_length: int, hop_length: int) -> int:
    if n_samples < win_length:
        return 0
    return 1 + (n_samples - win_length) // hop_length


# --------------------------------------------------------------------------
# Feature head: mel filterbank + DCT (SpectrogramConfig.feature).
# Both are plain matmuls against small constant matrices, so they fuse
# into the spectrogram tile as extra contractions — no new host<->device
# boundary and no new dispatch.
# --------------------------------------------------------------------------


def hz_to_mel(f):
    """HTK mel scale: m = 2595 * log10(1 + f / 700)."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_bins: int,
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """[n_bins, n_mels] triangular HTK-mel filterbank (peak height 1).

    `n_bins` is the number of AVAILABLE bins (after any max_bins cap), so
    the band edges clamp to the capped spectrum's top frequency; bin k maps
    to k * sample_rate / n_fft Hz.  Raises if any filter would have empty
    support (too many mels for the available bin resolution) — a silently
    all-zero band would poison the log-mel floor downstream.
    """
    bin_hz = np.arange(n_bins, dtype=np.float64) * (sample_rate / n_fft)
    top_hz = float(bin_hz[-1])
    fmax = min(top_hz, float(fmax) if fmax is not None else sample_rate / 2.0)
    if not 0.0 <= fmin < fmax:
        raise ValueError(f"mel range [{fmin}, {fmax}] Hz is empty")
    edges_hz = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    lo, ctr, hi = edges_hz[:-2], edges_hz[1:-1], edges_hz[2:]
    up = (bin_hz[:, None] - lo[None, :]) / np.maximum(ctr - lo, 1e-12)[None, :]
    down = (hi[None, :] - bin_hz[:, None]) / np.maximum(hi - ctr, 1e-12)[None, :]
    fb = np.maximum(0.0, np.minimum(up, down))              # [n_bins, n_mels]
    empty = np.where(fb.sum(axis=0) <= 0.0)[0]
    if empty.size:
        raise ValueError(
            f"mel filter(s) {empty.tolist()} have no FFT-bin support: "
            f"n_mels={n_mels} exceeds the resolution of {n_bins} bins over "
            f"[{fmin:.0f}, {fmax:.0f}] Hz — reduce n_mels or raise "
            "max_bins/n_fft"
        )
    return fb.astype(np.float32)


def dct_ortho(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] orthonormal DCT-II matrix (scipy.fft.dct norm='ortho'
    convention): out[j] = sum_i x[i] * c_j * cos(pi*(2i+1)*j / (2*n_in))."""
    i = np.arange(n_in, dtype=np.float64)[:, None]
    j = np.arange(n_out, dtype=np.float64)[None, :]
    m = np.cos(np.pi * (2.0 * i + 1.0) * j / (2.0 * n_in)) * np.sqrt(2.0 / n_in)
    m[:, 0] *= np.sqrt(0.5)
    return m.astype(np.float32)


# 8-bit mu-law companding (mu=255) over peak-normalized samples: the
# optional half-of-int16 upload codec for bandwidth-bound corpora
# (SpectrogramConfig.upload_codec="mulaw8").  ~38 dB companding SNR — far
# above the segmentation gate and the log-power feature scale; discovery
# quality is gated equal to the int16 path on planted corpora (tests).
_MULAW_MU = 255.0


def mulaw_encode_host(x: np.ndarray) -> np.ndarray:
    """float in [-1, 1] -> int8 codes in [-127, 127] (host side)."""
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MULAW_MU * np.abs(x)) / np.log1p(_MULAW_MU)
    return np.round(y * 127.0).astype(np.int8)


def mulaw_decode_device(q: jax.Array) -> jax.Array:
    """int8 codes -> float32 samples (device side, fused into the tile)."""
    y = q.astype(jnp.float32) / 127.0
    return jnp.sign(y) * (
        jnp.power(1.0 + _MULAW_MU, jnp.abs(y)) - 1.0
    ) / _MULAW_MU


@partial(
    jax.jit,
    static_argnames=(
        "win_length",
        "hop_length",
        "window",
        "n_fft",
        "power",
        "log_scale",
        "log_floor",
        "max_bins",
        "fft_impl",
        "fft_precision",
        "feature",
        "n_mels",
        "n_mfcc",
        "sample_rate",
        "fmin",
        "fmax",
        "return_energy",
    ),
)
def batched_spectrogram(
    signals: jax.Array,                # [B, N] padded float32
    lengths: jax.Array,                # [B] int32 true sample counts
    *,
    win_length: int = 1024,
    hop_length: int = 256,
    window: str = "hann",
    n_fft: int | None = None,
    power: float = 2.0,
    log_scale: bool = True,
    log_floor: float = 1e-10,
    max_bins: int | None = None,
    fft_impl: str = "matmul",
    fft_precision: str = "highest",
    feature: str = "bins",
    n_mels: int = 64,
    n_mfcc: int = 20,
    sample_rate: int = 44_100,
    fmin: float = 0.0,
    fmax: float | None = None,
    return_energy: bool = False,
):
    """[B, N] padded signals -> ([B, F, feat] features, [B] frame counts).

    F = frame capacity of the padded length; frames past a clip's true frame
    count contain the pad fill (the log floor for "bins"/"mel" log features,
    0.0 otherwise — `feature_pad_fill`) and must be masked downstream via
    the returned frame counts.

    feature="mel"/"mfcc" appends the filterbank (and DCT) contraction to the
    same fused program; with return_energy=True a third output [B, F] carries
    the segmentation frame energy computed from the RAW capped power spectrum
    (identical to frame_energy on the feature="bins" output), so the energy
    gate never depends on the feature choice.
    """
    import chex

    chex.assert_rank(signals, 2)          # SS6.2 static sanitizer tier
    chex.assert_rank(lengths, 1)
    chex.assert_equal_shape_prefix([signals, lengths], 1)
    B, N = signals.shape
    n_fft = n_fft or win_length
    F = num_frames(N, win_length, hop_length)
    if F == 0:
        raise ValueError(f"padded length {N} shorter than win_length {win_length}")

    # Static frame-index matrix: [F, win] gather indices.
    idx = (
        np.arange(F, dtype=np.int32)[:, None] * hop_length
        + np.arange(win_length, dtype=np.int32)[None, :]
    )
    frames = signals[:, idx]                                   # [B, F, win]
    w = jnp.asarray(window_array(window, win_length))
    frames = frames * w                                        # fused elementwise

    if fft_impl == "matmul":
        # Real DFT as ONE matmul against a [win, 2*bins] packed [cos | sin]
        # DFT matrix.  The matmul precision (fft_precision) is the
        # throughput knob: the DFT dominates the spectrogram stage's FLOPs,
        # and unlike the DTW Gram there is no catastrophic-cancellation
        # structure here (PERF.md records each tier against the oracle).
        bins = n_fft // 2 + 1
        # rfft semantics: zero-pad (n_fft > win) contributes nothing beyond
        # the first win rows; truncate (n_fft < win) drops the tail.
        rows = min(win_length, n_fft)
        k = (
            2.0
            * np.pi
            / n_fft
            * np.outer(np.arange(rows, dtype=np.float64), np.arange(bins))
        )
        cs_m = jnp.asarray(
            np.concatenate([np.cos(k), np.sin(k)], axis=1).astype(np.float32)
        )                                                      # [rows, 2*bins]
        prec = {
            "default": jax.lax.Precision.DEFAULT,
            "high": jax.lax.Precision.HIGH,
            "highest": jax.lax.Precision.HIGHEST,
        }[fft_precision]
        reim = jnp.einsum(
            "bfw,wk->bfk", frames[..., :rows], cs_m, precision=prec
        )
        re = reim[..., :bins]
        im = reim[..., bins:]
        p2 = jnp.maximum(re * re + im * im, 0.0)               # |X|^2, no sqrt
    else:
        spec = jnp.fft.rfft(frames, n=n_fft, axis=-1)          # [B, F, n_fft//2+1]
        p2 = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    # Power spectrum (the default) needs neither sqrt nor pow.
    if power == 2.0:
        out = p2
    elif power == 1.0:
        out = jnp.sqrt(p2)
    else:
        out = p2 ** (power / 2.0)
    if max_bins is not None:
        out = out[..., :max_bins]

    # Mask frames that read past a clip's true length before log-compression
    # so padding contributes exactly the log floor (silence), not garbage.
    frame_counts = jnp.where(
        lengths >= win_length, 1 + (lengths - win_length) // hop_length, 0
    ).astype(jnp.int32)
    frame_ids = jnp.arange(F, dtype=jnp.int32)[None, :, None]  # [1, F, 1]
    valid = frame_ids < frame_counts[:, None, None]

    def _bins_output(lin):
        if log_scale:
            o = jnp.log10(jnp.maximum(lin, log_floor))
            return jnp.where(valid, o, jnp.log10(jnp.float32(log_floor)))
        return jnp.where(valid, lin, 0.0)

    energy = None
    if return_energy:
        # The segmentation gate's input, regardless of feature head: exactly
        # frame_energy() of the "bins" output (bit-identical to the two-call
        # path the feature="bins" tile uses).
        energy = frame_energy(_bins_output(out), log_scale=log_scale, power=power)

    if feature == "bins":
        feats = _bins_output(out)
    elif feature in ("mel", "mfcc"):
        fb = jnp.asarray(
            mel_filterbank(out.shape[-1], sample_rate, n_fft, n_mels, fmin, fmax)
        )
        # Zero the pad frames BEFORE projecting so they cannot bleed into
        # the mel sums; HIGHEST precision — the filterbank matmul is ~30x
        # cheaper than the DFT, so the exact pass costs nothing measurable.
        melp = jnp.einsum(
            "bfk,km->bfm",
            jnp.where(valid, out, 0.0),
            fb,
            precision=jax.lax.Precision.HIGHEST,
        )
        if feature == "mel":
            if log_scale:
                feats = jnp.where(
                    valid,
                    jnp.log10(jnp.maximum(melp, log_floor)),
                    jnp.log10(jnp.float32(log_floor)),
                )
            else:
                feats = jnp.where(valid, melp, 0.0)
        else:  # mfcc: log compression of the mel bands is definitional
            logmel = jnp.log10(jnp.maximum(melp, log_floor))
            mf = jnp.einsum(
                "bfm,mc->bfc",
                logmel,
                jnp.asarray(dct_ortho(n_mels, n_mfcc)),
                precision=jax.lax.Precision.HIGHEST,
            )
            feats = jnp.where(valid, mf, 0.0)
    else:
        raise ValueError(f"unknown feature {feature!r}")

    feats = feats.astype(jnp.float32)
    if return_energy:
        return feats, frame_counts, energy
    return feats, frame_counts


def feature_pad_fill(cfg: SpectrogramConfig) -> float:
    """The constant that pad frames (and rows past a clip's frame count)
    hold in assembled feature arrays — matches batched_spectrogram's mask."""
    if cfg.feature == "mfcc" or not cfg.log_scale:
        return 0.0
    return float(np.log10(np.float32(cfg.log_floor)))


def _cfg_kwargs(cfg: SpectrogramConfig) -> dict:
    return dict(
        win_length=cfg.win_length,
        hop_length=cfg.hop_length,
        window=cfg.window,
        n_fft=cfg.n_fft,
        power=cfg.power,
        log_scale=cfg.log_scale,
        log_floor=cfg.log_floor,
        max_bins=cfg.max_bins,
        fft_impl=cfg.fft_impl,
        fft_precision=cfg.fft_precision,
        feature=cfg.feature,
        n_mels=cfg.n_mels,
        n_mfcc=cfg.n_mfcc,
        sample_rate=cfg.sample_rate,
        fmin=cfg.fmin,
        fmax=cfg.fmax,
    )


def spectrogram_from_config(
    signals: jax.Array, lengths: jax.Array, cfg: SpectrogramConfig
) -> tuple[jax.Array, jax.Array]:
    return batched_spectrogram(signals, lengths, **_cfg_kwargs(cfg))


@partial(
    jax.jit,
    static_argnames=(
        "win_length",
        "hop_length",
        "window",
        "n_fft",
        "power",
        "log_scale",
        "log_floor",
        "max_bins",
        "fft_impl",
        "fft_precision",
        "feature",
        "n_mels",
        "n_mfcc",
        "sample_rate",
        "fmin",
        "fmax",
    ),
)
def _spectrogram_energy_tile(signals, lengths, scales=None, **kw):
    """One fused device call per tile: spectrogram + frame counts + energy.

    A separate eager frame_energy would cost extra dispatch round-trips per
    tile; fused, the whole tile is one XLA program (one dispatch).

    `signals` may be int16 with per-clip `scales`: PCM16 sources ship at
    half the host->device bandwidth and are decoded on device exactly
    (x/32768 is a power-of-two scale; the subsequent /scale division
    matches the host normalization bit for bit).  int8 signals are 8-bit
    mu-law codes of the PEAK-NORMALIZED signal (upload_codec="mulaw8");
    there `scales` MULTIPLIES after decode to restore original amplitude
    (only passed when the pipeline is not normalizing).
    """
    if signals.dtype == jnp.int16:
        signals = signals.astype(jnp.float32) / jnp.float32(32768.0)
        if scales is not None:
            signals = signals / scales[:, None]
    elif signals.dtype == jnp.int8:
        signals = mulaw_decode_device(signals)
        if scales is not None:
            signals = signals * scales[:, None]
    if kw.get("feature", "bins") != "bins":
        # One pass: feature head + raw-spectrum energy share the power
        # spectrum inside the fused program (the gate is feature-invariant).
        return batched_spectrogram(signals, lengths, return_energy=True, **kw)
    out, fc = batched_spectrogram(signals, lengths, **kw)
    en = frame_energy(
        out,
        log_scale=kw.get("log_scale", True),
        power=kw.get("power", 2.0),
    )
    return out, fc, en


def spectrogram_corpus(
    sigs,
    cfg: SpectrogramConfig,
    *,
    clip_batch: int = 16,
    chunk_frames: int = 1024,
    return_device: bool = False,
    scales=None,
    sig_lengths: np.ndarray | None = None,
    devices: list | None = None,
) -> tuple[np.ndarray | jax.Array, np.ndarray, np.ndarray]:
    """Streaming corpus STFT with *fixed* device shapes (SURVEY.md SS8 P1).

    Ragged clips -> ([B, F_max, bins] log-spectrograms, [B] frame counts,
    [B, F_max] frame energies), computed in [clip_batch, chunk_samples]
    device tiles.  Why not one padded [B, N_max] call:

    * every new corpus length would compile a new XLA program; the fixed
      tile compiles once, ever;
    * hours-long field recordings (BASELINE config 5) at 44.1 kHz would not
      fit HBM padded to max length; tiles bound device memory at
      clip_batch * chunk_samples regardless of corpus size.

    Tiles are hop-aligned with win-hop sample overlap, so the assembled
    frames are bit-identical to a single-shot batched_spectrogram call
    (tested in tests/test_spectrogram.py).

    `devices`: optional list of jax devices to data-parallelize over —
    clip GROUPS round-robin across them (each group's tiles stay on one
    device so its spectrogram assembles without cross-device traffic),
    and the device-resident result is collected onto devices[0], whose
    HBM holds the resident corpus for the downstream segment gather.
    Same program per device, so results are bit-identical to the
    single-device path (tested); this is the config-5 multi-device story
    for the spectrogram stage — the DFT/filterbank matmul compute scales
    with the device count while the assembly is one device-to-device copy
    per group.  None (default) = current default-device behavior.
    """
    if not len(sigs):
        raise ValueError("empty corpus")
    win, hop = cfg.win_length, cfg.hop_length
    B = len(sigs)
    if sig_lengths is None:
        # Eager path: dtype uniformity is checked by scanning (mixing int16
        # and float32 would silently truncate the float clips in the int16
        # tile buffer).  Lazy callers (pipeline streaming ingest) pass
        # sig_lengths from WAV headers instead — their preparation step
        # guarantees a uniform dtype by construction, and scanning here
        # would force-load the whole corpus before the first tile.
        if any(s.dtype != sigs[0].dtype for s in sigs):
            raise ValueError(
                "all clips must share a dtype; mixing int16 and float32 "
                "would silently truncate the float clips in the int16 tile "
                "buffer"
            )
        sig_lengths = np.array([len(s) for s in sigs], dtype=np.int64)
    frames_per_clip = np.array(
        [num_frames(int(n), win, hop) for n in sig_lengths], dtype=np.int32
    )
    F_max = int(frames_per_clip.max())
    if F_max == 0:
        raise ValueError(f"no clip reaches win_length={win} samples")
    CF = int(chunk_frames)
    chunk_samples = CF * hop + (win - hop)
    # Don't pad a small corpus up to the configured tile height: every tile
    # upload would mostly carry zero rows (a 3-clip corpus in a 16-row tile
    # wastes 81% of the host->device bandwidth).
    clip_batch = min(clip_batch, B)
    bins = cfg.feature_dim
    specs = None
    if not return_device:
        specs = np.full(
            (B, F_max, bins), np.float32(feature_pad_fill(cfg)), dtype=np.float32
        )
    frame_counts = frames_per_clip.copy()
    energies = np.full((B, F_max), np.log10(np.float32(1e-10)), dtype=np.float32)

    device_groups: list[jax.Array] = []
    # Dispatch pipelining: materializing each tile's (tiny) energy vector
    # immediately would serialize upload -> compute -> download per tile;
    # holding a small window of in-flight tiles lets the next tile's upload
    # overlap the previous tile's compute.  Collection itself rides ONE
    # worker thread (round 4): np.asarray on a tile future releases the GIL
    # while it blocks on the download, so the main loop keeps
    # building/uploading the NEXT tiles instead of stalling — on
    # upload-bound corpora (BASELINE config 5) the download waits otherwise
    # punch holes in the host->device stream.  One worker, FIFO, disjoint
    # row writes: bitwise-identical to inline collection
    # (APD_SYNC_SPECTRO=1 forces the inline path; identity tested in
    # tests/test_spectrogram.py).  Errors park and re-raise on the caller.
    pending: list[tuple] = []

    def collect_one(item=None):
        g0_, glen_, f0_, out_, fc_, en_ = (
            pending.pop(0) if item is None else item
        )
        en_np = np.asarray(en_)
        fc_np = np.asarray(fc_)
        out_np = None if out_ is None else np.asarray(out_)
        for k in range(glen_):
            n = min(int(fc_np[k]), CF, F_max - f0_)
            if n > 0:
                if out_np is not None:
                    specs[g0_ + k, f0_ : f0_ + n] = out_np[k, :n]
                energies[g0_ + k, f0_ : f0_ + n] = en_np[k, :n]

    sync_collect = os.environ.get("APD_SYNC_SPECTRO", "") == "1"
    collect_q: queue.Queue | None = None
    collect_err: list[BaseException] = []
    worker = None
    if not sync_collect:
        # maxsize bounds in-flight tiles (device buffers + download queue)
        # to the same 6-deep window the inline path uses.
        collect_q = queue.Queue(maxsize=6)

        def _collector():
            while True:
                item = collect_q.get()
                if item is None:
                    return
                if collect_err:
                    continue  # drain; producer must never block on put()
                try:
                    collect_one(item)
                except BaseException as exc:
                    collect_err.append(exc)

        worker = threading.Thread(
            target=_collector, name="apd-spectro-collect", daemon=True
        )
        worker.start()

    def emit(item):
        if worker is None:
            pending.append(item)
            if len(pending) >= 6:
                collect_one()
            return
        if collect_err:
            raise collect_err[0]
        collect_q.put(item)

    n_dev = len(devices) if devices else 0
    try:
        for gi, g0 in enumerate(range(0, B, clip_batch)):
            # Group -> device round-robin (no-op without `devices`):
            # device_put commits the tile inputs, so the jitted tile
            # program executes on the group's device and its outputs stay
            # there until collection.
            dev = devices[gi % n_dev] if n_dev else None
            put = (
                jnp.asarray
                if dev is None
                else (lambda x, d=dev: jax.device_put(x, d))
            )
            group = sigs[g0 : g0 + clip_batch]
            g_frames = frames_per_clip[g0 : g0 + clip_batch]
            n_chunks = max(1, -(-int(g_frames.max()) // CF))
            group_tiles: list[jax.Array] = []
            g_scales = None
            if scales is not None:
                g_scales = np.ones((clip_batch,), np.float32)
                g_scales[: len(group)] = scales[g0 : g0 + clip_batch]
            for c in range(n_chunks):
                s0 = c * CF * hop
                # Fresh buffer per tile: with tiles in flight, a reused
                # buffer could be aliased zero-copy by the CPU backend and
                # corrupted by the next iteration's writes.  int16 input
                # (PCM16 sources) ships at half the bandwidth and is
                # decoded+scaled on device.
                dtype = (
                    sigs[0].dtype
                    if sigs[0].dtype in (np.int16, np.int8)
                    else np.float32
                )
                tile_sig = np.zeros((clip_batch, chunk_samples), dtype=dtype)
                tile_len = np.zeros((clip_batch,), dtype=np.int32)
                for k, sig in enumerate(group):
                    avail = max(0, len(sig) - s0)
                    take = min(avail, chunk_samples)
                    if take > 0:
                        tile_sig[k, :take] = sig[s0 : s0 + take]
                    tile_len[k] = take
                out, fc, en = _spectrogram_energy_tile(
                    put(tile_sig),
                    put(tile_len),
                    scales=None if g_scales is None else put(g_scales),
                    **_cfg_kwargs(cfg),
                )
                if return_device:
                    # Invalid frames already hold the log floor (masked in
                    # the kernel), so raw tiles concatenate into the final
                    # layout with no host round-trip of the spectrogram
                    # data.
                    group_tiles.append(out)
                    emit((g0, len(group), c * CF, None, fc, en))
                else:
                    emit((g0, len(group), c * CF, out, fc, en))
                # 6-deep window either way: tile collection downloads take
                # a transfer each; a deeper window keeps
                # uploads / compute of later tiles overlapping them.
                # Bounded device memory: 6 tiles of [clip_batch, CF, bins]
                # f32 (the inline path pops in emit(); the worker's queue
                # maxsize enforces it).
            if return_device:
                g = (
                    jnp.concatenate(group_tiles, axis=1)
                    if len(group_tiles) > 1
                    else group_tiles[0]
                )
                if g.shape[1] < F_max:
                    fill = feature_pad_fill(cfg)
                    g = jnp.pad(
                        g,
                        ((0, 0), (0, F_max - g.shape[1]), (0, 0)),
                        constant_values=np.float32(fill),
                    )
                device_groups.append(g[:, :F_max])
    finally:
        # Shut the collector down on EVERY exit path (a tile-program error
        # escaping the loop must not leak a blocked daemon thread holding
        # the specs/energies closure — the scatter-worker lesson,
        # ADVICE r3).
        if worker is not None:
            collect_q.put(None)
            worker.join()
    if collect_err:
        raise collect_err[0]
    while pending:
        collect_one()
    if return_device:
        if n_dev > 1 and len(device_groups) > 1:
            # Collect the round-robined groups onto the primary device
            # (a device-to-device copy): concatenating COMMITTED
            # arrays living on different devices is an error, and the
            # downstream segment gather wants one resident corpus anyway.
            device_groups = [
                jax.device_put(g, devices[0]) for g in device_groups
            ]
        specs_dev = (
            jnp.concatenate(device_groups, axis=0)
            if len(device_groups) > 1
            else device_groups[0]
        )[:B]
        return specs_dev, frame_counts, energies
    return specs, frame_counts, energies


def frame_energy(
    spectrograms: jax.Array, log_scale: bool = True, power: float = 2.0
) -> jax.Array:
    """Per-frame energy [B, F]: log10 of *mean power* across bins.

    Mean-of-logs (a geometric mean) would dilute narrowband signals below
    the gate; arithmetic mean power keeps a tonal motif ~10*log10(SNR)
    log-units above the noise floor, which is what the dB-relative
    segmentation threshold assumes.  `power` is the exponent the input
    spectrogram was computed with (1.0 = magnitude, 2.0 = power); values
    are raised to 2/power so the gate always operates in power units and
    threshold_db keeps its dB meaning for magnitude spectrograms too.
    """
    if log_scale:
        lin = jnp.power(10.0, spectrograms)     # undo log10 compression
    else:
        lin = spectrograms
    if power != 2.0:
        lin = jnp.maximum(lin, 0.0) ** (2.0 / power)
    return jnp.log10(jnp.maximum(jnp.mean(lin, axis=-1), 1e-10))
