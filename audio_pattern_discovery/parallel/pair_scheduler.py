"""All-pairs DTW driver: pair-block scheduling over the device (SS3 row 6).

The reference iterates (i, j) pairs in a CPU hot loop; this driver
dispatches whole blocks of pairs per device call so per-pair Python
overhead is amortized away (SURVEY.md SS8 'the hard parts').  Two routes:

* The tile route (`all_pairs_distances_tiled`): sequences are length-sorted
  into tiles and one GPU kernel call computes many (ti x ti) tile-pairs
  (ops/dtw_tile.py).  Unbanded and "diag"-banded jobs only.
* The plain route: upper-triangle pairs are bucketed by max(len_i, len_j)
  into a few padded lengths (one XLA compilation per (bucket, batch)
  shape); each block gathers its sequences on device from the resident
  feature tensor and runs the batched wavefront of ops/dtw.py (or the
  blocked long-sequence wavefront of ops/dtw_long.py past 1024 frames).

`all_pairs_distances` chooses between them by the job's shape
(`tile_kernel_wins`).  Both routes persist blocks for restart (SURVEY.md
SS6.3-6.4) and round-robin blocks over an explicit device list (each chip
owns a slice of pair space; results are gathered on host).
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
import time
from functools import partial
from pathlib import Path
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from audio_pattern_discovery import native
from audio_pattern_discovery.config import DTWConfig
from audio_pattern_discovery.ops.dtw import dtw_batch
from audio_pattern_discovery.ops.dtw_long import dtw_long_batch
from audio_pattern_discovery.ops.dtw_tile import dtw_tile_pairs, scratch_bytes
from audio_pattern_discovery.platform import on_gpu

# Buckets longer than this take the blocked long-sequence wavefront: the
# scan path's [B, S, S] cost tensor grows quadratically with S.
LONG_BUCKET = 1024

# Longest padded sequence the tile route takes (tile_kernel_wins): the
# longest at which the kernel has been measured against the plain path.
MAX_TILE_SEQ_LEN = 2048

# Device bytes one tile-kernel call may spend on its strip-boundary
# scratch; caps the tile-pairs per call at long sequence lengths.
_TILE_SCRATCH_BUDGET = 512 * 1024**2


# Direct (original-order) block scatter is used while D fits comfortably
# in host cache-friendly territory; above this the per-block random-row
# writes degrade superlinearly (measured: K=20k/1.6 GB fine and fully
# hidden under device wait, K=40k/6.7 GB spent 100-280 s scattering) and
# the contiguous-sorted + one-final-gather strategy wins.
_DIRECT_SCATTER_BYTES = 2 * 1024**3


def _long_block_shape(bucket: int, cap: int = 256) -> tuple[int, int]:
    """(block, padded_len) for the blocked long-sequence path: a healthy
    tile size with the bucket padded UP to a multiple of it (dtw_long needs
    S % block == 0; its +inf length masking makes the padding free), never
    a degenerate 1-element block from an odd bucket length."""
    blk = min(cap, 1 << max(bucket - 1, 1).bit_length())
    padded = -(-bucket // blk) * blk
    return int(blk), int(padded)


def bucket_lengths(lengths: np.ndarray, step: int, max_len: int) -> np.ndarray:
    """Smallest multiple of `step` >= each length (capped at max_len)."""
    b = np.minimum(-(-lengths // step) * step, max_len)
    return np.maximum(b, step)


def stripe_width(seq_len: int, band: int | None, auto_widen: bool,
                 max_len_diff: int | None) -> int | None:
    """Width (multiple of 128) of the "widen" band stripe that covers every
    pair whose |len_a - len_b| <= max_len_diff, or None when the band is
    off, unbounded, or at least a quarter of the row."""
    if band is None:
        return None
    if auto_widen:
        if max_len_diff is None:
            return None
        wv_max = max(int(band), int(max_len_diff))
    else:
        wv_max = int(band)
    w = 128 * (-(-(2 * wv_max + 2) // 128))
    if 4 * w > seq_len:
        return None
    return w


def scan_len_diff_classes(
    seq_len: int,
    band: int | None,
    auto_widen: bool,
) -> list[int]:
    """Upper-inclusive |len_a - len_b| thresholds partitioning pairs into
    groups whose widened band needs the same `stripe_width`, so pairs of
    one block share their band geometry.  A single class where the band
    is off, not widened, or never narrow (e.g. S <= 2*W)."""
    if band is None or not auto_widen:
        return [seq_len]
    bounds: list[int] = []
    prev = stripe_width(seq_len, band, auto_widen, 0)
    for dd in range(1, seq_len + 1):
        w = stripe_width(seq_len, band, auto_widen, dd)
        if w != prev:
            bounds.append(dd - 1)
            prev = w
    bounds.append(seq_len)
    return bounds


def enumerate_pair_blocks(
    lengths: np.ndarray,
    pair_batch: int,
    bucket_step: int,
    max_len: int,
    band: int | None = None,
    auto_widen: bool = True,
    new_from: int | None = None,
):
    """Yield (row_cap, bucket_len, max_len_diff, ii, jj) blocks covering the
    upper triangle.

    `new_from`: incremental-update filter — only pairs with at least one
    index >= new_from are emitted (pairs among indices < new_from are
    already known to the caller; SS6.4 incremental corpus growth).

    DTW is symmetric, so every pair is oriented shorter-first (ii = shorter
    sequence): the kernel's sequential row loop then runs only row_cap
    steps.  Pairs are bucketed by the longer side's padded length (the
    column width) and sub-bucketed by the shorter side's, so blocks get
    tight static row capacities.  Within each shape, pairs are further
    grouped by their |len_i - len_j| class (`scan_len_diff_classes`); the
    emitted `max_len_diff` is the class's upper bound.  Deterministic
    order: (column bucket, row bucket, class) ascending, pairs in the
    row-major order of each length-sorted group pair.
    """
    K = len(lengths)
    lengths = np.asarray(lengths)
    buckets = bucket_lengths(lengths, bucket_step, max_len)
    # This enumeration sits on the critical path of the all-pairs job (a
    # naive 50M-pair triu + full-array orientation/bucket masks costs tens
    # of seconds of single-core time; scale_bench "enumerate").  Group-wise construction touches only K-sized arrays until the final
    # per-block index output: sequences are grouped by bucket with each
    # group length-sorted, so (a) a group-pair's pairs are a direct
    # repeat/tile cartesian (same-bucket: triangle in sorted positions), and
    # (b) the shorter-first orientation holds by construction — no per-pair
    # swap/masks.  Streaming per group-pair also means the first block
    # yields in milliseconds, overlapping the rest with device work.
    order = np.argsort(lengths, kind="stable").astype(np.int32)
    b_sorted = buckets[order]
    uniq = [int(b) for b in np.unique(buckets)]
    groups = {b: order[b_sorted == b] for b in uniq}

    for bb in uniq:
        gb = groups[bb]
        # At most TWO row capacities per column bucket (full and half):
        # every distinct (row, col) shape is a fresh XLA compile, so finer
        # row buckets cost more in compiles than their row savings return.
        half = min(bb, max(bucket_step, -(-(bb // 2) // bucket_step) * bucket_step))
        classes = scan_len_diff_classes(bb, band, auto_widen)
        for ba in uniq:
            if ba > bb:
                break
            ga = groups[ba]
            rb = half if (ba <= half < bb) else bb
            if ba == bb:
                n = len(gb)
                if n < 2:
                    continue
                counts = np.arange(n - 1, 0, -1)
                iu = np.repeat(np.arange(n - 1, dtype=np.int32), counts)
                ju = np.concatenate(
                    [np.arange(i + 1, n, dtype=np.int32) for i in range(n - 1)]
                )
                ii, jj = gb[iu], gb[ju]
            else:
                if not (len(ga) and len(gb)):
                    continue
                ii = np.repeat(ga, len(gb))
                jj = np.tile(gb, len(ga))
            if new_from is not None:
                keep = (ii >= new_from) | (jj >= new_from)
                if not keep.any():
                    continue
                ii, jj = ii[keep], jj[keep]
            if len(classes) == 1:
                splits = [(int(classes[0]), ii, jj)]
            else:
                dd = lengths[jj] - lengths[ii]                 # >= 0
                cls = np.searchsorted(np.asarray(classes), dd)
                splits = []
                for c, bound in enumerate(classes):
                    m = cls == c
                    if m.any():
                        splits.append((int(bound), ii[m], jj[m]))
            for bound, ic, jc in splits:
                for s in range(0, len(ic), pair_batch):
                    yield (
                        rb,
                        bb,
                        bound,
                        ic[s : s + pair_batch],
                        jc[s : s + pair_batch],
                    )


@partial(
    jax.jit,
    static_argnames=(
        "row_cap",
        "bucket",
        "metric",
        "band",
        "auto_widen",
        "normalize",
        "matmul_dtype",
        "band_mode",
    ),
)
def _dtw_block(
    features: jax.Array,      # [K, L, d] device-resident
    lengths: jax.Array,       # [K]
    ii: jax.Array,            # [B] (shorter sequence of each pair)
    jj: jax.Array,            # [B] (longer sequence)
    *,
    row_cap: int,
    bucket: int,
    metric: str,
    band: int | None,
    auto_widen: bool,
    normalize: str,
    matmul_dtype: str | None,
    band_mode: str = "widen",
) -> jax.Array:
    # Pairs arrive shorter-first, so rows stop at row_cap (<= bucket).
    a = features[ii, :row_cap]
    b = features[jj, :bucket]
    la = lengths[ii]
    lb = lengths[jj]
    if bucket > LONG_BUCKET:
        # Over-long bucket: the blocked wavefront keeps memory at boundary
        # vectors instead of the scan path's [B, S, S] cost tensor.
        blk, padded = _long_block_shape(bucket)
        a = jnp.pad(a, ((0, 0), (0, padded - row_cap), (0, 0)))
        if padded > bucket:
            b = jnp.pad(b, ((0, 0), (0, padded - bucket), (0, 0)))
        return dtw_long_batch(
            a,
            b,
            la,
            lb,
            metric=metric,
            band=band,
            auto_widen=auto_widen,
            normalize=normalize,
            block=blk,
            matmul_dtype=matmul_dtype,
            band_mode=band_mode,
        )
    return dtw_batch(
        a,
        b,
        la,
        lb,
        metric=metric,
        band=band,
        auto_widen=auto_widen,
        normalize=normalize,
        matmul_dtype=matmul_dtype,
        band_mode=band_mode,
    )


def _with_retries(fn: Callable, max_retries: int, pending_exc: BaseException):
    """Re-run `fn` up to max_retries times after an initial failure.

    `pending_exc` is the exception that triggered the retry; it is raised
    directly when max_retries < 1 (no bare `raise`, so the helper works
    outside an `except` block) and chained from the final retry failure."""
    if max_retries < 1:
        raise pending_exc
    for attempt in range(max_retries):
        try:
            return fn()
        except Exception:
            if attempt == max_retries - 1:
                raise
    raise AssertionError("unreachable")


def _block_key(ii: np.ndarray, jj: np.ndarray, cfg_tag: bytes = b"") -> str:
    """Resume key: pair indices + the DTW config fingerprint, so blocks
    persisted under one metric/band/normalization are never reused after a
    config change (they would silently poison the distance matrix)."""
    h = hashlib.sha1(ii.tobytes() + b"|" + jj.tobytes() + b"|" + cfg_tag)
    return f"block_{ii[0]}_{jj[0]}_{len(ii)}_{h.hexdigest()[:16]}"


def _cfg_tag(cfg: DTWConfig, features: np.ndarray, lengths: np.ndarray) -> bytes:
    """DTW config + a feature fingerprint: resume blocks must also be
    invalidated when UPSTREAM config changes the features (different AE,
    bins, segmentation) — same indices, different sequences.  The
    fingerprint hashes shapes, lengths, and a 64-row stride of the feature
    tensor (any feature-affecting change perturbs essentially all values)."""
    h = hashlib.sha1(
        repr(
            (cfg.metric, cfg.band, cfg.auto_widen_band, cfg.normalize,
             cfg.dtype, cfg.band_mode)
        ).encode()
    )
    h.update(repr(features.shape).encode())
    h.update(np.ascontiguousarray(lengths).tobytes())
    step = max(1, features.shape[0] // 64)
    h.update(np.ascontiguousarray(features[::step]).tobytes())
    return h.hexdigest().encode()


def make_tile_class_fn(
    lens_sorted: np.ndarray,   # [nT*ti] lengths in tile order (pad: 1)
    nT: int,
    ti: int,
    L: int,
    n_real: int,
) -> Callable[[int, int], tuple[int, int]]:
    """(I, J) tile-pair -> (rows_cls, width_cls): the two tiles' max REAL
    lengths, each rounded UP on an L//8 ladder.

    The tile kernel's loops are bounded inside the kernel, so the class
    only groups tile-pairs of similar DP cost into the same call (a call
    lasts as long as its slowest program).  Both components are
    >=-monotone, which is what `_merge_thin_classes` relies on.  Pad
    entries (length 1, trailing positions >= n_real) are excluded: their
    outputs are never scattered.
    """
    tmax = np.empty(nT, np.int64)
    for t in range(nT):
        real = lens_sorted[t * ti : min((t + 1) * ti, n_real)]
        if len(real) == 0:
            real = lens_sorted[t * ti : (t + 1) * ti]
        tmax[t] = real.max()
    rq = max(16, L // 8)

    def pair_class(i: int, j: int) -> tuple[int, int]:
        rows_cls = min(L, rq * -(-int(tmax[i]) // rq))
        width_cls = min(L, rq * -(-int(tmax[j]) // rq))
        return rows_cls, width_cls

    return pair_class


def _merge_thin_classes(
    by_class: dict[tuple[int, ...], list],
    min_programs: int = 16,
    max_merge_cost: int = 400_000,
) -> None:
    """Merge (rows, width) classes with few tile-pairs into neighbors, in
    place.

    Every class dispatches its own chunks, and a class's last chunk is
    padded up to a power of two; thin classes therefore cost more in
    poorly-filled calls than the DP rows their tighter bound saves.

    Merging takes the elementwise max of the two keys, so the merged class
    still bounds every member; the target minimizes a crude device-time
    model (DP cost ~ tile-pairs * rows * (3 + width-ish key)).
    `max_merge_cost` caps the model units one merge may add, so a thin
    class whose only neighbors are EXPENSIVE (one long-sequence tile-pair
    next to a bulk class of short ones) keeps its own chunks instead of
    upgrading the bulk.
    """

    def t(cls, n):
        r, s = cls[0], cls[1]
        return n * r * (3 + s)

    while len(by_class) > 1:
        thin = [c for c in by_class if len(by_class[c]) < min_programs]
        if not thin:
            return
        best = None  # (cost, small, target)
        for small in thin:
            for other in by_class:
                if other == small:
                    continue
                m = tuple(map(max, small, other))
                cost = (
                    t(m, len(by_class[small]))
                    - t(small, len(by_class[small]))
                    + t(m, len(by_class[other]))
                    - t(other, len(by_class[other]))
                )
                if best is None or cost < best[0]:
                    best = (cost, small, other)
        if best[0] > max_merge_cost:
            return
        _, small, target = best
        m = tuple(map(max, small, target))
        merged = by_class.pop(small) + by_class.pop(target)
        by_class.setdefault(m, []).extend(merged)


def all_pairs_distances_tiled(
    features: np.ndarray,          # [K, L, d] padded segment features
    lengths: np.ndarray,           # [K] true frame counts
    cfg: DTWConfig,
    *,
    block_dir: str | Path | None = None,
    progress: Callable[[int, int], None] | None = None,
    devices: list | None = None,
    max_retries: int = 1,
    stats: dict | None = None,
    chunk_programs: int = 64,
    interpret: bool = False,
    ti: int = 128,
    known: tuple[int, np.ndarray] | None = None,
) -> np.ndarray:
    """Symmetric [K, K] DTW matrix via the all-pairs tile kernel
    (ops/dtw_tile.py), for unbanded and "diag"-banded jobs.

    Sequences upload once as a device-resident corpus; each (ti x ti)
    tile-pair reuses its 2*ti sequences for ti*ti pairs.  Dispatches go in
    chunks of up to `chunk_programs` tile-pairs (fewer where the kernel's
    boundary scratch would pass its budget) with the same pipelined
    in-flight window, chunk persistence, and retry contract as the
    per-pair scheduler.  `interpret=True` runs the kernel in the Pallas
    interpreter (tests; small power-of-two `ti`).

    `known=(k_old, D_old)`: incremental update.  Distances among the first
    k_old sequences are taken from D_old; the sort permutation groups old
    sequences before new ones (each side length-sorted, so tiles stay
    length-coherent) and tile-pairs whose tiles are both pure-old are
    skipped entirely — the computed fraction scales with the new-pair
    share, not the full triangle.  The one boundary tile mixing old and
    new recomputes its old x old pairs; same features, same kernel, so
    the overwrite is a no-op numerically.

    `progress(done, total)` is invoked from the scheduler's scatter WORKER
    thread in the default async-assembly mode (main thread only under
    APD_SYNC_SCATTER=1) — callbacks must be thread-safe; calls are strictly
    sequential (one worker), never concurrent.
    """
    K, L, d = features.shape
    lengths = np.asarray(lengths, dtype=np.int32)
    if K < 2:
        return np.zeros((K, K), dtype=np.float32)
    diag = cfg.band is not None
    if diag and cfg.band_mode != "diag":
        raise ValueError(
            "the tile kernel implements band_mode='diag' and unbanded jobs "
            f"only (band={cfg.band}, band_mode={cfg.band_mode!r})"
        )
    chunk_programs = int(
        max(1, min(chunk_programs,
                   _TILE_SCRATCH_BUDGET // scratch_bytes(1, ti, L)))
    )

    Kp = -(-K // ti) * ti
    # Sort sequences by length: tiles then hold near-constant lengths, so
    # the kernel's per-program row loops (bounded by the longest lane)
    # waste little on shorter lanes.
    #
    # Two un-permutation strategies, chosen by matrix size: up to ~contract
    # scale, blocks fancy-scatter STRAIGHT into original-order D inside the
    # collect loop — that work hides under the device wait and needs no
    # final gather.  Past ~2 GB of matrix, per-block random-row writes into
    # D thrash the host's caches, so large jobs assemble per ROW STRIP: blocks
    # land in a cache-sized [<=ti, K] buffer per sorted row-strip, and a
    # completed strip flushes once — one vectorized column un-permute +
    # ti contiguous row writes — touching D exactly once, sequentially.
    # Update jobs force direct scatter: skipped tile-pairs would leave row
    # strips permanently incomplete (strip_left counts all nT pieces), and
    # strips would also need their old-column region prefilled from D_old
    # per strip — a K_old x K_old fancy gather, the exact host tail the
    # strip design exists to kill.  Accepted tradeoff: a LARGE-fraction
    # update of a > 2 GB matrix re-enters the direct-scatter regime —
    # slower, not pathological, and updates that big are near
    # full-recompute cost anyway.  Generalizing strip accounting to per-strip piece counts
    # + D_old prefill is the upgrade path if large-fraction huge-K updates
    # become a real workload.
    direct = known is not None or K * K * 4 <= _DIRECT_SCATTER_BYTES
    D = np.zeros((K, K), dtype=np.float32)
    if known is not None:
        k_old, D_old = known
        D[:k_old, :k_old] = D_old
        # Group old before new (each side length-sorted): tiles then hold
        # only-old or only-new sequences (plus at most one boundary tile),
        # so pure-old tile-pairs can be skipped instead of scattering new
        # indices across every tile.
        perm = np.concatenate(
            [
                np.argsort(lengths[:k_old], kind="stable"),
                k_old + np.argsort(lengths[k_old:], kind="stable"),
            ]
        ).astype(np.int64)
    else:
        perm = np.argsort(lengths, kind="stable").astype(np.int64)
    lens_sorted = lengths[perm]
    lens_p = np.ones((Kp,), np.int32)
    lens_p[:K] = lens_sorted
    nT = Kp // ti

    if devices is None:
        devices = [jax.devices()[0]]
    t_up = time.perf_counter()
    if isinstance(features, jax.Array):
        # Already device-resident (the pipeline's AE features are): permute
        # and pad on device — no host round-trip of the [K, L, d] corpus.
        feats_p = jnp.pad(
            features.astype(jnp.float32)[jnp.asarray(perm)],
            ((0, Kp - K), (0, 0), (0, 0)),
        )
    else:
        fp = np.zeros((Kp, L, d), np.float32)
        fp[:K, :L] = features[perm]
        feats_p = jnp.asarray(fp)
    feats_dev = [jax.device_put(feats_p, dv) for dv in devices]
    lens_dev = [jax.device_put(jnp.asarray(lens_p), dv) for dv in devices]
    # honest sync so upload_s reflects the actual transfer, not its launch
    for fd in feats_dev:
        np.asarray(fd[0, 0, 0])
    upload_s = time.perf_counter() - t_up

    pair_class = make_tile_class_fn(lens_p, nT, ti, L, K)

    pairs_list = [(i, j) for i in range(nT) for j in range(i, nT)]
    n_all_pairs = K * (K - 1) // 2
    if known is not None:
        # Skip tile-pairs with no new sequence on either side; their pairs
        # are all in D_old.  (Pad positions >= K are never "new".)
        pos_new = np.zeros(nT * ti, bool)
        pos_new[:K] = perm >= k_old
        tile_new = [bool(pos_new[t * ti : (t + 1) * ti].any()) for t in range(nT)]
        pairs_list = [
            (i, j) for (i, j) in pairs_list if tile_new[i] or tile_new[j]
        ]
        n_all_pairs -= k_old * (k_old - 1) // 2
    if diag:
        # Put the LONGER tile (J >= I: tiles are length-sorted) on the
        # kernel's shared row side, which runs along the strip columns:
        # each strip then sweeps about strip*(la/lb) + 2*band lane rows,
        # against strip*(lb/la) + 2*band*(lb/la) the other way round.
        # Scatter handles (J, I) blocks identically (both triangles are
        # written per block).
        pairs_list = [(j, i) for (i, j) in pairs_list]
    if stats is None:
        stats = {}
    stats.update(
        dispatch_s=0.0, collect_s=0.0, scatter_s=0.0, persist_s=0.0,
        enumerate_s=0.0, blocks=0, pad_pairs=0, pairs=n_all_pairs,
        tiled=True, tile_programs=len(pairs_list), upload_s=upload_s,
        device_blocks=[0] * len(devices),
    )

    if block_dir is not None:
        block_dir = Path(block_dir)
        block_dir.mkdir(parents=True, exist_ok=True)
        cfg_tag = _cfg_tag(cfg, features, lengths) + b"|tile"

    # Group tile-pairs by (rows, width) class, then pad each class's tail
    # chunk UP to the next power of two (not the full chunk size: a 6-pair
    # tail padded to 64 would run 58 redundant tile-pairs every job, while
    # pow2 keeps the padding under 2x and the compiled U shapes to a
    # handful).  Pad entries repeat the last tile-pair; duplicate scatters
    # are idempotent.
    by_class: dict[tuple[int, ...], list[tuple[int, int]]] = {}
    for pij in pairs_list:
        by_class.setdefault(pair_class(*pij), []).append(pij)
    _merge_thin_classes(by_class)
    stats["tile_classes"] = len(by_class)
    chunks: list[tuple[np.ndarray, np.ndarray, tuple[int, ...]]] = []
    for cls, plist in sorted(by_class.items()):
        for s in range(0, len(plist), chunk_programs):
            part = plist[s : s + chunk_programs]
            u = 1 << max(0, (len(part) - 1).bit_length())
            while len(part) < min(u, chunk_programs):
                part = part + [part[-1]]
            ii = np.array([p[0] for p in part], np.int32)
            jj = np.array([p[1] for p in part], np.int32)
            chunks.append((ii, jj, cls))

    done_programs = 0
    total_programs = len(pairs_list)
    norm = cfg.normalize == "path_len"
    pending: list = []

    ls_f = lens_p.astype(np.float32)

    # strip-assembly state (large-K path; see strategy comment above)
    inv = None if direct else np.argsort(perm)
    strip_bufs: dict[int, np.ndarray] = {}
    strip_left: dict[int, int] = {}
    # Fused C++ scatter (native/apd_native.cc): one pass over each block
    # writes both mirrored destinations with normalization inlined, vs ~6
    # NumPy passes + temps (host assembly is the largest share of the
    # config-4 job on the GPU; PERF.md).  NumPy twin kept
    # as fallback + A/B control (APD_NO_NATIVE_SCATTER=1; identity tested
    # in tests/test_native.py and tests/test_dtw_tile.py).
    use_native = (
        native.available()
        and os.environ.get("APD_NO_NATIVE_SCATTER", "") != "1"
    )

    def _strip_buf(I):
        buf = strip_bufs.get(I)
        if buf is None:
            buf = np.zeros((min(ti, K - I * ti), K), np.float32)
            strip_bufs[I] = buf
            # strip I receives one piece per tile: from pairs (I, J >= I)
            # directly and (J < I, I) mirrored — nT pieces total
            strip_left[I] = nT
        return buf

    def _strip_dec(I):
        strip_left[I] -= 1
        if strip_left[I] == 0:
            del strip_left[I]
            buf = strip_bufs.pop(I)
            rows = perm[I * ti : I * ti + buf.shape[0]]
            if use_native:
                native.strip_unpermute(buf, inv, rows, D)
            else:
                D[rows] = np.take(buf, inv, axis=1)

    def strip_add(I, c0, part):
        buf = _strip_buf(I)
        buf[:, c0 : c0 + part.shape[1]] = part
        _strip_dec(I)

    def scatter_chunk(ii, jj, blocks):
        # Each (I, J) appears once.  Both triangles are written per block
        # (mirroring the 64 KB block is ~0.1 ms; a final full-matrix
        # D += D.T measured 7.1 s at K=10k on the throttled host).
        # Diagonal tiles take their strict-upper part mirrored so D stays
        # exactly symmetric and the diagonal exactly zero regardless of
        # last-ulp differences between the kernel's (u,v) and (v,u) paths.
        seen = set()
        for u in range(len(ii)):
            I, J = int(ii[u]), int(jj[u])
            if (I, J) in seen:
                continue
            seen.add((I, J))
            blk = blocks[u]
            r0, c0 = I * ti, J * ti
            # pad sequences (sorted index >= K) exist only in the last tile
            nr, nc = min(ti, K - r0), min(ti, K - c0)
            if use_native and not direct:
                # Fused strip writes — ONE pass over the raw block does
                # normalize + strip-I rows + transposed strip-J rows, in a
                # ctypes call that RELEASES THE GIL for its whole duration,
                # where the NumPy chain (divide temp, triu, .T copy) holds
                # the GIL on the scatter worker and starves the main
                # thread's dispatch loop.
                bufI = _strip_buf(I)
                lr = ls_f[r0 : r0 + nr] if norm else None
                lc = ls_f[c0 : c0 + nc] if norm else None
                if I == J:
                    native.scatter_block_strip(
                        blk, nr, nc, lr, lc, bufI, c0, None, 0
                    )
                    _strip_dec(I)
                else:
                    bufJ = _strip_buf(J)
                    native.scatter_block_strip(
                        blk, nr, nc, lr, lc, bufI, c0, bufJ, r0
                    )
                    _strip_dec(I)
                    _strip_dec(J)
                continue
            if use_native and direct:
                # The native win here is the permuted scatter (1.9x) with
                # normalization inlined; strip completion rides
                # native.strip_unpermute in _strip_dec above (1.7x).
                native.scatter_block_direct(
                    blk, nr, nc,
                    ls_f[r0 : r0 + nr] if norm else None,
                    ls_f[c0 : c0 + nc] if norm else None,
                    perm[r0 : r0 + nr], perm[c0 : c0 + nc], D, I == J,
                )
                continue
            if norm:
                blk = blk[:nr, :nc] / (
                    ls_f[r0 : r0 + nr][:, None] + ls_f[c0 : c0 + nc][None, :]
                )
            else:
                blk = blk[:nr, :nc]
            if direct:
                r_orig = perm[r0 : r0 + nr]
                c_orig = perm[c0 : c0 + nc]
                if I == J:
                    sym = np.triu(blk, k=1)
                    D[np.ix_(r_orig, c_orig)] = sym + sym.T
                else:
                    D[np.ix_(r_orig, c_orig)] = blk
                    D[np.ix_(c_orig, r_orig)] = blk.T
            else:
                if I == J:
                    sym = np.triu(blk, k=1)
                    strip_add(I, c0, sym + sym.T)
                else:
                    strip_add(I, c0, blk)
                    strip_add(J, r0, np.ascontiguousarray(blk.T))
        return len(seen)

    # Matrix assembly rides ONE worker thread: `np.asarray(fut)` releases
    # the GIL while it blocks on the device, so scatter/persist overlap the
    # device wait instead of stalling the collect loop between dispatches —
    # host assembly grows with K and outlasts the device at config-4 scale
    # (PERF.md).  A single worker keeps D writes strictly sequential (no
    # locking, bitwise-identical result); its errors are parked and
    # re-raised on the main thread.  APD_SYNC_SCATTER=1 forces the inline
    # path (A/B measurement + the identity test in test_dtw_tile.py).
    sync_scatter = os.environ.get("APD_SYNC_SCATTER", "") == "1"
    scatter_q: queue.Queue = queue.Queue(maxsize=8)
    scatter_err: list[BaseException] = []

    def handle_block(ii, jj, vals, path):
        nonlocal done_programs
        t0 = time.perf_counter()
        done_programs += scatter_chunk(ii, jj, vals)
        stats["scatter_s"] += time.perf_counter() - t0
        if path is not None:
            t0 = time.perf_counter()
            np.savez(path, ii=ii, jj=jj, blocks=vals)
            stats["persist_s"] += time.perf_counter() - t0
        if progress:
            progress(done_programs, total_programs)

    def scatter_worker():
        while True:
            item = scatter_q.get()
            if item is None:
                return
            if scatter_err:
                continue  # drain so the producer can never block on put()
            try:
                handle_block(*item)
            except BaseException as exc:
                scatter_err.append(exc)

    worker = None
    if not sync_scatter:
        worker = threading.Thread(
            target=scatter_worker, name="apd-scatter", daemon=True
        )
        worker.start()

    def emit_block(ii, jj, vals, path):
        if worker is None:
            handle_block(ii, jj, vals, path)
            return
        if scatter_err:
            raise scatter_err[0]
        scatter_q.put((ii, jj, vals, path))

    def collect_one():
        ii, jj, dispatch, fut, path = pending.pop(0)
        t0 = time.perf_counter()
        try:
            vals = np.asarray(fut)
        except Exception as exc:
            vals = _with_retries(
                lambda: np.asarray(dispatch()), max_retries, exc
            )
        stats["collect_s"] += time.perf_counter() - t0
        emit_block(ii, jj, vals, path)

    # The try spans the WHOLE dispatch/collect region, not just the final
    # drain: any exception escaping the chunk loop (retry exhaustion, a
    # corrupt resume block's np.load, emit_block re-raising a parked
    # scatter error) must still put(None)/join() or it leaks one daemon
    # scatter thread per failed call, each pinning this closure's K x K D.
    try:
        for ci, (ii, jj, cls) in enumerate(chunks):
            stats["blocks"] += 1
            path = None
            if block_dir is not None:
                cls_tag = "|".join(str(c) for c in cls)
                path = block_dir / (
                    _block_key(ii, jj, cfg_tag + f"|{cls_tag}".encode())
                    + ".npz"
                )
                if path.exists():
                    saved = np.load(path)
                    emit_block(saved["ii"], saved["jj"], saved["blocks"], None)
                    continue
            di = ci % len(devices)
            stats["device_blocks"][di] += 1

            def dispatch(di=di, ii=ii, jj=jj):
                return dtw_tile_pairs(
                    feats_dev[di], lens_dev[di],
                    jnp.asarray(ii), jnp.asarray(jj),
                    ti=ti, band=cfg.band, metric=cfg.metric,
                    interpret=interpret,
                )

            t0 = time.perf_counter()
            try:
                fut = dispatch()
            except Exception as exc:
                fut = _with_retries(dispatch, max_retries, exc)
            stats["dispatch_s"] += time.perf_counter() - t0
            pending.append((ii, jj, dispatch, fut, path))
            if len(pending) >= 4 * len(devices):
                collect_one()
        while pending:
            collect_one()
    finally:
        if worker is not None:
            scatter_q.put(None)
            worker.join()
    if scatter_err:
        raise scatter_err[0]
    assert not strip_bufs, "incomplete row strips after all chunks"
    return D


def tile_kernel_wins(seq_len: int, feat_dim: int, cfg: DTWConfig) -> bool:
    """Does the tile kernel beat the plain path for this job's shape?

    Decided by observable shape only.  The kernel takes unbanded and
    "diag"-banded jobs ("widen" bands stay on the plain path) up to
    `MAX_TILE_SEQ_LEN` frames.  It won at every measured shape, S=128 to
    2048 and d=16 to 513 (PERF.md), so feat_dim does not narrow the route.
    """
    if cfg.band is not None and cfg.band_mode != "diag":
        return False
    return seq_len <= MAX_TILE_SEQ_LEN


def all_pairs_distances(
    features: np.ndarray,          # [K, L, d] padded segment features
    lengths: np.ndarray,           # [K] true frame counts
    cfg: DTWConfig,
    *,
    bucket_step: int = 32,
    block_dir: str | Path | None = None,
    progress: Callable[[int, int], None] | None = None,
    devices: list | None = None,
    matmul_dtype: str | None = None,
    max_retries: int = 1,
    stats: dict | None = None,
    tiled: bool | None = None,
    known: tuple[int, np.ndarray] | None = None,
) -> np.ndarray:
    """Symmetric [K, K] DTW distance matrix over all segment pairs.

    `devices`: optional explicit device list; pair blocks round-robin across
    them (single-host multi-chip DP over pair space).  Default: one device.
    `block_dir`: persist each block's distances for crash resume.
    `max_retries`: failure detection (SURVEY.md SS6.3) — a block whose
    dispatch or materialization raises is retried synchronously up to this
    many times before the error propagates; completed blocks are unaffected
    (and, with `block_dir`, already persisted).
    `stats`: optional dict filled with host-side timing breakdown
    (dispatch_s, collect_s, persist_s, blocks, pad_pairs) for perf triage.
    `known=(k_old, D_old)`: incremental corpus growth (SS6.4) — the first
    k_old sequences' pairwise distances are taken from D_old (a prior run
    over byte-identical features); only pairs touching a new sequence are
    computed, so update cost scales with the new-pair share of the
    triangle, not K^2.
    """
    K, L, _ = features.shape
    lengths = np.asarray(lengths, dtype=np.int32)
    if known is not None:
        k_old, D_old = known
        if not (0 <= k_old <= K and D_old.shape == (k_old, k_old)):
            raise ValueError(
                f"known: D_old shape {D_old.shape} != ({k_old}, {k_old}) "
                f"or k_old {k_old} out of range for K={K}"
            )

    diag = cfg.band is not None and cfg.band_mode == "diag"
    if tiled is None:
        tiled = bool(
            cfg.use_pallas
            and matmul_dtype is None
            and cfg.dtype != "bfloat16"
            and on_gpu()
            and tile_kernel_wins(L, features.shape[2], cfg)
        )
    if tiled:
        return all_pairs_distances_tiled(
            features, lengths, cfg,
            block_dir=block_dir, progress=progress, devices=devices,
            max_retries=max_retries, stats=stats, known=known,
        )

    if cfg.length_bucketing:
        step = min(bucket_step, L)
    else:
        step = L
    D = np.zeros((K, K), dtype=np.float32)
    if K < 2:
        return D

    if devices is None:
        devices = [jax.devices()[0]]
    feats_dev = [jax.device_put(jnp.asarray(features, jnp.float32), d) for d in devices]
    lens_dev = [jax.device_put(jnp.asarray(lengths), d) for d in devices]

    if block_dir is not None:
        block_dir = Path(block_dir)
        block_dir.mkdir(parents=True, exist_ok=True)
        cfg_tag = _cfg_tag(cfg, features, lengths)

    # Effective batch: don't pad a tiny workload up to the configured batch
    # — round the corpus's own pair count to a multiple of 8.  The scan
    # path materializes [B, S, S] cost tensors, so B is capped at 1024.
    n_all_pairs = K * (K - 1) // 2
    if known is not None:
        n_all_pairs -= k_old * (k_old - 1) // 2
    B = int(min(cfg.pair_batch, 1024, max(8, -(-n_all_pairs // 8) * 8)))

    if stats is None:
        stats = {}
    stats.update(
        dispatch_s=0.0, collect_s=0.0, scatter_s=0.0, persist_s=0.0,
        enumerate_s=0.0, blocks=0, pad_pairs=0, pairs=n_all_pairs,
    )

    # Blocks STREAM from the enumerator instead of materializing a list:
    # at 10k sequences the enumeration is tens of seconds of single-core
    # numpy (worse under the shared host's CPU throttling), and streaming
    # overlaps all of it with device work — the in-flight window keeps the
    # chip busy while the host prepares the next groups.
    # Per-block device-gather budget: each dispatch gathers [B, bucket, d]
    # a/b operands, so long buckets must take proportionally smaller blocks
    # (a 128k-pair block at bucket=1024 would gather 17 GiB).
    gather_budget = 2 << 30
    d_feat = features.shape[2]

    def blocks_iter():
        t0 = time.perf_counter()
        for row_cap, bucket, mld, ii, jj in enumerate_pair_blocks(
            lengths, B, step, L, band=cfg.band, auto_widen=cfg.auto_widen_band,
            new_from=None if known is None else k_old,
        ):
            cap = max(512, gather_budget // (bucket * d_feat * 8))
            if bucket > LONG_BUCKET:
                # dtw_long_batch's [B, nB, blk, blk] cost tiles blow up with
                # gather-budget-sized batches; keep those blocks small.
                cap = min(cap, 512)
            for s in range(0, len(ii), cap):
                stats["enumerate_s"] += time.perf_counter() - t0
                yield row_cap, bucket, mld, ii[s : s + cap], jj[s : s + cap]
                t0 = time.perf_counter()

    total_pairs = n_all_pairs
    done_pairs = 0

    # In-flight results for pipelining: keep a sliding window of dispatched
    # blocks and sync only the oldest when the window is full, so the device
    # queue never empties between host-side collections.
    pending: list[tuple[np.ndarray, np.ndarray, Callable, jax.Array, Path | None]] = []

    def collect_one():
        nonlocal done_pairs
        ii, jj, dispatch, fut, path = pending.pop(0)
        t0 = time.perf_counter()
        try:
            vals = np.asarray(fut)[: len(ii)]
        except Exception as exc:
            vals = _with_retries(
                lambda: np.asarray(dispatch())[: len(ii)], max_retries, exc
            )
        stats["collect_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        # Upper-triangle scatter only; one vectorized D + D.T symmetrization
        # at the end replaces the second 50M-element random scatter.
        D[ii, jj] = vals
        stats["scatter_s"] += time.perf_counter() - t0
        if path is not None:
            t0 = time.perf_counter()
            np.savez(path, ii=ii, jj=jj, d=vals)
            stats["persist_s"] += time.perf_counter() - t0
        done_pairs += len(ii)
        if progress:
            progress(done_pairs, total_pairs)

    def drain():
        while pending:
            collect_one()

    for bi, (row_cap, bucket, mld, ii, jj) in enumerate(blocks_iter()):
        stats["blocks"] += 1
        path = None
        if block_dir is not None:
            path = block_dir / (_block_key(ii, jj, cfg_tag) + ".npz")
            if path.exists():
                saved = np.load(path)
                D[saved["ii"], saved["jj"]] = saved["d"]
                done_pairs += len(ii)
                if progress:
                    progress(done_pairs, total_pairs)
                continue

        # Pad partial blocks to the next power of two (not the full batch:
        # length-diverse corpora produce many (bucket, row) combos whose
        # tails would otherwise each dispatch pair_batch of mostly-padding
        # work).  Pad entries are self-pairs of index 0; discarded on
        # collection.
        B_blk = min(B, max(8, 1 << (len(ii) - 1).bit_length()))
        ii_pad = np.zeros(B_blk, dtype=np.int32)
        jj_pad = np.zeros(B_blk, dtype=np.int32)
        ii_pad[: len(ii)] = ii
        jj_pad[: len(jj)] = jj

        di = bi % len(devices)

        def dispatch(di=di, ii_pad=ii_pad, jj_pad=jj_pad, row_cap=row_cap,
                     bucket=bucket):
            # Index vectors ride along with the jitted call (one transfer
            # fused into the dispatch — no separate eager device_puts).
            return _dtw_block(
                feats_dev[di],
                lens_dev[di],
                ii_pad,
                jj_pad,
                row_cap=row_cap,
                bucket=bucket,
                metric=cfg.metric,
                band=cfg.band,
                auto_widen=cfg.auto_widen_band,
                normalize=cfg.normalize,
                matmul_dtype=matmul_dtype
                or (cfg.dtype if cfg.dtype == "bfloat16" else None),
                band_mode=cfg.band_mode if diag else "widen",
            )

        stats["pad_pairs"] += B_blk - len(ii)
        t0 = time.perf_counter()
        try:
            fut = dispatch()
        except Exception as exc:
            fut = _with_retries(dispatch, max_retries, exc)
        stats["dispatch_s"] += time.perf_counter() - t0
        pending.append((ii, jj, dispatch, fut, path))
        # 10-deep per device: deep enough that host-side collection (scatter
        # + persist) and dispatch latency never drain the device queue.  In-flight entries hold only the tiny output futures
        # (the gathers live inside each compiled program), so depth costs
        # almost nothing.
        if len(pending) >= 10 * len(devices):
            collect_one()
    drain()
    # Pairs scatter into one triangle each (orientation varies per block);
    # the matrix is their disjoint union, so D + D.T symmetrizes exactly.
    D += D.T
    if known is not None:
        # The old x old block was never enumerated; its distances come from
        # the prior run (after symmetrization, so nothing doubles).
        D[:k_old, :k_old] = D_old
    return D
