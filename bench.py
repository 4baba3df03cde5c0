#!/usr/bin/env python
"""Headline benchmark (BASELINE.json metric: DTW pair alignments/sec).

Workload: BASELINE config 4 — the whole all-pairs job over K latent
sequences (default K=10,240, S=128 frames, d=16, band=16 "diag"), run
end to end through `parallel.pair_scheduler.all_pairs_distances`: the
production router picks the route (on a GPU, the tile kernel of
ops/dtw_tile.py), uploads the corpus, dispatches every tile-pair and
assembles the K x K matrix on the host.  One warm-up job compiles every
program shape; the timed jobs that follow reuse them.

Baseline: the native C++ CPU loop (native/apd_native.cc), the reference's
single-core hot loop, measured on this host on a slice of the same pairs.

Needs a CUDA GPU: on any other device it exits non-zero without a result.

Usage: python bench.py [K] [RUNS]
Prints ONE JSON line on stdout:
  {"metric": ..., "value": best pairs/s, "value_median": ..., "unit": ...,
   "vs_baseline": ..., "route": ..., "device": {...}, "gpu": ...}
Detail goes to stderr.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

SEQ_LEN = 128          # segment length (frames) after bucketing
LATENT_DIM = 16        # AE latent width (AutoencoderConfig.latent_dim)
BAND = 16              # "diag" corridor half-width
CPU_PAIRS = 24         # single-core C++ pairs, enough to time reliably


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv: list[str]) -> int:
    K = int(argv[0]) if argv else 10_240
    runs = int(argv[1]) if len(argv) > 1 else 3

    import jax

    from audio_pattern_discovery import native
    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel.pair_scheduler import (
        all_pairs_distances,
    )
    from audio_pattern_discovery.platform import require_gpu
    from audio_pattern_discovery.synthetic import random_sequences
    from audio_pattern_discovery.utils.doctor import gpu_name_and_power_limit

    require_gpu("bench.py")
    dev = jax.devices()[0]
    gpu = gpu_name_and_power_limit()
    log(f"device: {dev.device_kind} x{len(jax.devices())}; {gpu}")

    feats, lens = random_sequences(K, SEQ_LEN, LATENT_DIM, seed=0)
    cfg = DTWConfig(band=BAND, band_mode="diag", normalize="path_len")
    n_pairs = K * (K - 1) // 2

    stats: dict = {}
    t0 = time.perf_counter()
    all_pairs_distances(feats, lens, cfg, stats=stats)
    log(f"warm-up job (compiles included): {time.perf_counter() - t0:.2f} s")
    route = "tile" if stats.get("tiled") else "plain"
    times = []
    for r in range(runs):
        stats = {}
        t0 = time.perf_counter()
        D = all_pairs_distances(feats, lens, cfg, stats=stats)
        times.append(time.perf_counter() - t0)
        log(
            f"run {r}: {times[-1]:.3f} s = {n_pairs / times[-1]:,.0f} pairs/s "
            f"(upload {stats.get('upload_s', 0.0):.3f} s, collect "
            f"{stats['collect_s']:.3f} s, scatter {stats['scatter_s']:.3f} s)"
        )
    best = n_pairs / min(times)
    median = n_pairs / float(np.median(times))

    # ---- CPU baseline: native C++ single core, same pairs ---------------
    rng = np.random.default_rng(1)
    ii = rng.integers(0, K, CPU_PAIRS)
    jj = rng.integers(0, K, CPU_PAIRS)
    vs_baseline = None
    if native.available():
        args = (feats[ii], feats[jj], lens[ii], lens[jj])
        kw = dict(band=BAND, normalize="path_len", n_threads=1,
                  band_mode="diag")
        cpu = []
        for _ in range(3):
            t0 = time.perf_counter()
            ref = native.dtw_batch_cpu(*args, **kw)
            cpu.append(time.perf_counter() - t0)
        cpu_rate = CPU_PAIRS / min(cpu)
        vs_baseline = float(f"{best / cpu_rate:.3g}")
        log(f"CPU baseline (1 core C++, best of 3): {cpu_rate:,.0f} pairs/s")
        err = np.max(np.abs(D[ii, jj] - ref) / np.maximum(np.abs(ref), 1e-6))
        log(f"max relative difference vs the C++ loop on {CPU_PAIRS} pairs: "
            f"{err:.2e}")
    else:
        log("native library unavailable: no baseline ratio")

    print(json.dumps({
        "metric": "diag_dtw_all_pairs_per_sec",
        "value": round(best, 1),
        "value_median": round(median, 1),
        "unit": "pairs/s",
        "vs_baseline": vs_baseline,
        "route": route,
        "K": K, "seq_len": SEQ_LEN, "feat_dim": LATENT_DIM, "band": BAND,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "gpu": gpu,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
