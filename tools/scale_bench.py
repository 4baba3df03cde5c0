#!/usr/bin/env python
"""BASELINE config 4 at full scale: all-pairs banded wavefront DTW over 10k
latent sequences on one chip, through the production pair-block scheduler.

Prints pairs/s and total wall time to stderr and one JSON line to stdout.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

N_SEQ = int(__import__("os").environ.get("APD_SCALE_N", 10_000))
# Pairs per plain-path block (the scheduler caps it at 1024).
PAIR_BATCH = int(__import__("os").environ.get("APD_SCALE_BATCH", 131_072))
SEQ_LEN = 128
LATENT_DIM = 16
BAND = 16


def log(m):
    print(m, file=sys.stderr, flush=True)


def main() -> int:
    import jax

    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel.pair_scheduler import (
        all_pairs_distances,
    )

    import jax.numpy as jnp

    log(f"device: {jax.devices()[0]}")
    rng = np.random.default_rng(0)
    lengths = rng.integers(SEQ_LEN // 2, SEQ_LEN + 1, N_SEQ).astype(np.int32)
    # The production pipeline hands the scheduler DEVICE-RESIDENT features
    # (AE latents never leave the chip); mirror that by GENERATING the
    # synthetic corpus on device — DTW throughput is value-independent, and
    # the real pipeline never uploads the corpus.  Only the lengths vector
    # crosses from the host.
    t0 = time.time()
    feats = jax.random.normal(
        jax.random.PRNGKey(0), (N_SEQ, SEQ_LEN, LATENT_DIM), jnp.float32
    )
    np.asarray(feats[0, 0, 0])
    log(f"corpus device-generated: {feats.nbytes / 1e6:.0f} MB in "
        f"{time.time() - t0:.1f}s")
    # APD_SCALE_BAND_MODE overrides the band semantics for A/B runs
    # (default: the production DTWConfig default, diag since round 4).
    band_mode = os.environ.get("APD_SCALE_BAND_MODE", "")
    cfg = DTWConfig(band=BAND, pair_batch=PAIR_BATCH, max_seq_len=SEQ_LEN,
                    **({"band_mode": band_mode} if band_mode else {}))
    log(f"band_mode: {cfg.band_mode}")

    n_pairs = N_SEQ * (N_SEQ - 1) // 2
    t_last = [time.time()]

    def progress(done, total):
        now = time.time()
        if now - t_last[0] > 15:
            t_last[0] = now
            log(f"  {done:,}/{total:,} pairs ({100*done/total:.1f}%)")

    # APD_SCALE_RUNS=N runs the whole job N times in THIS process (warm
    # compiles after run 1), so run-to-run spread is measured without
    # paying process start-up per run.
    n_runs = int(__import__("os").environ.get("APD_SCALE_RUNS", 1))
    rates = []
    for run in range(n_runs):
        stats: dict = {}
        t0 = time.time()
        D = all_pairs_distances(feats, lengths, cfg, progress=progress, stats=stats)
        wall = time.time() - t0
        pps = n_pairs / wall
        rates.append(pps)
        log(f"run {run + 1}/{n_runs}: {n_pairs:,} pairs in {wall:.1f}s = {pps:,.0f} pairs/s")
        # In the default (async) mode scatter/persist run on the scheduler's
        # worker thread, overlapped with collect-wait — NOT additive with
        # wall, so other-host sums only the main-thread stages.  Under
        # APD_SYNC_SCATTER=1 they run inline on the main thread, so the
        # label and the other-host subtraction must switch to stay additive.
        sync_scatter = os.environ.get("APD_SYNC_SCATTER", "") == "1"
        overlap_tag = "" if sync_scatter else " (overlapped)"
        other_host = wall - stats["enumerate_s"] - stats["dispatch_s"] - stats["collect_s"]
        if sync_scatter:
            other_host -= stats["scatter_s"] + stats["persist_s"]
        log(
            f"  breakdown: enumerate {stats['enumerate_s']:.1f}s, "
            f"dispatch {stats['dispatch_s']:.1f}s, "
            f"collect-wait {stats['collect_s']:.1f}s, "
            f"scatter {stats['scatter_s']:.1f}s{overlap_tag}, "
            f"persist {stats['persist_s']:.1f}s{overlap_tag}, "
            f"other-host {other_host:.1f}s, "
            f"{stats['blocks']} blocks, {stats['pad_pairs']:,} pad pairs "
            f"({100 * stats['pad_pairs'] / n_pairs:.2f}%), "
            f"upload {stats.get('upload_s', 0.0):.1f}s"
        )
    log(f"D checks: sym_err={np.abs(D - D.T).max()}, diag={np.abs(np.diag(D)).max()}, finite={np.isfinite(D).all()}")
    print(json.dumps({
        "metric": "allpairs_10k_banded_dtw_pairs_per_sec",
        "value": round(max(rates), 1),
        "unit": "pairs/s",
        "runs": [round(r, 1) for r in rates],
        "wall_s": round(n_pairs / max(rates), 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
