#!/usr/bin/env python
"""Incremental-update economics at contract scale: grow a K-sequence corpus
by a fraction F of new sequences and compare `known=`-update DTW cost to the
full-triangle recompute (parallel/pair_scheduler.py `known`, SS6.4).

Usage: python tools/update_bench.py [K] [F]   (defaults: 10000 0.05)
Prints one JSON line to stdout; detail on stderr.  JAX_PLATFORMS=cpu for a
host smoke run (tiny K recommended).
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SEQ_LEN = 128
LATENT_DIM = 16
BAND = 16


def log(m):
    print(m, file=sys.stderr, flush=True)


def main() -> int:
    import jax
    import jax.numpy as jnp

    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel.pair_scheduler import (
        all_pairs_distances,
    )

    K = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
    frac = float(sys.argv[2]) if len(sys.argv) > 2 else 0.05
    k_old = K - int(round(K * frac))
    log(f"device: {jax.devices()[0]}; K={K}, k_old={k_old} (+{K - k_old} new)")

    rng = np.random.default_rng(0)
    feats_np = rng.normal(0, 1, (K, SEQ_LEN, LATENT_DIM)).astype(np.float32)
    lengths = rng.integers(SEQ_LEN // 2, SEQ_LEN + 1, K).astype(np.int32)
    feats = jnp.asarray(feats_np)
    np.asarray(feats[0, 0, 0])
    cfg = DTWConfig(band=BAND, max_seq_len=SEQ_LEN)

    # Warm run 1 of the process pays handshake/compiles as always; judge by
    # the per-phase warm numbers below.
    n_runs = int(os.environ.get("APD_UPDATE_RUNS", 2))
    full_s, up_s = [], []
    for run in range(n_runs):
        t0 = time.time()
        D_full = all_pairs_distances(feats, lengths, cfg)
        full_s.append(time.time() - t0)
        log(f"run {run + 1}: full triangle {full_s[-1]:.1f}s")

        stats: dict = {}
        t0 = time.time()
        D_up = all_pairs_distances(
            feats, lengths, cfg,
            known=(k_old, D_full[:k_old, :k_old]), stats=stats,
        )
        up_s.append(time.time() - t0)
        log(
            f"run {run + 1}: update {up_s[-1]:.1f}s "
            f"({stats['pairs']:,} computed pairs"
            + (f", {stats['tile_programs']} tile programs" if "tile_programs" in stats else "")
            + ")"
        )
        err = float(np.abs(D_up - D_full).max())
        log(f"  max |D_update - D_full| = {err:.2e}")
        assert err < 1e-4, "update diverged from full recompute"

    n_new_pairs = K * (K - 1) // 2 - k_old * (k_old - 1) // 2
    print(json.dumps({
        "metric": "update_vs_full_speedup",
        "K": K,
        "new_fraction": frac,
        "value": round(min(full_s) / min(up_s), 2),
        "unit": "x",
        "full_s": [round(x, 1) for x in full_s],
        "update_s": [round(x, 1) for x in up_s],
        "new_pairs": n_new_pairs,
        "pair_share": round(n_new_pairs / (K * (K - 1) // 2), 4),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
