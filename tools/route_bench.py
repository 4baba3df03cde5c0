#!/usr/bin/env python
"""Tile kernel vs plain XLA path, end to end through all_pairs_distances.

For each shape (S, d, band) of the PERF.md table, one process times the
whole all-pairs job over K random sequences twice per route — `tiled=True`
(ops/dtw_tile.py) and `tiled=False` (the per-pair blocks of ops/dtw.py) —
after one warm-up job per route that compiles its programs, and reports
the warm wall time, pairs/s and the largest relative difference between
the two matrices.  Needs a CUDA GPU.

Usage: python tools/route_bench.py [K] [S,d,band ...]
  e.g. python tools/route_bench.py 2048 128,16,16 128,16,none
Prints one JSON line per shape on stdout.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

DEFAULT_SHAPES = ["128,16,16", "128,16,none", "512,16,none", "128,513,none"]


def _parse(shape: str) -> tuple[int, int, int | None]:
    s, d, band = shape.split(",")
    return int(s), int(d), None if band.lower() == "none" else int(band)


def main(argv: list[str]) -> int:
    K = int(argv[0]) if argv else 2048
    shapes = [_parse(x) for x in (argv[1:] or DEFAULT_SHAPES)]

    import jax

    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel.pair_scheduler import (
        all_pairs_distances,
    )
    from audio_pattern_discovery.platform import require_gpu
    from audio_pattern_discovery.synthetic import random_sequences
    from audio_pattern_discovery.utils.doctor import gpu_name_and_power_limit

    require_gpu("route_bench")
    gpu = gpu_name_and_power_limit()
    print(f"# {gpu}; {jax.devices()[0].device_kind}", file=sys.stderr)
    n_pairs = K * (K - 1) // 2
    for S, d, band in shapes:
        feats, lens = random_sequences(K, S, d, seed=S + d)
        cfg = DTWConfig(band=band, band_mode="diag", normalize="none")
        row = {"K": K, "seq_len": S, "feat_dim": d, "band": band, "gpu": gpu}
        mats = {}
        for name, tiled in (("tile", True), ("plain", False)):
            t0 = time.perf_counter()
            mats[name] = all_pairs_distances(feats, lens, cfg, tiled=tiled)
            row[f"{name}_first_s"] = round(time.perf_counter() - t0, 4)
        for name, tiled in (("tile", True), ("plain", False),
                            ("plain", False), ("tile", True)):
            t0 = time.perf_counter()
            all_pairs_distances(feats, lens, cfg, tiled=tiled)
            dt = time.perf_counter() - t0
            row.setdefault(f"{name}_s", []).append(round(dt, 4))
        for name in ("tile", "plain"):
            row[f"{name}_pairs_per_s"] = round(n_pairs / min(row[f"{name}_s"]))
        off = ~np.eye(K, dtype=bool)
        a, b = mats["tile"][off], mats["plain"][off]
        row["max_rel_diff_offdiag"] = float(
            np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6))
        )
        row["speedup"] = round(min(row["plain_s"]) / min(row["tile_s"]), 2)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
