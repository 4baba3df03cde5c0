#!/usr/bin/env python
"""Host scatter microbench: fused C++ block scatter vs the NumPy chain.

Times ONLY the host assembly half of the tiled pair scheduler (no device,
no jax): synthetic [ti, ti] blocks driven through the same scatter_chunk code
paths via all-tile-pair chunks.  This half outlasts the device in the
config-4 job on the GPU (PERF.md).

Usage: python tools/scatter_bench.py [K] [ti]   (defaults 10240 128)
Strip mode is timed at the same K with the direct threshold forced to 0,
on a sampled subset of tile-rows when the full strip state would not fit
host RAM.  Prints per-mode wall + the native/numpy ratio.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    K = int(sys.argv[1]) if len(sys.argv) > 1 else 10_240
    ti = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    from audio_pattern_discovery import native

    if not native.available():
        print("native library unavailable", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    nT = -(-K // ti)
    Kp = nT * ti
    perm = rng.permutation(K).astype(np.int64)
    inv = np.argsort(perm)
    ls_f = np.ones(Kp, np.float32)
    ls_f[:K] = rng.integers(64, 129, K).astype(np.float32)
    pairs = [(i, j) for i in range(nT) for j in range(i, nT)]
    # one shared random block re-used for every pair: scatter cost is
    # destination-bound, the source values don't matter
    blk = rng.normal(0, 1, (ti, ti)).astype(np.float32)
    D = np.zeros((K, K), np.float32)
    print(f"K={K} ti={ti}: {len(pairs)} tile-pair blocks "
          f"({len(pairs) * ti * ti * 4 / 2**20:.0f} MiB of block data), "
          f"D = {K * K * 4 / 2**20:.0f} MiB", file=sys.stderr)

    # ---- direct mode ----
    def run_direct(use_native: bool) -> float:
        t0 = time.perf_counter()
        for I, J in pairs:
            r0, c0 = I * ti, J * ti
            nr, nc = min(ti, K - r0), min(ti, K - c0)
            if use_native:
                native.scatter_block_direct(
                    blk, nr, nc, ls_f[r0:r0 + nr], ls_f[c0:c0 + nc],
                    perm[r0:r0 + nr], perm[c0:c0 + nc], D, I == J,
                )
                continue
            b = blk[:nr, :nc] / (
                ls_f[r0:r0 + nr][:, None] + ls_f[c0:c0 + nc][None, :]
            )
            ro, co = perm[r0:r0 + nr], perm[c0:c0 + nc]
            if I == J:
                sym = np.triu(b, k=1)
                D[np.ix_(ro, co)] = sym + sym.T
            else:
                D[np.ix_(ro, co)] = b
                D[np.ix_(co, ro)] = b.T
        return time.perf_counter() - t0

    for label, un in (("numpy", False), ("native", True), ("numpy2", False),
                      ("native2", True)):
        s = run_direct(un)
        print(f"direct {label}: {s:.2f} s "
              f"({len(pairs) / s:,.0f} blocks/s)", file=sys.stderr)
        if label == "numpy2":
            d_np = s
        elif label == "native2":
            d_nat = s

    # ---- strip mode (faithful to scatter_chunk: a pair (I, J) writes the
    # block into strip I at c0 AND its transpose into strip J at r0, exactly
    # strip_add).  All nT strips are allocated when the full strip state
    # (= K^2 floats, same as D) fits a 2 GiB budget; otherwise both I and J
    # are restricted to a sampled strip prefix so every mirror lands in an
    # allocated buffer — the real scheduler's write pattern on a sub-square.
    if K * K * 4 <= 2 * 2**30:
        strips = list(range(nT))
    else:
        strips = list(range(max(4, int(2 * 2**30 / (ti * K * 4)))))
    spairs = [(i, j) for i in strips for j in strips if j >= i]
    n_pieces = sum(1 if i == j else 2 for i, j in spairs)
    print(f"strip mode: {len(strips)} strips, {len(spairs)} tile-pairs = "
          f"{n_pieces} strip_add pieces", file=sys.stderr)

    def run_strip(use_native: bool) -> float:
        bufs = {i: np.zeros((min(ti, K - i * ti), K), np.float32)
                for i in strips}
        t0 = time.perf_counter()
        for I, J in spairs:
            r0, c0 = I * ti, J * ti
            nr, nc = min(ti, K - r0), min(ti, K - c0)
            if use_native:
                native.scatter_block_strip(
                    blk, nr, nc, ls_f[r0:r0 + nr], ls_f[c0:c0 + nc],
                    bufs[I], c0, None if I == J else bufs[J], r0,
                )
                continue
            b = blk[:nr, :nc] / (
                ls_f[r0:r0 + nr][:, None] + ls_f[c0:c0 + nc][None, :]
            )
            if I == J:
                sym = np.triu(b, k=1)
                bufs[I][:, c0:c0 + nc] = sym + sym.T
            else:
                bufs[I][:, c0:c0 + nc] = b
                bufs[J][:, r0:r0 + nr] = np.ascontiguousarray(b.T)
        # strip completion
        for i in strips:
            rows = perm[i * ti:i * ti + bufs[i].shape[0]]
            if use_native:
                native.strip_unpermute(bufs[i], inv, rows, D)
            else:
                D[rows] = np.take(bufs[i], inv, axis=1)
        return time.perf_counter() - t0

    s_np = min(run_strip(False), run_strip(False))
    s_nat = min(run_strip(True), run_strip(True))
    print(f"strip numpy: {s_np:.2f} s   strip native: {s_nat:.2f} s",
          file=sys.stderr)
    print(f"RESULT direct native/numpy = {d_np / d_nat:.2f}x   "
          f"strip native/numpy = {s_np / s_nat:.2f}x", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
