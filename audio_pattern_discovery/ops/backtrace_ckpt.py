"""Checkpointed exact DTW backtrace in O(B * sqrt(N) * M) memory
(SURVEY.md SS8 'backtrace memory'; prior art: arXiv 2008.02734's
linear-memory parallelizable alignment — this is the checkpoint/recompute
variant of the same idea, chosen because it reuses the production
anti-diagonal scan and reproduces its cell values BITWISE).

Strategy: the DP grid's rows are processed in segments of `row_chunk` rows.
A forward pass stores only each segment's LAST row (the carry into the next
segment).  The backward pass then re-materializes one segment's direction
block at a time — [B, row_chunk, M] instead of [B, N, M] — and walks the
path through it on the host, hopping segment to segment.

Exactness: every cell is c[i,j] + min(three neighbors) — a pure function of
neighbor VALUES, so any decomposition of the sweep computes bitwise
identical f32 values, and the tie-break (diag > up > left) is applied to
identical operands.  Paths therefore match ops.dtw.dtw_batch_with_dirs +
ops.backtrace.walk_path exactly (tested).

Compile economy: the segment offset `s0` is a TRACED scalar (dynamic slice),
so the whole job uses at most four XLA programs — (full, tail) x
(forward, dirs) — not one per segment.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from audio_pattern_discovery.ops.dtw import INF, pairwise_cost


def _segment_scan(Cs, carry, corner, rows: int, with_dirs: bool):
    """Anti-diagonal scan over one row segment with a row carry boundary.

    Subgrid cell (i', j) sits on diagonal k = i' + j; cells with i' == 0
    take their up/diag predecessors from `carry` (lane-aligned: up =
    carry[j], diag = shift(carry)[j] with `corner` = D[s0-1, -1] shifted in
    at lane 0).  Returns (segment's last row [B, M], dirs or None).
    """
    _, B, M = Cs.shape
    j_idx = jnp.arange(M, dtype=jnp.int32)[None, :]

    def shift_j(x, fill):
        return jnp.concatenate(
            [jnp.broadcast_to(fill, (B, 1)).astype(x.dtype), x[:, :-1]], axis=1
        )

    carry_diag = shift_j(carry, corner[:, None])

    def step(state, c_row):
        prev, prev2, last_row, k = state
        top = j_idx == k                 # lanes where this diagonal hits i'==0
        d_up = jnp.where(top, carry, prev)
        d_diag = jnp.where(top, carry_diag, shift_j(prev2, INF))
        d_left = shift_j(prev, INF)
        if with_dirs:
            best01 = jnp.where(d_diag <= d_up, jnp.uint8(0), jnp.uint8(1))
            val01 = jnp.minimum(d_diag, d_up)
            dirs = jnp.where(val01 <= d_left, best01, jnp.uint8(2))
            pred = jnp.minimum(val01, d_left)
        else:
            dirs = jnp.uint8(0)          # placeholder (scan needs a leaf)
            pred = jnp.minimum(jnp.minimum(d_diag, d_up), d_left)
        cur = c_row + pred
        # Segment's last row: cell (rows-1, j) sits on diagonal k = rows-1+j.
        hit = j_idx == (k - (rows - 1))
        last_row = jnp.where(hit, cur, last_row)
        return (cur, prev, last_row, k + 1), dirs

    init = (
        jnp.full((B, M), INF),
        jnp.full((B, M), INF),
        jnp.full((B, M), INF),
        jnp.int32(0),
    )
    (_, _, last_row, _), dirs = jax.lax.scan(step, init, Cs)
    return last_row, (dirs if with_dirs else None)


@partial(
    jax.jit,
    static_argnames=("rows", "metric", "band", "auto_widen", "with_dirs",
                     "band_mode"),
)
def _segment_pass(
    a, b, len_a, len_b, carry, corner, s0, *,
    rows: int, metric: str, band: int | None, auto_widen: bool,
    with_dirs: bool, band_mode: str = "widen",
):
    """Cost + validity for absolute rows [s0, s0+rows), then the scan."""
    M = b.shape[1]
    a_seg = jax.lax.dynamic_slice_in_dim(a, s0, rows, axis=1)
    C = pairwise_cost(a_seg, b, metric)                     # [B, rows, M]
    # Validity in ABSOLUTE row coordinates (i = s0 + i').
    k = jnp.arange(rows + M - 1, dtype=jnp.int32)[:, None, None]
    j = jnp.arange(M, dtype=jnp.int32)[None, None, :]
    i_abs = k - j + s0
    la = len_a[None, :, None]
    lb = len_b[None, :, None]
    valid = (i_abs >= s0) & (i_abs < la) & (j < lb) & (k - j >= 0) & (k - j < rows)
    if band is not None and band_mode == "diag":
        # Scaled corridor (oracle/dtw.py); exact int32 predicate.
        den = la - 1
        num = lb - 1
        r = jnp.int32(max(int(band), 1))
        valid &= jnp.abs(j * den - i_abs * num) <= r * jnp.maximum(den, num)
    elif band is not None:
        w = jnp.int32(band)
        if auto_widen:
            w = jnp.maximum(w, jnp.abs(la - lb))
        valid &= jnp.abs(i_abs - j) <= w
    # Skew to diagonal-major (same layout as ops.dtw._skew_to_diagonals).
    kk = jnp.arange(rows + M - 1, dtype=jnp.int32)
    jj = jnp.arange(M, dtype=jnp.int32)
    i_idx = jnp.clip(kk[:, None] - jj[None, :], 0, rows - 1)
    Cs = jnp.take_along_axis(C, i_idx[None, :, :], axis=1)
    Cs = jnp.transpose(Cs, (1, 0, 2))
    Cs = jnp.where(valid, Cs, INF)
    return _segment_scan(Cs, carry, corner, rows, with_dirs)


def dtw_paths_checkpointed(
    a: np.ndarray,           # [B, N, d] padded
    b: np.ndarray,           # [B, M, d]
    len_a: np.ndarray,       # [B]
    len_b: np.ndarray,
    *,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    row_chunk: int | None = None,
    band_mode: str = "widen",
) -> list[list[tuple[int, int]]]:
    """Exact warping paths for B pairs in O(B * row_chunk * M) device memory.

    Default row_chunk ~ sqrt(N*8) rounded to a multiple of 8: it balances
    the carry store (N/row_chunk rows) against the per-segment dirs block
    while keeping the dispatch count ~2*N/row_chunk small (each dispatch
    pays a fixed launch cost).
    """
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    la = jnp.asarray(len_a, jnp.int32)
    lb = jnp.asarray(len_b, jnp.int32)
    B, N, _ = a.shape
    M = b.shape[1]
    if row_chunk is None:
        row_chunk = int(max(8, min(N, -(-int((8 * N) ** 0.5) // 8) * 8)))
    n_seg = -(-N // row_chunk)

    common = dict(metric=metric, band=band, auto_widen=auto_widen,
                  band_mode=band_mode)

    # Forward: store each segment's carry-in row.  Carries stay ON DEVICE
    # ([n_seg, B, M] f32 is tiny), so the forward loop enqueues all segment
    # dispatches without a single host sync.
    carries: list[jax.Array] = []
    corners: list[jax.Array] = []
    carry = jnp.full((B, M), INF)
    corner = jnp.zeros((B,), jnp.float32)      # virtual D[-1,-1] = 0
    for s in range(n_seg):
        s0 = s * row_chunk
        rows = min(row_chunk, N - s0)
        carries.append(carry)
        corners.append(corner)
        carry, _ = _segment_pass(
            a, b, la, lb, carry, corner, jnp.int32(s0),
            rows=rows, with_dirs=False, **common,
        )
        corner = jnp.full((B,), INF)           # later segments see no corner

    # Backward: re-materialize one segment's dirs block at a time and walk.
    la_np = np.asarray(la)
    lb_np = np.asarray(lb)
    pos = [(int(la_np[p]) - 1, int(lb_np[p]) - 1) for p in range(B)]
    paths: list[list[tuple[int, int]]] = [[p] for p in pos]
    for s in range(n_seg - 1, -1, -1):
        s0 = s * row_chunk
        rows = min(row_chunk, N - s0)
        if all(i < s0 for i, _ in pos):
            continue
        _, dirs = _segment_pass(
            a, b, la, lb, carries[s], corners[s],
            jnp.int32(s0), rows=rows, with_dirs=True, **common,
        )
        dirs_np = np.asarray(dirs)             # [Kseg, B, M] diagonal-major
        for p in range(B):
            i, j = pos[p]
            if i < s0:
                continue
            guard = rows + M + 2
            while i >= s0 and (i > 0 or j > 0) and guard > 0:
                d = int(dirs_np[(i - s0) + j, p, j])
                if d == 0:
                    i, j = i - 1, j - 1
                elif d == 1:
                    i -= 1
                else:
                    j -= 1
                # Clamp against corrupt directions at the true grid edges
                # (matches ops.backtrace.walk_path's guard).
                if s == 0 and i < 0:
                    i = 0
                if j < 0:
                    j = 0
                paths[p].append((i, j))
                guard -= 1
            pos[p] = (i, j)
    for p in range(B):
        paths[p].reverse()
    return paths
