"""All-pairs DTW tile kernel for the GPU (Pallas through Triton).

Why a kernel: the plain path (ops/dtw.py) materializes a [B, N, M] cost
tensor, a skewed copy and a validity grid in device memory per block, then
walks N+M-1 anti-diagonals as a `lax.scan` — one small device step each.
Here one program computes a whole DP on chip and device memory sees only
the feature sequences, one strip-boundary column and one scalar per pair.

Layout.  The scheduler sorts sequences by length and cuts them into tiles
of `ti`.  Program (u, r) of the grid takes tile-pair u = (I, J) and row r
of tile I: the row sequence y = corpus[I*ti + r] is shared by the whole
program, and lane p holds the pair (y, corpus[J*ti + p]).  The pair index
therefore runs across threads: one warp per program, ti/32 pairs per
thread.

DP order.  DTW is symmetric, so each lane runs its own sequence x_p down
the DP rows i and y along the columns j.  The columns are cut into strips
of `strip` slots.  Within a strip the DP row lives in registers (one
value per slot per lane) and the strip is swept row by row; the strip's
last column is written to a boundary buffer in device memory, which the
next strip reads as its left neighbour.  Frame costs are computed in fp32
from the features by direct differences (no Gram, no tensor cores), so
self-pairs come out exactly zero.

Band.  `band=None` is the unbanded DP.  An integer band is the "diag"
corridor of oracle/dtw.py: cell (i, j) of an la x lb grid is valid iff
|j*(la-1) - i*(lb-1)| <= max(band, 1) * max(la-1, lb-1).  Each strip only
sweeps the rows where some lane's corridor meets its columns, so banded
work scales with the corridor width, not with la*lb.  Every loop bound is
computed inside the kernel from the lengths, so one compiled program
serves every length mix at a given (S, d, band, metric).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Plain Python float so the kernel traces it as an inline constant.
INF = float("inf")

# Feature widths up to this are unrolled in the cost loop; wider features
# (raw spectrogram bins) loop over the channel axis instead.
_UNROLL_FEATURES = 32


def _tile_kernel(
    ti_ref,      # [U] i32 tile-row index of each tile-pair
    tj_ref,      # [U] i32 tile-col index
    lens_ref,    # [K] i32 sequence lengths (pad entries: 1)
    y_ref,       # [K, S, d] f32 sequences (row side, scalar loads)
    x_ref,       # [nT, S, d, ti] f32 sequences, tile-major, pair on the minor axis
    out_ref,     # [U, ti, ti] f32 distances
    col_ref,     # [U, ti, S, ti] f32 strip-boundary column (scratch)
    *,
    band: int | None,
    metric: str,
    strip: int,
):
    S, d, P = x_ref.shape[1], x_ref.shape[2], x_ref.shape[3]
    u = pl.program_id(0)
    r = pl.program_id(1)
    J = tj_ref[u]
    g = ti_ref[u] * P + r
    lu = lens_ref[g]                                  # row sequence length
    lp = lens_ref[pl.ds(J * P, P)]                    # [P] lane lengths
    den = lu - 1
    num = lp - 1
    if band is not None:
        rm = max(int(band), 1) * jnp.maximum(num, den)  # corridor half-width
    inf_p = jnp.full((P,), INF, jnp.float32)

    def cell_costs(i, j0):
        """[strip] lane vectors of frame costs for row i, columns j0 + w."""
        cols = [jnp.minimum(j0 + w, S - 1) for w in range(strip)]

        def channel(c, acc):
            xc = x_ref[J, i, c, :]
            out = []
            for w in range(strip):
                yc = y_ref[g, cols[w], c]
                if metric == "cosine":
                    out.append(acc[w] + xc * yc)
                else:
                    t = xc - yc
                    out.append(acc[w] + t * t)
            return tuple(out)

        acc = tuple(jnp.zeros((P,), jnp.float32) for _ in range(strip))
        if d <= _UNROLL_FEATURES:
            for c in range(d):
                acc = channel(c, acc)
        else:
            acc = jax.lax.fori_loop(0, d, channel, acc)
        if metric == "cosine":
            return [1.0 - a for a in acc]
        if metric == "euclidean":
            return [jnp.sqrt(a) for a in acc]
        return list(acc)

    def valid(i, j):
        ok = (i < lp) & (j < lu)
        if band is not None:
            ok = ok & (jnp.abs(j * num - i * den) <= rm)
        return ok

    def row_range(j0):
        """Hull over lanes of the rows whose valid cells meet the strip."""
        if band is None:
            # A traced zero: the strip loop carries i_lo, and the Triton
            # lowering cannot carry a literal.
            return jnp.min(0 * num), jnp.max(num)
        j1 = jnp.minimum(j0 + strip - 1, den)
        safe = jnp.maximum(den, 1)
        a = j0 * num - rm
        lo = jnp.where(a <= 0, 0, jax.lax.div(a + safe - 1, safe))
        hi = jnp.minimum(jax.lax.div(j1 * num + rm, safe), num)
        lo = jnp.where(den == 0, 0, lo)
        hi = jnp.where(den == 0, num, hi)
        return jnp.min(lo), jnp.max(hi)

    def strip_body(s, carry):
        out, prev_lo, prev_hi = carry
        j0 = s * strip
        i_lo, i_hi = row_range(j0)

        def left_of(i):
            # D[i, j0-1]: written by the previous strip for its own rows;
            # every other row of that column is outside all corridors.
            ok = (i >= prev_lo) & (i <= prev_hi)
            v = col_ref[u, r, jnp.clip(i, 0, S - 1), :]
            return jnp.where(ok, v, inf_p)

        # Diagonal predecessor of the strip's first row: the virtual start
        # D[-1, -1] = 0 for the first strip, else D[i_lo-1, j0-1].
        dl0 = jnp.where((i_lo == 0) & (j0 == 0), 0.0, left_of(i_lo - 1))

        def row_body(i, rc):
            row, dl, out = rc
            left = left_of(i)
            costs = cell_costs(i, j0)
            new = []
            diag = dl
            cur = left
            for w in range(strip):
                j = j0 + w
                c = jnp.where(valid(i, j), costs[w], inf_p)
                up = row[w]
                cur = c + jnp.minimum(jnp.minimum(up, diag), cur)
                out = jnp.where((i == num) & (j == den), cur, out)
                diag = up
                new.append(cur)
            col_ref[u, r, i, :] = cur
            return tuple(new), left, out

        init = (tuple(inf_p for _ in range(strip)), dl0, out)
        _, _, out = jax.lax.fori_loop(i_lo, i_hi + 1, row_body, init)
        return out, i_lo, i_hi

    n_strips = jax.lax.div(lu + strip - 1, strip)
    out, _, _ = jax.lax.fori_loop(
        0, n_strips, strip_body, (inf_p, jnp.int32(1), jnp.int32(0))
    )
    out_ref[u, r, :] = out


def default_strip(band: int | None, feat_dim: int) -> int:
    """Strip width by shape, as measured on the H100 (PERF.md): narrow
    strips for the "diag" corridor (each strip sweeps ~strip*ratio + 2*band
    rows, so wider strips sweep more rows outside it), wider ones unbanded,
    widest for raw-bin features, where each strip row loads all d lane
    features once."""
    if band is not None:
        return 8
    return 32 if feat_dim > _UNROLL_FEATURES else 16


def scratch_bytes(U: int, ti: int, seq_len: int) -> int:
    """Device bytes of the strip-boundary buffer of one call."""
    return U * ti * seq_len * ti * 4


@partial(
    jax.jit,
    static_argnames=("ti", "band", "metric", "strip", "interpret"),
)
def dtw_tile_pairs(
    feats,        # [K, S, d] f32 padded sequences (device-resident corpus)
    lengths,      # [K] i32 (pad entries: length 1)
    ti_idx,       # [U] i32 tile-row indices
    tj_idx,       # [U] i32 tile-col indices
    *,
    ti: int,
    band: int | None = None,
    metric: str = "euclidean",
    strip: int | None = None,
    interpret: bool = False,
):
    """DTW distances for U tile-pairs -> [U, ti, ti] blocks, where block u
    holds dist(corpus[I*ti + a], corpus[J*ti + b]) at [a, b] for
    (I, J) = (ti_idx[u], tj_idx[u]).  Unnormalized; `band` is the "diag"
    corridor or None.  `ti` must be a power of two and K a multiple of
    it.  `strip` (columns per DP strip) defaults to `default_strip`; results
    do not depend on it.  `interpret=True` runs the Pallas interpreter
    (tests only)."""
    import chex

    chex.assert_rank(feats, 3)
    chex.assert_rank([lengths, ti_idx, tj_idx], 1)
    K, S, d = feats.shape
    if K % ti:
        raise ValueError(f"K={K} must be padded to a multiple of ti={ti}")
    if ti & (ti - 1):
        raise ValueError(f"ti={ti} must be a power of two")
    if metric not in ("euclidean", "sqeuclidean", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    if strip is None:
        strip = default_strip(band, d)
    f32 = feats.astype(jnp.float32)
    if metric == "cosine":
        f32 = f32 / jnp.maximum(
            jnp.linalg.norm(f32, axis=-1, keepdims=True), 1e-12
        )
    x = jnp.transpose(f32.reshape(K // ti, ti, S, d), (0, 2, 3, 1))
    U = ti_idx.shape[0]
    out, _ = pl.pallas_call(
        partial(_tile_kernel, band=band, metric=metric, strip=strip),
        grid=(U, ti),
        out_shape=(
            jax.ShapeDtypeStruct((U, ti, ti), jnp.float32),
            jax.ShapeDtypeStruct((U, ti, S, ti), jnp.float32),
        ),
        backend="triton",
        # One warp per program: as fast as four in the measurements
        # (PERF.md), and it rules out a lane vector replicated across warps
        # racing on the boundary buffer.
        compiler_params=pl_triton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="dtw_tile",
    )(ti_idx.astype(jnp.int32), tj_idx.astype(jnp.int32),
      lengths.astype(jnp.int32), f32, x)
    return out
