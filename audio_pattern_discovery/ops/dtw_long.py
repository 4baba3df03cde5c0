"""Blocked long-sequence DTW (SURVEY.md SS6.7, SS8 'the hard parts').

The reference handles long recordings by segmentation only; this rebuild
adds the long-context analogue of sequence parallelism: the [N, M] DP grid
is tiled into [BLK, BLK] blocks processed in *block anti-diagonal* order.
Block (I, J) depends only on (I-1, J), (I, J-1), (I-1, J-1), so every block
on a diagonal is independent -> one `lax.scan` step computes a whole block
diagonal (vmapped), and memory holds only O(S * S/BLK) boundary vectors,
never the O(S^2) cost matrix.  This removes the device-memory [B,S,S] cost
of the skewed scan (ops/dtw.py): sequences of tens of thousands of frames
fit.

The same block kernel drives the multi-device wavefront in
parallel/wavefront.py, where block-columns are sharded over the mesh and
the right-column boundary rides a ppermute each step (the SP/CP
analogue for DTW; prior art for the diagonal formulation:
arXiv 2008.02734).

Inside a block the intra-row dependency is resolved with a min-plus
(tropical semiring) Hillis-Steele scan: x_j = min(e_j, x_{j-1} + c_j) is
affine over (min, +), so maps compose associatively and a row falls out in
log2(BLK) full-width vector steps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# np scalar, NOT jnp: a jnp scalar constructor at module scope initializes
# the default backend at import time (accelerator start-up and a device
# memory reservation before the caller has chosen its platform).
INF = np.float32(np.inf)


def _block_cost(
    a_blk: jax.Array,        # [BLK, d]
    b_blk: jax.Array,        # [BLK, d]
    metric: str,
    matmul_dtype=None,
) -> jax.Array:
    """[BLK, BLK] frame-cost tile (Gram-matmul form).

    Delegates to ops.dtw.pairwise_cost so the numerics policy (metric
    validation, cosine normalization, the Gram trick and its
    cancellation-guarding precision recipe) lives in exactly one place.
    """
    from audio_pattern_discovery.ops.dtw import pairwise_cost

    return pairwise_cost(a_blk[None], b_blk[None], metric, matmul_dtype)[0]


def _minplus_row_scan(e: jax.Array, c: jax.Array, x_init: jax.Array) -> jax.Array:
    """x_j = min(e_j, x_{j-1} + c_j) with x_{-1} = x_init, over the last axis."""
    n = e.shape[-1]
    e = e.at[..., 0].set(jnp.minimum(e[..., 0], x_init + c[..., 0]))
    sh = 1
    lanes = jnp.arange(n)
    while sh < n:
        mask = lanes >= sh
        e_s = jnp.roll(e, sh, axis=-1)
        c_s = jnp.roll(c, sh, axis=-1)
        e = jnp.where(mask, jnp.minimum(e, e_s + c), e)
        c = jnp.where(mask, c_s + c, c)
        sh *= 2
    return e


def dtw_block_kernel(
    a_blk: jax.Array,        # [BLK, d] rows I*BLK..  of sequence a
    b_blk: jax.Array,        # [BLK, d] cols J*BLK..  of sequence b
    top: jax.Array,          # [BLK]  D[I*BLK-1, J*BLK + :]
    left: jax.Array,         # [BLK]  D[I*BLK + :, J*BLK-1]
    corner: jax.Array,       # []     D[I*BLK-1, J*BLK-1]
    row0: jax.Array,         # []     global row index I*BLK
    col0: jax.Array,         # []     global col index J*BLK
    len_a: jax.Array,        # []
    len_b: jax.Array,        # []
    *,
    metric: str,
    band: int | None,
    band_width: jax.Array | None,   # [] traced band (>= |la-lb| if widened)
    matmul_dtype=None,
    band_mode: str = "widen",
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """One DP block -> (bottom row [BLK], right col [BLK], hit value [], hit mask [])."""
    BLK = a_blk.shape[0]
    c_tile = _block_cost(a_blk, b_blk, metric, matmul_dtype)    # [BLK, BLK]

    gj = col0 + jnp.arange(BLK, dtype=jnp.int32)                # [BLK]
    gi = row0 + jnp.arange(BLK, dtype=jnp.int32)                # [BLK]
    valid = (gi[:, None] < len_a) & (gj[None, :] < len_b)
    if band is not None and band_mode == "diag":
        # Scaled corridor |j*(la-1) - i*(lb-1)| <= max(band,1)*max(la-1,lb-1)
        # (oracle/dtw.py).  Products are computed in int32 — exact for
        # lengths up to 2^15 frames per side (products < 2^31), matching
        # the oracle predicate bit-for-bit on every length this framework
        # routes; the earlier f32 form could flip corridor-edge cells past
        # 2^24 (ADVICE r4).
        den = (len_a - 1).astype(jnp.int32)
        num = (len_b - 1).astype(jnp.int32)
        r = jnp.int32(max(int(band), 1))
        lhs = jnp.abs(
            gj[None, :].astype(jnp.int32) * den
            - gi[:, None].astype(jnp.int32) * num
        )
        valid &= lhs <= r * jnp.maximum(den, num)
    elif band is not None:
        valid &= jnp.abs(gi[:, None] - gj[None, :]) <= band_width
    c_tile = jnp.where(valid, c_tile, INF)

    def row_body(carry, inp):
        prev, left_prev = carry          # prev: [BLK] D[i-1, tile]; left_prev: D[i-1, col0-1]
        c_row, left_i, gi_i = inp
        prev_shift = jnp.concatenate([left_prev[None], prev[:-1]])
        e = c_row + jnp.minimum(prev, prev_shift)
        # Virtual origin D[-1,-1] = 0 for the global cell (0, 0).
        e = e.at[0].set(
            jnp.where(
                (gi_i == 0) & (col0 == 0),
                c_row[0],
                e[0],
            )
        )
        row = _minplus_row_scan(e, c_row, left_i)
        return (row, left_i), row

    init = (top, corner)
    (_, _), rows = jax.lax.scan(
        row_body, init, (c_tile, left, gi)
    )                                                            # rows: [BLK, BLK]

    bottom = rows[-1]
    right = rows[:, -1]
    hit = (gi[:, None] == len_a - 1) & (gj[None, :] == len_b - 1)
    has_hit = jnp.any(hit)
    hit_val = jnp.sum(jnp.where(hit, rows, 0.0))
    return bottom, right, hit_val, has_hit


@partial(
    jax.jit,
    static_argnames=(
        "metric",
        "band",
        "auto_widen",
        "normalize",
        "block",
        "matmul_dtype",
        "band_mode",
    ),
)
def dtw_long_batch(
    a: jax.Array,            # [B, S, d] padded (S multiple of block)
    b: jax.Array,            # [B, S, d]
    len_a: jax.Array,        # [B] int32
    len_b: jax.Array,        # [B]
    *,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    block: int = 256,
    matmul_dtype: str | None = None,
    band_mode: str = "widen",
) -> jax.Array:
    """Batched DTW over long padded sequences; boundary-only memory.

    Drop-in for ops.dtw.dtw_batch for equal padded lengths; verified against
    it in tests/test_dtw_long.py.  Returns [B] float32 distances.
    """
    B, S, d = a.shape
    if b.shape[1] != S:
        raise ValueError("dtw_long_batch requires equal padded lengths")
    BLK = min(block, S)
    if S % BLK:
        raise ValueError(f"padded length {S} not a multiple of block {BLK}")
    nB = S // BLK                       # block-rows == block-cols
    la = len_a.astype(jnp.int32)
    lb = len_b.astype(jnp.int32)
    if band is not None:
        w = jnp.int32(band)
        bw = jnp.maximum(w, jnp.abs(la - lb)) if auto_widen else jnp.broadcast_to(w, la.shape)
    else:
        bw = None

    W = nB                              # max active blocks on a diagonal

    # vmap the block kernel over (batch, slot).
    mm_dtype = jnp.bfloat16 if matmul_dtype == "bfloat16" else None

    def one_block(a_seq, b_seq, top, left, corner, I, J, la_, lb_, bw_):
        a_blk = jax.lax.dynamic_slice_in_dim(a_seq, I * BLK, BLK, axis=0)
        b_blk = jax.lax.dynamic_slice_in_dim(b_seq, J * BLK, BLK, axis=0)
        return dtw_block_kernel(
            a_blk,
            b_blk,
            top,
            left,
            corner,
            I * BLK,
            J * BLK,
            la_,
            lb_,
            metric=metric,
            band=band,
            band_width=bw_,
            matmul_dtype=mm_dtype,
            band_mode=band_mode,
        )

    slot_block = jax.vmap(
        one_block, in_axes=(None, None, 0, 0, 0, 0, 0, None, None, None)
    )
    batch_block = jax.vmap(
        slot_block, in_axes=(0, 0, 0, 0, 0, None, None, 0, 0, 0 if band is not None else None)
    )

    def step(carry, k):
        H, V, corner_snap, out = carry
        # H: [B, nB, BLK] bottom rows per block-col; V: [B, nB, BLK] right
        # cols per block-row; corner_snap: H[..., -1] as of the START of the
        # previous step (the (I-1, J-1) bottom-right corners).
        new_snap = H[..., -1]                                   # [B, nB]

        Js = jnp.arange(W, dtype=jnp.int32)                     # slot -> J (slot == block-col)
        Is = k - Js
        active = (Is >= 0) & (Is < nB) & (Js < nB)
        Is_c = jnp.clip(Is, 0, nB - 1)

        top = H                                                 # [B, W, BLK]: slot w IS col w
        left = jnp.take_along_axis(
            V, Is_c[None, :, None].repeat(B, 0), axis=1
        )
        corner = jnp.where(
            (Js == 0)[None, :],
            jnp.where((Is_c == 0)[None, :], 0.0, INF),
            jnp.concatenate(
                [jnp.full((B, 1), INF), corner_snap[:, :-1]], axis=1
            ),
        )                                                       # [B, W]
        # Blocks in block-row 0 have no row above: top = +inf.
        top = jnp.where((Is_c == 0)[None, :, None], INF, top)
        # Blocks in block-col 0 have no col to the left: left = +inf.
        left = jnp.where((Js == 0)[None, :, None], INF, left)

        bottom, right, hit_val, has_hit = batch_block(
            a, b, top, left, corner, Is_c, Js, la, lb, bw
        )                                                       # [B, W, BLK] x2, [B, W] x2

        # Update boundaries; V scatters by block-row with inactive slots
        # dropped via an out-of-bounds index.
        H = jnp.where(active[None, :, None], bottom, H)          # slot == col
        Is_upd = jnp.where(active, Is_c, nB)
        V = V.at[:, Is_upd, :].set(right, mode="drop")

        hit_any = jnp.any(has_hit & active[None, :], axis=1)    # [B]
        hit_sum = jnp.sum(
            jnp.where(has_hit & active[None, :], hit_val, 0.0), axis=1
        )
        out = jnp.where(hit_any, hit_sum, out)
        return (H, V, new_snap, out), None

    init = (
        jnp.full((B, nB, BLK), INF),
        jnp.full((B, nB, BLK), INF),
        jnp.full((B, nB), INF),
        jnp.full((B,), INF),
    )
    ks = jnp.arange(2 * nB - 1, dtype=jnp.int32)
    (_, _, _, out), _ = jax.lax.scan(step, init, ks)
    if normalize == "path_len":
        out = out / (la + lb).astype(jnp.float32)
    elif normalize != "none":
        raise ValueError(f"unknown normalize {normalize!r}")
    return out
