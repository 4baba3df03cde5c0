"""Multi-device DTW wavefront decomposition (SURVEY.md SS6.7, SS3 row 9).

The long-context / sequence-parallel analogue for this workload: ONE very
long DTW pair is decomposed across the mesh.  Block-columns of the blocked
DP grid (ops/dtw_long.py) are sharded over a 1-D "seq" mesh axis; blocks on
a block anti-diagonal are independent, so at every scan step each device
computes the active blocks of its own column stripe and hands exactly one
[BLK] right-column boundary (plus its corner scalar) to its right neighbor
via `ppermute` — a halo exchange of one diagonal per step, the
pattern ring-attention uses for attention and arXiv 2008.02734 describes
for DTW.

The reference has nothing comparable (single-process CPU; long recordings
are only ever segmented).  Memory per device: O(S * S / (P * BLK)) boundary
vectors; no device ever holds the O(S^2) cost matrix, and sequence b is
itself sharded so arbitrarily long inputs scale with the mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map as _shard_map_impl

    _REP_KWARG = "check_vma"
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map as _shard_map_impl

    _REP_KWARG = "check_rep"


def _shard_map(f, **kw):
    # jax >= 0.8 names the replication-check kwarg check_vma; the
    # experimental module it replaced called it check_rep.
    return _shard_map_impl(f, **{_REP_KWARG: False}, **kw)

from audio_pattern_discovery.ops.dtw_long import dtw_block_kernel

# np scalar, NOT jnp: a jnp scalar constructor at module scope initializes
# the default backend at import time (accelerator start-up and a device
# memory reservation before the caller has chosen its platform).
INF = np.float32(np.inf)

# Compiled-callable cache: one jitted shard_map per static configuration
# (mesh, axis, metric, band shape, block grid, batch).  The shard_fn closure
# passed in is behaviorally determined by the key, so the first one seen is
# kept; without this every dtw_wavefront_sharded call would re-trace the
# full 2*nB-1-step scan.
_WAVEFRONT_CACHE: dict[tuple, object] = {}


def _cached_wavefront_fn(mesh, axis, metric, band, auto_widen, blk, n_blocks, batch, shard_fn):
    key = (mesh, axis, metric, band, auto_widen, blk, n_blocks, batch)
    fn = _WAVEFRONT_CACHE.get(key)
    if fn is None:
        fn = jax.jit(
            _shard_map(
                shard_fn,
                mesh=mesh,
                in_specs=(P(), P(None, axis, None), P(), P(), P()),
                out_specs=P(),
            )
        )
        _WAVEFRONT_CACHE[key] = fn
    return fn


def dtw_wavefront_sharded(
    a,                       # [B, S, d] (replicated; the "query" sequence rows)
    b,                       # [B, S, d] (sharded over "seq" on axis 1)
    len_a,                   # [B] int32
    len_b,                   # [B]
    mesh: Mesh,
    *,
    axis: str = "seq",
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    block: int = 256,
):
    """Batched DTW with block-columns sharded across `mesh[axis]`.

    Returns [B] float32 distances, numerically identical to
    ops.dtw_long.dtw_long_batch (tested on the virtual CPU mesh).
    """
    B, S, d = a.shape
    n_dev = mesh.shape[axis]
    BLK = min(block, S)
    if S % BLK:
        raise ValueError(f"padded length {S} not a multiple of block {BLK}")
    nB = S // BLK
    if nB % n_dev:
        raise ValueError(f"{nB} block-columns not divisible by {n_dev} devices")
    nJl = nB // n_dev                   # block-columns per device

    la = len_a.astype(jnp.int32)
    lb = len_b.astype(jnp.int32)
    if band is not None:
        w = jnp.int32(band)
        bw = jnp.maximum(w, jnp.abs(la - lb)) if auto_widen else jnp.broadcast_to(w, la.shape)
    else:
        bw = la * 0  # unused placeholder (static band=None skips it)

    def one_block(a_seq, b_stripe, top, left, corner, I, Jl, la_, lb_, bw_, J0):
        a_blk = jax.lax.dynamic_slice_in_dim(a_seq, I * BLK, BLK, axis=0)
        b_blk = jax.lax.dynamic_slice_in_dim(b_stripe, Jl * BLK, BLK, axis=0)
        return dtw_block_kernel(
            a_blk,
            b_blk,
            top,
            left,
            corner,
            I * BLK,
            (J0 + Jl) * BLK,
            la_,
            lb_,
            metric=metric,
            band=band,
            band_width=bw_ if band is not None else None,
        )

    slot_block = jax.vmap(
        one_block, in_axes=(None, None, 0, 0, 0, 0, 0, None, None, None, None)
    )
    batch_block = jax.vmap(
        slot_block, in_axes=(0, 0, 0, 0, 0, None, None, 0, 0, 0, None)
    )

    def shard_fn(a_rep, b_sh, la_, lb_, bw_):
        # b_sh: [B, S/n_dev, d] — this device's column stripe.
        dev = jax.lax.axis_index(axis)
        J0 = dev * nJl                                           # global first block-col

        def step(carry, k):
            H, V, snap, edge_in, edge_last_prev, out = carry
            new_snap = H[..., -1]                                # [B, nJl]
            new_edge_last = edge_in[..., -1]                     # [B]

            Jls = jnp.arange(nJl, dtype=jnp.int32)               # local slot -> Jl
            Js = J0 + Jls                                        # global J
            Is = k - Js
            active = (Is >= 0) & (Is < nB)
            Is_c = jnp.clip(Is, 0, nB - 1)

            top = H                                              # [B, nJl, BLK] (slot == col)
            top = jnp.where((Is_c == 0)[None, :, None], INF, top)
            left = jnp.take_along_axis(
                V, Is_c[None, :, None].repeat(B, 0), axis=1
            )
            corner = jnp.concatenate(
                [edge_last_prev[:, None], snap[:, :-1]], axis=1
            )                                                    # [B, nJl]
            # Stripe-first slot takes the neighbor's halo instead of locals.
            left = left.at[:, 0, :].set(edge_in)
            # Global col 0 has no left neighbor at all.
            left = jnp.where((Js == 0)[None, :, None], INF, left)
            corner = jnp.where(
                (Js == 0)[None, :],
                jnp.where((Is_c == 0)[None, :], 0.0, INF),
                corner,
            )
            # Block-row 0 has no top-left neighbor for any col > 0: without
            # this mask, slot 0 of a stripe consumes edge_last_prev — the
            # halo of an INACTIVE neighbor block computed from a stale
            # V[:, 0] left boundary — and the distance skips a whole
            # block-column of costs whenever a stripe holds >= 3 columns.
            corner = jnp.where(((Is_c == 0) & (Js != 0))[None, :], INF, corner)

            bottom, right, hit_val, has_hit = batch_block(
                a_rep, b_sh, top, left, corner, Is_c, Jls, la_, lb_, bw_, J0
            )

            keep = active[None, :, None]
            H = jnp.where(keep, bottom, H)
            V_upd_idx = jnp.where(active, Is_c, nB)
            V = V.at[:, V_upd_idx, :].set(right, mode="drop")

            hit_any = jnp.any(has_hit & active[None, :], axis=1)
            hit_sum = jnp.sum(
                jnp.where(has_hit & active[None, :], hit_val, 0.0), axis=1
            )
            out = jnp.where(hit_any, hit_sum, out)

            # Halo: this stripe's LAST column's right col rides to the right
            # neighbor; it is consumed there at step k+1.
            edge_out = right[:, -1, :]                           # [B, BLK]
            edge_next = jax.lax.ppermute(
                edge_out,
                axis_name=axis,
                perm=[(i, (i + 1) % n_dev) for i in range(n_dev)],
            )
            return (H, V, new_snap, edge_next, new_edge_last, out), None

        init = (
            jnp.full((B, nJl, BLK), INF),
            jnp.full((B, nB, BLK), INF),
            jnp.full((B, nJl), INF),
            jnp.full((B, BLK), INF),
            jnp.full((B,), INF),
            jnp.full((B,), INF),
        )
        ks = jnp.arange(2 * nB - 1, dtype=jnp.int32)
        (_, _, _, _, _, out), _ = jax.lax.scan(step, init, ks)
        # Exactly one device saw the terminal cell; the rest carry +inf.
        return jax.lax.pmin(out, axis)

    fn = _cached_wavefront_fn(
        mesh, axis, metric, band, auto_widen, BLK, nB, B, shard_fn
    )
    out = fn(a, b, la, lb, bw)
    if normalize == "path_len":
        out = out / (la + lb).astype(jnp.float32)
    elif normalize != "none":
        raise ValueError(f"unknown normalize {normalize!r}")
    return out


def shard_b_for_wavefront(b, mesh: Mesh, axis: str = "seq"):
    """Place [B, S, d] b with its sequence axis sharded over the mesh."""
    return jax.device_put(b, NamedSharding(mesh, P(None, axis, None)))
