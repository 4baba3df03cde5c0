"""Batched anti-diagonal wavefront DTW in plain JAX (SURVEY.md SS3 rows 5-6,
SS4.3): the plain XLA path of the all-pairs router, and the reference the
tile kernel is tested against.  Design:

* The O(N*M) recurrence is serialized only across *anti-diagonals*: cells on
  diagonal k = i+j depend on diagonals k-1 and k-2 and are otherwise
  independent (prior art: arXiv 2008.02734, linear-memory parallel DTW).
  We iterate diagonals with `lax.scan`; each step updates a whole [B, S]
  wavefront for a batch of B pairs at once.
* The pairwise frame-cost matrix is where the FLOPs are: for (sq)euclidean
  and cosine it reduces to a batched matmul (|a|^2 + |b|^2 - 2ab^T), which
  XLA hands to its matmul libraries.  The cost tensor is then *skewed* into
  diagonal-major layout once, so every scan step reads a contiguous row —
  no per-step diagonal gathers.
* Ragged pair lengths are handled with +inf masking over a padded [B, S, S]
  grid: invalid cells (past a sequence's true length, or outside the
  Sakoe-Chiba band) cost +inf, which min() propagation ignores; the final
  distance is extracted at each pair's true terminal cell (len_a-1, len_b-1)
  as the scan passes its diagonal.  Padding therefore cannot perturb results
  (tested: padding invariance, SURVEY.md SS5.2).
* Sakoe-Chiba band |i-j| <= w is a masking predicate; per-pair auto-widening
  to >= |len_a - len_b| keeps a feasible path without dynamic shapes.

The GPU tile kernel (ops/dtw_tile.py) implements the same recurrence with
the cost computed on chip (no [B,S,S] round-trip through device memory);
this module runs on every platform.
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


# --------------------------------------------------------------------- costs
def pairwise_cost(
    a: jax.Array,            # [B, N, d]
    b: jax.Array,            # [B, M, d]
    metric: str = "euclidean",
    matmul_dtype: jnp.dtype | None = None,
) -> jax.Array:
    """Batched frame-to-frame cost matrices [B, N, M] (Gram-matmul form).

    `matmul_dtype=jnp.bfloat16` runs the Gram matmul in bf16 with f32
    accumulation.
    """
    if metric == "cosine":
        a = a / jnp.maximum(jnp.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
        b = b / jnp.maximum(jnp.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    am, bm = (a, b)
    # Precision: a reduced-precision f32 matmul (TF32 or bf16 passes)
    # catastrophically cancels in the |a|^2+|b|^2-2ab Gram trick
    # (self-distances come out ~0.1, not 0).  f32 inputs therefore request
    # HIGHEST explicitly; the fast path is opting into bf16 storage via
    # matmul_dtype, which keeps DEFAULT.
    precision = jax.lax.Precision.HIGHEST
    if matmul_dtype is not None:
        am, bm = a.astype(matmul_dtype), b.astype(matmul_dtype)
        precision = jax.lax.Precision.DEFAULT
    gram = jax.lax.dot_general(
        am,
        bm,
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=precision,
    )  # [B, N, M]
    if metric == "cosine":
        return 1.0 - gram
    sq_a = jnp.sum(a * a, axis=-1, dtype=jnp.float32)  # [B, N]
    sq_b = jnp.sum(b * b, axis=-1, dtype=jnp.float32)  # [B, M]
    sq = sq_a[:, :, None] + sq_b[:, None, :] - 2.0 * gram
    sq = jnp.maximum(sq, 0.0)
    if metric == "sqeuclidean":
        return sq
    if metric == "euclidean":
        return jnp.sqrt(sq)
    raise ValueError(f"unknown metric {metric!r}")


def _skew_to_diagonals(C: jax.Array) -> jax.Array:
    """[B, N, M] cost -> [K=N+M-1, B, M] diagonal-major: out[k,b,j] = C[b,k-j,j].

    Out-of-grid entries (k-j outside [0,N)) are clamped garbage; callers mask
    them with the validity grid before use.
    """
    B, N, M = C.shape
    k = jnp.arange(N + M - 1, dtype=jnp.int32)
    j = jnp.arange(M, dtype=jnp.int32)
    i_idx = jnp.clip(k[:, None] - j[None, :], 0, N - 1)        # [K, M]
    Cs = jnp.take_along_axis(C, i_idx[None, :, :], axis=1)      # [B, K, M]
    return jnp.transpose(Cs, (1, 0, 2))                         # [K, B, M]


def _validity_grid(
    N: int,
    M: int,
    len_a: jax.Array,        # [B]
    len_b: jax.Array,        # [B]
    band: int | None,
    auto_widen: bool,
    band_mode: str = "widen",
) -> jax.Array:
    """[K, B, M] bool: cell (i=k-j, j) is inside both sequences and the band.

    `band_mode="diag"` uses the scaled Sakoe-Chiba corridor
    |j*(la-1) - i*(lb-1)| <= max(band,1)*max(la-1, lb-1) (semantics and
    properties: oracle/dtw.py module docstring).  The predicate is exact in
    int32: products are bounded by (N-1)*(M-1) < 2^31 for every padded
    length this framework routes here (<= 2^15 frames each side).
    """
    k = jnp.arange(N + M - 1, dtype=jnp.int32)[:, None, None]   # [K, 1, 1]
    j = jnp.arange(M, dtype=jnp.int32)[None, None, :]           # [1, 1, M]
    i = k - j                                                   # [K, 1, M]
    la = len_a.astype(jnp.int32)[None, :, None]
    lb = len_b.astype(jnp.int32)[None, :, None]
    valid = (i >= 0) & (i < la) & (j < lb)
    if band is None:
        return valid
    if band_mode == "diag":
        den = la - 1
        num = lb - 1
        r = jnp.int32(max(int(band), 1))
        valid &= jnp.abs(j * den - i * num) <= r * jnp.maximum(den, num)
    elif band_mode == "widen":
        w = jnp.int32(band)
        if auto_widen:
            w = jnp.maximum(w, jnp.abs(la - lb))
        valid &= jnp.abs(i - j) <= w
    else:
        raise ValueError(f"unknown band_mode {band_mode!r}")
    return valid


# ----------------------------------------------------------------- wavefront
@partial(
    jax.jit,
    static_argnames=("metric", "band", "auto_widen", "normalize", "matmul_dtype",
                     "band_mode"),
)
def dtw_batch(
    a: jax.Array,            # [B, N, d] padded
    b: jax.Array,            # [B, M, d] padded
    len_a: jax.Array,        # [B] int32
    len_b: jax.Array,        # [B] int32
    *,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    matmul_dtype: str | None = None,
    band_mode: str = "widen",
) -> jax.Array:
    """All B DTW distances in one device dispatch.  Returns [B] float32."""
    import chex

    # Trace-time shape/dtype invariants (SURVEY.md SS6.2: chex assertions are
    # the static half of the sanitizer tier; jax_debug_nans is the dynamic
    # half, enabled suite-wide in tests/conftest.py).
    chex.assert_rank([a, b], 3)
    chex.assert_rank([len_a, len_b], 1)
    chex.assert_equal_shape_prefix([a, len_a], 1)
    chex.assert_equal_shape_prefix([b, len_b], 1)
    chex.assert_axis_dimension(b, 2, a.shape[2])
    B, N, _ = a.shape
    M = b.shape[1]
    mm_dtype = jnp.bfloat16 if matmul_dtype == "bfloat16" else None
    C = pairwise_cost(a, b, metric, mm_dtype)                   # [B, N, M]
    Cs = _skew_to_diagonals(C)                                  # [K, B, M]
    valid = _validity_grid(N, M, len_a, len_b, band, auto_widen, band_mode)
    Cs = jnp.where(valid, Cs, INF)

    j_idx = jnp.arange(M, dtype=jnp.int32)[None, :]             # [1, M]
    k_star = (len_a + len_b - 2).astype(jnp.int32)              # [B]
    j_star = (len_b - 1).astype(jnp.int32)                      # [B]

    def shift_j(x):
        # x[:, j-1] with +inf shifted in at j=0.
        return jnp.concatenate([jnp.full((B, 1), INF), x[:, :-1]], axis=1)

    def step(carry, c_row):
        prev, prev2, out, k = carry
        pred = jnp.minimum(prev, jnp.minimum(shift_j(prev), shift_j(prev2)))
        pred = jnp.where((k == 0) & (j_idx == 0), 0.0, pred)
        cur = c_row + pred                                       # [B, M]
        hit = (k == k_star)[:, None] & (j_idx == j_star[:, None])
        out = jnp.where(
            jnp.any(hit, axis=1),
            jnp.sum(jnp.where(hit, cur, 0.0), axis=1),
            out,
        )
        return (cur, prev, out, k + 1), None

    init = (
        jnp.full((B, M), INF),
        jnp.full((B, M), INF),
        jnp.full((B,), INF),
        jnp.int32(0),
    )
    (_, _, out, _), _ = jax.lax.scan(step, init, Cs)
    if normalize == "path_len":
        out = out / (len_a + len_b).astype(jnp.float32)
    elif normalize != "none":
        raise ValueError(f"unknown normalize {normalize!r}")
    return out


@partial(
    jax.jit,
    static_argnames=("metric", "band", "auto_widen", "normalize", "matmul_dtype",
                     "band_mode"),
)
def dtw_batch_with_dirs(
    a: jax.Array,
    b: jax.Array,
    len_a: jax.Array,
    len_b: jax.Array,
    *,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    matmul_dtype: str | None = None,
    band_mode: str = "widen",
) -> tuple[jax.Array, jax.Array]:
    """Distances + per-cell step directions for backtrace.

    Returns ([B] distances, [B, K, M] uint8 dirs in diagonal-major layout:
    dirs[b, i+j, j] is the argmin predecessor of cell (i, j):
    0 = diag (i-1,j-1), 1 = up (i-1,j), 2 = left (i,j-1).
    Tie-break diag > up > left matches oracle/dtw.py.  Memory is O(B*K*M) —
    use only for the (few) within-cluster pairs that need paths
    (SURVEY.md SS8 "backtrace memory").
    """
    B, N, _ = a.shape
    M = b.shape[1]
    mm_dtype = jnp.bfloat16 if matmul_dtype == "bfloat16" else None
    C = pairwise_cost(a, b, metric, mm_dtype)
    Cs = _skew_to_diagonals(C)
    valid = _validity_grid(N, M, len_a, len_b, band, auto_widen, band_mode)
    Cs = jnp.where(valid, Cs, INF)

    j_idx = jnp.arange(M, dtype=jnp.int32)[None, :]
    k_star = (len_a + len_b - 2).astype(jnp.int32)
    j_star = (len_b - 1).astype(jnp.int32)

    def shift_j(x):
        return jnp.concatenate([jnp.full((B, 1), INF), x[:, :-1]], axis=1)

    def step(carry, c_row):
        prev, prev2, out, k = carry
        d_diag = shift_j(prev2)
        d_up = prev
        d_left = shift_j(prev)
        best01 = jnp.where(d_diag <= d_up, jnp.uint8(0), jnp.uint8(1))
        val01 = jnp.minimum(d_diag, d_up)
        dirs = jnp.where(val01 <= d_left, best01, jnp.uint8(2))
        pred = jnp.minimum(val01, d_left)
        pred = jnp.where((k == 0) & (j_idx == 0), 0.0, pred)
        cur = c_row + pred
        hit = (k == k_star)[:, None] & (j_idx == j_star[:, None])
        out = jnp.where(
            jnp.any(hit, axis=1),
            jnp.sum(jnp.where(hit, cur, 0.0), axis=1),
            out,
        )
        return (cur, prev, out, k + 1), dirs

    init = (
        jnp.full((B, M), INF),
        jnp.full((B, M), INF),
        jnp.full((B,), INF),
        jnp.int32(0),
    )
    (_, _, out, _), dirs = jax.lax.scan(step, init, Cs)          # dirs [K, B, M]
    if normalize == "path_len":
        out = out / (len_a + len_b).astype(jnp.float32)
    elif normalize != "none":
        raise ValueError(f"unknown normalize {normalize!r}")
    return out, jnp.transpose(dirs, (1, 0, 2))


def dtw_pair(
    a: jax.Array,
    b: jax.Array,
    *,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    band_mode: str = "widen",
) -> jax.Array:
    """Single unbatched pair (convenience / tests). a: [N, d], b: [M, d]."""
    a = jnp.atleast_2d(a)
    b = jnp.atleast_2d(b)
    return dtw_batch(
        a[None],
        b[None],
        jnp.array([a.shape[0]], jnp.int32),
        jnp.array([b.shape[0]], jnp.int32),
        metric=metric,
        band=band,
        auto_widen=auto_widen,
        normalize=normalize,
        band_mode=band_mode,
    )[0]
