"""PCA(-whitening) frame embedder — the linear alternative to the AE
(SURVEY.md SS3 row 4 / SS2 "additional modules" insurance note: a
PCA/whitening step is a plausible reference component).

Split of the work: the only O(N)-in-frames computation is the [d, d]
covariance Gram, which runs as one HIGHEST-precision matmul on device;
the eigendecomposition is a tiny [d <= 513]^2 host solve in float64 (exact,
deterministic — device eigh would be slower than shipping the matrix back).
Projection is a device matmul fused with the scaler transform at encode.

Determinism: eigenvector signs are fixed so each component's
largest-|coefficient| entry is positive; ties in eigenvalues keep
numpy.linalg.eigh's deterministic ordering.  Same frames -> bitwise
identical embedding on every run, which is what lets the incremental
update path freeze it via checkpoint exactly like the AE.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class PCAState:
    """Frozen linear embedding: y = ((x - mean) @ components) / scale."""

    mean: np.ndarray          # [d]     mean of the (scaled) training frames
    components: np.ndarray    # [d, k]  top-k eigenvectors, sign-fixed
    scale: np.ndarray         # [k]     sqrt(eigenvalue) if whitening, else 1
    explained: np.ndarray     # [k]     fraction of total variance per comp


@jax.jit
def _covariance(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Mean and unnormalized scatter matrix of [N, d] frames (one matmul;
    HIGHEST precision — the Gram of standardized data cancels like the DTW
    Gram, and bf16 passes would corrupt small eigenvalues)."""
    mu = jnp.mean(x, axis=0)
    xc = x - mu
    s = jnp.einsum("nd,ne->de", xc, xc, precision=jax.lax.Precision.HIGHEST)
    return mu, s


def fit_pca(
    flat_scaled: np.ndarray,   # [N, d] standardized training frames
    n_components: int,
    whiten: bool = True,
    eps: float = 1e-6,
) -> PCAState:
    n, d = flat_scaled.shape
    if not 1 <= n_components <= d:
        raise ValueError(f"n_components={n_components} not in [1, {d}]")
    if n < 2:
        raise ValueError(f"need >= 2 frames to fit PCA, got {n}")
    mu_dev, s_dev = _covariance(jnp.asarray(flat_scaled, jnp.float32))
    mu = np.asarray(mu_dev, np.float64)
    cov = np.asarray(s_dev, np.float64) / (n - 1)
    w, v = np.linalg.eigh(cov)                       # ascending eigenvalues
    w = np.maximum(w[::-1], 0.0)                     # descending, clip noise
    v = v[:, ::-1]
    comps = v[:, :n_components]
    # Sign convention: largest-|coefficient| entry positive.
    flip = np.sign(comps[np.argmax(np.abs(comps), axis=0), np.arange(n_components)])
    flip[flip == 0] = 1.0
    comps = comps * flip[None, :]
    top_w = w[:n_components]
    scale = np.sqrt(top_w) + eps if whiten else np.ones(n_components)
    total = float(w.sum()) or 1.0
    return PCAState(
        mean=mu.astype(np.float32),
        components=comps.astype(np.float32),
        scale=scale.astype(np.float32),
        explained=(top_w / total).astype(np.float32),
    )


@jax.jit
def _proj(x, mean, comps, scale):
    return jnp.einsum(
        "...d,dk->...k", x - mean, comps,
        precision=jax.lax.Precision.HIGHEST,
    ) / scale


def encode_pca(state: PCAState, frames: jax.Array) -> np.ndarray:
    """[..., d] (scaled) frames -> [..., k] embedding, one device matmul.
    (_proj is module-scope so repeat calls hit the jit cache instead of
    retracing.)"""
    return np.asarray(
        _proj(
            jnp.asarray(frames),
            jnp.asarray(state.mean),
            jnp.asarray(state.components),
            jnp.asarray(state.scale),
        )
    )
