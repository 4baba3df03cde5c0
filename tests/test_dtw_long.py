"""Blocked long-sequence DTW vs the scan wavefront and the NumPy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from audio_pattern_discovery.ops.dtw import dtw_batch
from audio_pattern_discovery.ops.dtw_long import dtw_long_batch
from audio_pattern_discovery.oracle.dtw import dtw_oracle


def _batch(rng, B, S, d=4):
    a = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    b = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    la = rng.integers(S // 2, S + 1, B).astype(np.int32)
    lb = rng.integers(S // 2, S + 1, B).astype(np.int32)
    return a, b, la, lb


@pytest.mark.parametrize("block", [8, 16, 32])
def test_matches_scan_wavefront(rng, block):
    a, b, la, lb = _batch(rng, B=5, S=32)
    want = np.asarray(dtw_batch(jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb)))
    got = np.asarray(
        dtw_long_batch(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb), block=block
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_matches_oracle_unpadded(rng):
    a, b, la, lb = _batch(rng, B=4, S=24)
    got = np.asarray(
        dtw_long_batch(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb), block=8
        )
    )
    for i in range(4):
        want = dtw_oracle(a[i, : la[i]], b[i, : lb[i]])
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-4)


def test_banded_matches_oracle(rng):
    a, b, la, lb = _batch(rng, B=4, S=24)
    got = np.asarray(
        dtw_long_batch(
            jnp.asarray(a),
            jnp.asarray(b),
            jnp.asarray(la),
            jnp.asarray(lb),
            band=5,
            block=8,
        )
    )
    for i in range(4):
        want = dtw_oracle(a[i, : la[i]], b[i, : lb[i]], band=5)
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-4)


def test_normalization_and_full_length(rng):
    a, b, _, _ = _batch(rng, B=3, S=16)
    la = np.full(3, 16, np.int32)
    lb = np.full(3, 16, np.int32)
    got = np.asarray(
        dtw_long_batch(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb),
            normalize="path_len", block=8,
        )
    )
    want = np.asarray(
        dtw_batch(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb),
            normalize="path_len",
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_single_block_degenerate(rng):
    """block >= S collapses to one block; must still be exact."""
    a, b, la, lb = _batch(rng, B=3, S=8)
    got = np.asarray(
        dtw_long_batch(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb), block=8
        )
    )
    for i in range(3):
        want = dtw_oracle(a[i, : la[i]], b[i, : lb[i]])
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-4)


def test_longer_than_pallas_ceiling(rng):
    """A long length (S=1024), past the scan path's comfortable range."""
    a, b, la, lb = _batch(rng, B=2, S=1024, d=3)
    got = np.asarray(
        dtw_long_batch(
            jnp.asarray(a),
            jnp.asarray(b),
            jnp.asarray(la),
            jnp.asarray(lb),
            band=32,
            block=256,
        )
    )
    for i in range(2):
        want = dtw_oracle(a[i, : la[i]], b[i, : lb[i]], band=32)
        np.testing.assert_allclose(got[i], want, rtol=1e-3, atol=1e-3)
