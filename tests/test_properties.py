"""Property-based tests (SURVEY.md SS5.2): DTW invariants under hypothesis.

These pin the mathematical contract of the alignment layer independent of
any hand-picked example: symmetry, identity, band saturation, padding
invariance, and path-length normalization bounds.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from audio_pattern_discovery.oracle.dtw import dtw_oracle


def _seq(draw, n, d):
    vals = draw(
        st.lists(
            st.floats(-10, 10, allow_nan=False, width=32),
            min_size=n * d,
            max_size=n * d,
        )
    )
    return np.asarray(vals, np.float32).reshape(n, d)


@st.composite
def seq_pair(draw, max_len=12, d=3):
    na = draw(st.integers(2, max_len))
    nb = draw(st.integers(2, max_len))
    return _seq(draw, na, d), _seq(draw, nb, d)


@settings(max_examples=40, deadline=None)
@given(seq_pair())
def test_dtw_symmetry(pair):
    a, b = pair
    assert np.isclose(dtw_oracle(a, b), dtw_oracle(b, a), rtol=1e-5)


@settings(max_examples=25, deadline=None)
@given(seq_pair())
def test_dtw_identity_and_nonnegativity(pair):
    a, b = pair
    assert dtw_oracle(a, a) == 0.0
    assert dtw_oracle(a, b) >= 0.0


@settings(max_examples=25, deadline=None)
@given(seq_pair())
def test_band_saturation_equals_unbanded(pair):
    """A band at least max(N, M) wide must not change the distance."""
    a, b = pair
    full = dtw_oracle(a, b)
    wide = dtw_oracle(a, b, band=max(len(a), len(b)))
    assert np.isclose(full, wide, rtol=1e-6)


@settings(max_examples=25, deadline=None)
@given(seq_pair(), st.integers(1, 6))
def test_band_monotone_in_width(pair, w):
    """Widening the band can only shrink (or keep) the constrained distance."""
    a, b = pair
    base = max(abs(len(a) - len(b)), 1)
    narrow = dtw_oracle(a, b, band=base + w)
    wider = dtw_oracle(a, b, band=base + w + 3)
    assert wider <= narrow + 1e-5 * max(1.0, abs(narrow))


@settings(max_examples=20, deadline=None)
@given(seq_pair())
def test_device_padding_invariance(pair):
    """Padded+masked batched DTW == unpadded oracle (SS5.2)."""
    import jax.numpy as jnp

    from audio_pattern_discovery.ops.dtw import dtw_batch

    a, b = pair
    L = 16
    ap = np.zeros((1, L, a.shape[1]), np.float32)
    bp = np.zeros((1, L, b.shape[1]), np.float32)
    ap[0, : len(a)] = a
    bp[0, : len(b)] = b
    got = np.asarray(
        dtw_batch(
            jnp.asarray(ap),
            jnp.asarray(bp),
            jnp.asarray([len(a)], jnp.int32),
            jnp.asarray([len(b)], jnp.int32),
        )
    )[0]
    want = dtw_oracle(a, b)
    assert np.isclose(got, want, rtol=1e-4, atol=1e-4)


@settings(max_examples=25, deadline=None)
@given(seq_pair())
def test_triangle_like_bound_on_concatenation(pair):
    """DTW distance to a repeated sequence is bounded by within-pair cost:
    d(a, a++a) <= d(a, a) + per-step warp cost of repeating the last frame.
    Weak sanity bound: d(a, a++a) is finite and >= 0."""
    a, _ = pair
    aa = np.concatenate([a, a])
    d = dtw_oracle(a, aa)
    assert np.isfinite(d) and d >= 0.0


@settings(max_examples=8, deadline=None)
@given(
    st.integers(2, 30),          # band
    st.integers(0, 6),           # seed
)
@pytest.mark.full
def test_tile_kernel_matches_scan_on_random_corpora(band, seed):
    """Property: the all-pairs tile kernel agrees with the scan path on
    random ragged corpora across "diag" band widths (interpret mode)."""
    import jax.numpy as jnp

    from audio_pattern_discovery.ops.dtw import dtw_batch
    from audio_pattern_discovery.ops.dtw_tile import dtw_tile_pairs

    rng = np.random.default_rng(seed)
    ti, S, d = 8, 16, 3
    K = 2 * ti
    feats = rng.normal(0, 1, (K, S, d)).astype(np.float32)
    lengths = rng.integers(2, S + 1, K).astype(np.int32)
    blocks = np.asarray(
        dtw_tile_pairs(
            jnp.asarray(feats), jnp.asarray(lengths),
            jnp.asarray([0], jnp.int32), jnp.asarray([1], jnp.int32),
            ti=ti, band=band, interpret=True,
        )
    )
    ii = np.repeat(np.arange(ti), ti)
    jj = np.tile(np.arange(ti, 2 * ti), ti)
    ref = np.asarray(
        dtw_batch(
            jnp.asarray(feats[ii]), jnp.asarray(feats[jj]),
            jnp.asarray(lengths[ii]), jnp.asarray(lengths[jj]),
            band=band, band_mode="diag", normalize="none",
        )
    ).reshape(ti, ti)
    np.testing.assert_allclose(blocks[0], ref, rtol=1e-4, atol=1e-4)
