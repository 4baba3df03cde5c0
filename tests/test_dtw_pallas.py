"""The Pallas tile kernel (ops/dtw_tile.py) against the float64 NumPy
oracle, in interpret mode: every metric x band x length regime, plus the
pair enumerator's |len_a - len_b| classes.  The compiled kernel is checked
on the card by tests marked `gpu` and by chip_smoke.py."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from audio_pattern_discovery.ops.dtw_tile import dtw_tile_pairs
from audio_pattern_discovery.oracle.dtw import dtw_oracle

TI, S, D = 4, 9, 3


def _lengths(regime: str, rng) -> np.ndarray:
    K = 2 * TI
    if regime == "equal":
        return np.full(K, S, np.int32)
    if regime == "spread":
        return np.sort(rng.integers(2, S + 1, K)).astype(np.int32)
    # length-1 sequences (the scheduler's pad convention) beside full ones
    lens = np.sort(rng.integers(1, S + 1, K)).astype(np.int32)
    lens[0] = lens[1] = 1
    lens[-1] = S
    return lens


@pytest.mark.parametrize("regime", ["equal", "spread", "len1_pad"])
@pytest.mark.parametrize("band", [None, 4, 16], ids=["unbanded", "diag4", "diag16"])
@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine"])
def test_tile_kernel_matches_oracle(metric, band, regime):
    rng = np.random.default_rng(zlib.crc32(repr((metric, band, regime)).encode()))
    lens = _lengths(regime, rng)
    feats = rng.normal(0, 1, (2 * TI, S, D)).astype(np.float32)
    for k, n in enumerate(lens):
        feats[k, n:] = 0.0
    pairs = [(0, 0), (0, 1), (1, 1)]
    blocks = np.asarray(
        dtw_tile_pairs(
            jnp.asarray(feats), jnp.asarray(lens),
            jnp.asarray([p[0] for p in pairs], jnp.int32),
            jnp.asarray([p[1] for p in pairs], jnp.int32),
            ti=TI, band=band, metric=metric, strip=4, interpret=True,
        )
    )
    for u, (I, J) in enumerate(pairs):
        for a in range(TI):
            for b in range(TI):
                A, B = I * TI + a, J * TI + b
                want = dtw_oracle(
                    feats[A, : lens[A]], feats[B, : lens[B]], metric=metric,
                    band=band, band_mode="diag",
                )
                np.testing.assert_allclose(
                    blocks[u, a, b], want, rtol=1e-5, atol=1e-5,
                    err_msg=f"pair ({A}, {B}) lengths ({lens[A]}, {lens[B]})",
                )


def test_scan_len_diff_classes():
    from audio_pattern_discovery.parallel.pair_scheduler import (
        scan_len_diff_classes,
        stripe_width,
    )

    # S=128: the stripe never applies -> a single class.
    assert scan_len_diff_classes(128, 16, True) == [128]
    # S=512: narrow diffs share the W=128 stripe, wider ones W=256, the
    # rest none; class bounds must track stripe_width exactly.
    classes = scan_len_diff_classes(512, 16, True)
    assert classes[-1] == 512
    for lo, hi in zip([0] + [c + 1 for c in classes[:-1]], classes):
        want = stripe_width(512, 16, True, hi)
        for dd in (lo, (lo + hi) // 2, hi):
            assert stripe_width(512, 16, True, dd) == want
    # Band off or widen off: a single class.
    assert scan_len_diff_classes(128, None, True) == [128]
    assert scan_len_diff_classes(128, 9, False) == [128]
