import numpy as np
import pytest

from audio_pattern_discovery.config import AutoencoderConfig
from audio_pattern_discovery.models.autoencoder import (
    FeatureScaler,
    encode_frames,
    train_autoencoder,
)


def _toy_frames(rng, n=2048, dim=32, rank=4):
    """Low-rank data the AE can compress losslessly-ish."""
    basis = rng.normal(0, 1, (rank, dim))
    coeff = rng.normal(0, 1, (n, rank))
    return (coeff @ basis).astype(np.float32)


def test_training_reduces_loss(rng):
    frames = _toy_frames(rng)
    cfg = AutoencoderConfig(
        latent_dim=4, hidden_dims=(32,), epochs=20, batch_size=256, learning_rate=1e-2
    )
    _, _, losses = train_autoencoder(frames, cfg)
    assert losses[-1] < 0.5 * losses[0]
    assert losses[-1] < 0.2  # low-rank data must compress well


def test_encode_shapes(rng):
    frames = _toy_frames(rng, n=512)
    cfg = AutoencoderConfig(latent_dim=6, hidden_dims=(16,), epochs=2, batch_size=128)
    model, state, _ = train_autoencoder(frames, cfg)
    z = encode_frames(model, state.params, frames)
    assert z.shape == (512, 6)
    assert z.dtype == np.float32
    # 3-D (padded segments) path.
    z3 = encode_frames(model, state.params, frames.reshape(8, 64, 32))
    assert z3.shape == (8, 64, 6)
    np.testing.assert_allclose(z3.reshape(512, 6), z, rtol=1e-5, atol=1e-5)


def test_determinism(rng):
    frames = _toy_frames(rng, n=512)
    cfg = AutoencoderConfig(latent_dim=4, hidden_dims=(16,), epochs=3, batch_size=128)
    import jax

    _, s1, l1 = train_autoencoder(frames, cfg)
    _, s2, l2 = train_autoencoder(frames, cfg)
    assert l1 == l2
    assert jax.tree_util.tree_all(
        jax.tree_util.tree_map(
            lambda x, y: bool(np.array_equal(x, y)), s1.params, s2.params
        )
    )


def test_scaler_roundtrip(rng):
    frames = rng.normal(3.0, 2.5, (1000, 8)).astype(np.float32)
    sc = FeatureScaler.fit(frames)
    t = sc.transform(frames)
    assert abs(t.mean()) < 1e-2
    assert abs(t.std() - 1.0) < 1e-2


def test_denoising_mode_trains(rng):
    frames = _toy_frames(rng, n=512)
    cfg = AutoencoderConfig(
        latent_dim=4, hidden_dims=(16,), epochs=5, batch_size=128, denoising_std=0.3
    )
    _, _, losses = train_autoencoder(frames, cfg)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_encode_frames_empty_input():
    import numpy as np

    from audio_pattern_discovery.config import AutoencoderConfig
    from audio_pattern_discovery.models.autoencoder import (
        create_model,
        encode_frames,
        init_state,
    )
    import jax

    cfg = AutoencoderConfig(latent_dim=4, hidden_dims=(8,))
    model, state, _ = init_state(cfg, 16, jax.random.PRNGKey(0))
    out = encode_frames(model, state.params, np.zeros((0, 16), np.float32))
    assert out.shape == (0, 4)


def test_train_fewer_frames_than_devices(rng):
    """n < mesh size must replicate instead of crashing on batch shape."""
    import jax

    from audio_pattern_discovery.config import AutoencoderConfig, ParallelConfig
    from audio_pattern_discovery.models.autoencoder import train_autoencoder
    from audio_pattern_discovery.parallel.mesh import data_sharding, make_mesh

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs the 8-device virtual mesh")
    mesh = make_mesh(ParallelConfig(), devices=jax.devices())
    frames = rng.normal(0, 1, (5, 12)).astype(np.float32)
    cfg = AutoencoderConfig(latent_dim=3, hidden_dims=(8,), epochs=2)
    _, state, losses = train_autoencoder(
        frames, cfg, data_sharding=data_sharding(mesh)
    )
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_pool_quantization_grid():
    """Training pools >= 4096 frames snap UP to the 4096 ladder with
    repeated real frames (shape-stable compiles across corpora); smaller
    pools pass through untouched (small-corpus behavior stays
    bit-identical, incl. the committed golden anchor)."""
    from audio_pattern_discovery.models.autoencoder import (
        _quantize_pool,
    )

    rng = np.random.default_rng(0)
    small = rng.normal(0, 1, (4095, 8)).astype(np.float32)
    assert _quantize_pool(small, seed=3) is small

    exact = rng.normal(0, 1, (8192, 8)).astype(np.float32)
    assert _quantize_pool(exact, seed=3) is exact

    odd = rng.normal(0, 1, (5000, 8)).astype(np.float32)
    q = _quantize_pool(odd, seed=3)
    assert q.shape == (8192, 8)
    assert q.dtype == np.float32
    np.testing.assert_array_equal(q[:5000], odd)
    # every pad row is a copy of some real row
    matches = (q[5000:, None, :] == odd[None, :, :]).all(-1).any(-1)
    assert matches.all()
    # deterministic in the seed
    np.testing.assert_array_equal(q, _quantize_pool(odd, seed=3))


def test_pool_quantization_shares_one_compile(rng):
    """Two corpora whose frame counts land on the same ladder point must
    produce identical (pool, perm) shapes — the whole point: one compiled
    train_epoch serves both."""
    frames_a = _toy_frames(rng, n=4097)
    frames_b = _toy_frames(rng, n=8192 - 1)
    cfg = AutoencoderConfig(latent_dim=4, hidden_dims=(16,), epochs=1)
    _, state_a, _ = train_autoencoder(frames_a, cfg)
    _, state_b, _ = train_autoencoder(frames_b, cfg)
    # same ladder point (8192) -> same batch count baked into both runs
    assert state_a.step == state_b.step


def _flax_twin(hidden_dims, latent_dim, out_dim):
    """The Flax module this AE's weights must match bit for bit."""
    nn = pytest.importorskip("flax.linen")

    class Twin(nn.Module):
        def setup(self):
            self.enc_layers = [nn.Dense(h) for h in hidden_dims] + [
                nn.Dense(latent_dim)
            ]
            self.dec_layers = [nn.Dense(h) for h in reversed(hidden_dims)] + [
                nn.Dense(out_dim)
            ]

        def __call__(self, x):
            h = x
            for layer in self.enc_layers[:-1]:
                h = nn.relu(layer(h))
            z = self.enc_layers[-1](h)
            h = z
            for layer in self.dec_layers[:-1]:
                h = nn.relu(layer(h))
            return self.dec_layers[-1](h), z

    return Twin()


@pytest.mark.parametrize(
    "hidden, latent, dim, seed",
    [((256, 64), 16, 513, 0), ((16,), 4, 12, 7)],
)
def test_init_and_forward_equal_flax(hidden, latent, dim, seed):
    """Initial weights (and hence the committed golden anchors) are the
    ones the former Flax model drew: same tree, bit-identical leaves, and
    the same forward pass."""
    import jax
    import jax.numpy as jnp

    from audio_pattern_discovery.models.autoencoder import AutoEncoder

    twin = _flax_twin(hidden, latent, dim)
    key = jax.random.PRNGKey(seed)
    x0 = jnp.zeros((1, dim), jnp.float32)
    want = twin.init(key, x0)
    model = AutoEncoder(hidden, latent, dim)
    got = model.init(key, x0)
    fl = jax.tree_util.tree_leaves_with_path(want)
    ml = jax.tree_util.tree_leaves_with_path(got)
    assert [str(p) for p, _ in fl] == [str(p) for p, _ in ml]
    for (_, a), (_, b) in zip(fl, ml):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x = jax.random.normal(jax.random.PRNGKey(1), (5, dim))
    (r1, z1), (r2, z2) = twin.apply(want, x), model.apply(got, x)
    np.testing.assert_array_equal(np.asarray(z1), np.asarray(z2))
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
