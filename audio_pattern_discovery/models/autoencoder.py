"""Autoencoder over spectrogram frames (SURVEY.md SS3 row 4, SS4.2).

A small dense (optionally denoising) autoencoder: encoder output is the
per-frame latent embedding that DTW runs over (BASELINE.json config 3).
Training is a single jitted optax `train_step` with donated state,
minibatches sliced from a device-resident corpus tensor, and an optional
data-parallel batch sharding over the device mesh (parallel/mesh.py).
Checkpoints are `.npz` files (utils/checkpoint.py).

The MLP is plain JAX over a dict pytree
`{"params": {"enc_layers_0": {"kernel", "bias"}, ..., "dec_layers_k": ...}}`.
Its initial weights are the ones the Flax `nn.Dense` stack this module
once used would draw from the same key: each layer's kernel is LeCun-normal
from `fold_in(key, sha1(layer_name + counter))`, its bias zero.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from audio_pattern_discovery.config import AutoencoderConfig

_ACTS = {"relu": jax.nn.relu, "tanh": jnp.tanh, "gelu": jax.nn.gelu}


def _fold_in_name(key: jax.Array, name: str, counter: int) -> jax.Array:
    """Key of the `counter`-th draw inside the layer called `name`: the
    first four bytes of sha1(name || counter) folded into `key`."""
    m = hashlib.sha1()
    m.update(name.encode("utf-8"))
    m.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(m.digest()[:4], "big"))
    )


@dataclass(frozen=True)
class AutoEncoder:
    """MLP encoder/decoder; bottleneck = latent_dim."""

    hidden_dims: tuple[int, ...]
    latent_dim: int
    out_dim: int
    activation: str = "relu"
    dtype: Any = jnp.float32

    def _layers(self, in_dim: int) -> list[tuple[str, int, int]]:
        """(name, fan_in, fan_out) for every dense layer, in call order."""
        enc = [*self.hidden_dims, self.latent_dim]
        dec = [*reversed(self.hidden_dims), self.out_dim]
        out, prev = [], in_dim
        for prefix, widths in (("enc_layers", enc), ("dec_layers", dec)):
            for i, w in enumerate(widths):
                out.append((f"{prefix}_{i}", prev, w))
                prev = w
        return out

    def init(self, key: jax.Array, x: jax.Array) -> dict:
        kernel_init = jax.nn.initializers.lecun_normal()
        params = {}
        for name, fan_in, fan_out in self._layers(x.shape[-1]):
            params[name] = {
                "kernel": kernel_init(
                    _fold_in_name(key, name, 1), (fan_in, fan_out), jnp.float32
                ),
                "bias": jnp.zeros((fan_out,), jnp.float32),
            }
        return {"params": params}

    def _stack(self, params: dict, prefix: str, h: jax.Array) -> jax.Array:
        p = params["params"]
        n = sum(1 for k in p if k.startswith(prefix))
        act = _ACTS[self.activation]
        for i in range(n):
            layer = p[f"{prefix}_{i}"]
            kernel = layer["kernel"].astype(self.dtype)
            h = jnp.dot(h.astype(self.dtype), kernel) + layer["bias"].astype(
                self.dtype
            )
            if i < n - 1:
                h = act(h)
        return h

    def encode(self, params: dict, x: jax.Array) -> jax.Array:
        return self._stack(params, "enc_layers", x)

    def decode(self, params: dict, z: jax.Array) -> jax.Array:
        return self._stack(params, "dec_layers", z)

    def apply(self, params: dict, x: jax.Array, method=None):
        """`method=None`: (reconstruction, latent); else `method(self,
        params, x)`, e.g. `AutoEncoder.encode`."""
        if method is not None:
            return method(self, params, x)
        z = self.encode(params, x)
        return self.decode(params, z), z


@dataclass
class FeatureScaler:
    """Per-bin standardization fitted on the corpus; applied before encode."""

    mean: np.ndarray   # [dim]
    std: np.ndarray    # [dim]

    @classmethod
    def fit(cls, frames: np.ndarray) -> "FeatureScaler":
        mean = frames.mean(axis=0)
        std = np.maximum(frames.std(axis=0), 1e-6)
        return cls(mean.astype(np.float32), std.astype(np.float32))

    def transform(self, frames):
        return (frames - self.mean) / self.std


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int


def create_model(cfg: AutoencoderConfig, input_dim: int) -> AutoEncoder:
    return AutoEncoder(
        hidden_dims=cfg.hidden_dims,
        latent_dim=cfg.latent_dim,
        out_dim=input_dim,
        activation=cfg.activation,
        dtype=jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32,
    )


def init_state(
    cfg: AutoencoderConfig,
    input_dim: int,
    rng: jax.Array,
    param_shardings=None,
) -> tuple[AutoEncoder, TrainState, optax.GradientTransformation]:
    """`param_shardings`: optional callable params -> NamedSharding pytree
    (parallel.mesh.ae_param_sharding) placing params in a TP layout BEFORE
    tx.init, so the optimizer state inherits the same layout and the jitted
    epoch scan carries it (XLA keeps hidden activations sharded)."""
    model = create_model(cfg, input_dim)
    params = model.init(rng, jnp.zeros((1, input_dim), jnp.float32))
    if param_shardings is not None:
        params = jax.device_put(params, param_shardings(params))
    tx = optax.adam(cfg.learning_rate)
    return model, TrainState(params, tx.init(params), 0), tx


def make_train_step(model: AutoEncoder, tx: optax.GradientTransformation, denoising_std: float):
    """Returns jitted (params, opt_state, batch, noise_key) -> (params, opt_state, loss)."""

    def loss_fn(params, batch, noisy):
        recon, _ = model.apply(params, noisy)
        return jnp.mean((recon.astype(jnp.float32) - batch) ** 2)

    def train_step_inner(params, opt_state, batch, key):
        noisy = batch
        if denoising_std > 0.0:
            noisy = batch + denoising_std * jax.random.normal(key, batch.shape)
        loss, grads = jax.value_and_grad(loss_fn)(params, batch, noisy)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    train_step = jax.jit(train_step_inner, donate_argnums=(0, 1))
    train_step.inner = train_step_inner
    return train_step


def make_train_epoch(
    model: AutoEncoder,
    tx: optax.GradientTransformation,
    denoising_std: float,
    data_sharding=None,
):
    """One fused device dispatch per epoch: `lax.scan` over the minibatches.

    The per-step Python loop costs ~4 host<->device round-trips per batch
    (eager gather, eager key split, blocking loss sync) — fatal on a
    remote-relay backend with a ~27 ms dispatch floor.  Scanning the whole
    epoch on device collapses that to one dispatch; the gather and RNG
    splits fuse into the compiled program.
    """
    step_inner = make_train_step(model, tx, denoising_std).inner

    @partial(jax.jit, donate_argnums=(0, 1))
    def train_epoch(params, opt_state, frames, perm, rng):
        # perm: [n_batches, bs] int32 minibatch index matrix for this epoch.
        def body(carry, idx):
            params, opt_state, rng = carry
            rng, key = jax.random.split(rng)
            batch = frames[idx]
            if data_sharding is not None:
                batch = jax.lax.with_sharding_constraint(batch, data_sharding)
            params, opt_state, loss = step_inner(params, opt_state, batch, key)
            return (params, opt_state, rng), loss

        (params, opt_state, rng), losses = jax.lax.scan(
            body, (params, opt_state, rng), perm
        )
        return params, opt_state, rng, jnp.mean(losses)

    return train_epoch


_POOL_GRID = 4096


def _quantize_pool(frames: np.ndarray, seed: int) -> np.ndarray:
    """Pad a >= 4096-frame training pool UP to the next 4096 multiple with
    repeated random frames.

    Why: `train_epoch`'s compiled program bakes in the frame-pool shape,
    the batch size, and the scan length — so every NEW corpus used to pay
    a fresh ~10-20 s XLA compile on this backend (measured: steady-state
    training is 1.4 s) just because its frame count differed.  Snapping
    the pool to a coarse ladder makes those shapes recur across corpora,
    turning the per-corpus compile into a persistent-cache hit.  `encode`
    applies the same trick (its 4096-multiple tail pad below).  Pools
    under 4096 frames are left EXACTLY as-is: tiny compiles are the same
    price either way, and small-corpus behavior (tests, the committed
    golden anchor) stays bit-identical.  Padding adds up to 4095
    duplicated frames — worst case ~50% of an n=4097 pool, fading to
    < 4% at 100k frames.  The duplicates are a uniform random resample
    of the real pool, so they only reweight per-epoch sampling slightly
    (the pool is already a redundant frame sample, not a curated set);
    config-5's quality gates stayed 1.0 under it.
    """
    n = frames.shape[0]
    if n < _POOL_GRID or n % _POOL_GRID == 0:
        return frames
    n_q = _POOL_GRID * -(-n // _POOL_GRID)
    extra = np.random.default_rng(seed ^ 0x9E3779B9).integers(0, n, n_q - n)
    return np.concatenate([frames, frames[extra]], axis=0)


def train_autoencoder(
    frames: np.ndarray,            # [N, dim] standardized training frames
    cfg: AutoencoderConfig,
    log_every: int = 5,
    logger=None,
    data_sharding=None,            # optional jax.sharding.NamedSharding for DP
    param_shardings=None,          # optional callable params -> TP layout tree
    sync_losses: bool = True,
) -> tuple[AutoEncoder, TrainState, list[float]]:
    """Train on spectrogram frames; returns (model, state, per-epoch losses).

    With `data_sharding`, each minibatch is placed sharded over the mesh's
    data axis — XLA turns the gradient reduction into an all-reduce
    (DP over chips, SURVEY.md SS3 row 9).  With `param_shardings`
    (parallel.mesh.ae_param_sharding), params train in a tensor-parallel
    layout over the mesh's model axis (SS3 row 9).

    `sync_losses=False` returns the per-epoch losses as UNMATERIALIZED
    device futures (list of 0-d jax arrays): every epoch dispatch stays in
    flight so the caller can overlap training with other host work (the
    config-5 upload overlap, pipeline.discover); materialize with
    float(x).  The returned state's params are futures too — any use
    blocks until training drains.
    """
    frames = np.asarray(frames)
    frames = _quantize_pool(frames, cfg.seed)
    n, dim = frames.shape
    rng = jax.random.PRNGKey(cfg.seed)
    rng, init_rng = jax.random.split(rng)
    model, state, tx = init_state(cfg, dim, init_rng, param_shardings)
    train_epoch = make_train_epoch(model, tx, cfg.denoising_std, data_sharding)

    bs = min(cfg.batch_size, n)
    if data_sharding is not None:
        n_shards = data_sharding.mesh.devices.size
        if n < n_shards:
            # Too few frames to shard: replicate rather than crash on an
            # unsatisfiable batch shape.
            data_sharding = None
            train_epoch = make_train_epoch(model, tx, cfg.denoising_std, None)
        else:
            bs = max(n_shards, bs - bs % n_shards)
    n_batches = max(1, n // bs)
    frames_dev = jax.device_put(jnp.asarray(frames, jnp.float32))

    params, opt_state = state.params, state.opt_state
    shuffle_rng = np.random.default_rng(cfg.seed)
    losses: list[float] = []
    loss_futs: list = []
    for epoch in range(cfg.epochs):
        perm = shuffle_rng.permutation(n)[: n_batches * bs].reshape(n_batches, bs)
        params, opt_state, rng, epoch_loss = train_epoch(
            params, opt_state, frames_dev, jnp.asarray(perm), rng
        )
        if log_every and logger and (epoch + 1) % log_every == 0:
            # Sync only when asked to log; otherwise epochs stay in flight.
            logger.info(
                f"AE epoch {epoch + 1}/{cfg.epochs} loss={float(epoch_loss):.5f}"
            )
        loss_futs.append(epoch_loss)
    losses = loss_futs if not sync_losses else [float(x) for x in loss_futs]
    return model, TrainState(params, opt_state, cfg.epochs * n_batches), losses


@partial(jax.jit, static_argnames=("model",))
def _encode_batch(model: AutoEncoder, params, x: jax.Array) -> jax.Array:
    return model.apply(params, x, method=AutoEncoder.encode)


def _params_device_span(params):
    """Union of devices the param leaves live on (after mesh training the
    carried params come out placed over the whole mesh)."""
    span: set = set()
    for leaf in jax.tree_util.tree_leaves(params):
        sh = getattr(leaf, "sharding", None)
        if sh is not None:
            span |= set(sh.device_set)
    return span


def encode_frames(
    model: AutoEncoder, params, frames: jax.Array, chunk: int = 1 << 16
) -> np.ndarray:
    """Encode [N, dim] (or [..., dim]) frames -> latent [N, latent].

    Works for any placement combination: after mesh training the params
    are placed over the whole device mesh, while the frames may arrive
    COMMITTED to a single device (e.g. the resident-corpus segment gather
    runs on the data-primary device) — jit refuses mixed committed
    placements, so each piece is replicated over the params' mesh first
    (a broadcast jit would otherwise perform internally)."""
    lead = frames.shape[:-1]
    flat = jnp.reshape(frames, (-1, frames.shape[-1]))
    n = flat.shape[0]
    if n == 0:
        latent = model.latent_dim
        return np.zeros((*lead, latent), np.float32)
    place = lambda piece: piece  # noqa: E731
    span = _params_device_span(params)
    if len(span) > 1:
        mesh = jax.sharding.Mesh(
            np.array(sorted(span, key=lambda d: d.id)), ("_rep",)
        )
        rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        place = lambda piece: jax.device_put(piece, rep)  # noqa: E731
    outs = []
    for s in range(0, n, chunk):
        piece = flat[s : s + chunk]
        # Pad the tail to a multiple of 4096 so jit sees few distinct shapes.
        pad = (-piece.shape[0]) % min(4096, chunk)
        if pad:
            piece = jnp.pad(piece, ((0, pad), (0, 0)))
        z = np.asarray(_encode_batch(model, params, place(piece)))
        outs.append(z[: min(chunk, n - s)])
    z = np.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
    return z.reshape(*lead, -1).astype(np.float32)
