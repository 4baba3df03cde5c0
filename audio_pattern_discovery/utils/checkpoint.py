"""Checkpoint / resume for the autoencoder train state (SURVEY.md SS6.4).

The reference (Rust, single process) has no checkpointing; the rebuild
gets two resume layers:

* AE train state as one `.npz` (this module): params + optimizer state +
  step + the fitted FeatureScaler, so an interrupted run re-encodes with
  the exact same weights instead of retraining.
* Distance-matrix blocks via `.npz` files (parallel/pair_scheduler.py
  `block_dir`) — the all-pairs DTW job resumes at block granularity.

The file stores the flattened leaves of the (params, opt_state) pytree;
restore unflattens them into a freshly-initialized template state
(`init_state`), which recovers optax's tuple-of-namedtuple structure and
shape-checks every leaf.
"""

from __future__ import annotations

from pathlib import Path

import jax
import numpy as np

from audio_pattern_discovery.config import AutoencoderConfig
from audio_pattern_discovery.models.autoencoder import (
    AutoEncoder,
    FeatureScaler,
    TrainState,
    init_state,
)

_STATE_FILE = "ae_state.npz"


def save_ae_checkpoint(
    ckpt_dir: str | Path,
    state: TrainState,
    scaler: FeatureScaler | None = None,
) -> Path:
    """Persist the AE train state (+ feature scaler) under `ckpt_dir`."""
    path = Path(ckpt_dir) / _STATE_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = jax.tree_util.tree_leaves(
        jax.device_get((state.params, state.opt_state))
    )
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    arrays["step"] = np.asarray(int(state.step))
    if scaler is not None:
        arrays["scaler_mean"] = scaler.mean
        arrays["scaler_std"] = scaler.std
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **arrays)
    tmp.replace(path)
    return path


def has_ae_checkpoint(ckpt_dir: str | Path) -> bool:
    return (Path(ckpt_dir) / _STATE_FILE).is_file()


def restore_ae_checkpoint(
    ckpt_dir: str | Path,
    cfg: AutoencoderConfig,
    input_dim: int,
) -> tuple[AutoEncoder, TrainState, FeatureScaler | None]:
    """Restore (model, state, scaler) saved by `save_ae_checkpoint`.

    `cfg`/`input_dim` must match the saved run: the template state built
    from them supplies the pytree structure (and shape-checks the load).
    """
    model, template, _ = init_state(
        cfg, input_dim, jax.random.PRNGKey(cfg.seed)
    )
    leaves, treedef = jax.tree_util.tree_flatten(
        (template.params, template.opt_state)
    )
    with np.load(Path(ckpt_dir) / _STATE_FILE) as z:
        n_saved = sum(1 for k in z.files if k.startswith("leaf_"))
        if n_saved != len(leaves):
            raise ValueError(
                f"AE checkpoint holds {n_saved} arrays, the config expects "
                f"{len(leaves)} — it was saved under another autoencoder "
                "config; run a full discovery"
            )
        loaded = []
        for i, ref in enumerate(leaves):
            arr = z[f"leaf_{i}"]
            if arr.shape != np.shape(ref):
                raise ValueError(
                    f"AE checkpoint array {i} has shape {arr.shape}, the "
                    f"config expects {np.shape(ref)}; run a full discovery"
                )
            loaded.append(arr)
        step = int(z["step"])
        scaler = None
        if "scaler_mean" in z.files:
            scaler = FeatureScaler(
                np.asarray(z["scaler_mean"], np.float32),
                np.asarray(z["scaler_std"], np.float32),
            )
    params, opt_state = jax.tree_util.tree_unflatten(treedef, loaded)
    return model, TrainState(params, opt_state, step), scaler


# ---------------------------------------------------------------- PCA
# The PCA embedder's "state" is four small arrays; a plain .npz is the
# whole checkpoint.

_PCA_FILE = "pca_state.npz"


def save_pca_checkpoint(ckpt_dir, state, scaler) -> None:
    """Persist PCAState + FeatureScaler under `ckpt_dir`."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    np.savez(
        d / _PCA_FILE,
        mean=state.mean,
        components=state.components,
        scale=state.scale,
        explained=state.explained,
        scaler_mean=scaler.mean,
        scaler_std=scaler.std,
    )


def has_pca_checkpoint(ckpt_dir) -> bool:
    return (Path(ckpt_dir) / _PCA_FILE).is_file()


def restore_pca_checkpoint(ckpt_dir):
    """-> (PCAState, FeatureScaler) saved by save_pca_checkpoint."""
    from audio_pattern_discovery.models.pca import PCAState

    z = np.load(Path(ckpt_dir) / _PCA_FILE)
    state = PCAState(
        mean=z["mean"], components=z["components"],
        scale=z["scale"], explained=z["explained"],
    )
    scaler = FeatureScaler(z["scaler_mean"], z["scaler_std"])
    return state, scaler
