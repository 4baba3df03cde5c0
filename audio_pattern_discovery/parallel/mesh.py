"""Device mesh + sharding helpers (SURVEY.md SS3 rows 9-10, SS6.8).

The reference is a single-process CPU tool with no distribution layer; the
equivalent here is JAX's mesh + NamedSharding over XLA collectives (NCCL
between the GPUs of a host) — no custom transport.

Axes:
* "data"  — batch / pair-space data parallelism (the workload's natural axis:
  AE minibatches and DTW pair blocks shard here).
* "model" — optional tensor parallelism over the AE's hidden dimension.
  The AE is tiny so this is off (size 1) by default, but the plumbing is
  real and exercised by dryrun_multichip / tests/test_sharding.py.

TP/PP/EP/ring-attention are intentionally out of scope: there is no
transformer and no expert layer in this workload (SURVEY.md SS3 row 9).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from audio_pattern_discovery.config import ParallelConfig


def make_mesh(cfg: ParallelConfig | None = None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    model = cfg.model_axis if cfg else 1
    data = cfg.data_axis if cfg and cfg.data_axis > 0 else n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    dev_array = np.asarray(devices[: data * model]).reshape(data, model)
    return Mesh(dev_array, axis_names=("data", "model"))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch / pair) dimension over the data axis."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def ae_param_sharding(mesh: Mesh, params) -> object:
    """TP layout for AE params: hidden-dim sharded over "model".

    Dense kernels [in, out] shard the output dim on even encoder layers and
    the input dim on the ones that consume them, so activations stay sharded
    through the hidden layers and XLA inserts the minimal collectives.
    With model axis size 1 this is a no-op layout (fully replicated).
    """
    def spec_for(path: tuple, leaf) -> NamedSharding:
        if leaf.ndim == 2:
            return NamedSharding(mesh, P(None, "model"))
        if leaf.ndim == 1:
            return NamedSharding(mesh, P("model"))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(spec_for, params)
