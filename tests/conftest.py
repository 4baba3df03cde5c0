"""Test configuration: run the suite on CPU with 8 virtual devices.

Tests must be deterministic and runnable without an accelerator; sharding /
collective logic is exercised on a fake 8-device mesh (SURVEY.md SS5.2
'multi-chip without a cluster').  Tests that need a CUDA GPU carry the
`gpu` marker and skip elsewhere; on a GPU host run them with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu

This module is imported by pytest before any test module, so the env
defaults below are in place before jax initializes its backend.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# SURVEY.md SS6.2: JAX is functional so data races are structurally absent;
# the numerics sanitizer is NaN trapping on every primitive's output.
jax.config.update("jax_debug_nans", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA GPU (skips elsewhere)")
    config.addinivalue_line(
        "markers",
        "full: slow e2e/scale test, excluded from the default fast profile "
        "(include with -m full / -m 'full or not full' or APD_FULL_TESTS=1)",
    )


def pytest_collection_modifyitems(config, items):
    # Fast/full profiles: a plain `pytest tests/ -q` runs the fast profile;
    # any behavior-touching change should run the FULL suite via
    # APD_FULL_TESTS=1 (or an explicit -m expression, which wins outright).
    if not config.getoption("-m") and os.environ.get("APD_FULL_TESTS") != "1":
        skip_full = pytest.mark.skip(
            reason="full-profile test; run APD_FULL_TESTS=1 pytest (or -m full)"
        )
        for item in items:
            if "full" in item.keywords:
                item.add_marker(skip_full)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's device is a CUDA GPU.  Decided
    per test, never at import, so every worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is None:
        return
    from audio_pattern_discovery.platform import on_gpu

    if not on_gpu():
        pytest.skip("needs a CUDA GPU (JAX_PLATFORMS=cuda pytest -m gpu)")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
