"""Importing the package must never initialize a JAX backend.

A module-scope jnp scalar (e.g. ``INF = jnp.float32(...)``) constructs a
device array at import time, which initializes the default backend: every
``import audio_pattern_discovery.cli`` (and every test worker, tool and
--dump-config call) would then pay accelerator start-up and hold device
memory before it has decided to use the device."""

import subprocess
import sys


def test_package_import_initializes_no_backend():
    code = (
        "import audio_pattern_discovery.cli\n"
        "import audio_pattern_discovery.pipeline\n"
        "import audio_pattern_discovery.query\n"
        "from jax._src import xla_bridge\n"
        "assert not xla_bridge._backends, (\n"
        "    'package import initialized JAX backend(s): '\n"
        "    + str(list(xla_bridge._backends))\n"
        ")\n"
        "print('clean')\n"
    )
    # A fresh interpreter (the suite's own process already has a backend);
    # JAX_PLATFORMS=cpu keeps the check meaningful even if a regression
    # sneaks in — the failure mode asserted is 'a backend exists at all',
    # not 'the accelerator was touched'.
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
