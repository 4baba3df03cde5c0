"""Environment diagnostics: `python -m audio_pattern_discovery --doctor`.

One command that says what a run will execute on: package versions, the
native library, the compile cache, the JAX device, and (on a GPU host) the
card's name and power limit as `nvidia-smi` reports them — a card set
below its maximum power runs slower under load, so every timing needs
that line beside it.

Every probe is individually guarded: a dead backend or missing native lib
degrades that one entry to an "error" string, never the whole report.
"""

from __future__ import annotations

import os


def _guard(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - diagnostics must never crash
        return {"error": f"{type(e).__name__}: {e}"}


def _versions() -> dict:
    import jax
    import jaxlib
    import numpy

    import audio_pattern_discovery as apd

    return {
        "audio_pattern_discovery": apd.__version__,
        "jax": jax.__version__,
        "jaxlib": jaxlib.__version__,
        "numpy": numpy.__version__,
    }


def _host() -> dict:
    info: dict = {"cpus": os.cpu_count()}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    info["mem_total_gb"] = round(
                        int(line.split()[1]) / 1024**2, 1
                    )
                    break
    except OSError:
        pass
    return info


def _native() -> dict:
    from audio_pattern_discovery import native

    return {"available": native.available()}


def _compile_cache() -> dict:
    import jax

    cache_dir = jax.config.jax_compilation_cache_dir
    out: dict = {"dir": cache_dir}
    if cache_dir and os.path.isdir(cache_dir):
        entries = [
            os.path.join(cache_dir, n) for n in os.listdir(cache_dir)
        ]
        files = [p for p in entries if os.path.isfile(p)]
        out["entries"] = len(files)
        out["bytes"] = sum(os.path.getsize(p) for p in files)
    else:
        out["entries"] = 0
    return out


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi`'s "name, power.limit" line for each GPU, or "" when
    there is no nvidia-smi (a host without a GPU)."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return ""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip()


def _device() -> dict:
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "n_devices": len(devices),
        "device_kind": devices[0].device_kind,
    }


def run_doctor(probe_device: bool = True) -> dict:
    """Collect the full diagnostic report as a JSON-serializable dict."""
    report = {
        "versions": _guard(_versions),
        "host": _guard(_host),
        "native_lib": _guard(_native),
        "compile_cache": _guard(_compile_cache),
        "gpu": _guard(gpu_name_and_power_limit),
        "env": {
            k: os.environ[k]
            for k in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR",
                      "XLA_FLAGS")
            if k in os.environ
        },
    }
    if probe_device:
        report["device"] = _guard(_device)
    return report
