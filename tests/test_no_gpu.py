"""Without a GPU the measurement scripts fail loudly and print no result,
and the one platform decision (platform.py) says so.  Also: where the
compile cache lives."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(args, cwd, env_extra=None, timeout=240):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **(env_extra or {})}
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def _has_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict) and ("ok" in obj or "value" in obj):
            return True
    return False


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_script_fails_without_gpu(script):
    r = _run([script], cwd=ROOT)
    assert r.returncode != 0
    assert not _has_result(r.stdout), r.stdout
    assert "needs a CUDA GPU" in r.stderr, r.stderr[-2000:]


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert not _has_result(r.stdout), r.stdout


def test_platform_decision_on_cpu():
    from audio_pattern_discovery.platform import on_gpu, require_gpu

    assert on_gpu() is False
    with pytest.raises(SystemExit, match="needs a CUDA GPU"):
        require_gpu("this test")


_CACHE_PROBE = (
    "import audio_pattern_discovery, jax; "
    "print(jax.config.jax_compilation_cache_dir)"
)


def test_cache_dir_honours_variable(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cache")}
    r = _run(["-c", _CACHE_PROBE], cwd=ROOT, env_extra=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == str(tmp_path / "cache")


def test_cache_dir_defaults_to_checkout():
    env = {**os.environ}
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("JAX_PLATFORMS", None)   # a CPU-pinned process keeps no cache
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == str(ROOT / ".jax_cache")
