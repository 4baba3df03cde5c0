"""The main path needs only numpy, scipy, optax, chex, einops and JAX:
flax, orbax and matplotlib are blocked in sys.modules, then the entry
modules import and a discovery (AE on, checkpoint on, images on) plus a
query run end to end."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_BLOCK = textwrap.dedent(
    """
    import sys
    for name in ("flax", "orbax", "orbax.checkpoint", "matplotlib",
                 "matplotlib.pyplot"):
        sys.modules[name] = None   # any import of them raises ImportError
    """
)


def _python(code: str, tmp_path=None, timeout=600):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, "-c", _BLOCK + textwrap.dedent(code)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.parametrize(
    "module",
    ["audio_pattern_discovery.pipeline", "audio_pattern_discovery.cli",
     "audio_pattern_discovery.query"],
)
def test_entry_module_imports_without_optional_packages(module):
    r = _python(f"import {module}; print('ok')")
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_discover_and_query_run_without_optional_packages(tmp_path):
    code = f"""
    import json
    from pathlib import Path
    from audio_pattern_discovery.cli import main
    from audio_pattern_discovery.synthetic import make_corpus

    tmp = Path({str(tmp_path)!r})
    make_corpus(tmp / "src", n_clips=7, n_motifs=2, clip_seconds=1.5,
                sample_rate=16_000, seed=3)
    (tmp / "corpus").mkdir()
    for p in sorted((tmp / "src").glob("clip_*.wav"))[:6]:
        (tmp / "corpus" / p.name).write_bytes(p.read_bytes())
    common = ["-s", "spectrogram.sample_rate=16000",
              "-s", "spectrogram.win_length=256",
              "-s", "spectrogram.hop_length=128",
              "-s", "spectrogram.max_bins=32",
              "-s", "segmentation.min_len_frames=6",
              "-s", "autoencoder.epochs=2",
              "-s", "autoencoder.hidden_dims=[16]",
              "-s", "autoencoder.latent_dim=4",
              "-s", "autoencoder.checkpoint=true",
              "-s", "dtw.max_seq_len=64"]
    assert main([str(tmp / "corpus"), "-o", str(tmp / "out"), *common]) == 0
    assert list((tmp / "out").rglob("*.png")), "no cluster images"
    assert (tmp / "out" / "ae_ckpt" / "ae_state.npz").is_file()
    assert main(["--query", str(tmp / "src" / "clip_0006.wav"),
                 "-o", str(tmp / "out"), *common]) == 0
    print("ok")
    """
    r = _python(code)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
