#!/usr/bin/env python
"""(Re-)record the committed golden anchors under the TEST SUITE's exact
environment (CPU backend, 8 virtual devices — the device count changes AE
gradient-reduction order, so recordings from any other env do not match;
see tests/test_pipeline_e2e.py golden tests).

    python tools/record_golden_anchors.py [seed7] [mfcc_pca] [lenvar]

With no arguments, prints what each anchor covers and exits.  Overwriting
an anchor is a BEHAVIORAL change: justify it in the commit message.
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

# Suite env BEFORE jax initializes (conftest.py does exactly this).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_debug_nans", True)

import numpy as np  # noqa: E402

GOLDEN_DIR = Path(__file__).resolve().parent.parent / "tests" / "golden"

ANCHORS = {
    "seed7": (
        "GOLDEN_cpu_seed7.npz",
        "default config (band=16) on the seed-7 corpus",
    ),
    "mfcc_pca": (
        "GOLDEN_cpu_seed7_mfcc_pca.npz",
        "MFCC front-end + PCA embedder on the seed-7 corpus",
    ),
    "lenvar": (
        "GOLDEN_cpu_lenvar_seed11.npz",
        "length-varied corpus (motifs 0.15-0.6 s) pinning the diag "
        "band default where it differs from widen",
    ),
}


def _discover(which: str):
    from audio_pattern_discovery.config import PipelineConfig
    from audio_pattern_discovery.pipeline import discover
    from audio_pattern_discovery.synthetic import make_corpus

    cfg = PipelineConfig()
    cfg.dtw.band = 16
    cfg.output.write_snippets = False
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    with tempfile.TemporaryDirectory() as td:
        corpus = Path(td) / "corpus"
        if which == "lenvar":
            make_corpus(corpus, n_clips=10, n_motifs=3,
                        motif_seconds=(0.15, 0.6), seed=11)
        else:
            make_corpus(corpus, n_clips=12, n_motifs=3, seed=7)
        if which == "mfcc_pca":
            cfg.spectrogram.feature = "mfcc"
            cfg.spectrogram.n_mels = 48
            cfg.spectrogram.n_mfcc = 16
            cfg.autoencoder.method = "pca"
            cfg.autoencoder.latent_dim = 8
        return discover(corpus, cfg)


def main() -> int:
    names = sys.argv[1:]
    if not names:
        for k, (f, desc) in ANCHORS.items():
            print(f"{k:10s} {f:35s} {desc}")
        print("\nusage: record_golden_anchors.py [seed7] [mfcc_pca] [lenvar]")
        return 0
    for name in names:
        fname, desc = ANCHORS[name]
        result = _discover(name)
        path = GOLDEN_DIR / fname
        np.savez(path, D=result.distance_matrix, labels=result.labels)
        lens = np.asarray(result.seg_lengths)
        print(
            f"recorded {path.name}: {result.distance_matrix.shape[0]} "
            f"segments, {len(set(result.labels.tolist()))} clusters, "
            f"lengths {lens.min()}..{lens.max()} — {desc}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
