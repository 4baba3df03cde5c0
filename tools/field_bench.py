#!/usr/bin/env python
"""BASELINE config 5 at hours scale: end-to-end discovery on field-style
recordings (long 44.1 kHz clips, planted motifs), streaming tiles throughout.

Synthesizes the corpus once (cached under APD_FIELD_DIR, default
/tmp/apd_field), runs the full pipeline on the real chip, and prints stage
timings + the cluster-quality scorecard as one JSON line on stdout.

Usage:
    python tools/field_bench.py [hours]      # default 2.0
Env: APD_FIELD_DIR, APD_FIELD_SEED.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

CLIP_MINUTES = 5.0
SAMPLE_RATE = 44_100
N_MOTIFS = 6
OCC_PER_CLIP = 8


def log(m):
    print(m, file=sys.stderr, flush=True)


def main() -> int:
    hours = float(sys.argv[1]) if len(sys.argv) > 1 else 2.0
    seed = int(os.environ.get("APD_FIELD_SEED", 11))
    n_clips = max(1, round(hours * 60 / CLIP_MINUTES))
    base = pathlib.Path(os.environ.get("APD_FIELD_DIR", "/tmp/apd_field"))
    corpus = base / f"corpus_{n_clips}x{int(CLIP_MINUTES)}min_s{seed}"

    from audio_pattern_discovery.synthetic import make_corpus

    if not (corpus / "truth.json").exists():
        log(f"synthesizing {n_clips} x {CLIP_MINUTES:.0f} min clips ...")
        t0 = time.time()
        make_corpus(
            corpus,
            n_clips=n_clips,
            n_motifs=N_MOTIFS,
            occurrences_per_clip=OCC_PER_CLIP,
            clip_seconds=CLIP_MINUTES * 60,
            motif_seconds=(0.3, 0.6),
            sample_rate=SAMPLE_RATE,
            seed=seed,
        )
        log(f"synthesis: {time.time() - t0:.0f}s")
    else:
        log(f"reusing corpus at {corpus}")

    from audio_pattern_discovery.config import PipelineConfig
    from audio_pattern_discovery.pipeline import discover
    from audio_pattern_discovery.utils.logging import get_logger

    out = base / "out"
    cfg = PipelineConfig()
    cfg.spectrogram.sample_rate = SAMPLE_RATE
    cfg.dtw.band = 16
    cfg.output.write_snippets = False   # hours of snippets would swamp disk
    cfg.output.write_images = False
    # APD_FIELD_CODEC=mulaw8 halves the dominant upload vs int16 (quality
    # parity gated in tests/test_pipeline_e2e.py).
    codec = os.environ.get("APD_FIELD_CODEC")
    if codec:
        cfg.spectrogram.upload_codec = codec
    # APD_FIELD_OVERLAP=0.5 launches AE training after the first half of
    # the clips so epochs hide under the remaining uploads (round 4;
    # quality gated by the scorecard below).
    overlap = os.environ.get("APD_FIELD_OVERLAP")
    if overlap:
        cfg.autoencoder.overlap_clip_fraction = float(overlap)
    cfg.validate()

    t0 = time.time()
    result = discover(corpus, cfg, out_dir=out, logger=get_logger())
    wall = time.time() - t0

    truth = json.loads((corpus / "truth.json").read_text())
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from eval_clusters import evaluate

    scores = evaluate(result.manifest(), truth)
    rec = {
        "metric": "config5_e2e_hours_scale",
        "hours": hours,
        "n_clips": n_clips,
        "n_segments": len(result.segments),
        "n_clusters": len(result.clusters),
        "wall_s": round(wall, 1),
        "timings_s": {k: round(v, 1) for k, v in result.counters.timings_s.items()},
        "upload_codec": cfg.spectrogram.upload_codec,
        **scores,
    }
    log(json.dumps(rec, indent=2))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
