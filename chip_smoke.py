#!/usr/bin/env python
"""Smoke test of the whole system on one CUDA GPU: the quickest proof that
discovery still starts, runs its compiled kernels and gets the right answer
on the card.

    python chip_smoke.py            # phases 1-4 on one GPU
    python chip_smoke.py --four     # only the four-GPU sharded discovery

Run it from the root of a checkout.  Everything runs in this one process
(the CLI is driven in-process through `cli.main`), so it holds one card.
Phases, each of which fails the run:

1. Discovery: a 100-clip, 10 s, 44.1 kHz corpus with 6 planted motifs
   through `cli.main`, once with the default config (unbanded, AE on,
   images on, AE checkpoint kept for phase 2) and once with
   `-s dtw.band=16`; purity and coverage against the planted truth.
2. Query: `query_corpus` with a held-out planted-motif WAV against phase
   1's index; each query segment's top match is its own motif.
3. All-pairs at config-4 width: K=10,240, S=128, d=16 through
   `all_pairs_distances`, band=16 "diag" and unbanded; route, wall time,
   and 256 pairs spot-checked against the native C++ loop (or the oracle).
4. Kernel vs reference: the tile kernel at each shape of the PERF.md table
   against the float64 oracle (rtol 1e-5) and the plain path at HIGHEST
   precision (rtol 1e-4, self-pairs excluded: the plain path's Gram form
   leaves a cancellation residue there); the spectrogram against the
   float64 STFT oracle at the test suite's tolerance.

`--four` runs only the sharded discovery over four GPUs
(`parallel.data_axis=-1`) on the 0.5 h field corpus of tools/field_bench.py
and compares it with `data_axis=1` in the same process.

Exits non-zero without printing a result when JAX finds no GPU or any
phase fails.  The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PURITY_MIN = 0.9       # the planted-corpus gates of tests/test_pipeline_e2e.py
COVERAGE_MIN = 0.7
ORACLE_RTOL = 1e-5     # kernel vs float64 oracle: fp32-level agreement
PLAIN_RTOL = 1e-4      # kernel vs plain path (Gram-form cost, HIGHEST)
SPEC_TOL = 1e-4        # tests/test_spectrogram.py: rtol = atol = 1e-4
# 4 GPUs vs 1: the data-parallel AE reduces its gradients in another order,
# so the learned embedding, and every distance after it, differs slightly;
# the cluster partition must not.
FOUR_RTOL = 5e-2


def say(msg: str) -> None:
    print(msg, flush=True)


def _evaluate(manifest: dict, truth: list[dict]) -> dict:
    sys.path.insert(0, str(ROOT / "tools"))
    from eval_clusters import evaluate

    return evaluate(manifest, truth)


def _motif_at(truth: list[dict], file: str, start: int, end: int):
    best, best_ov = None, 0
    for t in truth:
        if t["file"] != os.path.basename(file):
            continue
        ov = min(end, t["end_sample"]) - max(start, t["start_sample"])
        if ov > best_ov:
            best, best_ov = t["motif"], ov
    return best


# ----------------------------------------------------------------- phases
def phase_discovery(work: Path) -> dict:
    from audio_pattern_discovery import cli
    from audio_pattern_discovery.synthetic import make_corpus

    src = work / "src"
    make_corpus(src, n_clips=101, n_motifs=6, occurrences_per_clip=3,
                clip_seconds=10.0, sample_rate=44_100, seed=5)
    corpus = work / "corpus"
    corpus.mkdir()
    for p in sorted(src.glob("clip_*.wav"))[:100]:
        shutil.copy(p, corpus / p.name)
    truth = [t for t in json.loads((src / "truth.json").read_text())
             if t["file"] != "clip_0100.wav"]
    out = {}
    for name, extra in (("default", []), ("band16", ["-s", "dtw.band=16"])):
        od = work / f"out_{name}"
        t0 = time.perf_counter()
        rc = cli.main([str(corpus), "-o", str(od),
                       "-s", "autoencoder.checkpoint=true", *extra])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli.main ({name}) returned {rc}")
        scores = _evaluate(json.loads((od / "clusters.json").read_text()),
                           truth)
        pngs = len(list((od / "images").glob("*.png"))) if (
            od / "images").is_dir() else len(list(od.rglob("*.png")))
        say(f"phase 1 [{name}]: {wall:.1f} s wall, purity "
            f"{scores['purity']}, coverage {scores['coverage']}, "
            f"{pngs} cluster images")
        if scores["purity"] < PURITY_MIN or scores["coverage"] < COVERAGE_MIN:
            raise RuntimeError(f"discovery quality below the gates: {scores}")
        if name == "default" and pngs == 0:
            raise RuntimeError("default config wrote no cluster images")
        out[name] = od
    return {"src": src, "index": out["default"]}


def phase_query(src: Path, index: Path) -> None:
    from audio_pattern_discovery.config import PipelineConfig
    from audio_pattern_discovery.query import query_corpus

    cfg = PipelineConfig()
    cfg.autoencoder.checkpoint = True
    truth = json.loads((src / "truth.json").read_text())
    t0 = time.perf_counter()
    report = query_corpus(index, [src / "clip_0100.wav"], cfg, top_k=5)
    wall = time.perf_counter() - t0
    hop, win = cfg.spectrogram.hop_length, cfg.spectrogram.win_length
    checked = 0
    for q in report["queries"]:
        want = _motif_at(truth, "clip_0100.wav", q["start_frame"] * hop,
                         (q["end_frame"] - 1) * hop + win)
        if want is None:
            continue
        top = q["matches"][0]
        got = _motif_at(truth, top["file"], top["start_sample"],
                        top["end_sample"])
        if got != want:
            raise RuntimeError(
                f"query segment of motif {want}: top match is motif {got}")
        checked += 1
    if not checked:
        raise RuntimeError("no query segment overlapped a planted motif")
    say(f"phase 2: {checked} query segments, each matched its own motif "
        f"first ({wall:.1f} s)")


def _reference(feats, lens, ii, jj, band, metric="euclidean"):
    """Distances of pairs (ii, jj) from the native C++ loop when it is
    built, else from the float64 oracle."""
    import numpy as np

    from audio_pattern_discovery import native
    from audio_pattern_discovery.oracle.dtw import dtw_oracle

    if native.available():
        return native.dtw_batch_cpu(
            feats[ii], feats[jj], lens[ii], lens[jj], metric=metric,
            band=band, band_mode="diag", normalize="path_len"), "native C++"
    return np.array([
        dtw_oracle(feats[a, :lens[a]], feats[b, :lens[b]], metric=metric,
                   band=band, band_mode="diag", normalize="path_len")
        for a, b in zip(ii, jj)
    ]), "oracle"


def phase_all_pairs() -> None:
    import numpy as np

    from audio_pattern_discovery.config import DTWConfig
    from audio_pattern_discovery.parallel.pair_scheduler import (
        all_pairs_distances,
    )
    from audio_pattern_discovery.synthetic import random_sequences

    feats, lens = random_sequences(10_240, 128, 16, seed=4)
    K, S, d = feats.shape
    rng = np.random.default_rng(4)
    ii = rng.integers(0, K, 256)
    jj = (ii + 1 + rng.integers(0, K - 1, 256)) % K
    for band in (16, None):
        cfg = DTWConfig(band=band, band_mode="diag", normalize="path_len")
        stats: dict = {}
        t0 = time.perf_counter()
        D = all_pairs_distances(feats, lens, cfg, stats=stats)
        wall = time.perf_counter() - t0
        if not np.all(np.isfinite(D)) or D.shape != (K, K):
            raise RuntimeError(f"band={band}: non-finite or misshapen matrix")
        ref, what = _reference(feats, lens, ii, jj, band)
        err = float(np.max(np.abs(D[ii, jj] - ref) / np.abs(ref)))
        route = "tile kernel" if stats.get("tiled") else "plain XLA"
        say(f"phase 3 [band={band}]: K={K} S={S} d={d}, route {route}, "
            f"{wall:.2f} s wall incl. compile ({K * (K - 1) // 2 / wall:,.0f}"
            f" pairs/s), max rel diff vs {what} on 256 pairs {err:.2e}")
        if route != "tile kernel":
            raise RuntimeError("the router did not take the tile kernel")
        if err > PLAIN_RTOL:
            raise RuntimeError(f"band={band}: spot check failed ({err:.2e})")


def phase_kernel_vs_reference() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from audio_pattern_discovery.ops.dtw import dtw_batch
    from audio_pattern_discovery.ops.dtw_tile import dtw_tile_pairs
    from audio_pattern_discovery.ops.spectrogram import batched_spectrogram
    from audio_pattern_discovery.oracle.dtw import dtw_oracle
    from audio_pattern_discovery.oracle.stft import stft_oracle
    from audio_pattern_discovery.synthetic import random_sequences

    ti = 128
    pairs = [(0, 0), (0, 1), (1, 1)]
    for S, d, band, n_oracle in ((128, 16, 16, 256), (128, 16, None, 256),
                                 (512, 16, None, 32), (128, 513, None, 256)):
        feats, lens = random_sequences(2 * ti, S, d, seed=S + d)
        for metric in ("euclidean", "sqeuclidean", "cosine"):
            blocks = np.asarray(dtw_tile_pairs(
                jnp.asarray(feats), jnp.asarray(lens),
                jnp.asarray([p[0] for p in pairs], jnp.int32),
                jnp.asarray([p[1] for p in pairs], jnp.int32),
                ti=ti, band=band, metric=metric,
            ))
            rng = np.random.default_rng(S * d)
            u = rng.integers(0, 3, 256)
            a = rng.integers(0, ti, 256)
            b = rng.integers(0, ti, 256)
            A = np.array([pairs[x][0] for x in u]) * ti + a
            B = np.array([pairs[x][1] for x in u]) * ti + b
            got = blocks[u, a, b]
            with jax.default_matmul_precision("highest"):
                plain = np.asarray(dtw_batch(
                    jnp.asarray(feats[A]), jnp.asarray(feats[B]),
                    jnp.asarray(lens[A]), jnp.asarray(lens[B]), band=band,
                    band_mode="diag", metric=metric,
                ))
            off = A != B
            e_plain = float(np.max(
                np.abs(got[off] - plain[off]) / np.abs(plain[off])))
            oracle_err = 0.0
            if metric == "euclidean":
                want = np.array([
                    dtw_oracle(feats[x, :lens[x]], feats[y, :lens[y]],
                               band=band, band_mode="diag")
                    for x, y in zip(A[:n_oracle], B[:n_oracle])
                ])
                oracle_err = float(np.max(
                    np.abs(got[:n_oracle] - want)
                    / np.maximum(np.abs(want), 1e-30)))
                if not np.allclose(got[:n_oracle], want, rtol=ORACLE_RTOL,
                                   atol=0.0):
                    raise RuntimeError(
                        f"S={S} d={d} band={band}: kernel vs oracle "
                        f"{oracle_err:.2e} > {ORACLE_RTOL}")
            say(f"phase 4 [S={S} d={d} band={band} {metric}]: max rel diff "
                f"vs plain(HIGHEST) {e_plain:.2e}"
                + (f", vs float64 oracle on {n_oracle} pairs "
                   f"{oracle_err:.2e}" if metric == "euclidean" else ""))
            if e_plain > PLAIN_RTOL:
                raise RuntimeError(
                    f"S={S} d={d} band={band} {metric}: kernel vs plain "
                    f"{e_plain:.2e} > {PLAIN_RTOL}")

    rng = np.random.default_rng(7)
    sig = rng.normal(0, 0.3, 44_100).astype(np.float32)
    ref = stft_oracle(sig, win_length=1024, hop_length=256)
    for prec in ("high", "highest"):
        spec, counts = batched_spectrogram(
            sig[None], np.array([len(sig)], np.int32), win_length=1024,
            hop_length=256, fft_precision=prec,
        )
        got = np.asarray(spec[0, : int(counts[0])])
        err = float(np.max(np.abs(got - ref) / (SPEC_TOL + SPEC_TOL * np.abs(ref))))
        say(f"phase 4 [spectrogram fft_precision={prec}]: max error "
            f"{err:.3f} of the test tolerance (rtol=atol={SPEC_TOL})")
        from audio_pattern_discovery.config import SpectrogramConfig

        if prec == SpectrogramConfig().fft_precision and err > 1.0:
            raise RuntimeError(
                f"spectrogram at the default fft_precision={prec} misses "
                "the oracle tolerance")


def phase_four(work: Path) -> None:
    import jax
    import numpy as np

    from audio_pattern_discovery.config import PipelineConfig
    from audio_pattern_discovery.pipeline import discover
    from audio_pattern_discovery.synthetic import make_corpus

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, JAX sees {len(jax.devices())}")
    corpus = work / "field"
    # tools/field_bench.py at 0.5 h: 6 clips of 5 min, 6 motifs, 8 each.
    make_corpus(corpus, n_clips=6, n_motifs=6, occurrences_per_clip=8,
                clip_seconds=300.0, motif_seconds=(0.3, 0.6),
                sample_rate=44_100, seed=11)
    truth = json.loads((corpus / "truth.json").read_text())
    results = {}
    for axis in (-1, 1):
        cfg = PipelineConfig()
        cfg.spectrogram.sample_rate = 44_100
        cfg.dtw.band = 16
        cfg.output.write_snippets = False
        cfg.output.write_images = False
        cfg.parallel.data_axis = axis
        t0 = time.perf_counter()
        res = discover(corpus, cfg, out_dir=work / f"field_out_{axis}")
        wall = time.perf_counter() - t0
        scores = _evaluate(res.manifest(), truth)
        say(f"four [data_axis={axis}]: {len(res.segments)} segments, "
            f"{wall:.1f} s wall, purity {scores['purity']}, coverage "
            f"{scores['coverage']}")
        results[axis] = res

    def partition(res):
        groups: dict[int, list[int]] = {}
        for seg, lab in enumerate(res.labels):
            groups.setdefault(int(lab), []).append(seg)
        return sorted(tuple(g) for g in groups.values())

    D4, D1 = results[-1].distance_matrix, results[1].distance_matrix
    err = float(np.max(np.abs(D4 - D1) / np.maximum(np.abs(D1), 1e-6)))
    same = partition(results[-1]) == partition(results[1])
    say(f"four: partitions identical: {same}; max rel distance difference "
        f"{err:.2e} (tolerance {FOUR_RTOL})")
    if not same or err > FOUR_RTOL:
        raise RuntimeError("4-GPU discovery differs from the 1-GPU run")


# ------------------------------------------------------------------ main
def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded discovery check")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import jax

    from audio_pattern_discovery import native
    from audio_pattern_discovery.platform import require_gpu
    from audio_pattern_discovery.utils.doctor import gpu_name_and_power_limit

    require_gpu("chip_smoke.py")
    devices = jax.devices()
    dev = devices[0]
    say(f"gpu: {gpu_name_and_power_limit()}")
    say(f"jax device: {dev.device_kind} x{len(devices)} (jax {jax.__version__})")
    say(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    say(f"native library available: {native.available()}")

    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT))
    failures = []
    try:
        if args.four:
            phases = [("four", lambda: phase_four(work))]
        else:
            state: dict = {}
            phases = [
                ("discovery", lambda: state.update(phase_discovery(work))),
                ("query", lambda: phase_query(state["src"], state["index"])),
                ("all-pairs", phase_all_pairs),
                ("kernel vs reference", phase_kernel_vs_reference),
            ]
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                fn()
            except Exception:
                failures.append(name)
                say(f"FAILED phase {name}:\n{traceback.format_exc()}")
            say(f"-- {name}: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
