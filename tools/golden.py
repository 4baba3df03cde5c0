#!/usr/bin/env python
"""Golden-output regression harness (SURVEY.md SS8 'bit-exact cluster parity').

Save a run's full behavioral fingerprint, then check later runs against it:

    python tools/golden.py save  CORPUS GOLDEN.npz [-s key=value ...]
    python tools/golden.py check CORPUS GOLDEN.npz [-s key=value ...]

The fingerprint is the distance matrix (float tolerance) and the cluster
label partition (exact, up to label renumbering).  This is the mechanism
for demonstrating "identical cluster assignments" across refactors and —
once the reference corpus is available — against the reference itself.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _canonical_partition(labels: np.ndarray) -> list[tuple[int, ...]]:
    groups: dict[int, list[int]] = {}
    for i, lab in enumerate(labels):
        groups.setdefault(int(lab), []).append(i)
    return sorted(tuple(g) for g in groups.values())


def _run(corpus: str, overrides: list[str]):
    from audio_pattern_discovery.cli import _parse_override
    from audio_pattern_discovery.config import PipelineConfig
    from audio_pattern_discovery.pipeline import discover

    cfg = PipelineConfig()
    if overrides:
        cfg = cfg.override(dict(_parse_override(kv) for kv in overrides))
    return discover(corpus, cfg)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["save", "check"])
    ap.add_argument("corpus")
    ap.add_argument("golden")
    ap.add_argument("-s", "--set", dest="overrides", action="append", default=[])
    ap.add_argument("--rtol", type=float, default=1e-4)
    args = ap.parse_args()

    result = _run(args.corpus, args.overrides)
    D = result.distance_matrix
    labels = result.labels

    if args.mode == "save":
        np.savez(args.golden, D=D, labels=labels)
        print(f"saved golden: {D.shape[0]} segments, "
              f"{len(set(labels.tolist()))} clusters -> {args.golden}")
        return 0

    ref = np.load(args.golden)
    ok = True
    if ref["D"].shape != D.shape:
        print(f"FAIL: segment count {D.shape[0]} != golden {ref['D'].shape[0]}")
        return 1
    derr = float(np.abs(ref["D"] - D).max())
    dscale = float(np.abs(ref["D"]).max()) or 1.0
    if derr > args.rtol * dscale:
        print(f"FAIL: distance matrix max|err| {derr:.3e} > rtol*scale")
        ok = False
    else:
        print(f"distances OK (max|err| {derr:.3e})")
    if _canonical_partition(ref["labels"]) != _canonical_partition(labels):
        print("FAIL: cluster partition differs from golden")
        ok = False
    else:
        print("cluster partition identical")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
