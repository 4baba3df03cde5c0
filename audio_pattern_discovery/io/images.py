"""Per-cluster spectrogram images (SURVEY.md SS3 row 8, SS1.2).

The reference's typical auxiliary output for human inspection of discovered
motifs is per-cluster audio snippets and/or spectrogram images; snippets are
written by pipeline.write_artifacts, images here.  Host-side only: each
image is a colormapped RGB array written as a PNG by `write_png` (NumPy and
zlib, no plotting library).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

# Anchor colors of a dark-to-bright sequential map (black, purple, red,
# orange, pale yellow), linearly interpolated to 256 entries.
_ANCHORS = np.array(
    [
        [0, 0, 4],
        [59, 15, 112],
        [140, 41, 129],
        [222, 73, 104],
        [254, 159, 109],
        [252, 253, 191],
    ],
    np.float64,
)
COLORMAP = np.stack(
    [
        np.interp(
            np.linspace(0.0, 1.0, 256),
            np.linspace(0.0, 1.0, len(_ANCHORS)),
            _ANCHORS[:, ch],
        )
        for ch in range(3)
    ],
    axis=1,
).round().astype(np.uint8)                               # [256, 3]

_GAP = 4          # pixels between member panels
_SCALE = 2        # each spectrogram cell becomes SCALE x SCALE pixels


def write_png(path: str | Path, rgb: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 array as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    # Filter type 0 (None) on every scanline.
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1
    ).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_cluster_images(
    out_dir: str | Path,
    clusters,                      # list[ClusterReport]
    seg_spectrograms: np.ndarray,  # [K, L, bins] raw (log) spectrogram segments
    seg_lengths: np.ndarray,       # [K]
    *,
    max_per_cluster: int = 8,
) -> list[Path]:
    """One PNG per cluster: members' spectrograms side by side, exemplar
    first, frequency upwards, on one shared color scale.

    Returns the written paths."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written: list[Path] = []
    for rep in clusters:
        members = [rep.exemplar] + [m for m in rep.members if m != rep.exemplar]
        members = members[:max_per_cluster]
        specs = [
            np.asarray(seg_spectrograms[m, : seg_lengths[m]], np.float64)
            for m in members
        ]
        vmin = min(float(s.min()) for s in specs)
        vmax = max(float(s.max()) for s in specs)
        span = vmax - vmin if vmax > vmin else 1.0
        bins = seg_spectrograms.shape[2]
        width = sum(s.shape[0] for s in specs) + _GAP * (len(specs) - 1)
        canvas = np.full((bins, width, 3), 255, np.uint8)
        x0 = 0
        for s in specs:
            idx = np.clip((s.T[::-1] - vmin) / span * 255.0, 0, 255)
            canvas[:, x0 : x0 + s.shape[0]] = COLORMAP[idx.astype(np.uint8)]
            x0 += s.shape[0] + _GAP
        canvas = canvas.repeat(_SCALE, axis=0).repeat(_SCALE, axis=1)
        path = out / f"cluster{rep.cluster_id:03d}.png"
        write_png(path, canvas)
        written.append(path)
    return written
