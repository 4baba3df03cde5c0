"""The PNG writer and the per-cluster image layout (io/images.py)."""

import struct
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

from audio_pattern_discovery.io.images import (
    COLORMAP,
    write_cluster_images,
    write_png,
)


def _read_png(path):
    """Minimal decoder for the writer's format (8-bit RGB, filter 0)."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    assert (depth, ctype) == (8, 2)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert np.all(raw[:, 0] == 0)
    return raw[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (64, 129)])
def test_write_png_roundtrip(tmp_path, shape):
    rgb = np.random.default_rng(0).integers(0, 256, (*shape, 3), np.uint8)
    write_png(tmp_path / "x.png", rgb)
    np.testing.assert_array_equal(_read_png(tmp_path / "x.png"), rgb)


def test_write_png_rejects_bad_shape(tmp_path):
    with pytest.raises(ValueError, match="H, W, 3"):
        write_png(tmp_path / "x.png", np.zeros((4, 4), np.uint8))


def test_cluster_images_layout(tmp_path):
    """Members side by side (exemplar first), frequency upwards, one shared
    color scale: the global minimum maps to the map's first color and the
    maximum to its last."""
    K, L, bins = 3, 10, 6
    specs = np.zeros((K, L, bins), np.float32)
    specs[0, :4] = 0.0
    specs[1, :5] = 1.0
    specs[1, 0, 0] = 5.0                       # the global maximum
    specs[2, :3] = 2.0
    lengths = np.array([4, 5, 3])
    rep = SimpleNamespace(cluster_id=7, exemplar=1, members=[0, 1, 2])
    (path,) = write_cluster_images(tmp_path, [rep], specs, lengths)
    img = _read_png(path)
    # panel widths 5 (exemplar) + 4 + 3 frames, two 4-pixel gaps, scale 2
    assert img.shape == (2 * bins, 2 * (5 + 4 + 3 + 2 * 4), 3)
    # frame 0 of the exemplar: bin 0 (bottom row) holds the maximum
    np.testing.assert_array_equal(img[-1, 0], COLORMAP[-1])
    np.testing.assert_array_equal(img[0, 0], COLORMAP[51])   # 1.0 of 0..5
    # second panel (segment 0, all zeros) is the bottom of the map
    x0 = 2 * (5 + 4)
    np.testing.assert_array_equal(img[0, x0], COLORMAP[0])
