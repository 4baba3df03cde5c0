"""Warm-process serving (serve.py): protocol, fault isolation, and
output parity with the direct library calls.

The server runs as a real subprocess under JAX_PLATFORMS=cpu, exercising
the --serve CLI wiring,
the socket protocol, and the one-at-a-time request loop end to end.  One
long test amortizes the subprocess's import cost — the point of the serve
mode is precisely that process startup is expensive.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from audio_pattern_discovery.config import PipelineConfig
from audio_pattern_discovery.serve import request, serve
from audio_pattern_discovery.synthetic import make_corpus

REPO_ROOT = str(pathlib.Path(__file__).resolve().parents[1])


def _small_cfg_dict() -> dict:
    cfg = PipelineConfig()
    cfg.spectrogram.sample_rate = 16_000
    cfg.spectrogram.win_length = 256
    cfg.spectrogram.hop_length = 128
    cfg.spectrogram.max_bins = 64
    cfg.segmentation.threshold_db = -25.0
    cfg.segmentation.min_len_frames = 6
    cfg.segmentation.merge_gap_frames = 3
    cfg.autoencoder.enabled = False
    cfg.dtw.max_seq_len = 64
    cfg.dtw.pair_batch = 128
    return cfg.to_dict()


def _start_server(sock):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen(
        [
            sys.executable,
            "-m",
            "audio_pattern_discovery",
            "--serve",
            str(sock),
        ],
        cwd=REPO_ROOT,
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )
    deadline = time.time() + 180  # one-core host: imports can crawl
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(
                f"server died at startup: {proc.stderr.read()[-3000:]}"
            )
        if sock.exists():
            try:
                r = request(sock, {"cmd": "ping"}, timeout=10)
                if r.get("ok"):
                    return proc
            except OSError:
                pass
        time.sleep(0.2)
    proc.kill()
    raise TimeoutError("server never answered ping")


@pytest.mark.full
def test_serve_end_to_end(tmp_path):
    corpus = tmp_path / "corpus"
    make_corpus(corpus, n_clips=6, n_motifs=2, clip_seconds=1.5, seed=3)
    out_srv = tmp_path / "out_srv"
    out_lib = tmp_path / "out_lib"
    cfg_dict = _small_cfg_dict()
    sock = tmp_path / "apd.sock"

    proc = _start_server(sock)
    try:
        # -- discover through the server ---------------------------------
        r = request(
            sock,
            {
                "cmd": "discover",
                "wav_dir": str(corpus),
                "out_dir": str(out_srv),
                "config": cfg_dict,
            },
            timeout=600,
        )
        assert r["ok"], r.get("traceback", r)
        res = r["result"]
        assert res["n_clusters"] >= 1 and res["n_segments"] > 2
        assert (out_srv / "clusters.json").exists()

        # -- parity with the direct library call -------------------------
        from audio_pattern_discovery.pipeline import discover

        direct = discover(
            corpus, PipelineConfig.from_dict(cfg_dict), out_dir=out_lib
        )
        srv_clusters = json.loads((out_srv / "clusters.json").read_text())
        lib_clusters = json.loads((out_lib / "clusters.json").read_text())
        assert [c["members"] for c in srv_clusters["clusters"]] == [
            c["members"] for c in lib_clusters["clusters"]
        ]
        D_srv = np.load(out_srv / "distance_matrix.npy")
        D_lib = np.load(out_lib / "distance_matrix.npy")
        np.testing.assert_array_equal(D_srv, D_lib)
        assert res["n_segments"] == len(direct.segments)

        # -- query the warm index (second request, same process) ---------
        qwav = sorted(corpus.glob("*.wav"))[0]
        r = request(
            sock,
            {
                "cmd": "query",
                "out_dir": str(out_srv),
                "wavs": [str(qwav)],
                "top_k": 3,
                "config": cfg_dict,
            },
            timeout=600,
        )
        assert r["ok"], r.get("traceback", r)
        assert r["result"]["queries"], "query returned no matches"

        # -- fault isolation: bad requests must not kill the worker ------
        r = request(sock, {"cmd": "no_such_cmd"}, timeout=30)
        assert not r["ok"] and "unknown cmd" in r["error"]
        r = request(
            sock,
            {
                "cmd": "discover",
                "wav_dir": str(corpus),
                "out_dir": str(out_srv / "bad"),
                "config": cfg_dict,
                "overrides": {"dtw.nonexistent_knob": 1},
            },
            timeout=60,
        )
        assert not r["ok"]
        r = request(sock, {"cmd": "ping"}, timeout=30)
        assert r["ok"], "worker died after a failed request"

        # -- doctor (host-only) ------------------------------------------
        r = request(sock, {"cmd": "doctor", "probe_device": False}, timeout=60)
        assert r["ok"] and "versions" in r["result"]

        # -- shutdown ------------------------------------------------------
        r = request(sock, {"cmd": "shutdown"}, timeout=30)
        assert r["ok"]
        proc.wait(timeout=60)
        assert proc.returncode == 0
        out = proc.stdout.read().strip().splitlines()
        assert json.loads(out[-1])["served"] >= 6
        assert not sock.exists(), "socket file not cleaned up"
    finally:
        if proc.poll() is None:
            proc.kill()


def test_serve_refuses_second_live_server(tmp_path):
    """Two workers on one socket would race for the device; the second
    must refuse to start (in-process servers keep this test cheap)."""
    import threading

    sock = tmp_path / "apd.sock"
    t = threading.Thread(
        target=serve, args=(sock,), kwargs={"max_requests": 2}, daemon=True
    )
    t.start()
    deadline = time.time() + 30
    while time.time() < deadline and not sock.exists():
        time.sleep(0.05)
    assert request(sock, {"cmd": "ping"}, timeout=10)["ok"]
    with pytest.raises(RuntimeError, match="already answering"):
        serve(sock)
    request(sock, {"cmd": "shutdown"}, timeout=10)
    t.join(timeout=30)
    assert not t.is_alive()


def test_serve_replaces_stale_socket(tmp_path):
    """A dead server's leftover socket file must not brick the path."""
    import socket as socket_mod

    sock = tmp_path / "apd.sock"
    s = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    s.bind(str(sock))
    s.close()  # bound then closed: the file remains, nothing answers
    served = []
    import threading

    t = threading.Thread(
        target=lambda: served.append(serve(sock, max_requests=1)), daemon=True
    )
    t.start()
    deadline = time.time() + 30
    r = None
    while time.time() < deadline:
        try:
            r = request(sock, {"cmd": "ping"}, timeout=5)
            break
        except OSError:
            time.sleep(0.05)
    assert r and r["ok"]
    t.join(timeout=30)
    assert served == [1]
