"""--doctor diagnostics: the report must always materialize (each probe is
individually guarded) and name the suite's CPU backend."""

import json


def test_run_doctor_report_shape():
    from audio_pattern_discovery.utils.doctor import run_doctor

    rep = run_doctor()
    assert rep["versions"]["jax"]
    assert rep["host"]["cpus"] >= 1
    assert isinstance(rep["native_lib"]["available"], bool)
    assert "dir" in rep["compile_cache"]
    dev = rep["device"]
    assert "error" not in dev, dev
    assert dev["platform"] == "cpu"  # suite forces the CPU backend
    assert dev["n_devices"] == 8     # 8-virtual-device suite mesh
    assert isinstance(rep["gpu"], str)
    json.dumps(rep)  # JSON-serializable end to end


def test_cli_doctor_flag(capsys):
    from audio_pattern_discovery.cli import main

    assert main(["--doctor"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert "device" in rep and "versions" in rep


def test_run_doctor_probe_guard(monkeypatch):
    """A dead backend degrades the device entry, never the report."""
    import jax

    from audio_pattern_discovery.utils import doctor

    monkeypatch.setattr(
        jax, "devices", lambda *a: (_ for _ in ()).throw(RuntimeError("down"))
    )
    rep = doctor.run_doctor()
    assert "error" in rep["device"]
    assert rep["versions"]["jax"]
