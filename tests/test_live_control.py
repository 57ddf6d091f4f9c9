"""Live control-plane e2e: the streamer serving the ZMQ protocol in-process,
with RELOAD / PHASE_TYPE_SET / SOFT_RESET acting on the running engine
(capability the reference lacks — its daemon is a counter stub)."""

import subprocess
import sys
import time

import numpy as np
import pytest

from totton_tpu.control.client import DaemonClient
from totton_tpu.filters.generate import generate_one


@pytest.fixture(scope="module")
def phase_filter_dir(tmp_path_factory):
    """A directory with BOTH phases of the same geometry (hot-swappable)."""
    out = tmp_path_factory.mktemp("phase_coeff")
    generate_one("44k_2x", 2000, 25.0, 140.0, "minimum", str(out))
    generate_one("44k_2x", 2000, 25.0, 140.0, "linear", str(out))
    return out


def _wait_ping(client, proc, deadline_s=180):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if client.ping():
            return
        time.sleep(0.2)
    proc.kill()
    pytest.fail(f"streamer never served PING: {proc.stdout.read()}")


def test_config_eq_tracked_across_reload(phase_filter_dir, tmp_path):
    """The web 'apply EQ -> RELOAD' flow (reference SURVEY.md §3.4): the
    streamer re-reads config.json's eqEnabled/eqProfilePath on every
    RELOAD, so activating / switching / disabling an EQ profile reaches
    the live engine without a restart."""
    import json

    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"eqEnabled": False}))
    profile = tmp_path / "boost.txt"
    profile.write_text("Preamp: -3 dB\nFilter 1: ON PK Fc 1000 Hz Gain 3 dB Q 1.0\n")

    endpoint = f"ipc://{tmp_path}/cfg_eq.sock"
    proc = subprocess.Popen(
        [sys.executable, "-m", "totton_tpu.cli.stream",
         "--in", "null", "--out", str(tmp_path / "out.wav"),
         "--rate", "352800",
         "--ratio", "2", "--filter-dir", str(phase_filter_dir),
         "--config", str(cfg),
         "--control-endpoint", endpoint,
         "--duration", "120"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        client = DaemonClient(endpoint=endpoint, timeout_ms=15000)
        _wait_ping(client, proc)

        # Activate the profile the way the web layer does: edit config.json,
        # then RELOAD.
        cfg.write_text(json.dumps({
            "eqEnabled": True,
            "eqProfile": "boost",
            "eqProfilePath": str(profile),
        }))
        assert client.reload_config().ok

        # Point at a missing file: reload must survive and drop the EQ.
        cfg.write_text(json.dumps({
            "eqEnabled": True,
            "eqProfilePath": str(tmp_path / "gone.txt"),
        }))
        assert client.reload_config().ok

        # Disable: reload goes back to the clean filter. alsa.dither in
        # the same config write reaches the live sink (web toggle flow).
        cfg.write_text(json.dumps({"eqEnabled": False,
                                   "alsa": {"dither": True}}))
        assert client.reload_config().ok

        # RELOAD adopts config's filter.phaseType (settings-page PATCH flow).
        cfg.write_text(json.dumps({
            "eqEnabled": False, "filter": {"phaseType": "linear"},
        }))
        assert client.reload_config().ok
        assert client.get_phase_type().data["phase_type"] == "linear"

        # PHASE_TYPE_SET persists back into config.json so the next
        # RELOAD / restart keeps it.
        assert client.set_phase_type("minimum").ok
        assert json.loads(cfg.read_text())["filter"]["phaseType"] == "minimum"
        assert client.reload_config().ok
        assert client.get_phase_type().data["phase_type"] == "minimum"

        assert client.shutdown().ok
        assert proc.wait(timeout=60) == 0
        out = proc.stdout.read()
        assert "+ EQ" in out and "boost.txt" in out
        assert "EQ skipped" in out
        assert "Live dither: on" in out
        # The final reload line carries no EQ suffix.
        last_reload = [l for l in out.splitlines()
                       if l.startswith("Live reload:")][-1]
        assert "+ EQ" not in last_reload and "skipped" not in last_reload
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_startup_phase_from_config(phase_filter_dir, tmp_path):
    """Without --phase, the streamer boots with config.json's
    filter.phaseType — so a persisted PHASE_TYPE_SET survives a restart
    instead of reverting to minimum."""
    import json

    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"filter": {"phaseType": "linear"}}))
    endpoint = f"ipc://{tmp_path}/boot_phase.sock"
    proc = subprocess.Popen(
        [sys.executable, "-m", "totton_tpu.cli.stream",
         "--in", "null", "--out", "null", "--rate", "352800",
         "--ratio", "2", "--filter-dir", str(phase_filter_dir),
         "--config", str(cfg),
         "--control-endpoint", endpoint,
         "--duration", "60"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        client = DaemonClient(endpoint=endpoint, timeout_ms=15000)
        _wait_ping(client, proc)
        assert client.get_phase_type().data["phase_type"] == "linear"
        assert client.shutdown().ok
        assert proc.wait(timeout=60) == 0
        out = proc.stdout.read()
        assert "linear_phase" in out.splitlines()[0]  # loaded at startup
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_streamer_with_live_control(phase_filter_dir, tmp_path):
    endpoint = f"ipc://{tmp_path}/live.sock"
    proc = subprocess.Popen(
        [sys.executable, "-m", "totton_tpu.cli.stream",
         "--in", "null", "--out", "null", "--rate", "352800",
         "--ratio", "2", "--filter-dir", str(phase_filter_dir),
         "--control-endpoint", endpoint,
         "--stats-path", str(tmp_path / "stats.json"),
         "--duration", "60"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        # Generous timeout: PHASE_TYPE_SET does real work in the handler
        # (filter load from disk + spectrum FFT), ~1-2 s on the CPU backend.
        client = DaemonClient(endpoint=endpoint, timeout_ms=15000)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if client.ping():
                break
            time.sleep(0.2)
        else:
            proc.kill()
            pytest.fail(f"streamer never served PING: {proc.stdout.read()}")

        # Live phase swap (same geometry -> no recompile, no restart).
        r = client.set_phase_type("linear")
        assert r.ok, r.raw
        assert client.get_phase_type().data["phase_type"] == "linear"

        assert client.reload_config().ok
        assert client.soft_reset().ok

        stats = client.stats()
        assert stats.ok and stats.data["reloads"] >= 1

        # SHUTDOWN stops the stream loop and exits cleanly.
        assert client.shutdown().ok
        assert proc.wait(timeout=60) == 0
        out = proc.stdout.read()
        assert "Live reload:" in out
        assert "linear_phase" in out
        assert "Streaming stopped" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_sharded_phase_type_set(phase_filter_dir, tmp_path):
    """--shard-time + PHASE_TYPE_SET: a
    same-geometry hot swap must land on the sharded engine (the 16
    shipped artifacts — and this fixture's two phases — share geometry,
    so ShardedUpsampler.load_filter accepts it)."""
    endpoint = f"ipc://{tmp_path}/sharded_phase.sock"
    proc = subprocess.Popen(
        [sys.executable, "-m", "totton_tpu.cli.stream",
         "--in", "null", "--out", "null", "--rate", "352800",
         "--ratio", "2", "--filter-dir", str(phase_filter_dir),
         "--shard-time", "2",
         "--control-endpoint", endpoint,
         "--duration", "120"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        client = DaemonClient(endpoint=endpoint, timeout_ms=20000)
        _wait_ping(client, proc)
        r = client.set_phase_type("linear")
        assert r.ok, r.raw
        assert client.get_phase_type().data["phase_type"] == "linear"
        assert client.soft_reset().ok
        assert client.shutdown().ok
        assert proc.wait(timeout=60) == 0
        out = proc.stdout.read()
        assert "Sharded engine" in out
        assert "linear_phase" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
