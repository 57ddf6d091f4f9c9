"""Serving-plane control e2e.

8 concurrent streams on totton-serve with the ZMQ control endpoint
attached; a web-style RELOAD (config phaseType flip) lands mid-stream;
every client's output is continuous through its own per-slot crossfade
(gated against the min/linear oracles + the exact fade model, no click,
no dropped sample); STATS shows the swap. The ZMQ surface is the
reference daemon's (src/zmq/zmq_server_main.cpp:150-221) — which needs a
container restart for the same result."""

import json
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from totton_tpu.control.client import DaemonClient
from totton_tpu.engine.upsampler import upsample_signal
from totton_tpu.filters.generate import generate_one
from totton_tpu.filters.sidecar import load_filter
from totton_tpu.io.pcm import interleave
from totton_tpu.io.sockets import HEADER_BYTES, pack_header

RATE = 44100
FADE = 500


@pytest.fixture(scope="module")
def phase_filter_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_phase_coeff")
    generate_one("44k_2x", 2000, 25.0, 140.0, "minimum", str(out))
    generate_one("44k_2x", 2000, 25.0, 140.0, "linear", str(out))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stream_client(port, x, swap_gate, results, errors, i, chunk=400):
    """Trickle x through a serve stream; wait for the swap gate mid-way
    so the spectrum swap lands while this stream is live."""
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=120)
        s.settimeout(120)
        s.sendall(pack_header(None, 2, RATE))
        hdr = b""
        while len(hdr) < HEADER_BYTES:
            hdr += s.recv(HEADER_BYTES - len(hdr))
        received = bytearray()

        def pump():
            raw = interleave(x).astype("<f4").tobytes()
            frame_bytes = 8
            half = (len(raw) // 2) // frame_bytes * frame_bytes
            s.sendall(raw[:half])
            # Hold mid-stream until the controller confirms the reload
            # applied, so the swap provably lands inside every stream.
            swap_gate.wait(timeout=120)
            s.sendall(raw[half:])
            s.shutdown(socket.SHUT_WR)

        t = threading.Thread(target=pump)
        t.start()
        while True:
            got = s.recv(65536)
            if not got:
                break
            received += got
        t.join(timeout=120)
        s.close()
        results[i] = np.frombuffer(bytes(received), "<f4").reshape(-1, 2).T
    except Exception as e:  # pragma: no cover
        errors.append((i, e))


def _fade_expectation(ref_old, ref_new, p):
    """Expected output when the swap's fade starts at output sample p."""
    expect = ref_new.copy()
    expect[:, :p] = ref_old[:, :p]
    n = min(FADE, expect.shape[1] - p)
    ramp = np.arange(n, dtype=np.float32) / FADE
    expect[:, p:p + n] = (ref_old[:, p:p + n] * (1.0 - ramp)
                          + ref_new[:, p:p + n] * ramp)
    return expect


def test_follower_fleet_replays_leader_phase_flip(phase_filter_dir,
                                                  tmp_path):
    """Fleet deployment: a follower serve process replays the leader's
    published PHASE_TYPE event on its own serving plane — one control
    surface for N serve hosts, each with its own per-stream crossfades."""
    lead_port, fol_port = _free_port(), _free_port()
    endpoint = f"ipc://{tmp_path}/lead_ctl.sock"
    pub = f"ipc://{tmp_path}/lead_pub.sock"
    fol_stats = tmp_path / "fol_stats.json"
    common = [sys.executable, "-m", "totton_tpu.cli.serve",
              "--rate", str(RATE), "--ratio", "2",
              "--filter-dir", str(phase_filter_dir),
              "--max-streams", "4", "--swap-fade", str(FADE),
              "--duration", "600"]
    leader = subprocess.Popen(
        common + ["--listen", f"tcp-listen://127.0.0.1:{lead_port}",
                  "--control-endpoint", endpoint,
                  "--control-pub-endpoint", pub],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    follower = subprocess.Popen(
        common + ["--listen", f"tcp-listen://127.0.0.1:{fol_port}",
                  "--control-follow", pub,
                  "--stats-path", str(fol_stats)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        client = DaemonClient(endpoint=endpoint, timeout_ms=30000)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            if client.ping():
                break
            time.sleep(0.2)
        else:
            pytest.fail("leader never served PING")
        # Follower ready = its listener answers the stream header.
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            try:
                probe = socket.create_connection(
                    ("127.0.0.1", fol_port), timeout=1)
                probe.settimeout(10)
                probe.sendall(pack_header(None, 2, RATE))
                if probe.recv(HEADER_BYTES):
                    probe.close()
                    break
                probe.close()
            except OSError:
                pass
            time.sleep(0.3)
        else:
            pytest.fail("follower never accepted")

        lf_min = load_filter(str(
            phase_filter_dir / "filter_44k_2x_2000_min_phase.json"))
        lf_lin = load_filter(str(
            phase_filter_dir / "filter_44k_2x_2000_linear_phase.json"))
        block_size = lf_min.sidecar.fft_size - lf_min.sidecar.taps + 1
        block_in = block_size // 2
        rng = np.random.default_rng(11)
        x = (rng.normal(size=(2, 60 * block_in)) * 0.3).astype(np.float32)

        swap_gate = threading.Event()
        results: dict[int, np.ndarray] = {}
        errors: list = []
        t = threading.Thread(target=_stream_client, args=(
            fol_port, x, swap_gate, results, errors, 0))
        t.start()
        time.sleep(1.0)  # client mid-stream on the FOLLOWER
        assert client.set_phase_type("linear").ok
        time.sleep(1.0)  # PUB delivery + follower reload
        swap_gate.set()
        t.join(timeout=300)
        assert not errors, errors

        y = results[0]
        assert y.shape == (2, x.shape[1] * 2)
        ref_old = upsample_signal(x, lf_min)
        ref_new = upsample_signal(x, lf_lin)
        best_err, best_p = np.inf, None
        for p in range(0, y.shape[1] + 1, block_size):
            expect = _fade_expectation(ref_old, ref_new, p)
            err = float(np.max(np.abs(expect - y)))
            if err < best_err:
                best_err, best_p = err, p
        assert best_err < 5e-4, (best_p, best_err)
        assert 0 < best_p < y.shape[1], best_p

        st = json.loads(fol_stats.read_text())
        assert st["spectrum_swaps"] == 1
        # Leader SHUTDOWN propagates to the follower over PUB.
        assert client.shutdown().ok
        assert leader.wait(timeout=120) == 0
        assert follower.wait(timeout=120) == 0
        assert "Live serve reload" in follower.stdout.read()
    finally:
        for proc in (leader, follower):
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def test_live_reload_under_8_concurrent_streams(phase_filter_dir, tmp_path):
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"filter": {"phaseType": "minimum"}}))
    stats_path = tmp_path / "serve_stats.json"
    endpoint = f"ipc://{tmp_path}/serve_ctl.sock"
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "totton_tpu.cli.serve",
         "--listen", f"tcp-listen://127.0.0.1:{port}",
         "--rate", str(RATE), "--ratio", "2",
         "--filter-dir", str(phase_filter_dir),
         "--max-streams", "8", "--swap-fade", str(FADE),
         "--control-endpoint", endpoint,
         "--config", str(cfg),
         "--stats-path", str(stats_path),
         "--duration", "600"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        client = DaemonClient(endpoint=endpoint, timeout_ms=30000)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            if client.ping():
                break
            time.sleep(0.2)
        else:
            proc.kill()
            pytest.fail(f"serve never served PING: {proc.stdout.read()}")

        lf_min = load_filter(str(
            phase_filter_dir / "filter_44k_2x_2000_min_phase.json"))
        lf_lin = load_filter(str(
            phase_filter_dir / "filter_44k_2x_2000_linear_phase.json"))
        block_size = (lf_min.sidecar.fft_size - lf_min.sidecar.taps + 1)
        block_in = block_size // 2

        rng = np.random.default_rng(7)
        sigs = [(rng.normal(size=(2, (40 + 4 * i) * block_in)) * 0.3)
                .astype(np.float32) for i in range(8)]
        swap_gate = threading.Event()
        results: dict[int, np.ndarray] = {}
        errors: list = []
        threads = [threading.Thread(
            target=_stream_client,
            args=(port, sigs[i], swap_gate, results, errors, i))
            for i in range(8)]
        for t in threads:
            t.start()

        # Wait until every stream has drained its first half (all 8
        # attached and mid-stream), then flip the phase the web way:
        # PATCH config.json + RELOAD.
        # Every stream's first half drains at least this much output
        # (slots map to clients in arbitrary order, so gate on the min).
        out_floor = min(
            (x.shape[1] // 2 // block_in) * block_in * 2 for x in sigs)
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and not errors:
            try:
                st = json.loads(stats_path.read_text())
                active = st["streams"]["active"]
                drained = (bool(st["per_stream"]) and all(
                    ps["frames_out"] >= out_floor
                    for ps in st["per_stream"]))
            except (OSError, json.JSONDecodeError, KeyError):
                active, drained = 0, False
            if active == 8 and drained:
                break
            time.sleep(0.1)
        cfg.write_text(json.dumps({"filter": {"phaseType": "linear"}}))
        r = client.reload_config()
        assert r.ok, r
        swap_gate.set()

        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        assert len(results) == 8

        for i, y in results.items():
            x = sigs[i]
            # No dropped sample: exact output length.
            assert y.shape == (2, x.shape[1] * 2), (i, y.shape)
            # The swap lands at SOME post-swap dispatch boundary of this
            # stream (a block_size multiple); gate the whole output
            # against the exact fade model at that boundary.
            ref_old = upsample_signal(x, lf_min)
            ref_new = upsample_signal(x, lf_lin)
            best_err, best_p = np.inf, None
            for p in range(0, y.shape[1] + 1, block_size):
                expect = _fade_expectation(ref_old, ref_new, p)
                err = float(np.max(np.abs(expect - y)))
                if err < best_err:
                    best_err, best_p = err, p
            assert best_err < 5e-4, (i, best_p, best_err)
            # The swap really happened mid-stream for this client (not
            # before its first block, not after its last).
            assert 0 < best_p < y.shape[1], (i, best_p)

        # STATS shows the swap: daemon counters + merged serve stats.
        st = client.stats()
        assert st.ok
        assert st.data["reloads"] == 1
        assert st.data["phase_type"] == "linear"
        assert st.data["stream"]["spectrum_swaps"] == 1
        assert st.data["stream"]["streams"]["accepted"] == 8
        # PHASE_TYPE_SET persists into config.json (restart-safe).
        assert client.set_phase_type("minimum").ok
        assert json.loads(cfg.read_text())["filter"]["phaseType"] == "minimum"

        assert client.shutdown().ok
        assert proc.wait(timeout=120) == 0
        out = proc.stdout.read()
        assert "Live serve reload" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
