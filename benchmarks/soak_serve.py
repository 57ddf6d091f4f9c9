"""Serving-plane soak: sustained client churn + live control, RSS-gated.

Runs totton-serve for --minutes under continuous randomized churn
(normal roundtrips, aborts, brief floods, EQ swaps via ZMQ every ~20 s)
while sampling the server's VmRSS. Passes when the server survives the
whole soak with every slot recycled, a final exact stream, and bounded
memory: RSS after the warm plateau must not grow more than
--rss-slack-mb. This process never imports JAX, so the server child is
the only process on the device. This is the long-horizon leak check the unit suite
can't provide (slot leaks, fade-state leaks, latency-reservoir growth,
native buffer churn).

  python -m benchmarks.soak_serve [--minutes 5] [--rss-slack-mb 200]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from totton_tpu.io.pcm import interleave
from totton_tpu.io.sockets import HEADER_BYTES, pack_header

RATE = 44100


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rss_mb(pid: int) -> float:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def _roundtrip(port, n_frames, rng, timeout=120):
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    s.settimeout(timeout)
    s.sendall(pack_header(None, 2, RATE))
    hdr = b""
    while len(hdr) < HEADER_BYTES:
        got = s.recv(HEADER_BYTES - len(hdr))
        if not got:
            s.close()
            return None  # rejected (slots briefly full) — fine
        hdr += got
    x = (rng.normal(size=(2, n_frames)) * 0.3).astype(np.float32)

    def pump():
        s.sendall(interleave(x).astype("<f4").tobytes())
        s.shutdown(socket.SHUT_WR)

    t = threading.Thread(target=pump)
    t.start()
    buf = bytearray()
    while True:
        got = s.recv(65536)
        if not got:
            break
        buf += got
    t.join(timeout=timeout)
    s.close()
    return len(buf) // 8, x


def _abort(port, rng):
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=30)
        s.sendall(pack_header(None, 2, RATE))
        s.sendall((rng.normal(size=(2, 2000)) * 0.3).astype(np.float32)
                  .T.reshape(-1).astype("<f4").tobytes())
        time.sleep(float(rng.uniform(0, 0.05)))
        s.close()
    except OSError:
        pass


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=5.0)
    ap.add_argument("--rss-slack-mb", type=float, default=200.0)
    ap.add_argument("--streams", type=int, default=8)
    args = ap.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    endpoint = f"ipc:///tmp/soak_serve_{port}.sock"
    stats_path = f"/tmp/soak_serve_{port}.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "totton_tpu.cli.serve",
         "--listen", f"tcp-listen://127.0.0.1:{port}",
         "--rate", str(RATE), "--ratio", "16",
         "--filter-dir", os.path.join(repo, "data", "coefficients"),
         "--max-streams", str(args.streams),
         "--max-blocks-per-step", "4", "--swap-fade", "4096",
         "--control-endpoint", endpoint,
         "--stats-path", stats_path, "--duration", "36000"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        from totton_tpu.control.client import DaemonClient

        client = DaemonClient(endpoint=endpoint, timeout_ms=30000)
        deadline = time.monotonic() + 1800
        while time.monotonic() < deadline:
            if client.ping():
                break
            time.sleep(1.0)
        else:
            raise RuntimeError("server never served PING")

        rng = np.random.default_rng(0)
        # Warm plateau: one full roundtrip (steps compiled), then
        # baseline RSS.
        r = _roundtrip(port, 2 * 3192, rng)
        assert r is not None and r[0] == 2 * 3192 * 16
        base_rss = _rss_mb(proc.pid)
        print(f"warm RSS baseline: {base_rss:.0f} MB", flush=True)

        stop_at = time.monotonic() + args.minutes * 60
        rss_samples, iters, completed = [], 0, 0
        last_eq = time.monotonic()
        while time.monotonic() < stop_at:
            iters += 1
            kind = rng.integers(0, 10)
            if kind < 7:
                r = _roundtrip(port, int(rng.integers(1000, 10000)), rng)
                if r is not None:
                    frames_out, x = r
                    assert frames_out == x.shape[1] * 16, (
                        frames_out, x.shape)
                    completed += 1
            else:
                _abort(port, rng)
            if time.monotonic() - last_eq > 20:
                client.request({"cmd": "SOFT_RESET"}) if rng.integers(2) \
                    else client.reload_config()
                last_eq = time.monotonic()
            rss_samples.append(_rss_mb(proc.pid))
            if iters % 20 == 0:
                print(f"iter {iters}: RSS {rss_samples[-1]:.0f} MB, "
                      f"{completed} complete", flush=True)

        final_rss = max(rss_samples[-5:])
        growth = final_rss - base_rss
        print(f"soak done: {iters} iterations, {completed} completed "
              f"roundtrips; RSS {base_rss:.0f} -> {final_rss:.0f} MB "
              f"(growth {growth:+.0f} MB)", flush=True)
        assert proc.poll() is None, "server died during soak"
        # RSS gate, hard on every platform. This process stays JAX-free:
        # the server child holds the device.
        assert growth < args.rss_slack_mb, (
            f"RSS grew {growth:.0f} MB > slack {args.rss_slack_mb:.0f} MB "
            f"({growth / max(iters, 1):.2f} MB/iter)")
        # Final exact-shape stream + clean stats.
        r = _roundtrip(port, 5000, rng)
        assert r is not None and r[0] == 5000 * 16
        st = json.loads(open(stats_path).read())
        print(json.dumps({"soak": "pass", "iters": iters,
                          "completed": completed,
                          "rss_growth_mb": round(growth, 1),
                          "accepted": st["streams"]["accepted"],
                          "finished": st["streams"]["finished"]}),
              flush=True)
        assert client.shutdown().ok
        proc.wait(timeout=120)
        return 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


if __name__ == "__main__":
    sys.exit(main())
