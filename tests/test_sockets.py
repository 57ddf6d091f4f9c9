"""Network PCM transport: framed header, TCP/unix source+sink, and the
full 2-process e2e (sender -> socket -> totton-stream -> socket ->
receiver) with a live RELOAD mid-stream.

This is the live-device analog of the reference's ALSA loop
(src/alsa/alsa_streamer_main.cpp:495-611) for hosts where audio arrives
over the network.
"""

import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from totton_tpu.io.devices import open_sink, open_source
from totton_tpu.io.pcm import PcmFormat, float_to_pcm, interleave
from totton_tpu.io.sockets import (
    SocketSink,
    SocketSource,
    SocketSpec,
    pack_header,
    unpack_header,
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class TestHeader:
    def test_round_trip(self):
        for fmt in (None, PcmFormat.S16_LE, PcmFormat.S24_3LE,
                    PcmFormat.S32_LE):
            raw = pack_header(fmt, 2, 44100)
            assert len(raw) == 12
            assert unpack_header(raw) == (fmt, 2, 44100)

    def test_bad_magic(self):
        with pytest.raises(ValueError, match="magic"):
            unpack_header(b"NOPE" + pack_header(None, 2, 44100)[4:])

    def test_bad_version(self):
        raw = bytearray(pack_header(None, 2, 44100))
        raw[4] = 99
        with pytest.raises(ValueError, match="version"):
            unpack_header(bytes(raw))


class TestSpec:
    def test_tcp(self):
        s = SocketSpec("tcp://example:9000")
        assert (s.listen, s.host, s.port) == (False, "example", 9000)

    def test_tcp_listen_default_host(self):
        s = SocketSpec("tcp-listen://:9000")
        assert (s.listen, s.host, s.port) == (True, "0.0.0.0", 9000)

    def test_unix(self):
        s = SocketSpec("unix:/tmp/x.sock")
        assert not s.listen and s.path == "/tmp/x.sock"

    def test_matches(self):
        assert SocketSpec.matches("tcp://h:1")
        assert SocketSpec.matches("unix-listen:/p")
        assert not SocketSpec.matches("file:x.raw")
        with pytest.raises(ValueError):
            SocketSpec("tcp://noport")


def _roundtrip(src_spec: str, sink_spec: str, fmt, rng) -> None:
    """Source listens (or connects), sink pushes a signal; assert the
    samples survive the wire within the format's quantization."""
    x = np.clip(rng.normal(size=(2, 4000)) * 0.3, -0.9, 0.9).astype(
        np.float32)
    got = {}

    def read_side():
        src = open_source(src_spec)
        assert isinstance(src, SocketSource)
        assert src.sample_rate == 48000
        assert src.channels == 2
        chunks = []
        while True:
            c = src.read_frames(1024)
            if c.shape[1] == 0:
                break
            chunks.append(c)
        got["x"] = np.concatenate(chunks, axis=1)
        src.close()

    t = threading.Thread(target=read_side)
    t.start()
    sink = open_sink(sink_spec, 48000, fmt)
    assert isinstance(sink, SocketSink)
    for i in range(0, 4000, 640):  # odd chunking exercises reassembly
        sink.write_frames(x[:, i:i + 640])
    sink.close()
    t.join(timeout=20)
    assert not t.is_alive()
    tol = 0.0 if fmt is None else 1.5 / fmt.scale
    np.testing.assert_allclose(got["x"], x, atol=tol)


def test_tcp_roundtrip_f32(rng):
    port = free_port()
    _roundtrip(f"tcp-listen://127.0.0.1:{port}",
               f"tcp://127.0.0.1:{port}", None, rng)


def test_tcp_roundtrip_s24(rng):
    port = free_port()
    _roundtrip(f"tcp-listen://127.0.0.1:{port}",
               f"tcp://127.0.0.1:{port}", PcmFormat.S24_3LE, rng)


def test_unix_roundtrip_s32(rng, tmp_path):
    path = tmp_path / "audio.sock"
    _roundtrip(f"unix-listen:{path}", f"unix:{path}", PcmFormat.S32_LE, rng)


def test_reversed_roles(rng):
    """The sink may LISTEN and the source CONNECT (who binds is independent
    of which way audio flows)."""
    port = free_port()
    x = (rng.normal(size=(2, 1000)) * 0.2).astype(np.float32)
    got = {}

    def write_side():
        sink = SocketSink(f"tcp-listen://127.0.0.1:{port}", 44100, None)
        sink.write_frames(x)
        sink.close()

    t = threading.Thread(target=write_side)
    t.start()
    src = SocketSource(f"tcp://127.0.0.1:{port}")
    chunks = []
    while True:
        c = src.read_frames(256)
        if c.shape[1] == 0:
            break
        chunks.append(c)
    t.join(timeout=10)
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1), x)


def test_source_is_low_latency():
    """Socket sources must flag low latency so the stream session
    pre-compiles its dispatch shapes (io/stream.py _warm_up)."""
    assert SocketSource.low_latency is True


def test_connect_timeout():
    t0 = time.monotonic()
    with pytest.raises(OSError, match="cannot connect"):
        SocketSink(f"tcp://127.0.0.1:{free_port()}", 44100,
                   connect_timeout_s=0.3)
    assert time.monotonic() - t0 < 5


_SENDER = r"""
import socket, sys, time, numpy as np
from totton_tpu.io.pcm import PcmFormat, float_to_pcm, interleave
from totton_tpu.io.sockets import pack_header
port, n = int(sys.argv[1]), int(sys.argv[2])
rate = 44100
t = np.arange(n, dtype=np.float64) / rate
x = np.stack([0.5 * np.sin(2 * np.pi * 997.0 * t),
              0.4 * np.sin(2 * np.pi * 1499.0 * t)]).astype(np.float32)
deadline = time.monotonic() + 240  # streamer binds after its JAX import
while True:
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        break
    except OSError:
        if time.monotonic() > deadline:
            raise
        time.sleep(0.2)
sock.sendall(pack_header(PcmFormat.S32_LE, 2, rate))
step = 4410
for i in range(0, n, step):
    sock.sendall(float_to_pcm(interleave(x[:, i:i+step]), PcmFormat.S32_LE))
sock.close()
np.save(sys.argv[3], x)
"""


def test_socket_e2e_with_live_reload(coefficients_dir, tmp_path):
    """The round's Done-criterion e2e: sender process -> tcp ->
    totton-stream (upsampling 2x, live control endpoint) -> tcp ->
    receiver; validate_output gates pass and a RELOAD lands mid-stream."""
    from totton_tpu.control.client import DaemonClient
    from totton_tpu.engine.upsampler import upsample_signal
    from totton_tpu.filters.sidecar import load_filter
    from totton_tpu.testing.validate_output import validate_audio

    in_port, out_port = free_port(), free_port()
    endpoint = f"ipc://{tmp_path}/sock_e2e.sock"
    n = 44100  # 1 s of audio

    streamer = subprocess.Popen(
        [sys.executable, "-m", "totton_tpu.cli.stream",
         "--in", f"tcp-listen://127.0.0.1:{in_port}",
         "--out", f"tcp://127.0.0.1:{out_port}",
         "--filter-dir", str(coefficients_dir), "--ratio", "2",
         "--format", "f32",
         "--control-endpoint", endpoint],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    # The receiver listens; the streamer's sink connects to it.
    recv_srv = socket.socket()
    recv_srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    recv_srv.bind(("127.0.0.1", out_port))
    recv_srv.listen(1)
    recv_srv.settimeout(300)

    sender = subprocess.Popen(
        [sys.executable, "-c", _SENDER, str(in_port), str(n),
         str(tmp_path / "sent.npy")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    got = {}

    def receive():
        conn, _ = recv_srv.accept()
        from totton_tpu.io.sockets import HEADER_BYTES, unpack_header
        raw = b""
        while len(raw) < HEADER_BYTES:
            raw += conn.recv(HEADER_BYTES - len(raw))
        fmt, ch, rate = unpack_header(raw)
        assert fmt is None and ch == 2 and rate == 88200
        buf = bytearray()
        while True:
            chunk = conn.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
        got["y"] = np.frombuffer(bytes(buf), "<f4").reshape(-1, 2).T
        conn.close()

    recv_thread = threading.Thread(target=receive)
    recv_thread.start()
    try:
        # RELOAD mid-stream (same filter; proves the control plane is live
        # while network audio flows).
        client = DaemonClient(endpoint=endpoint, timeout_ms=20000)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if client.ping():
                break
            time.sleep(0.2)
        else:
            pytest.fail("no PING from streamer")
        assert client.reload_config().ok

        assert sender.wait(timeout=300) == 0, sender.stdout.read()
        rc = streamer.wait(timeout=300)
        out = streamer.stdout.read()
        assert rc == 0, out
        recv_thread.join(timeout=60)
        assert not recv_thread.is_alive()
        assert "Live reload:" in out
    finally:
        recv_srv.close()
        for proc in (sender, streamer):
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    x = np.load(tmp_path / "sent.npy")
    y = got["y"]
    assert y.shape[0] == 2 and y.shape[1] == 2 * n
    # Oracle gates (reference validate_output thresholds); input was
    # s32-quantized on the wire, output is lossless f32.
    lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
    ref = upsample_signal(x, lf)
    report = validate_audio(np.clip(ref, -1.0, 1.0), y)
    assert report["passed"], report
    # Beyond the coarse gates: the wire is float32-lossless, so the only
    # error sources are the engine and the sender's s32 input quantization.
    err = y - np.clip(ref, -1.0, 1.0)
    snr = 10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-300))
    assert snr > 100.0, f"SNR {snr:.1f} dB"


class TestPeerCloseCleanStop:
    """The docstring contract 'a closed peer is a clean stop on the sink
    side': a departed receiver surfaces as SinkClosedError and stream
    sessions treat it like source EOF (no traceback, no hang)."""

    def test_sink_raises_sink_closed(self, rng):
        from totton_tpu.io.devices import SinkClosedError

        port = free_port()
        received = {}

        def read_side():
            src = open_source(f"tcp-listen://127.0.0.1:{port}")
            received["first"] = src.read_frames(64)
            src.close()  # receiver departs mid-stream

        t = threading.Thread(target=read_side)
        t.start()
        sink = open_sink(f"tcp://127.0.0.1:{port}", 48000, PcmFormat.S16_LE)
        x = (rng.normal(size=(2, 4096)) * 0.1).astype(np.float32)
        with pytest.raises(SinkClosedError):
            # The OS buffers writes until the RST surfaces; keep writing
            # (large chunks, so the send buffer fills and blocks) until
            # the peer's departure is delivered, bounded by a deadline
            # rather than a fixed write count (which raced the reader
            # thread's close under a loaded machine).
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                sink.write_frames(x)
            pytest.fail("SinkClosedError not raised within deadline")
        t.join(timeout=10)
        sink.close()

    def test_sessions_stop_cleanly_on_sink_close(self, rng):
        from totton_tpu.io.devices import (
            AudioSink,
            NullSource,
            SinkClosedError,
        )
        from totton_tpu.io.stream import StreamSession, ThreadedStreamSession

        class DepartingSink(AudioSink):
            def __init__(self):
                self.writes = 0

            def write_frames(self, x):
                self.writes += 1
                if self.writes > 2:
                    raise SinkClosedError("peer gone")

        class _Identity:
            """Minimal engine: ratio-1 passthrough."""
            channels = 2
            ratio = 1
            block_input_frames = 256

            class config:
                block_size = 256

            def process_block(self, x):
                return np.asarray(x, np.float32)

            def reset(self):
                pass

        for cls in (StreamSession, ThreadedStreamSession):
            sink = DepartingSink()
            session = cls(NullSource(2, 48000, total_frames=100_000), sink,
                          _Identity(), period_frames=256,
                          max_batch_blocks=1)
            stats = session.run()  # must return, not raise or hang
            assert sink.writes >= 3
            assert stats.frames_in > 0


class TestIpv6Spec:
    def test_bracketed_literal_connect(self):
        s = SocketSpec("tcp://[::1]:9000")
        assert (s.listen, s.host, s.port) == (False, "::1", 9000)
        assert s.family == socket.AF_INET6

    def test_bracketed_literal_listen(self):
        s = SocketSpec("tcp-listen://[fe80::1%eth0]:7")
        assert (s.listen, s.host, s.port) == (True, "fe80::1%eth0", 7)
        assert s.family == socket.AF_INET6

    def test_bad_bracket_forms(self):
        with pytest.raises(ValueError):
            SocketSpec("tcp://[::1]")  # no port
        with pytest.raises(ValueError):
            SocketSpec("tcp://[::1:9000")  # unterminated bracket

    def test_v4_unchanged(self):
        s = SocketSpec("tcp://10.0.0.1:9000")
        assert s.family == socket.AF_INET

    def test_live_v6_loopback(self, rng):
        if not socket.has_ipv6:
            pytest.skip("no IPv6 support")
        with socket.socket(socket.AF_INET6, socket.SOCK_STREAM) as probe:
            try:
                probe.bind(("::1", 0))
                port = probe.getsockname()[1]
            except OSError:
                pytest.skip("IPv6 loopback unavailable")
        _roundtrip(f"tcp-listen://[::1]:{port}", f"tcp://[::1]:{port}",
                   None, rng)


def _raw_sender(port: int, frames: np.ndarray, *, rst: bool = False,
                rate: int = 48000):
    """Connect, send header + float32 frames, then close — orderly FIN by
    default, or an abortive RST (SO_LINGER 0) when rst=True."""
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall(pack_header(None, frames.shape[0], rate))
    s.sendall(interleave(frames).astype("<f4").tobytes())
    if rst:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     __import__("struct").pack("ii", 1, 0))
    s.close()


def _drain(src: SocketSource) -> np.ndarray:
    chunks = []
    while True:
        c = src.read_frames(1024)
        if c.shape[1] == 0:
            break
        chunks.append(c)
    return (np.concatenate(chunks, axis=1) if chunks
            else np.zeros((src.channels, 0), np.float32))


class TestTransportFaults:
    """Error-vs-EOF semantics: an orderly FIN is
    a clean stop, a mid-stream RST is a counted+logged transport error,
    and an opt-in reconnect window splices a restarted sender back in."""

    def test_orderly_fin_is_clean_eof(self, rng):
        port = free_port()
        x = (rng.normal(size=(2, 500)) * 0.2).astype(np.float32)
        t = threading.Thread(target=_raw_sender, args=(port, x))
        src_holder = {}

        def read_side():
            src = SocketSource(f"tcp-listen://127.0.0.1:{port}")
            src_holder["src"] = src
            src_holder["x"] = _drain(src)

        rt = threading.Thread(target=read_side)
        rt.start()
        time.sleep(0.2)
        t.start()
        rt.join(timeout=10)
        t.join(timeout=10)
        src = src_holder["src"]
        assert src.transport_errors == 0
        assert src.last_error is None
        np.testing.assert_array_equal(src_holder["x"], x)
        src.close()

    def test_rst_counts_transport_error(self, rng):
        port = free_port()
        x = (rng.normal(size=(2, 500)) * 0.2).astype(np.float32)
        src_holder = {}

        def read_side():
            src = SocketSource(f"tcp-listen://127.0.0.1:{port}")
            src_holder["src"] = src
            src_holder["x"] = _drain(src)

        rt = threading.Thread(target=read_side)
        rt.start()
        time.sleep(0.2)
        _raw_sender(port, x, rst=True)
        rt.join(timeout=10)
        src = src_holder["src"]
        # The RST may race the last recv: either the reset surfaced (the
        # case under test) or the kernel delivered all bytes first.
        if src.transport_errors:
            assert "ConnectionResetError" in src.last_error
            assert "errno" in src.last_error
        src.close()

    def test_rst_after_quiet_period_always_counts(self, rng):
        """Deterministic RST: the reader is mid-recv (stream drained) when
        the reset arrives, so it MUST surface as a transport error."""
        port = free_port()
        x = (rng.normal(size=(2, 256)) * 0.2).astype(np.float32)
        src_holder = {}

        def read_side():
            src = SocketSource(f"tcp-listen://127.0.0.1:{port}")
            src_holder["src"] = src
            src_holder["x"] = _drain(src)

        rt = threading.Thread(target=read_side)
        rt.start()
        time.sleep(0.2)
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(pack_header(None, 2, 48000))
        s.sendall(interleave(x).astype("<f4").tobytes())
        time.sleep(0.5)  # reader consumes everything, blocks in recv
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     __import__("struct").pack("ii", 1, 0))
        s.close()
        rt.join(timeout=10)
        src = src_holder["src"]
        assert src.transport_errors == 1
        assert "ConnectionResetError" in src.last_error
        np.testing.assert_array_equal(src_holder["x"], x)
        src.close()

    def test_reconnect_splices_new_sender(self, rng):
        port = free_port()
        a = (rng.normal(size=(2, 300)) * 0.2).astype(np.float32)
        b = (rng.normal(size=(2, 200)) * 0.2).astype(np.float32)
        src_holder = {}

        def read_side():
            src = SocketSource(f"tcp-listen://127.0.0.1:{port}",
                               reconnect_window_s=3.0)
            src_holder["src"] = src
            src_holder["x"] = _drain(src)

        rt = threading.Thread(target=read_side)
        rt.start()
        time.sleep(0.2)
        _raw_sender(port, a)          # first sender: clean FIN
        time.sleep(0.3)
        _raw_sender(port, b, rst=True)  # restarted sender, dies with RST
        # After the RST there is no third sender; window expires -> EOF.
        rt.join(timeout=30)
        assert not rt.is_alive()
        src = src_holder["src"]
        assert src.reconnects >= 1
        # Sample continuity across the splice: a then b, in order.
        np.testing.assert_array_equal(
            src_holder["x"][:, :a.shape[1]], a)
        np.testing.assert_array_equal(
            src_holder["x"][:, a.shape[1]:a.shape[1] + b.shape[1]], b)
        src.close()

    def test_reconnect_header_mismatch_rejected(self, rng):
        port = free_port()
        a = (rng.normal(size=(2, 100)) * 0.2).astype(np.float32)
        bad = (rng.normal(size=(4, 50)) * 0.2).astype(np.float32)
        src_holder = {}

        def read_side():
            src = SocketSource(f"tcp-listen://127.0.0.1:{port}",
                               reconnect_window_s=3.0)
            src_holder["src"] = src
            src_holder["x"] = _drain(src)

        rt = threading.Thread(target=read_side)
        rt.start()
        time.sleep(0.2)
        _raw_sender(port, a)
        time.sleep(0.3)
        _raw_sender(port, bad)  # 4 channels: must be rejected
        rt.join(timeout=15)
        assert not rt.is_alive()
        src = src_holder["src"]
        assert src.transport_errors >= 1
        assert "mismatch" in src.last_error
        np.testing.assert_array_equal(src_holder["x"], a)
        src.close()

    def test_reconnect_requires_listen_mode(self):
        with pytest.raises(ValueError, match="listen-mode"):
            SocketSource("tcp://127.0.0.1:1", reconnect_window_s=5.0)

    def test_session_folds_transport_stats(self, rng):
        """StreamSession surfaces the source's fault counters in its
        stats JSON (the xrun analog the reference web UI reads)."""
        from totton_tpu.io.stream import StreamSession
        from totton_tpu.io.devices import NullSink

        port = free_port()
        x = (rng.normal(size=(2, 2000)) * 0.2).astype(np.float32)
        result = {}

        class _Identity:
            channels = 2
            ratio = 1
            block_input_frames = 64

            class config:
                block_size = 64

            def process_block(self, x):
                return np.asarray(x, np.float32)

            def reset(self):
                pass

        def read_side():
            src = SocketSource(f"tcp-listen://127.0.0.1:{port}")
            session = StreamSession(src, NullSink(), _Identity(),
                                    period_frames=64, max_batch_blocks=1)
            result["stats"] = session.run()
            src.close()

        rt = threading.Thread(target=read_side)
        rt.start()
        time.sleep(0.3)
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(pack_header(None, 2, 48000))
        s.sendall(interleave(x).astype("<f4").tobytes())
        time.sleep(0.8)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     __import__("struct").pack("ii", 1, 0))
        s.close()
        rt.join(timeout=20)
        assert not rt.is_alive()
        stats = result["stats"]
        assert stats.transport_errors == 1
        j = stats.to_json()
        assert j["transport"]["errors"] == 1
        assert "ConnectionResetError" in j["transport"]["last_error"]
