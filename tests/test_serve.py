"""Multi-stream serving: N concurrent duplex socket streams batched on
one engine step (totton_tpu/serve.py). Each stream must be exactly
independent — same output as a dedicated single-stream engine."""

import socket
import threading
import time

import numpy as np
import pytest

from totton_tpu.engine.upsampler import upsample_signal
from totton_tpu.filters.sidecar import FilterSidecar, LoadedFilter
from totton_tpu.io.pcm import PcmFormat, float_to_pcm, interleave, pcm_to_float
from totton_tpu.io.sockets import HEADER_BYTES, pack_header, unpack_header
from totton_tpu.serve import StreamServer

RATE = 44100


def _filter(taps=33, fft=256, ratio=4, seed=5):
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=taps) * np.exp(-np.arange(taps) * 3.0 / taps))
    return LoadedFilter(
        taps=h.astype(np.float32),
        sidecar=FilterSidecar(
            coefficients_bin="<test>", taps=taps, fft_size=fft,
            block_size=fft - (taps - 1), upsample_factor=ratio,
        ),
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _client_roundtrip(port: int, x: np.ndarray, fmt=None,
                      chunk: int = 997, stagger_s: float = 0.0,
                      eq_text: str | None = None) -> np.ndarray:
    """Send [2, n] frames, half-close, read the full upsampled reply."""
    import struct

    from totton_tpu.io.sockets import FLAG_EQ_BLOCK

    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    flags = FLAG_EQ_BLOCK if eq_text is not None else 0
    s.sendall(pack_header(fmt, x.shape[0], RATE, flags=flags))
    if eq_text is not None:
        raw_eq = eq_text.encode("utf-8")
        s.sendall(struct.pack("<I", len(raw_eq)) + raw_eq)
    hdr = b""
    while len(hdr) < HEADER_BYTES:
        got = s.recv(HEADER_BYTES - len(hdr))
        assert got, "server closed before sending its header"
        hdr += got
    rfmt, ch, rrate = unpack_header(hdr)
    assert (rfmt, ch) == (fmt, x.shape[0])

    received = bytearray()
    done_sending = threading.Event()

    def pump_in():
        for i in range(0, x.shape[1], chunk):
            flat = interleave(x[:, i:i + chunk])
            if fmt is None:
                s.sendall(flat.astype("<f4").tobytes())
            else:
                s.sendall(float_to_pcm(flat, fmt))
            if stagger_s:
                time.sleep(stagger_s)
        s.shutdown(socket.SHUT_WR)
        done_sending.set()

    t = threading.Thread(target=pump_in)
    t.start()
    while True:
        buf = s.recv(65536)
        if not buf:
            break
        received += buf
    t.join(timeout=30)
    s.close()
    if fmt is None:
        flat = np.frombuffer(bytes(received), "<f4").astype(np.float32)
    else:
        flat = pcm_to_float(bytes(received), fmt)
    n = len(flat) // x.shape[0]
    return flat.reshape(n, x.shape[0]).T, rrate


@pytest.fixture()
def server():
    lf = _filter()
    port = _free_port()
    srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                       max_streams=4, channels=2)
    srv.start()
    yield srv, lf, port
    srv.stop()


class TestSingleStream:
    def test_round_trip_matches_oracle(self, server, rng):
        srv, lf, port = server
        x = (rng.normal(size=(2, 5000)) * 0.3).astype(np.float32)
        y, out_rate = _client_roundtrip(port, x)
        assert out_rate == RATE * lf.ratio
        ref = upsample_signal(x, lf)
        assert y.shape == ref.shape
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-6)

    def test_s16_wire_format(self, server, rng):
        srv, lf, port = server
        x = (rng.normal(size=(2, 2000)) * 0.3).astype(np.float32)
        y, _ = _client_roundtrip(port, x, fmt=PcmFormat.S16_LE)
        # The wire quantizes both directions with the library's own
        # (reference-exact) conversion; the oracle replays both.
        from totton_tpu.io.pcm import deinterleave

        def s16_roundtrip(a):
            return deinterleave(
                pcm_to_float(float_to_pcm(interleave(a), PcmFormat.S16_LE),
                             PcmFormat.S16_LE), 2)

        ref = s16_roundtrip(upsample_signal(s16_roundtrip(x), lf))
        assert y.shape == ref.shape
        # Both wire directions use the reference-exact PCM conversion
        # (clamp + truncate). <= 1 LSB vs the oracle: the server's float
        # output can differ by ULPs from a single-dispatch oracle (XLA
        # tiles different batch widths differently), which may flip a
        # boundary-sitting sample's truncation.
        assert np.max(np.abs(y - ref)) <= 1.01 / 32768

    def test_exact_block_multiple_input(self, server, rng):
        srv, lf, port = server
        block_in = srv.config.block_in
        x = (rng.normal(size=(2, 3 * block_in)) * 0.3).astype(np.float32)
        y, _ = _client_roundtrip(port, x)
        np.testing.assert_allclose(y, upsample_signal(x, lf),
                                   rtol=1e-5, atol=1e-6)


class TestConcurrentStreams:
    def test_8_concurrent_streams_isolated(self, rng):
        """8 concurrent clients (staggered joins, 4 slots -> queueing +
        slot reuse): every stream's output equals ITS OWN single-stream
        oracle — total isolation."""
        lf = _filter()
        port = _free_port()
        srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                           max_streams=4, channels=2)
        srv.start()
        try:
            signals = [(rng.normal(size=(2, 3000 + 417 * i)) * 0.3)
                       .astype(np.float32) for i in range(8)]
            results: dict[int, np.ndarray] = {}
            errors: list = []

            def run(i: int) -> None:
                try:
                    # First wave takes all 4 slots; the second wave starts
                    # after the first finishes (slot reuse).
                    if i >= 4:
                        time.sleep(1.0 + 0.1 * i)
                    y, _ = _client_roundtrip(port, signals[i],
                                             stagger_s=0.002)
                    results[i] = y
                except Exception as e:  # propagate to the main thread
                    errors.append((i, e))

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors
            assert len(results) == 8
            for i, y in results.items():
                ref = upsample_signal(signals[i], lf)
                assert y.shape == ref.shape, (i, y.shape, ref.shape)
                np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-6,
                                           err_msg=f"stream {i}")
            assert srv.stats.accepted == 8
        finally:
            srv.stop()

    def test_slot_reuse_resets_state(self, server, rng):
        """A second client on a reused slot must see a FRESH stream (zero
        tail), not the previous stream's history."""
        srv, lf, port = server
        x1 = (rng.normal(size=(2, 4000)) * 0.5).astype(np.float32)
        x2 = (rng.normal(size=(2, 2500)) * 0.3).astype(np.float32)
        _client_roundtrip(port, x1)
        y2, _ = _client_roundtrip(port, x2)
        np.testing.assert_allclose(y2, upsample_signal(x2, lf),
                                   rtol=1e-5, atol=1e-6)


class TestAdmission:
    def test_wrong_rate_rejected(self, server):
        srv, lf, port = server
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(pack_header(None, 2, 48000))  # server runs 44100
        s.settimeout(10)
        assert s.recv(HEADER_BYTES) == b""  # closed without a header
        s.close()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and srv.stats.rejected < 1:
            time.sleep(0.05)
        assert srv.stats.rejected == 1

    def test_wrong_channels_rejected(self, server):
        srv, lf, port = server
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(pack_header(None, 4, RATE))
        s.settimeout(10)
        assert s.recv(HEADER_BYTES) == b""
        s.close()

    def test_connect_listen_spec_required(self):
        with pytest.raises(ValueError, match="listen"):
            StreamServer(_filter(), "tcp://127.0.0.1:1", RATE)


def test_cli_smoke(tmp_path, rng):
    """totton-serve end to end: subprocess server, one socket client,
    oracle match + stats file."""
    import json
    import subprocess
    import sys

    from totton_tpu.filters.generate import generate_one
    from totton_tpu.filters.sidecar import load_filter

    coeff = tmp_path / "coeff"
    coeff.mkdir()
    generate_one("44k_2x", 2000, 25.0, 140.0, "minimum", str(coeff))
    port = _free_port()
    stats = tmp_path / "serve_stats.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "totton_tpu.cli.serve",
         "--listen", f"tcp-listen://127.0.0.1:{port}",
         "--rate", str(RATE), "--ratio", "2",
         "--filter-dir", str(coeff), "--max-streams", "2",
         "--stats-path", str(stats), "--duration", "60"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        x = (rng.normal(size=(2, 6000)) * 0.3).astype(np.float32)
        deadline = time.monotonic() + 240
        y = None
        while time.monotonic() < deadline:
            try:
                y, out_rate = _client_roundtrip(port, x)
                break
            except OSError:
                time.sleep(0.5)
        assert y is not None, "server never came up"
        assert out_rate == RATE * 2
        lf = load_filter(next(coeff.glob("*.json")))
        np.testing.assert_allclose(y, upsample_signal(x, lf),
                                   rtol=1e-4, atol=1e-5)
        # The stats file is written periodically (~0.5 s); poll for the
        # accepted count to land.
        deadline = time.monotonic() + 10
        j = {}
        while time.monotonic() < deadline:
            try:
                j = json.loads(stats.read_text())
            except (OSError, json.JSONDecodeError):
                j = {}
            if j.get("streams", {}).get("accepted") == 1:
                break
            time.sleep(0.2)
        assert j.get("streams", {}).get("accepted") == 1, j
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_cli_recycle_rss_drains_then_exits_3(tmp_path, rng):
    """--recycle-rss-mb: bounded-memory serving on runtimes that leak
    host memory below the framework.
    A 1 MB cap trips on the first poll; the live stream must still be
    drained to completion (oracle match, no cut) before the process
    exits with the recycle code 3 for its supervisor."""
    import json
    import subprocess
    import sys

    from totton_tpu.filters.generate import generate_one
    from totton_tpu.filters.sidecar import load_filter

    coeff = tmp_path / "coeff"
    coeff.mkdir()
    generate_one("44k_2x", 2000, 25.0, 140.0, "minimum", str(coeff))
    port = _free_port()
    stats = tmp_path / "serve_stats.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "totton_tpu.cli.serve",
         "--listen", f"tcp-listen://127.0.0.1:{port}",
         "--rate", str(RATE), "--ratio", "2",
         "--filter-dir", str(coeff), "--max-streams", "2",
         "--stats-path", str(stats),
         "--recycle-rss-mb", "1", "--recycle-check-s", "2.0",
         "--duration", "120"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        # Trickle slowly enough that the stream is still live when the
        # first RSS poll (t+2s) trips the cap — the drain must then wait
        # for this stream instead of cutting it.
        x = (rng.normal(size=(2, 6000)) * 0.3).astype(np.float32)
        deadline = time.monotonic() + 240
        y = None
        while time.monotonic() < deadline:
            try:
                y, out_rate = _client_roundtrip(port, x, chunk=400,
                                                stagger_s=0.25)
                break
            except OSError:
                time.sleep(0.5)
        assert y is not None, "server never came up"
        assert out_rate == RATE * 2
        lf = load_filter(next(coeff.glob("*.json")))
        np.testing.assert_allclose(y, upsample_signal(x, lf),
                                   rtol=1e-4, atol=1e-5)
        rc = proc.wait(timeout=60)
        out = proc.stdout.read()
        assert rc == 3, out
        assert "recycling" in out, out
        j = json.loads(stats.read_text())
        assert j["streams"]["finished"] == 1, j
        assert j["rss_mb"] is None or j["rss_mb"] > 1.0, j
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_cli_recycle_drain_timeout_cuts_live_listener(tmp_path, rng):
    """A live listener never half-closes, so a recycle's drain cannot
    finish; after --recycle-drain-s the server must cut it (logged),
    still exit 3, and not hang."""
    import subprocess
    import sys

    from totton_tpu.filters.generate import generate_one

    coeff = tmp_path / "coeff"
    coeff.mkdir()
    generate_one("44k_2x", 2000, 25.0, 140.0, "minimum", str(coeff))
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "totton_tpu.cli.serve",
         "--listen", f"tcp-listen://127.0.0.1:{port}",
         "--rate", str(RATE), "--ratio", "2",
         "--filter-dir", str(coeff), "--max-streams", "2",
         "--recycle-rss-mb", "1", "--recycle-check-s", "2.0",
         "--recycle-drain-s", "1.5", "--duration", "120"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    s = None
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            try:
                s = socket.create_connection(("127.0.0.1", port),
                                             timeout=5)
                break
            except OSError:
                time.sleep(0.5)
        assert s is not None, "server never came up"
        from totton_tpu.io.sockets import pack_header

        s.settimeout(60)
        s.sendall(pack_header(None, 2, RATE))
        # Keep the stream live (trickle, never half-close, read output)
        # until the server cuts it.
        x = (rng.normal(size=(2, 400)) * 0.3).astype(np.float32)
        raw = interleave(x).astype("<f4").tobytes()
        s.setblocking(False)
        deadline = time.monotonic() + 60
        cut = False
        while time.monotonic() < deadline:
            try:
                s.sendall(raw)
            except (BrokenPipeError, ConnectionResetError, OSError) as e:
                if getattr(e, "errno", None) in (socket.EAGAIN, 11, 115):
                    pass
                else:
                    cut = True
                    break
            try:
                while s.recv(65536):
                    pass
                cut = True  # orderly EOF from the server
                break
            except (BlockingIOError, socket.timeout):
                pass
            except OSError:
                cut = True
                break
            time.sleep(0.05)
        assert cut, "server never cut the live listener"
        rc = proc.wait(timeout=60)
        out = proc.stdout.read()
        assert rc == 3, out
        assert "cutting remaining streams" in out, out
    finally:
        if s is not None:
            s.close()
        proc.terminate()
        proc.wait(timeout=30)


class TestRobustness:
    """Lifecycle hardening (round-4 review findings): silent/aborting/
    stalled clients must never take down the acceptor, stall other
    streams, or leak a slot into the next client's audio."""

    def test_silent_client_does_not_block_accepts(self, rng):
        lf = _filter()
        port = _free_port()
        srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                           max_streams=2, channels=2, header_timeout_s=0.5)
        srv.start()
        try:
            silent = socket.create_connection(("127.0.0.1", port),
                                              timeout=10)
            # No header sent; a real client arriving behind it must still
            # be served (bounded header wait on the accept path).
            x = (rng.normal(size=(2, 2000)) * 0.3).astype(np.float32)
            y, _ = _client_roundtrip(port, x)
            np.testing.assert_allclose(y, upsample_signal(x, lf),
                                       rtol=1e-5, atol=1e-6)
            silent.close()
        finally:
            srv.stop()

    def test_abort_mid_stream_then_clean_reuse(self, server, rng):
        """A client that resets mid-stream must not corrupt the NEXT
        client's audio on the reused slot (in-flight steps drain before
        the slot is freed)."""
        srv, lf, port = server
        import struct as _struct

        for _ in range(3):
            s = socket.create_connection(("127.0.0.1", port), timeout=10)
            s.sendall(pack_header(None, 2, RATE))
            s.recv(HEADER_BYTES)
            junk = (np.ones((2, 10 * srv.config.block_in), np.float32)
                    * 0.9)
            s.sendall(interleave(junk).astype("<f4").tobytes())
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         _struct.pack("ii", 1, 0))
            s.close()  # RST with steps possibly in flight
        deadline = time.monotonic() + 20
        x = (rng.normal(size=(2, 3000)) * 0.3).astype(np.float32)
        y = None
        while time.monotonic() < deadline:
            try:
                y, _ = _client_roundtrip(port, x)
                break
            except (OSError, AssertionError):
                time.sleep(0.2)
        assert y is not None, "no slot became available after aborts"
        np.testing.assert_allclose(y, upsample_signal(x, lf),
                                   rtol=1e-5, atol=1e-6)

    def test_vanishing_client_after_header(self, server, rng):
        """RST right after the request header must not kill the acceptor
        thread (the reply-header send is guarded)."""
        srv, lf, port = server
        import struct as _struct

        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(pack_header(None, 2, RATE))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     _struct.pack("ii", 1, 0))
        s.close()
        time.sleep(0.3)
        x = (rng.normal(size=(2, 1500)) * 0.3).astype(np.float32)
        y, _ = _client_roundtrip(port, x)
        np.testing.assert_allclose(y, upsample_signal(x, lf),
                                   rtol=1e-5, atol=1e-6)


class TestPerStreamEq:
    """Per-stream EQ (FLAG_EQ_BLOCK): each client's Equalizer-APO profile
    is applied to ITS stream only, time-domain at the input rate."""

    def test_preamp_only(self, server, rng):
        srv, lf, port = server
        x = (rng.normal(size=(2, 3000)) * 0.3).astype(np.float32)
        y, _ = _client_roundtrip(port, x, eq_text="Preamp: -12 dB\n")
        gain = np.float32(10.0 ** (-12 / 20.0))
        ref = upsample_signal(x * gain, lf)
        np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-6)

    def test_band_eq_matches_sos_oracle(self, server, rng):
        from scipy.signal import sosfilt

        from totton_tpu.eq.apo import parse_eq_string
        from totton_tpu.serve import _profile_to_sos

        srv, lf, port = server
        eq = ("Preamp: -3 dB\n"
              "Filter 1: ON PK Fc 1000 Hz Gain 6 dB Q 1.0\n")
        x = (rng.normal(size=(2, 4000)) * 0.2).astype(np.float32)
        y, _ = _client_roundtrip(port, x, eq_text=eq)
        sos, preamp = _profile_to_sos(parse_eq_string(eq), RATE)
        zi = np.zeros((sos.shape[0], 2, 2))
        xf, _ = sosfilt(sos, x, axis=1, zi=zi)
        xf = xf.astype(np.float32) * np.float32(preamp)
        ref = upsample_signal(xf, lf)
        np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-6)

    def test_eq_isolated_between_streams(self, server, rng):
        """One client with EQ, one without, concurrently: each matches
        its own oracle (the EQ state is per-slot)."""
        srv, lf, port = server
        xa = (rng.normal(size=(2, 3500)) * 0.3).astype(np.float32)
        xb = (rng.normal(size=(2, 2600)) * 0.3).astype(np.float32)
        results = {}
        errors = []

        def run(name, x, eq):
            try:
                results[name] = _client_roundtrip(
                    port, x, eq_text=eq, stagger_s=0.002)[0]
            except Exception as e:
                errors.append((name, e))

        ta = threading.Thread(target=run,
                              args=("a", xa, "Preamp: -12 dB\n"))
        tb = threading.Thread(target=run, args=("b", xb, None))
        ta.start()
        tb.start()
        ta.join(timeout=60)
        tb.join(timeout=60)
        assert not errors, errors
        gain = np.float32(10.0 ** (-12 / 20.0))
        np.testing.assert_allclose(results["a"], upsample_signal(xa * gain, lf),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(results["b"], upsample_signal(xb, lf),
                                   rtol=1e-4, atol=1e-6)

    def test_oversized_eq_block_rejected(self, server):
        import struct

        from totton_tpu.io.sockets import FLAG_EQ_BLOCK

        srv, lf, port = server
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(pack_header(None, 2, RATE, flags=FLAG_EQ_BLOCK))
        s.sendall(struct.pack("<I", 10_000_000))
        s.settimeout(10)
        assert s.recv(HEADER_BYTES) == b""  # closed, no reply header
        s.close()

    def test_undecodable_eq_block_rejected(self, server):
        srv, lf, port = server
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        import struct

        from totton_tpu.io.sockets import FLAG_EQ_BLOCK

        s.sendall(pack_header(None, 2, RATE, flags=FLAG_EQ_BLOCK))
        bad = b"\xff\xfe\x00garbage"  # not UTF-8
        s.sendall(struct.pack("<I", len(bad)) + bad)
        s.settimeout(10)
        assert s.recv(HEADER_BYTES) == b""
        s.close()

    def test_unparseable_lines_tolerated(self, server, rng):
        """APO parsing is lenient (the reference parser skips lines its
        regex rejects): junk lines mean no EQ, not a rejection."""
        srv, lf, port = server
        x = (rng.normal(size=(2, 1500)) * 0.3).astype(np.float32)
        y, _ = _client_roundtrip(port, x,
                                 eq_text="Filter 1: ON PK Fc NOPE Hz\n")
        np.testing.assert_allclose(y, upsample_signal(x, lf),
                                   rtol=1e-5, atol=1e-6)


def test_8_concurrent_16x_streams_production_filter(rng):
    """The round-4 Done criterion verbatim: 8 concurrent socket streams
    through the BUNDLED production 16x/80k-tap filter, each passing the
    validate_output gates against its own upsampled reference."""
    import pathlib

    from totton_tpu.filters.sidecar import load_filter
    from totton_tpu.testing.validate_output import validate_audio

    coeff = pathlib.Path(__file__).parent.parent / "data" / "coefficients"
    lf = load_filter(str(coeff / "filter_44k_16x_80000_min_phase.json"))
    port = _free_port()
    srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                       max_streams=8, channels=2)
    srv.start()
    try:
        n = 6000  # ~0.14 s per stream; 8 streams exercise every slot
        sigs = []
        for i in range(8):
            t = np.arange(n) / RATE
            f0 = 300.0 + 150.0 * i
            sigs.append(np.stack([
                0.4 * np.sin(2 * np.pi * f0 * t),
                0.3 * np.sin(2 * np.pi * f0 * 1.5 * t),
            ]).astype(np.float32))
        results: dict[int, np.ndarray] = {}
        errors: list = []

        def run(i):
            try:
                results[i] = _client_roundtrip(port, sigs[i])[0]
            except Exception as e:
                errors.append((i, e))

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not errors, errors
        assert len(results) == 8
        for i, y in results.items():
            ref = upsample_signal(sigs[i], lf)
            assert y.shape == ref.shape
            # validate_output gates: input signal as reference, output
            # decimated by the ratio (the reference e2e methodology).
            report = validate_audio(sigs[i], y, 16)
            assert report["passed"], (i, report)
        assert srv.stats.accepted == 8
    finally:
        srv.stop()


class TestAdaptiveBatching:
    def test_bursty_client_batches_blocks(self, rng):
        """A client that pushes its whole signal at once (file-upsample
        use) gets multi-block steps: far fewer dispatches than blocks,
        identical output."""
        lf = _filter()
        port = _free_port()
        srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                           max_streams=4, channels=2,
                           max_blocks_per_step=8)
        srv.start()
        try:
            block_in = srv.config.block_in
            n_blocks = 64
            x = (rng.normal(size=(2, n_blocks * block_in)) * 0.3
                 ).astype(np.float32)
            # chunk = whole signal: the reader buffers a deep backlog.
            y, _ = _client_roundtrip(port, x, chunk=x.shape[1])
            np.testing.assert_allclose(y, upsample_signal(x, lf),
                                       rtol=1e-5, atol=1e-6)
            assert srv.stats.steps < n_blocks, (
                f"no batching: {srv.stats.steps} steps for {n_blocks} "
                "blocks")
        finally:
            srv.stop()

    def test_mixed_depth_slots_stay_isolated(self, rng):
        """One bursty + one trickling client concurrently: the bursty
        slot rides deep steps while the other contributes zero-padded
        rows — outputs stay exactly independent."""
        lf = _filter()
        port = _free_port()
        srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                           max_streams=4, channels=2,
                           max_blocks_per_step=8)
        srv.start()
        try:
            block_in = srv.config.block_in
            xa = (rng.normal(size=(2, 48 * block_in)) * 0.3
                  ).astype(np.float32)
            xb = (rng.normal(size=(2, 5 * block_in + 17)) * 0.3
                  ).astype(np.float32)
            results = {}
            errors = []

            def run(name, x, **kw):
                try:
                    results[name] = _client_roundtrip(port, x, **kw)[0]
                except Exception as e:
                    errors.append((name, e))

            ta = threading.Thread(
                target=run, args=("burst", xa),
                kwargs={"chunk": xa.shape[1]})
            tb = threading.Thread(
                target=run, args=("trickle", xb),
                kwargs={"chunk": 256, "stagger_s": 0.01})
            ta.start()
            tb.start()
            ta.join(timeout=120)
            tb.join(timeout=120)
            assert not errors, errors
            np.testing.assert_allclose(results["burst"],
                                       upsample_signal(xa, lf),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(results["trickle"],
                                       upsample_signal(xb, lf),
                                       rtol=1e-5, atol=1e-6)
        finally:
            srv.stop()

    def test_non_pow2_cap_rejected(self):
        with pytest.raises(ValueError, match="power of two"):
            StreamServer(_filter(), "tcp-listen://127.0.0.1:1", RATE,
                         max_blocks_per_step=12)


class TestAdaptiveWidth:
    """Adaptive row width: steps dispatch the smallest warmed
    power-of-two SLOT width covering the ready set (served slots
    compacted into leading rows), so light load never pays the full
    static batch."""

    def test_width_set(self):
        srv = StreamServer(_filter(), "tcp-listen://127.0.0.1:0", RATE,
                           max_streams=64)
        assert srv._slot_widths == [8, 16, 32, 64]
        srv4 = StreamServer(_filter(), "tcp-listen://127.0.0.1:0", RATE,
                            max_streams=4)
        assert srv4._slot_widths == [4]
        srv12 = StreamServer(_filter(), "tcp-listen://127.0.0.1:0", RATE,
                             max_streams=12)
        assert srv12._slot_widths == [8, 16]

    def test_light_load_dispatches_narrow_steps(self, rng):
        """One client on a 16-slot server: every step runs at the 8-slot
        width, never the full 16 — and the output is still exact."""
        lf = _filter()
        port = _free_port()
        srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                           max_streams=16, channels=2,
                           max_blocks_per_step=2)
        srv.start()
        try:
            x = (rng.normal(size=(2, 4000)) * 0.3).astype(np.float32)
            y, _ = _client_roundtrip(port, x)
            np.testing.assert_allclose(y, upsample_signal(x, lf),
                                       rtol=1e-5, atol=1e-6)
            with srv.stats.lock:
                shapes = dict(srv.stats.steps_by_shape)
            assert shapes, "no steps recorded"
            assert all(key.startswith("8x") for key in shapes), shapes
        finally:
            srv.stop()

    def test_isolation_across_width_transitions(self, rng):
        """12 staggered concurrent clients on 16 slots cross the 8/16
        width boundary repeatedly; every stream's output still equals its
        own single-stream oracle."""
        lf = _filter()
        port = _free_port()
        srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                           max_streams=16, channels=2)
        srv.start()
        try:
            signals = [(rng.normal(size=(2, 2500 + 311 * i)) * 0.3)
                       .astype(np.float32) for i in range(12)]
            results: dict[int, np.ndarray] = {}
            errors: list = []

            def run(i: int) -> None:
                try:
                    time.sleep(0.015 * i)
                    results[i] = _client_roundtrip(
                        port, signals[i], chunk=701,
                        stagger_s=0.002)[0]
                except Exception as e:  # pragma: no cover
                    errors.append((i, e))

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not errors, errors
            assert len(results) == 12
            for i, y in results.items():
                np.testing.assert_allclose(
                    y, upsample_signal(signals[i], lf),
                    rtol=1e-5, atol=1e-6, err_msg=f"stream {i}")
        finally:
            srv.stop()


def _control_client(port: int, timeout=60):
    """Open a serve stream and return (sock, helpers) for staged
    send/read control tests."""
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    s.sendall(pack_header(None, 2, RATE))
    hdr = b""
    while len(hdr) < HEADER_BYTES:
        hdr += s.recv(HEADER_BYTES - len(hdr))

    def send(frames: np.ndarray) -> None:
        s.sendall(interleave(frames).astype("<f4").tobytes())

    def read_exact(n_frames: int) -> np.ndarray:
        need = n_frames * 2 * 4
        buf = bytearray()
        while len(buf) < need:
            got = s.recv(need - len(buf))
            assert got, "server closed early"
            buf += got
        flat = np.frombuffer(bytes(buf), "<f4")
        return flat.reshape(n_frames, 2).T

    def read_rest() -> np.ndarray:
        buf = bytearray()
        while True:
            got = s.recv(65536)
            if not got:
                break
            buf += got
        flat = np.frombuffer(bytes(buf), "<f4")
        return flat.reshape(-1, 2).T

    return s, send, read_exact, read_rest


def _wait_counter(get, target, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if get() >= target:
            return
        time.sleep(0.01)
    raise AssertionError(f"counter never reached {target}")


class TestServeControl:
    """Live control on the SERVING plane: the shared spectrum swaps under
    active streams with a per-slot crossfade — the reference's
    RELOAD/PHASE_TYPE surface without its container restart."""

    FADE = 500

    def _start(self, fade=FADE, max_streams=4):
        lf = _filter()
        port = _free_port()
        srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                           max_streams=max_streams, channels=2,
                           swap_fade_frames=fade)
        srv.start()
        return srv, lf, port

    def test_set_eq_mid_stream_crossfades_exactly(self, rng):
        srv, lf, port = self._start()
        try:
            block_in = srv.config.block_in
            ratio = srv.config.ratio
            p1 = (rng.normal(size=(2, 4 * block_in)) * 0.3).astype(np.float32)
            p2 = (rng.normal(size=(2, 6 * block_in)) * 0.3).astype(np.float32)
            x = np.concatenate([p1, p2], axis=1)
            eq = np.linspace(0.4, 1.2, srv.config.n_bins)

            s, send, read_exact, read_rest = _control_client(port)
            send(p1)
            y1 = read_exact(p1.shape[1] * ratio)   # part 1 fully drained
            srv.set_eq(eq)
            _wait_counter(lambda: srv.stats.spectrum_swaps, 1)
            send(p2)
            s.shutdown(socket.SHUT_WR)
            y2 = read_rest()
            s.close()

            n1 = p1.shape[1] * ratio
            ref_old = upsample_signal(x, lf)
            ref_new = upsample_signal(x, lf, eq_response=eq)
            np.testing.assert_allclose(y1, ref_old[:, :n1],
                                       rtol=1e-5, atol=1e-6)
            F = self.FADE
            ramp = np.arange(F, dtype=np.float32) / F
            expect2 = ref_new[:, n1:].copy()
            expect2[:, :F] = (ref_old[:, n1:n1 + F] * (1.0 - ramp)
                              + ref_new[:, n1:n1 + F] * ramp)
            assert y2.shape == expect2.shape
            np.testing.assert_allclose(y2, expect2, rtol=1e-4, atol=1e-5)
            # The swap really changed the audio (guards a no-op fade).
            assert not np.allclose(ref_old[:, n1 + F:], ref_new[:, n1 + F:])
        finally:
            srv.stop()

    def test_load_filter_swap_mid_stream(self, rng):
        """Phase-flip analog: a different same-geometry filter swaps in
        live with the crossfade."""
        srv, lf, port = self._start()
        lf2 = _filter(seed=11)
        try:
            block_in = srv.config.block_in
            ratio = srv.config.ratio
            p1 = (rng.normal(size=(2, 3 * block_in)) * 0.3).astype(np.float32)
            p2 = (rng.normal(size=(2, 5 * block_in)) * 0.3).astype(np.float32)
            x = np.concatenate([p1, p2], axis=1)

            s, send, read_exact, read_rest = _control_client(port)
            send(p1)
            y1 = read_exact(p1.shape[1] * ratio)
            srv.load_filter(lf2)
            _wait_counter(lambda: srv.stats.spectrum_swaps, 1)
            send(p2)
            s.shutdown(socket.SHUT_WR)
            y2 = read_rest()
            s.close()

            n1 = p1.shape[1] * ratio
            ref_old = upsample_signal(x, lf)
            ref_new = upsample_signal(x, lf2)
            np.testing.assert_allclose(y1, ref_old[:, :n1],
                                       rtol=1e-5, atol=1e-6)
            F = self.FADE
            ramp = np.arange(F, dtype=np.float32) / F
            expect2 = ref_new[:, n1:].copy()
            expect2[:, :F] = (ref_old[:, n1:n1 + F] * (1.0 - ramp)
                              + ref_new[:, n1:n1 + F] * ramp)
            np.testing.assert_allclose(y2, expect2, rtol=1e-4, atol=1e-5)
            assert srv.filter is lf2
        finally:
            srv.stop()

    def test_geometry_mismatch_rejected_live(self):
        srv, lf, port = self._start()
        try:
            other = _filter(taps=17, fft=128, ratio=2, seed=3)
            with pytest.raises(ValueError, match="geometry"):
                srv.load_filter(other)
        finally:
            srv.stop()

    def test_soft_reset_zeroes_stream_history(self, rng):
        srv, lf, port = self._start(fade=0)
        try:
            block_in = srv.config.block_in
            ratio = srv.config.ratio
            p1 = (rng.normal(size=(2, 3 * block_in)) * 0.3).astype(np.float32)
            p2 = (rng.normal(size=(2, 2 * block_in)) * 0.3).astype(np.float32)

            s, send, read_exact, read_rest = _control_client(port)
            send(p1)
            read_exact(p1.shape[1] * ratio)
            srv.soft_reset()
            _wait_counter(lambda: srv.stats.soft_resets, 1)
            send(p2)
            s.shutdown(socket.SHUT_WR)
            y2 = read_rest()
            s.close()
            # History zeroed: continuation equals a FRESH stream's output.
            np.testing.assert_allclose(y2, upsample_signal(p2, lf),
                                       rtol=1e-5, atol=1e-6)
        finally:
            srv.stop()

    def test_concurrent_streams_fade_in_own_timelines(self, rng):
        """Two live streams at different positions when the swap lands:
        each crossfades over ITS OWN next FADE output samples."""
        srv, lf, port = self._start()
        try:
            block_in = srv.config.block_in
            ratio = srv.config.ratio
            eq = np.linspace(1.3, 0.6, srv.config.n_bins)
            parts = {
                "a": ((rng.normal(size=(2, 2 * block_in)) * 0.3)
                      .astype(np.float32),
                      (rng.normal(size=(2, 4 * block_in)) * 0.3)
                      .astype(np.float32)),
                "b": ((rng.normal(size=(2, 5 * block_in)) * 0.3)
                      .astype(np.float32),
                      (rng.normal(size=(2, 3 * block_in)) * 0.3)
                      .astype(np.float32)),
            }
            clients = {k: _control_client(port) for k in parts}
            y1 = {}
            for k, (p1, _p2) in parts.items():
                clients[k][1](p1)                       # send
            for k, (p1, _p2) in parts.items():
                y1[k] = clients[k][2](p1.shape[1] * ratio)  # read_exact
            srv.set_eq(eq)
            _wait_counter(lambda: srv.stats.spectrum_swaps, 1)
            y2 = {}
            for k, (_p1, p2) in parts.items():
                s = clients[k][0]
                clients[k][1](p2)
                s.shutdown(socket.SHUT_WR)
            for k in parts:
                y2[k] = clients[k][3]()                 # read_rest
                clients[k][0].close()

            F = self.FADE
            ramp = np.arange(F, dtype=np.float32) / F
            for k, (p1, p2) in parts.items():
                x = np.concatenate([p1, p2], axis=1)
                n1 = p1.shape[1] * ratio
                ref_old = upsample_signal(x, lf)
                ref_new = upsample_signal(x, lf, eq_response=eq)
                np.testing.assert_allclose(y1[k], ref_old[:, :n1],
                                           rtol=1e-5, atol=1e-6)
                expect2 = ref_new[:, n1:].copy()
                expect2[:, :F] = (ref_old[:, n1:n1 + F] * (1.0 - ramp)
                                  + ref_new[:, n1:n1 + F] * ramp)
                np.testing.assert_allclose(y2[k], expect2, rtol=1e-4,
                                           atol=1e-5, err_msg=f"stream {k}")
        finally:
            srv.stop()

    def test_abrupt_swap_without_fade(self, rng):
        """swap_fade_frames=0 keeps the reference's abrupt-swap
        semantics: post-swap output is pure new spectrum."""
        srv, lf, port = self._start(fade=0)
        try:
            block_in = srv.config.block_in
            ratio = srv.config.ratio
            p1 = (rng.normal(size=(2, 2 * block_in)) * 0.3).astype(np.float32)
            p2 = (rng.normal(size=(2, 2 * block_in)) * 0.3).astype(np.float32)
            x = np.concatenate([p1, p2], axis=1)
            eq = np.linspace(0.5, 1.5, srv.config.n_bins)
            s, send, read_exact, read_rest = _control_client(port)
            send(p1)
            read_exact(p1.shape[1] * ratio)
            srv.set_eq(eq)
            _wait_counter(lambda: srv.stats.spectrum_swaps, 1)
            send(p2)
            s.shutdown(socket.SHUT_WR)
            y2 = read_rest()
            s.close()
            n1 = p1.shape[1] * ratio
            ref_new = upsample_signal(x, lf, eq_response=eq)
            np.testing.assert_allclose(y2, ref_new[:, n1:],
                                       rtol=1e-5, atol=1e-6)
        finally:
            srv.stop()


class TestDevicePcmServing:
    """Device-side s16 quantization of the serve step: the drain moves
    int16 (half the bytes), bit-exact with the host conversion path."""

    def _start(self, fade=0):
        lf = _filter()
        port = _free_port()
        srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                           max_streams=4, channels=2, device_pcm=True,
                           swap_fade_frames=fade)
        srv.start()
        return srv, lf, port

    def _s16_roundtrip(self, a):
        from totton_tpu.io.pcm import deinterleave

        return deinterleave(
            pcm_to_float(float_to_pcm(interleave(a), PcmFormat.S16_LE),
                         PcmFormat.S16_LE), 2)

    def test_s16_stream_matches_oracle_within_one_lsb(self, rng):
        """Device quantization is the bit-exact twin of the host path
        GIVEN the same float input; vs a single-dispatch oracle the
        server's float output can differ by ULPs (XLA tiles different
        batch widths differently), which may flip a sample sitting
        exactly on a quantization boundary — so the wire contract is
        <= 1 LSB against the oracle."""
        srv, lf, port = self._start()
        try:
            x = (rng.normal(size=(2, 3000)) * 0.3).astype(np.float32)
            y, _ = _client_roundtrip(port, x, fmt=PcmFormat.S16_LE)
            ref = self._s16_roundtrip(
                upsample_signal(self._s16_roundtrip(x), lf))
            assert y.shape == ref.shape
            assert np.max(np.abs(y - ref)) <= 1.01 / 32768
        finally:
            srv.stop()

    def test_non_s16_client_rejected(self, rng):
        srv, lf, port = self._start()
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=30)
            s.settimeout(30)
            s.sendall(pack_header(None, 2, RATE))  # f32 wire format
            # Server closes without a reply header.
            hdr = s.recv(HEADER_BYTES)
            assert hdr == b""
            s.close()
            assert srv.stats.rejected == 1
        finally:
            srv.stop()

    def test_fade_step_quantizes_on_host_bit_exact(self, rng):
        """A live swap's fade step falls back to host float + the
        bit-exact quantize twin; the output dtype contract holds through
        the crossfade."""
        FADE = 300
        srv, lf, port = self._start(fade=FADE)
        try:
            block_in = srv.config.block_in
            ratio = srv.config.ratio
            p1 = (rng.normal(size=(2, 2 * block_in)) * 0.3).astype(np.float32)
            p2 = (rng.normal(size=(2, 4 * block_in)) * 0.3).astype(np.float32)
            eq = np.linspace(0.5, 1.4, srv.config.n_bins)

            import struct

            s = socket.create_connection(("127.0.0.1", port), timeout=60)
            s.settimeout(60)
            s.sendall(pack_header(PcmFormat.S16_LE, 2, RATE))
            hdr = b""
            while len(hdr) < HEADER_BYTES:
                hdr += s.recv(HEADER_BYTES - len(hdr))

            def send(frames):
                s.sendall(float_to_pcm(interleave(frames), PcmFormat.S16_LE))

            def read_frames(n):
                need = n * 2 * 2
                buf = bytearray()
                while len(buf) < need:
                    got = s.recv(need - len(buf))
                    assert got
                    buf += got
                return deinterleave_s16(bytes(buf))

            def deinterleave_s16(raw):
                from totton_tpu.io.pcm import deinterleave

                return deinterleave(pcm_to_float(raw, PcmFormat.S16_LE), 2)

            send(p1)
            y1 = read_frames(p1.shape[1] * ratio)
            srv.set_eq(eq)
            _wait_counter(lambda: srv.stats.spectrum_swaps, 1)
            send(p2)
            s.shutdown(socket.SHUT_WR)
            rest = bytearray()
            while True:
                got = s.recv(65536)
                if not got:
                    break
                rest += got
            y2 = deinterleave_s16(bytes(rest))
            s.close()

            q1 = self._s16_roundtrip(p1)
            q2 = self._s16_roundtrip(p2)
            x = np.concatenate([q1, q2], axis=1)
            n1 = p1.shape[1] * ratio
            ref_old = upsample_signal(x, lf)
            ref_new = upsample_signal(x, lf, eq_response=eq)
            ramp = np.arange(FADE, dtype=np.float32) / FADE
            expect2 = ref_new[:, n1:].copy()
            expect2[:, :FADE] = (ref_old[:, n1:n1 + FADE] * (1.0 - ramp)
                                 + ref_new[:, n1:n1 + FADE] * ramp)
            # <= 1 LSB vs the single-dispatch oracle (see
            # test_s16_stream_matches_oracle_within_one_lsb).
            assert np.max(np.abs(
                y1 - self._s16_roundtrip(ref_old[:, :n1]))) <= 1.01 / 32768
            assert np.max(np.abs(
                y2 - self._s16_roundtrip(expect2))) <= 1.01 / 32768
        finally:
            srv.stop()


class TestDispatchFaultInjection:
    """Device faults during the step dispatch: per-stream rollback on
    transients, visible failure when persistent (serve.py dispatcher
    guard — the chaos tests never inject an actual device fault)."""

    def test_transient_fault_cuts_stream_and_recycles_slot(self, rng):
        lf = _filter()
        port = _free_port()
        srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                           max_streams=2, channels=2)
        srv.start()
        try:
            real_step = srv._step
            boom = {"n": 0}

            def failing_step(t, x, s):
                boom["n"] += 1
                raise RuntimeError("injected device fault")

            srv._step = failing_step
            s = socket.create_connection(("127.0.0.1", port), timeout=30)
            s.settimeout(30)
            s.sendall(pack_header(None, 2, RATE))
            hdr = b""
            while len(hdr) < HEADER_BYTES:
                hdr += s.recv(HEADER_BYTES - len(hdr))
            x = (rng.normal(size=(2, 2 * srv.config.block_in)) * 0.3
                 ).astype(np.float32)
            s.sendall(interleave(x).astype("<f4").tobytes())
            # The faulted stream is cut (connection closed by server).
            deadline = time.monotonic() + 30
            cut = False
            while time.monotonic() < deadline:
                try:
                    got = s.recv(65536)
                except OSError:
                    cut = True
                    break
                if not got:
                    cut = True
                    break
            assert cut, "faulted stream was never cut"
            s.close()
            assert boom["n"] >= 1
            srv._step = real_step  # fault clears before 3 strikes

            # No leak: the slot recycles (pending_steps rolled back).
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                with srv._slot_lock:
                    if len(srv._free) == 2:
                        break
                time.sleep(0.05)
            with srv._slot_lock:
                assert len(srv._free) == 2
            assert all(sl.pending_steps == 0 for sl in srv.slots)
            assert not srv.failed

            # The server still serves a fresh stream exactly.
            x2 = (rng.normal(size=(2, 1500)) * 0.3).astype(np.float32)
            y, _ = _client_roundtrip(port, x2)
            np.testing.assert_allclose(y, upsample_signal(x2, lf),
                                       rtol=1e-5, atol=1e-6)
        finally:
            srv.stop()

    def test_persistent_fault_stops_server_visibly(self, rng):
        lf = _filter()
        port = _free_port()
        srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                           max_streams=2, channels=2)
        srv.start()
        try:
            def always_failing(t, x, s):
                raise RuntimeError("injected persistent fault")

            srv._step = always_failing
            s = socket.create_connection(("127.0.0.1", port), timeout=30)
            s.sendall(pack_header(None, 2, RATE))
            hdr = b""
            while len(hdr) < HEADER_BYTES:
                hdr += s.recv(HEADER_BYTES - len(hdr))
            x = (rng.normal(size=(2, 5 * srv.config.block_in)) * 0.3
                 ).astype(np.float32)
            # Keep feeding so the dispatcher keeps hitting the fault
            # (each failure cuts the stream; reconnect to re-trigger).
            for _ in range(5):
                try:
                    s.sendall(interleave(x).astype("<f4").tobytes())
                except OSError:
                    pass
                if srv._stop.wait(timeout=2.0):
                    break
                try:
                    s.close()
                    s = socket.create_connection(("127.0.0.1", port),
                                                 timeout=5)
                    s.sendall(pack_header(None, 2, RATE))
                except OSError:
                    break
            assert srv._stop.wait(timeout=30), "server never stopped"
            assert srv.failed
            try:
                s.close()
            except OSError:
                pass
        finally:
            srv.stop()


class TestInputBound:
    def test_flooding_nonreading_client_is_bounded_and_isolated(self, rng):
        """A hostile client that sends fast and never reads its output
        must NOT grow server memory without bound: the output backlog
        gates dispatch, the input backlog cap stops the reader, and TCP
        flow control throttles the sender. A concurrent healthy stream
        is unaffected."""
        lf = _filter()
        port = _free_port()
        srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                           max_streams=4, channels=2,
                           max_input_backlog_blocks=32)
        srv.start()
        flood = None
        try:
            # Flood client: pushes PCM forever, never reads.
            flood = socket.create_connection(("127.0.0.1", port),
                                             timeout=30)
            flood.sendall(pack_header(None, 2, RATE))
            hdr = b""
            while len(hdr) < HEADER_BYTES:
                hdr += flood.recv(HEADER_BYTES - len(hdr))
            flood.settimeout(0.2)
            noise = (rng.normal(size=(2, 8192)) * 0.3).astype(np.float32)
            raw = interleave(noise).astype("<f4").tobytes()
            sent = 0
            deadline = time.monotonic() + 10
            blocked = False
            while time.monotonic() < deadline:
                try:
                    flood.sendall(raw)
                    sent += len(raw)
                except socket.timeout:
                    blocked = True  # TCP flow control engaged
                    break
            assert blocked, f"sender never throttled after {sent} bytes"

            # Find the flood slot and assert its backlog is bounded.
            slot = next(s for s in srv.slots if s.sock is not None)
            chunk_frames = 65536 // 8  # one recv can land past the check
            with slot.buf_lock:
                backlog = slot.buf.shape[1]
            assert backlog <= slot.max_input_samples + chunk_frames + 1, (
                backlog, slot.max_input_samples)
            assert slot.stats.input_throttles >= 1
            # frames_in reaches a fixed point (reader parked, not
            # spinning through the flood). Dispatch legitimately keeps
            # consuming backlog until the never-read OUTPUT queue
            # saturates, waking the reader a few more times — poll for
            # quiescence instead of demanding it instantly.
            f0 = slot.stats.frames_in
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                time.sleep(0.6)
                f1 = slot.stats.frames_in
                if f1 == f0:
                    break
                f0 = f1
            assert slot.stats.frames_in == f0, "reader never parked"

            # A healthy concurrent stream flows normally throughout.
            x = (rng.normal(size=(2, 3000)) * 0.3).astype(np.float32)
            y, _ = _client_roundtrip(port, x)
            np.testing.assert_allclose(y, upsample_signal(x, lf),
                                       rtol=1e-5, atol=1e-6)
            status = srv._slot_status(slot)
            assert status["input_backlog_blocks"] >= 1
            assert status["input_throttles"] >= 1
        finally:
            if flood is not None:
                flood.close()
            srv.stop()

    def test_cap_below_step_depth_rejected(self):
        with pytest.raises(ValueError, match="max_input_backlog_blocks"):
            StreamServer(_filter(), "tcp-listen://127.0.0.1:1", RATE,
                         max_blocks_per_step=16,
                         max_input_backlog_blocks=8)


def test_low_latency_bank_serves_exact(rng):
    """The bundled --latency low bank (8k taps, fft 16384) serves
    streams exactly like any other geometry."""
    import pathlib

    from totton_tpu.filters.sidecar import load_filter

    coeff = pathlib.Path(__file__).parent.parent / "data" / "coefficients"
    path = coeff / "filter_44k_16x_8000_min_phase.json"
    if not path.is_file():
        pytest.skip("low-latency bank not bundled")
    lf = load_filter(str(path))
    port = _free_port()
    srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                       max_streams=4, channels=2, max_blocks_per_step=2)
    srv.start()
    try:
        n = 3 * srv.config.block_in + 101
        x = (rng.normal(size=(2, n)) * 0.3).astype(np.float32)
        y, out_rate = _client_roundtrip(port, x)
        assert out_rate == RATE * 16
        ref = upsample_signal(x, lf)
        assert y.shape == ref.shape
        np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-5)
    finally:
        srv.stop()


def test_per_stream_latency_percentiles(rng):
    """The stats surface carries an input-ready -> output-queued latency
    distribution per stream (p50/p95/max)."""
    lf = _filter()
    port = _free_port()
    srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                       max_streams=4, channels=2)
    srv.start()
    try:
        x = (rng.normal(size=(2, 20 * srv.config.block_in)) * 0.3
             ).astype(np.float32)
        y, _ = _client_roundtrip(port, x)
        np.testing.assert_allclose(y, upsample_signal(x, lf),
                                   rtol=1e-5, atol=1e-6)
        slot = srv.slots[
            max(range(len(srv.slots)), key=lambda i: len(srv.slots[i].lat_ms))]
        assert len(slot.lat_ms) >= 10
        status = srv._slot_status(slot)
        lat = status["latency_ms"]
        assert 0 <= lat["p50"] <= lat["p95"] <= lat["max"]
        assert lat["max"] < 60_000  # sane wall-clock magnitude
    finally:
        srv.stop()


def test_input_rate_eq_design_matches_output_rate_in_band():
    """Design claim behind per-stream EQ (serve._profile_to_sos): RBJ
    biquads designed at the 44.1k INPUT rate match the reference-style
    OUTPUT-rate (705.6k) design across the audio band — bilinear warping
    only separates them near the input Nyquist, far above any EQ band."""
    from totton_tpu.eq.apo import parse_eq_string
    from totton_tpu.eq.biquad import profile_response

    profile = parse_eq_string(
        "Filter 1: ON PK Fc 1000 Hz Gain 6 dB Q 1.0\n"
        "Filter 2: ON LS Fc 105 Hz Gain 4 dB Q 0.7\n"
        "Filter 3: ON HS Fc 8000 Hz Gain -2 dB Q 0.7\n")
    freqs = np.linspace(20.0, 16000.0, 400)
    h_in = profile_response(profile, freqs, 44100.0)
    h_out = profile_response(profile, freqs, 705600.0)
    dev_db = np.abs(20 * np.log10(np.abs(h_in) / np.abs(h_out)))
    assert dev_db.max() < 0.5, dev_db.max()


def test_drain_finishes_active_stream_and_stops_accepting(rng):
    """Graceful shutdown: drain() closes the listener but an in-flight
    stream still receives its complete output."""
    lf = _filter()
    port = _free_port()
    srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                       max_streams=2, channels=2)
    srv.start()
    try:
        x = (rng.normal(size=(2, 6000)) * 0.3).astype(np.float32)
        result = {}

        def client():
            # Slow trickle so drain() lands mid-stream.
            result["y"] = _client_roundtrip(port, x, chunk=500,
                                            stagger_s=0.02)[0]

        t = threading.Thread(target=client)
        t.start()
        time.sleep(0.15)  # client attached, mid-stream
        drain = {}

        def run_drain():
            drain["ok"] = srv.drain(timeout_s=60)

        dt = threading.Thread(target=run_drain)
        dt.start()
        # New connections must be refused once draining settles (the
        # acceptor may hold the listener fd for up to its 0.5 s accept
        # timeout before releasing it).
        deadline = time.monotonic() + 5
        refused = False
        while time.monotonic() < deadline and not refused:
            try:
                probe = socket.create_connection(("127.0.0.1", port),
                                                 timeout=1)
                probe.close()
                time.sleep(0.1)
            except OSError:
                refused = True
        assert refused, "listener still accepting after drain()"
        t.join(timeout=60)
        dt.join(timeout=60)
        assert drain.get("ok") is True
        np.testing.assert_allclose(result["y"], upsample_signal(x, lf),
                                   rtol=1e-5, atol=1e-6)
    finally:
        srv.stop()
