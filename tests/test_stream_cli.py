"""End-to-end streaming tests: StreamSession and the totton-stream CLI
(file mode), modeled on the reference's test_alsa_streamer_e2e.cpp and
e2e_local_file_test.sh (signal-metric validation thresholds)."""

import subprocess
import sys

import numpy as np
import pytest

from totton_tpu.engine.upsampler import StreamingUpsampler, upsample_signal
from totton_tpu.filters.sidecar import load_filter
from totton_tpu.io.devices import NullSink, WavFileSink, WavFileSource, open_source
from totton_tpu.io.stream import StreamSession
from totton_tpu.io.wav import read_wav, write_wav
from totton_tpu.testing.signals import sine
from totton_tpu.testing.validate_output import validate_audio


class TestStreamSession:
    def test_session_matches_offline(self, coefficients_dir, rng, tmp_path):
        lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
        n = 5000  # not a block multiple: exercises partial-final-block path
        x = (rng.normal(size=(2, n)) * 0.3).astype(np.float32)
        wav_in = str(tmp_path / "in.wav")
        write_wav(wav_in, x, 352800)

        source = WavFileSource(wav_in)
        sink = WavFileSink(str(tmp_path / "out.wav"), 705600)
        eng = StreamingUpsampler(lf, channels=2)
        stats = StreamSession(source, sink, eng, period_frames=777).run()
        sink.close()

        assert stats.frames_in == n
        assert stats.frames_out == n * 2
        y, rate = read_wav(str(tmp_path / "out.wav"))
        assert rate == 705600
        assert y.shape == (2, n * 2)

        # Compare against offline processing of the same (s24-quantized)
        # input; output WAV quantization dominates the remaining budget.
        x_quant, _ = read_wav(wav_in)
        ref = upsample_signal(x_quant, lf)
        np.testing.assert_allclose(y, np.clip(ref, -1, 0.9999999), atol=3e-7)

    def test_stats_file_written(self, coefficients_dir, tmp_path, rng):
        lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
        x = (rng.normal(size=(2, 2000)) * 0.1).astype(np.float32)
        wav_in = str(tmp_path / "in.wav")
        write_wav(wav_in, x, 352800)
        stats_path = str(tmp_path / "stats.json")
        session = StreamSession(
            WavFileSource(wav_in), NullSink(),
            StreamingUpsampler(lf, channels=2), stats_path=stats_path,
        )
        session.run()
        import json

        stats = json.loads(open(stats_path).read())
        assert stats["frames_in"] == 2000
        assert stats["output_rate"] == 705600
        assert "xruns" in stats
        level = stats["output_level"]
        assert level["peak_dbfs"] is not None and level["peak_dbfs"] < 0
        assert level["clipped_samples"] == 0


@pytest.mark.parametrize("mode", ["wav", "raw"])
def test_cli_file_pipeline(coefficients_dir, tmp_path, mode):
    """Full subprocess e2e: sine in -> CLI -> validated upsampled output."""
    fs_in = 352800
    x = sine(1000.0, 0.05, fs_in, amplitude=0.5, channels=2)
    filter_path = str(next(coefficients_dir.glob("filter_44k_2x_*.json")))

    if mode == "wav":
        in_path = str(tmp_path / "in.wav")
        out_path = str(tmp_path / "out.wav")
        write_wav(in_path, x, fs_in)
        cmd_io = ["--in", in_path, "--out", out_path]
    else:
        from totton_tpu.io.pcm import PcmFormat, float_to_pcm, interleave

        in_path = str(tmp_path / "in.raw")
        out_path = str(tmp_path / "out.raw")
        with open(in_path, "wb") as f:
            f.write(float_to_pcm(interleave(x), PcmFormat.S32_LE))
        cmd_io = ["--in-file", in_path, "--out-file", out_path,
                  "--rate", str(fs_in), "--format", "s32"]

    proc = subprocess.run(
        [sys.executable, "-m", "totton_tpu.cli.stream", *cmd_io,
         "--filter", filter_path],
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Streaming started" in proc.stderr
    assert "Streaming stopped" in proc.stderr

    if mode == "wav":
        y, rate = read_wav(out_path)
        assert rate == fs_in * 2
    else:
        from totton_tpu.io.pcm import PcmFormat, deinterleave, pcm_to_float

        y = deinterleave(
            pcm_to_float(open(out_path, "rb").read(), PcmFormat.S32_LE), 2
        )
    assert y.shape[1] == x.shape[1] * 2
    report = validate_audio(x, y, output_ratio=2)
    assert report["passed"], report


def test_cli_missing_args():
    proc = subprocess.run(
        [sys.executable, "-m", "totton_tpu.cli.stream"],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2
    assert "required" in proc.stderr


def test_cli_bad_filter(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "totton_tpu.cli.stream",
         "--in", "null", "--out", "null", "--rate", "44100",
         "--filter", "/nonexistent.json"],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1
    assert "not found" in proc.stderr


class TestDispatchBatching:
    """Auto dispatch-granule selection (deep offline batches amortize the
    per-dispatch cost; realtime dispatches block-at-a-time for latency)."""

    def test_offline_source_gets_deep_batches(self, coefficients_dir):
        from totton_tpu.io.stream import OFFLINE_BATCH_BLOCKS

        lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
        session = StreamSession(
            NullSourceFrames(4), NullSink(), StreamingUpsampler(lf, channels=2)
        )
        assert session.max_batch_blocks == OFFLINE_BATCH_BLOCKS
        assert session._dispatch_threshold == OFFLINE_BATCH_BLOCKS

    def test_realtime_source_dispatches_immediately(self, coefficients_dir):
        from totton_tpu.io.stream import REALTIME_BATCH_BLOCKS

        lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
        src = NullSourceFrames(4)
        src.realtime = True
        session = StreamSession(
            src, NullSink(), StreamingUpsampler(lf, channels=2)
        )
        assert session.max_batch_blocks == REALTIME_BATCH_BLOCKS
        assert session._dispatch_threshold == 1

    def test_stdin_pipe_is_low_latency(self, coefficients_dir):
        """`arecord | totton-stream -` must not sit behind a deep batch:
        stdin sources dispatch block-at-a-time (but never drop)."""
        from totton_tpu.io.devices import RawFileSource
        from totton_tpu.io.formats import PcmFormat
        from totton_tpu.io.stream import REALTIME_BATCH_BLOCKS

        src = RawFileSource("-", PcmFormat.S32_LE, 2, 352800)
        assert src.low_latency and not getattr(src, "realtime", False)
        lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
        session = StreamSession(
            src, NullSink(), StreamingUpsampler(lf, channels=2)
        )
        assert session.max_batch_blocks == REALTIME_BATCH_BLOCKS
        assert session._dispatch_threshold == 1

    def test_accumulated_dispatch_output_identical(self, coefficients_dir,
                                                   rng, tmp_path):
        """Deep-batch accumulation changes dispatch shape, not output
        (within float32 rounding: different batch shapes compile to
        different-but-equivalent reduction orders)."""
        lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
        n = 6 * 25536 + 123  # several whole blocks + a partial tail
        x = (rng.normal(size=(2, n)) * 0.3).astype(np.float32)
        wav_in = str(tmp_path / "in.wav")
        write_wav(wav_in, x, 352800)

        outs = []
        for batch in (1, 4, None):  # None = auto (deep)
            sink = WavFileSink(str(tmp_path / f"out_{batch}.wav"), 705600)
            stats = StreamSession(
                WavFileSource(wav_in), sink,
                StreamingUpsampler(lf, channels=2),
                max_batch_blocks=batch,
            ).run()
            sink.close()
            assert stats.frames_out == n * 2
            y, _ = read_wav(str(tmp_path / f"out_{batch}.wav"))
            outs.append(y)
        np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)
        np.testing.assert_allclose(outs[0], outs[2], atol=1e-6)


class NullSourceFrames:
    """Tiny source stub: k frames of silence, stereo."""

    channels = 2
    sample_rate = 352800

    def __init__(self, frames: int) -> None:
        self._left = frames

    def read_frames(self, n):
        take = min(n, self._left)
        self._left -= take
        return np.zeros((2, take), dtype=np.float32)

    def close(self):
        pass


def test_low_latency_session_warms_up_engine(coefficients_dir):
    """Low-latency sessions pre-compile dispatch shapes at construction
    (a mid-stream jit compile would drop/stall live audio)."""
    lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
    engine = StreamingUpsampler(lf, channels=2)
    shapes = []
    orig = engine.process_block
    engine.process_block = lambda x: (shapes.append(x.shape), orig(x))[1]
    src = NullSourceFrames(4)
    src.realtime = True
    StreamSession(src, NullSink(), engine)
    block_in = engine.block_input_frames
    from totton_tpu.io.stream import REALTIME_BATCH_BLOCKS
    assert (2, block_in) in shapes
    assert (2, REALTIME_BATCH_BLOCKS * block_in) in shapes
    # offline sessions must NOT pay an eager compile at construction
    shapes.clear()
    StreamSession(NullSourceFrames(4), NullSink(), engine)
    assert shapes == []


def test_sigint_stops_stream_gracefully(coefficients_dir, tmp_path):
    """SIGINT mid-stream triggers a clean stop (reference SIGINT semantics,
    alsa_streamer_main.cpp:38-40); a second signal would hard-exit, which
    matters when a device dispatch hangs."""
    import signal as _signal
    import subprocess
    import sys
    import time

    stats = tmp_path / "sig_stats.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "totton_tpu.cli.stream",
         "--in", "null", "--out", "null", "--rate", "352800", "--ratio", "2",
         "--filter-dir", str(coefficients_dir), "--duration", "120",
         "--stats-path", str(stats)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        # Wait for the stream loop to be live (it writes the stats file),
        # so the signal lands on the installed handler, not startup code.
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not stats.exists():
            if proc.poll() is not None:
                raise AssertionError(f"exited early: {proc.stdout.read()}")
            time.sleep(0.2)
        assert stats.exists(), "stream loop never came up"
        proc.send_signal(_signal.SIGINT)
        assert proc.wait(timeout=120) == 0
        out = proc.stdout.read()
        assert "Streaming stopped" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


class TestControlWiring:
    """The daemon's callbacks must act on the OUTERMOST engine (a
    SOFT_RESET once bypassed the crossfeed chain)."""

    def test_soft_reset_targets_outermost_engine(
            self, coefficients_dir, tmp_path, monkeypatch, rng):
        from totton_tpu.cli import stream as stream_cli
        from totton_tpu.control import daemon as daemon_mod
        from totton_tpu.engine.chain import CrossfeedChain
        from totton_tpu.filters.hrtf import generate_all

        cf_path = generate_all(tmp_path, sizes=["M"], families=["44k"])[0]
        captured = {}

        class FakeDaemon:
            def __init__(self, **kw):
                captured.update(kw)

            def start(self):
                pass

            def stop(self):
                pass

            def wait_for_shutdown(self, timeout=None):
                return True

        monkeypatch.setattr(daemon_mod, "ControlDaemon", FakeDaemon)

        wav_in = str(tmp_path / "in.wav")
        x = (rng.normal(size=(2, 2000)) * 0.1).astype(np.float32)
        write_wav(wav_in, x, 352800)
        rc = stream_cli.main([
            "--in", wav_in, "--out", "null",
            "--filter-dir", str(coefficients_dir), "--ratio", "2",
            "--crossfeed", str(cf_path),
            "--control-endpoint", "ipc:///tmp/totton_test_unused.sock",
        ])
        assert rc == 0
        assert isinstance(captured["on_soft_reset"].__self__, CrossfeedChain)


def test_cli_sharded_crossfeed_matches_unsharded(coefficients_dir, tmp_path,
                                                 rng):
    """--shard-time + --crossfeed composition:
    the sharded engine wrapped in the chain must produce the same audio as
    the single-device chain."""
    from totton_tpu.cli import stream as stream_cli
    from totton_tpu.filters.hrtf import generate_all

    cf_path = generate_all(tmp_path, sizes=["M"], families=["44k"])[0]
    x = (rng.normal(size=(2, 7000)) * 0.3).astype(np.float32)
    wav_in = str(tmp_path / "in.wav")
    write_wav(wav_in, x, 352800)

    common = ["--in", wav_in, "--filter-dir", str(coefficients_dir),
              "--ratio", "2", "--crossfeed", str(cf_path)]
    assert stream_cli.main(
        common + ["--out", str(tmp_path / "sharded.wav"),
                  "--shard-time", "2"]) == 0
    assert stream_cli.main(
        common + ["--out", str(tmp_path / "plain.wav")]) == 0

    y_sharded, r1 = read_wav(str(tmp_path / "sharded.wav"))
    y_plain, r2 = read_wav(str(tmp_path / "plain.wav"))
    assert r1 == r2 == 705600
    assert y_sharded.shape == y_plain.shape == (2, 14000)
    np.testing.assert_allclose(y_sharded, y_plain, atol=2e-5)


def test_transport_error_exits_nonzero(tmp_path):
    """A mid-stream RST on a socket input must end totton-stream with a
    NONZERO exit (round-3 weak #3: transport faults were folded into a
    clean stop); an orderly FIN stays exit 0."""
    import socket
    import struct
    import threading
    import time as _time

    from totton_tpu.io.pcm import interleave as _il
    from totton_tpu.io.sockets import pack_header

    def run_case(rst: bool) -> int:
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        proc = subprocess.Popen(
            [sys.executable, "-m", "totton_tpu.cli.stream",
             "--in", f"tcp-listen://127.0.0.1:{port}",
             "--out", "null"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def send():
            deadline = _time.monotonic() + 240
            while True:
                try:
                    s = socket.create_connection(("127.0.0.1", port),
                                                 timeout=10)
                    break
                except OSError:
                    if _time.monotonic() > deadline:
                        raise
                    _time.sleep(0.2)
            s.sendall(pack_header(None, 2, 44100))
            x = np.zeros((2, 4096), np.float32)
            s.sendall(_il(x).astype("<f4").tobytes())
            _time.sleep(1.0)
            if rst:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             struct.pack("ii", 1, 0))
            s.close()

        t = threading.Thread(target=send)
        t.start()
        rc = proc.wait(timeout=600)
        t.join(timeout=30)
        out = proc.stdout.read()
        if rst:
            assert "transport errors: 1" in out, out[-2000:]
        return rc

    assert run_case(rst=False) == 0
    assert run_case(rst=True) == 1
