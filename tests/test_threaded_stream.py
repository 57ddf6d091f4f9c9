"""Threaded streaming session: three-thread pipeline must produce output
identical to the synchronous session / offline processing."""

import numpy as np

from totton_tpu.engine.upsampler import StreamingUpsampler, upsample_signal
from totton_tpu.filters.sidecar import load_filter
from totton_tpu.io.devices import WavFileSink, WavFileSource
from totton_tpu.io.stream import ThreadedStreamSession
from totton_tpu.io.wav import read_wav, write_wav


def test_threaded_matches_offline(coefficients_dir, rng, tmp_path):
    lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
    n = 4321  # exercises the partial-final-block path
    x = (rng.normal(size=(2, n)) * 0.3).astype(np.float32)
    wav_in = str(tmp_path / "in.wav")
    write_wav(wav_in, x, 352800)

    source = WavFileSource(wav_in)
    sink = WavFileSink(str(tmp_path / "out.wav"), 705600)
    eng = StreamingUpsampler(lf, channels=2)
    stats = ThreadedStreamSession(
        source, sink, eng, period_frames=512
    ).run()
    sink.close()

    assert stats.frames_in == n
    assert stats.frames_out == n * 2
    y, _ = read_wav(str(tmp_path / "out.wav"))
    assert y.shape == (2, n * 2)

    x_quant, _ = read_wav(wav_in)
    ref = upsample_signal(x_quant, lf)
    # Tolerance: s24 WAV quantization (1 LSB = 1.2e-7) + f32 batch-order
    # noise from different FFT batch sizes than the offline path.
    np.testing.assert_allclose(y, np.clip(ref, -1, 0.9999999), atol=5e-7)


def test_threaded_stop_terminates(coefficients_dir, tmp_path, rng):
    import threading

    from totton_tpu.io.devices import NullSink, NullSource

    lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
    eng = StreamingUpsampler(lf, channels=2)
    session = ThreadedStreamSession(
        NullSource(channels=2, sample_rate=352800), NullSink(), eng
    )
    t = threading.Thread(target=session.run)
    t.start()
    import time

    time.sleep(0.3)
    session.stop()
    t.join(timeout=15)
    assert not t.is_alive()
    assert session.stats.blocks_processed > 0


def test_realtime_overflow_drops_not_blocks(coefficients_dir):
    """Realtime capture can't wait on a full ring: the feeder drops the
    chunk and counts it (reference: ring overflow -> drop + log,
    alsa_streamer_main.cpp:516-521). File sources instead backpressure."""
    import numpy as np

    from totton_tpu.engine.upsampler import StreamingUpsampler
    from totton_tpu.filters.sidecar import load_filter
    from totton_tpu.io.devices import NullSink, NullSource
    from totton_tpu.io.stream import ThreadedStreamSession

    lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
    src = NullSource(channels=2, sample_rate=352800, total_frames=4096)
    src.realtime = True
    session = ThreadedStreamSession(
        src, NullSink(), StreamingUpsampler(lf, channels=2),
        period_frames=4096, buffer_blocks=3,
    )
    # Fill the input ring to capacity so the next feeder write must fail.
    filler = np.zeros(1024, np.float32)
    while session._in_ring.write(filler):
        pass
    session._feeder(max_frames=4096)  # one chunk against a full ring
    assert session.stats.input_overflows >= 1
    assert session.stats.frames_in == 4096  # read happened, then dropped
    assert session._feed_done.is_set()


def _stalled_write_session(coefficients_dir, realtime: bool):
    from totton_tpu.io.devices import NullSink, NullSource

    lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
    eng = StreamingUpsampler(lf, channels=2)
    src = NullSource(channels=2, sample_rate=352800)
    if realtime:
        src.realtime = True
    session = ThreadedStreamSession(src, NullSink(), eng, buffer_blocks=3)
    ring = session._out_ring
    # Fill the ring so the writer stalls immediately.
    pad = np.zeros(1024, np.float32)
    while ring.write(pad):
        pass
    leftover = ring.available_to_write()
    if leftover:
        ring.write(np.zeros(leftover, np.float32))
    return session, ring


def _run_stalled_write(session, ring):
    import threading
    import time

    flat = np.zeros(ring.capacity - (ring.capacity % 2), np.float32)
    writer = threading.Thread(target=session._write_out, args=(flat,))
    writer.start()
    time.sleep(0.1)  # ~50 poll iterations under the old per-poll accounting
    mid_stall = session.stats.output_overflows
    # Drain in small chunks: partial progress must NOT re-arm the counter
    # (the round-2 regression: one count per ring-fill cycle).
    while writer.is_alive():
        ring.read(min(4096, ring.available_to_read()))
        time.sleep(0.001)
    writer.join(timeout=5)
    assert not writer.is_alive()
    return mid_stall, session.stats.output_overflows


def test_write_out_counts_one_overflow_per_episode(coefficients_dir):
    """A realtime session's slow-sink episode counts ONE output overflow:
    not one per 2 ms poll (round-1 regression) and not one per ring-fill
    cycle during the chunked write (round-2 regression)."""
    session, ring = _stalled_write_session(coefficients_dir, realtime=True)
    mid, final = _run_stalled_write(session, ring)
    assert mid == 1
    assert final == 1


def test_write_out_offline_backpressure_counts_nothing(coefficients_dir):
    """Offline sources deliberately push dispatches larger than the output
    ring; that healthy backpressure is not an xrun."""
    session, ring = _stalled_write_session(coefficients_dir, realtime=False)
    mid, final = _run_stalled_write(session, ring)
    assert mid == 0
    assert final == 0


def test_low_latency_dispatch_quantized_to_warmed_shapes():
    """Low-latency sessions may only dispatch the shapes _warm_up
    pre-compiled ({1, max_batch_blocks} blocks); a 2..max-1 backlog must
    round down to 1 rather than jit a fresh shape mid-stream."""
    from totton_tpu.io.stream import _quantize_nblocks

    for ready in range(1, 8):
        assert _quantize_nblocks(ready, 8, low_latency=True) == 1
    for ready in (8, 9, 100):
        assert _quantize_nblocks(ready, 8, low_latency=True) == 8
    # Offline EOF remainders quantize DOWN to powers of two so the shape
    # universe is {1, 2, 4, ..., max} — one-time compiles under the
    # persistent XLA cache regardless of input file length.
    assert _quantize_nblocks(3, 8, low_latency=False) == 2
    assert _quantize_nblocks(353, 512, low_latency=False) == 256
    assert _quantize_nblocks(1, 8, low_latency=False) == 1
    assert _quantize_nblocks(8, 8, low_latency=False) == 8
    assert _quantize_nblocks(100, 8, low_latency=False) == 8


def test_output_ring_size_independent_of_dispatch_depth(coefficients_dir):
    """The output ring must not scale with max_batch_blocks (round-1: a
    512-block offline dispatch eagerly allocated a ~210 MB output ring);
    _write_out chunks into whatever space the drainer frees."""
    from totton_tpu.io.devices import NullSink, NullSource

    lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
    eng = StreamingUpsampler(lf, channels=2)
    session = ThreadedStreamSession(
        NullSource(channels=2, sample_rate=352800), NullSink(), eng,
        buffer_blocks=8, max_batch_blocks=512,
    )
    expected = eng.config.block_size * 8 * 2  # block_size * buffer_blocks * ch
    assert session._out_ring.capacity == expected


def test_stream_stats_cross_thread_counts_exact():
    """StreamStats is the framework's observability surface; its counters
    are mutated from feeder/drainer/main threads concurrently
    (unsynchronized += once lost counts). All mutators now
    serialize on one lock — concurrent increments must be conserved."""
    import threading

    from totton_tpu.io.stream import StreamStats

    stats = StreamStats()
    n_threads, n_iter = 8, 4000

    def worker():
        y = np.full((2, 4), 0.5, np.float32)
        for _ in range(n_iter):
            stats.add_frames_in(3)
            stats.add_frames_out(6)
            stats.count_input_overflow()
            stats.count_output_overflow()
            stats.add_dispatch(1, 0.001)
            stats.meter_output(y)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    # Concurrent snapshots must never tear or crash.
    for _ in range(50):
        stats.to_json()
    for t in threads:
        t.join()

    total = n_threads * n_iter
    assert stats.frames_in == 3 * total
    assert stats.frames_out == 6 * total
    assert stats.input_overflows == total
    assert stats.output_overflows == total
    assert stats.blocks_processed == total
    assert stats.metered_samples == 8 * total
    assert abs(stats.process_time_s - 0.001 * total) < 1e-6
    assert stats.peak_out == 0.5


def test_threaded_session_frame_conservation(coefficients_dir, rng, tmp_path):
    """Under the threaded session with many small period reads, counts must
    balance exactly: frames_out == frames_in * ratio (EOF flush included)."""
    from totton_tpu.engine.upsampler import StreamingUpsampler
    from totton_tpu.filters.sidecar import load_filter
    from totton_tpu.io.devices import NullSink, WavFileSource
    from totton_tpu.io.stream import ThreadedStreamSession
    from totton_tpu.io.wav import write_wav

    lf = load_filter(next(coefficients_dir.glob("filter_44k_2x_*.json")))
    n = 4999  # not a block multiple: exercises the padded-flush tail
    x = (rng.normal(size=(2, n)) * 0.1).astype(np.float32)
    wav_in = str(tmp_path / "in.wav")
    write_wav(wav_in, x, 352800)
    session = ThreadedStreamSession(
        WavFileSource(wav_in), NullSink(),
        StreamingUpsampler(lf, channels=2), period_frames=7,
    )
    stats = session.run()
    assert stats.frames_in == n
    assert stats.frames_out == n * 2
