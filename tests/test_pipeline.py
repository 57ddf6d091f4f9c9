"""Pipelined dispatch (dispatch_block/fetch + session overlap) must be
sample-exact with the synchronous path — the overlap is a scheduling
change only (overlap transfer and compute in the live streaming path)."""

import numpy as np
import pytest

from totton_tpu.engine.upsampler import StreamingUpsampler
from totton_tpu.filters.sidecar import FilterSidecar, LoadedFilter
from totton_tpu.io.devices import NullSink
from totton_tpu.io.stream import (
    StreamSession,
    ThreadedStreamSession,
    _EnginePipeline,
)


def _filter(taps=17, fft=64, ratio=4, seed=3):
    rng = np.random.default_rng(seed)
    return LoadedFilter(
        taps=rng.normal(size=taps).astype(np.float32),
        sidecar=FilterSidecar(
            coefficients_bin="<test>", taps=taps, fft_size=fft,
            block_size=fft - (taps - 1), upsample_factor=ratio,
        ),
    )


class _ArraySource:
    """Feeds a fixed [C, T] signal in period-sized chunks."""

    low_latency = False
    realtime = False

    def __init__(self, x, rate=44100):
        self._x = np.asarray(x, np.float32)
        self._pos = 0
        self.channels = self._x.shape[0]
        self.sample_rate = rate

    def read_frames(self, n):
        chunk = self._x[:, self._pos:self._pos + n]
        self._pos += chunk.shape[1]
        return chunk

    def close(self):
        pass


class _CaptureSink:
    def __init__(self):
        self.chunks = []

    def write_frames(self, x):
        self.chunks.append(np.array(x))

    def write_quantized(self, x):
        self.chunks.append(np.array(x))

    def set_dither(self, enabled):
        return False

    def close(self):
        pass

    @property
    def out(self):
        return (np.concatenate(self.chunks, axis=1) if self.chunks
                else np.zeros((0, 0)))


class TestEngineTwoPhase:
    def test_chained_dispatches_equal_sequential(self, rng):
        lf = _filter()
        x = rng.normal(size=(2, 6 * (64 - 16) // 4)).astype(np.float32)
        block_in = (64 - 16) // 4

        ref_eng = StreamingUpsampler(lf, channels=2)
        ref = [np.array(ref_eng.process_block(
            x[:, i * block_in:(i + 1) * block_in])) for i in range(6)]

        eng = StreamingUpsampler(lf, channels=2)
        # Dispatch three steps BEFORE fetching any: the carried tail must
        # chain on-device without a host sync.
        handles = [eng.dispatch_block(x[:, i * block_in:(i + 1) * block_in])
                   for i in range(3)]
        got = [eng.fetch(h) for h in handles]
        handles = [eng.dispatch_block(x[:, i * block_in:(i + 1) * block_in])
                   for i in range(3, 6)]
        got += [eng.fetch(h) for h in handles]
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(r, g)

    def test_fade_bookkeeping_across_inflight_swap(self, rng):
        """A hot-swap between two in-flight dispatches applies to the
        steps dispatched AFTER it, with the fade ramp carried in dispatch
        order — exactly like the synchronous path."""
        lf = _filter()
        lf2 = _filter(seed=9)
        block_in = (64 - 16) // 4
        x = rng.normal(size=(2, 4 * block_in)).astype(np.float32)
        fade = 40

        ref_eng = StreamingUpsampler(lf, channels=2, swap_fade_frames=fade)
        ref = [np.array(ref_eng.process_block(x[:, :block_in]))]
        ref_eng.load_filter(lf2)
        ref += [np.array(ref_eng.process_block(
            x[:, i * block_in:(i + 1) * block_in])) for i in range(1, 4)]

        eng = StreamingUpsampler(lf, channels=2, swap_fade_frames=fade)
        h0 = eng.dispatch_block(x[:, :block_in])
        eng.load_filter(lf2)
        hs = [eng.dispatch_block(x[:, i * block_in:(i + 1) * block_in])
              for i in range(1, 4)]
        got = [eng.fetch(h) for h in [h0] + hs]
        for r, g in zip(ref, got):
            np.testing.assert_allclose(r, g, rtol=1e-6, atol=1e-7)

    def test_device_pcm_two_phase(self, rng):
        from totton_tpu.io.pcm import PcmFormat

        lf = _filter()
        block_in = (64 - 16) // 4
        x = (rng.normal(size=(2, 3 * block_in)) * 0.4).astype(np.float32)
        ref_eng = StreamingUpsampler(lf, channels=2,
                                     device_pcm=PcmFormat.S16_LE)
        ref = np.array(ref_eng.process_block(x))
        eng = StreamingUpsampler(lf, channels=2,
                                 device_pcm=PcmFormat.S16_LE)
        h = eng.dispatch_block(x)
        got = eng.fetch(h)
        np.testing.assert_array_equal(ref, got)
        assert got.dtype == np.int16


class TestShardedTwoPhase:
    def test_dispatch_fetch_equals_process_block(self, rng):
        import jax

        from totton_tpu.parallel import ShardedUpsampler, make_mesh

        lf = _filter(taps=33, fft=256, ratio=4)
        mesh = make_mesh(n_channel=2, n_time=2,
                         devices=jax.devices()[:4])
        eng_a = ShardedUpsampler(lf, mesh, channels=2)
        eng_b = ShardedUpsampler(lf, mesh, channels=2)
        step_in = eng_a.block_input_frames
        x = rng.normal(size=(2, 3 * step_in)).astype(np.float32)
        ref = [np.array(eng_a.process_block(
            x[:, i * step_in:(i + 1) * step_in])) for i in range(3)]
        handles = [eng_b.dispatch_block(x[:, i * step_in:(i + 1) * step_in])
                   for i in range(3)]
        got = [eng_b.fetch(h) for h in handles]
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(r, g)


class TestSessionPipelining:
    @pytest.mark.parametrize("session_cls",
                             [StreamSession, ThreadedStreamSession])
    @pytest.mark.parametrize("depth", [1, 2, 3])
    def test_pipelined_equals_synchronous(self, rng, session_cls, depth):
        lf = _filter()
        block_in = (64 - 16) // 4
        x = rng.normal(size=(2, 11 * block_in + 5)).astype(np.float32)

        outs = []
        for d in (0, depth):
            sink = _CaptureSink()
            session = session_cls(
                _ArraySource(x), sink, StreamingUpsampler(lf, channels=2),
                period_frames=block_in, max_batch_blocks=2,
                pipeline_depth=d)
            stats = session.run()
            assert stats.frames_in == x.shape[1]
            assert stats.frames_out == x.shape[1] * 4
            outs.append(sink.out)
        np.testing.assert_array_equal(outs[0], outs[1])

    def test_auto_depth_engines_without_async_api(self):
        """Engines lacking dispatch_block silently run synchronously."""

        class _Plain:
            channels = 2
            ratio = 1
            block_input_frames = 8

            class config:
                block_size = 8

            def process_block(self, x):
                return np.asarray(x, np.float32)

        pipe = _EnginePipeline(_Plain(), __import__(
            "totton_tpu.io.stream", fromlist=["StreamStats"]).StreamStats(),
            8, lambda y, v: None, depth=4)
        assert pipe.depth == 0

    def test_stats_count_all_steps(self, rng):
        lf = _filter()
        block_in = (64 - 16) // 4
        x = rng.normal(size=(2, 8 * block_in)).astype(np.float32)
        sink = _CaptureSink()
        session = StreamSession(
            _ArraySource(x), sink, StreamingUpsampler(lf, channels=2),
            period_frames=block_in, max_batch_blocks=1, pipeline_depth=2)
        stats = session.run()
        assert stats.blocks_processed == 8
        assert stats.frames_out == 8 * block_in * 4


class TestChainTwoPhase:
    def test_crossfeed_chain_pipelined_equals_sync(self, rng, tmp_path):
        from totton_tpu.engine.chain import CrossfeedChain
        from totton_tpu.engine.crossfeed import (
            CrossfeedFilter,
            CrossfeedProcessor,
        )
        from totton_tpu.filters.hrtf import generate_all

        cf_path = generate_all(tmp_path, sizes=["M"], families=["44k"])[0]
        lf = _filter()
        block_in = (64 - 16) // 4
        x = rng.normal(size=(2, 9 * block_in)).astype(np.float32) * 0.3

        def build():
            return CrossfeedChain(
                StreamingUpsampler(lf, channels=2),
                CrossfeedProcessor(CrossfeedFilter.load(str(cf_path))))

        ref_eng = build()
        ref = [np.array(ref_eng.process_block(
            x[:, i * block_in:(i + 1) * block_in])) for i in range(9)]

        eng = build()
        handles = [eng.dispatch_block(x[:, i * block_in:(i + 1) * block_in])
                   for i in range(3)]
        got = [eng.fetch(h) for h in handles]
        handles = [eng.dispatch_block(x[:, i * block_in:(i + 1) * block_in])
                   for i in range(3, 9)]
        got += [eng.fetch(h) for h in handles]
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(r, g)
