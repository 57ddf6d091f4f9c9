"""Core overlap-save ops vs a naive direct-convolution oracle.

Strategy modeled on the reference's engine oracle test
(tests/cpp/test_vulkan_upsampler.cpp): tiny filters checked against direct
convolution, streaming continuity across block boundaries, zero-stuff
upsampling vs a ZeroStuff+Convolve oracle.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from totton_tpu.ops.overlap_save import (
    OverlapSaveConfig,
    filter_spectrum,
    frame_input,
    make_block_step,
    upsample_blocks,
    zero_stuff,
)


def oracle_upsample(x: np.ndarray, h: np.ndarray, ratio: int) -> np.ndarray:
    """Direct zero-stuff + convolution oracle in float64."""
    up = np.zeros(len(x) * ratio)
    up[::ratio] = x
    return np.convolve(up, np.asarray(h, dtype=np.float64))[: len(up)]


def rel_err(y, ref):
    return np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30)


class TestConfig:
    def test_bundled_geometry(self):
        cfg = OverlapSaveConfig(taps=80001, fft_size=131072, block_size=51072,
                                ratio=16)
        assert cfg.frame_in == 8192
        assert cfg.block_in == 3192
        assert cfg.halo_in == 5000
        assert cfg.overlap == 80000
        assert cfg.n_bins == 65537

    def test_invariant_rejection(self):
        with pytest.raises(ValueError, match="invariant"):
            OverlapSaveConfig(taps=100, fft_size=256, block_size=100, ratio=1)
        with pytest.raises(ValueError, match="power of two"):
            OverlapSaveConfig(taps=100, fft_size=300, block_size=201, ratio=1)
        with pytest.raises(ValueError, match="ratio"):
            OverlapSaveConfig(taps=97, fft_size=128, block_size=32, ratio=3)


class TestFraming:
    def test_frames_match_slices(self, rng):
        x = rng.normal(size=(3, 5 * 8 + 20)).astype(np.float32)
        frames = np.asarray(frame_input(jnp.asarray(x), block_in=8, halo_in=20))
        assert frames.shape == (3, 5, 28)
        for i in range(5):
            np.testing.assert_array_equal(frames[:, i], x[:, i * 8 : i * 8 + 28])

    def test_halo_larger_than_block(self, rng):
        # The production regime: halo (5000) > block_in (3192).
        x = rng.normal(size=(1, 4 * 3 + 10)).astype(np.float32)
        frames = np.asarray(frame_input(jnp.asarray(x), block_in=3, halo_in=10))
        for i in range(4):
            np.testing.assert_array_equal(frames[:, i], x[:, i * 3 : i * 3 + 13])

    def test_bad_length_rejected(self):
        with pytest.raises(ValueError, match="multiple"):
            frame_input(jnp.zeros((1, 25)), block_in=8, halo_in=2)


class TestZeroStuff:
    def test_positions(self):
        x = jnp.asarray([[1.0, 2.0, 3.0]])
        out = np.asarray(zero_stuff(x, 4))
        expected = np.zeros(12)
        expected[[0, 4, 8]] = [1, 2, 3]
        np.testing.assert_array_equal(out[0], expected)

    def test_ratio_one_identity(self):
        x = jnp.asarray([1.0, 2.0])
        assert zero_stuff(x, 1) is x


class TestAgainstOracle:
    @pytest.mark.parametrize(
        "taps,fft,ratio",
        [(5, 64, 1), (9, 64, 2), (17, 64, 4), (33, 128, 8), (33, 128, 16),
         (257, 2048, 2)],
    )
    def test_matches_direct_convolution(self, rng, taps, fft, ratio):
        cfg = OverlapSaveConfig(taps=taps, fft_size=fft,
                                block_size=fft - (taps - 1), ratio=ratio)
        h = rng.normal(size=taps)
        spectrum = filter_spectrum(h, fft)
        x = rng.normal(size=(2, 5 * cfg.block_in)).astype(np.float32)
        xin = np.concatenate(
            [np.zeros((2, cfg.halo_in), np.float32), x], axis=-1
        )
        y = np.asarray(upsample_blocks(jnp.asarray(xin), spectrum, cfg))
        ref = np.stack([oracle_upsample(x[c], h, ratio) for c in range(2)])
        assert rel_err(y, ref) < 1e-5

    def test_impulse_response_recovery(self, rng):
        # An impulse through the convolver must reproduce the taps.
        taps = 13
        cfg = OverlapSaveConfig(taps=taps, fft_size=64, block_size=52, ratio=4)
        h = rng.normal(size=taps)
        spectrum = filter_spectrum(h, 64)
        x = np.zeros((1, cfg.block_in), np.float32)
        x[0, 0] = 1.0
        xin = np.concatenate([np.zeros((1, cfg.halo_in), np.float32), x], -1)
        y = np.asarray(upsample_blocks(jnp.asarray(xin), spectrum, cfg))[0]
        np.testing.assert_allclose(y[:taps], h, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(y[taps:], 0, atol=1e-5)

    def test_history_in_input_respected(self, rng):
        # Explicit nonzero halo must contribute exactly like earlier stream
        # content would.
        cfg = OverlapSaveConfig(taps=9, fft_size=32, block_size=24, ratio=2)
        h = rng.normal(size=9)
        spectrum = filter_spectrum(h, 32)
        full = rng.normal(size=2 * cfg.block_in + cfg.halo_in).astype(np.float32)
        y = np.asarray(
            upsample_blocks(jnp.asarray(full[None]), spectrum, cfg)
        )[0]
        ref_full = oracle_upsample(full, h, 2)
        # The op's output corresponds to input starting after the halo.
        ref = ref_full[cfg.halo_in * 2 :]
        assert rel_err(y, ref[: len(y)]) < 1e-5


class TestStreaming:
    def test_block_streaming_equals_single_shot(self, rng):
        cfg = OverlapSaveConfig(taps=17, fft_size=64, block_size=48, ratio=4)
        h = rng.normal(size=17)
        spectrum = filter_spectrum(h, 64)
        step = make_block_step(cfg)
        x = rng.normal(size=(2, 7 * cfg.block_in)).astype(np.float32)

        tail = jnp.zeros((2, cfg.halo_in), jnp.float32)
        chunks = []
        for i in range(7):
            y, tail = step(
                tail, jnp.asarray(x[:, i * cfg.block_in : (i + 1) * cfg.block_in]),
                spectrum,
            )
            chunks.append(np.asarray(y))
        streamed = np.concatenate(chunks, axis=-1)

        xin = np.concatenate([np.zeros((2, cfg.halo_in), np.float32), x], -1)
        single = np.asarray(upsample_blocks(jnp.asarray(xin), spectrum, cfg))
        np.testing.assert_allclose(streamed, single, rtol=1e-5, atol=1e-6)

    def test_multi_block_chunks(self, rng):
        # Feeding 2 blocks at a time must equal 1 block at a time.
        cfg = OverlapSaveConfig(taps=9, fft_size=32, block_size=24, ratio=2)
        h = rng.normal(size=9)
        spectrum = filter_spectrum(h, 32)
        step = make_block_step(cfg)
        x = rng.normal(size=(1, 4 * cfg.block_in)).astype(np.float32)

        tail = jnp.zeros((1, cfg.halo_in), jnp.float32)
        y2 = []
        for i in range(2):
            y, tail = step(
                tail,
                jnp.asarray(x[:, i * 2 * cfg.block_in : (i + 1) * 2 * cfg.block_in]),
                spectrum,
            )
            y2.append(np.asarray(y))
        ref = oracle_upsample(x[0], h, 2)
        assert rel_err(np.concatenate(y2, -1)[0], ref) < 1e-5




def _geometry(ratio: int) -> OverlapSaveConfig:
    """Small geometry with the production invariants at any ratio:
    frame_in 64, block_in 40, halo_in 24."""
    return OverlapSaveConfig(taps=24 * ratio + 1, fft_size=64 * ratio,
                             block_size=40 * ratio, ratio=ratio)


def _stream_oracle(tail, x, h, cfg):
    """float64 oracle of one step: zero-stuff [tail | x], convolve, drop
    the history's output."""
    out = []
    for c in range(x.shape[0]):
        full = oracle_upsample(np.concatenate([tail[c], x[c]]), h, cfg.ratio)
        out.append(full[cfg.halo_in * cfg.ratio:])
    return np.stack(out)


class TestStepOracle:
    """The jitted streaming step (rfft -> periodic extension -> x H ->
    irfft -> discard) against the float64 oracle, over every ratio and
    the dispatch widths the engine, live and serve paths use."""

    @pytest.mark.parametrize("channels", [1, 2])
    @pytest.mark.parametrize("blocks", [1, 2, 33, 64])
    @pytest.mark.parametrize("ratio", [1, 2, 4, 8, 16])
    def test_step_matches_float64_oracle(self, rng, ratio, blocks, channels):
        cfg = _geometry(ratio)
        h = rng.normal(size=cfg.taps)
        tail = rng.normal(size=(channels, cfg.halo_in)).astype(np.float32)
        x = rng.normal(size=(channels, blocks * cfg.block_in)).astype(
            np.float32)
        y, new_tail = make_block_step(cfg)(
            jnp.asarray(tail), jnp.asarray(x), filter_spectrum(h, cfg.fft_size))
        assert y.shape == (channels, blocks * cfg.block_size)
        # float32 transforms of <= 1024 points: ~1e-7 relative noise, so
        # 1e-5 of the peak leaves two orders of margin.
        assert rel_err(np.asarray(y), _stream_oracle(tail, x, h, cfg)) < 1e-5
        np.testing.assert_array_equal(
            np.asarray(new_tail),
            np.concatenate([tail, x], axis=-1)[:, -cfg.halo_in:])

    @pytest.mark.parametrize("taps,fft", [(2, 16), (16, 64), (64, 256),
                                          (128, 512)])
    def test_odd_overlap(self, rng, taps, fft):
        """Even tap counts give an odd overlap (ratio 1 only, since
        (taps-1) % ratio == 0)."""
        cfg = OverlapSaveConfig(taps=taps, fft_size=fft,
                                block_size=fft - (taps - 1), ratio=1)
        assert cfg.overlap % 2 == 1
        h = rng.normal(size=taps)
        x = rng.normal(size=(2, 3 * cfg.block_in)).astype(np.float32)
        xin = np.concatenate([np.zeros((2, cfg.halo_in), np.float32), x], -1)
        y = np.asarray(upsample_blocks(jnp.asarray(xin),
                                       filter_spectrum(h, fft), cfg))
        ref = np.stack([oracle_upsample(x[c], h, 1) for c in range(2)])
        assert rel_err(y, ref) < 1e-5

    @pytest.mark.parametrize("ratio", [1, 2, 4, 8, 16])
    def test_spectrum_hot_swap_never_recompiles(self, rng, ratio):
        """The spectrum is a traced argument: swapping filters (RELOAD /
        EQ) reuses the compiled step and takes effect at once."""
        cfg = _geometry(ratio)
        step = make_block_step(cfg)
        tail = np.zeros((2, cfg.halo_in), np.float32)
        x = rng.normal(size=(2, 2 * cfg.block_in)).astype(np.float32)
        outs, sizes = [], []
        for _ in range(3):
            h = rng.normal(size=cfg.taps)
            y, _ = step(jnp.asarray(tail), jnp.asarray(x),
                        filter_spectrum(h, cfg.fft_size))
            assert rel_err(np.asarray(y), _stream_oracle(tail, x, h, cfg)) < 1e-5
            outs.append(np.asarray(y))
            sizes.append(step._cache_size())
        assert sizes[0] == sizes[-1]
        assert not np.allclose(outs[0], outs[1])


class TestSpectrum:
    @pytest.mark.parametrize("m", [2, 8, 64, 1024])
    @pytest.mark.parametrize("ratio", [1, 2, 4, 8, 16])
    def test_periodic_extension_is_zero_stuffed_rfft(self, rng, ratio, m):
        """rfft(frame, M) extended periodically == rfft of the zero-stuffed
        frame at length r*M (the free zero-stuffing of the hot path)."""
        from totton_tpu.ops.overlap_save import _periodic_rfft_extend

        x = rng.normal(size=(3, m)).astype(np.float32)
        got = np.asarray(_periodic_rfft_extend(jnp.fft.rfft(jnp.asarray(x)),
                                               ratio))
        up = np.zeros((3, m * ratio))
        up[:, ::ratio] = x
        ref = np.fft.rfft(up)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())

    @pytest.mark.parametrize("fft", [64, 1024, 131072])
    def test_filter_spectrum_matches_numpy(self, rng, fft):
        h = rng.normal(size=fft // 2 + 1)
        eq = rng.uniform(0.5, 2.0, size=fft // 2 + 1)
        hr, hi = filter_spectrum(h, fft, eq)
        assert hr.dtype == jnp.float32 and hr.shape == (fft // 2 + 1,)
        ref = np.fft.rfft(h, fft) * eq
        np.testing.assert_allclose(np.asarray(hr) + 1j * np.asarray(hi), ref,
                                   rtol=1e-6, atol=1e-6 * np.abs(ref).max())

    def test_filter_spectrum_rejects_bad_inputs(self):
        with pytest.raises(ValueError, match="longer"):
            filter_spectrum(np.ones(65), 64)
        with pytest.raises(ValueError, match="eq_response"):
            filter_spectrum(np.ones(8), 64, np.ones(10))

    @pytest.mark.parametrize("ratio", [1, 2, 4, 8, 16])
    def test_production_width_snr_gate(self, rng, ratio):
        """At the production width (80001 taps, fft 131072) one frame
        stays above the 125 dB gate against float64 on this backend."""
        from scipy import signal as ssig

        cfg = OverlapSaveConfig(taps=80001, fft_size=131072,
                                block_size=51072, ratio=ratio)
        h = rng.normal(size=cfg.taps) * np.exp(-np.arange(cfg.taps) / 8000)
        x = (rng.normal(size=(1, cfg.halo_in + cfg.block_in)) * 0.3).astype(
            np.float32)
        y = np.asarray(upsample_blocks(jnp.asarray(x),
                                       filter_spectrum(h, cfg.fft_size), cfg))
        up = np.zeros(x.shape[1] * ratio)
        up[::ratio] = x[0]
        ref = ssig.fftconvolve(up, h)[cfg.halo_in * ratio:][: y.shape[1]]
        snr = 10 * np.log10(np.sum(ref ** 2) / np.sum((y[0] - ref) ** 2))
        assert snr >= 125.0, snr
