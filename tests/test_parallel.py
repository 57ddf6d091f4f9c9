"""Multi-chip sharding tests on the virtual 8-device CPU mesh: sharded
output must equal single-device output exactly (halo exchange is exact, not
approximate)."""

import jax
import numpy as np
import pytest

from totton_tpu.engine.upsampler import StreamingUpsampler
from totton_tpu.filters.sidecar import load_filter
from totton_tpu.parallel import ShardedUpsampler, make_mesh, sharded_upsample


@pytest.fixture(scope="module")
def small_filter(tmp_path_factory):
    from totton_tpu.filters.generate import generate_one

    out = tmp_path_factory.mktemp("par_coeff")
    # fft_size 4096 >> taps gives block_in 774 with halo_in 250 — a healthy
    # block/halo ratio at test scale.
    r = generate_one("44k_4x", 1000, 25.0, 140.0, "minimum", str(out),
                     fft_size=4096)
    return load_filter(r["json_path"])


def test_devices_available():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"


class TestMesh:
    def test_default_all_time(self):
        mesh = make_mesh()
        assert mesh.shape == {"channel": 1, "time": 8}

    def test_2d(self):
        mesh = make_mesh(n_channel=2)
        assert mesh.shape == {"channel": 2, "time": 4}

    def test_bad_split(self):
        with pytest.raises(ValueError, match="cover"):
            make_mesh(n_channel=3, n_time=3)


class TestShardedUpsample:
    @pytest.mark.parametrize("n_channel,n_time", [(1, 8), (2, 4), (4, 2), (8, 1)])
    def test_matches_single_device(self, small_filter, rng, n_channel, n_time):
        lf = small_filter
        mesh = make_mesh(n_channel=n_channel, n_time=n_time)
        cfg_block_in = lf.sidecar.block_input_frames
        channels = 8
        # Enough blocks that every time shard holds >= halo_in samples.
        blocks_per_shard = 8
        t = blocks_per_shard * cfg_block_in * n_time
        x = (rng.normal(size=(channels, t)) * 0.3).astype(np.float32)

        y_sharded = sharded_upsample(x, lf, mesh)

        eng = StreamingUpsampler(lf, channels=channels)
        y_single = eng.process_block(x)
        np.testing.assert_allclose(y_sharded, y_single, rtol=1e-5, atol=1e-6)

    def test_shard_too_small_rejected(self):
        # Production 16x geometry: halo_in (5000) > block_in (3192), so one
        # block per time shard must be rejected.
        from totton_tpu.ops.overlap_save import OverlapSaveConfig
        from totton_tpu.parallel.sharded import _check_shapes

        cfg = OverlapSaveConfig(taps=80001, fft_size=131072,
                                block_size=51072, ratio=16)
        mesh = make_mesh(n_channel=1, n_time=8)
        with pytest.raises(ValueError, match="halo"):
            _check_shapes(cfg, mesh, channels=2, t=cfg.block_in * 8)

    def test_non_divisible_rejected(self, small_filter):
        lf = small_filter
        mesh = make_mesh(n_channel=1, n_time=8)
        bad_t = lf.sidecar.block_input_frames * 8 + 1
        with pytest.raises(ValueError, match="shards"):
            sharded_upsample(np.zeros((2, bad_t), np.float32), lf, mesh)


class TestShardedStreaming:
    def test_streaming_continuity_across_steps(self, small_filter, rng):
        lf = small_filter
        mesh = make_mesh(n_channel=2, n_time=4)
        sharded = ShardedUpsampler(lf, mesh, channels=4)
        block_in = sharded.config.block_in
        per_step = sharded.step_input_frames * 4  # 4 blocks per shard...

        # Ensure halo fits in a shard
        while (per_step // 4) < sharded.config.halo_in:
            per_step *= 2
        steps = 3
        x = (rng.normal(size=(4, steps * per_step)) * 0.3).astype(np.float32)

        chunks = [
            sharded.process_block(x[:, i * per_step : (i + 1) * per_step])
            for i in range(steps)
        ]
        y_stream = np.concatenate(chunks, axis=-1)

        eng = StreamingUpsampler(lf, channels=4)
        y_single = eng.process_block(x)
        np.testing.assert_allclose(y_stream, y_single, rtol=1e-5, atol=1e-6)

    def test_rejected_swap_leaves_state_consistent(self, small_filter, rng):
        """A geometry-mismatched load_filter must not touch ANY state: a
        later set_eq rebuilds the spectrum from self._filter.taps, so a
        half-applied swap would silently corrupt audio."""
        import dataclasses

        from totton_tpu.filters.sidecar import LoadedFilter

        lf = small_filter
        mesh = make_mesh(n_channel=1, n_time=4)
        sharded = ShardedUpsampler(lf, mesh, channels=2)
        per_step = sharded.step_input_frames
        while (per_step // 4) < sharded.config.halo_in:
            per_step *= 2
        x = (rng.normal(size=(2, per_step)) * 0.3).astype(np.float32)
        y_before = sharded.process_block(x)
        sharded.reset()

        bad = LoadedFilter(
            taps=np.zeros(501, np.float32),
            sidecar=dataclasses.replace(
                lf.sidecar, taps=501, fft_size=2048, block_size=2048 - 500),
        )
        with pytest.raises(ValueError):
            sharded.load_filter(bad)
        assert sharded._filter is lf

        # set_eq after the rejected swap still matches the clean engine.
        sharded.set_eq(np.ones(sharded.config.n_bins, np.float64))
        y_after = sharded.process_block(x)
        np.testing.assert_allclose(y_after, y_before, rtol=1e-6, atol=1e-7)

    def test_reset(self, small_filter, rng):
        lf = small_filter
        mesh = make_mesh(n_channel=1, n_time=4)
        sharded = ShardedUpsampler(lf, mesh, channels=2)
        per_step = sharded.step_input_frames
        while (per_step // 4) < sharded.config.halo_in:
            per_step *= 2
        x = (rng.normal(size=(2, per_step)) * 0.3).astype(np.float32)
        y1 = sharded.process_block(x)
        _ = sharded.process_block(x)
        sharded.reset()
        y3 = sharded.process_block(x)
        np.testing.assert_array_equal(y1, y3)


class TestShardedSwapFade:
    def test_faded_swap_matches_single_device(self, small_filter, rng):
        """A crossfaded EQ swap on the sharded engine must equal the
        single-device engine's faded output (same ramp, same junction)."""
        lf = small_filter
        mesh = make_mesh(n_channel=1, n_time=4)
        fade = 256
        sharded = ShardedUpsampler(lf, mesh, channels=2,
                                   swap_fade_frames=fade)
        single = StreamingUpsampler(lf, channels=2, swap_fade_frames=fade)
        step_in = sharded.block_input_frames
        # Feed the single-device engine the same per-step granule.
        x1 = rng.normal(size=(2, step_in)).astype(np.float32) * 0.3
        x2 = rng.normal(size=(2, step_in)).astype(np.float32) * 0.3
        np.testing.assert_allclose(sharded.process_block(x1),
                                   single.process_block(x1),
                                   rtol=1e-5, atol=1e-7)
        eq = np.full(sharded.config.n_bins, 0.5, np.float64)
        sharded.set_eq(eq)
        single.set_eq(eq)
        y_s = sharded.process_block(x2)
        y_1 = single.process_block(x2)
        np.testing.assert_allclose(y_s, y_1, rtol=1e-4, atol=1e-6)
        # And the fade actually happened: first sample is far from the pure
        # new-spectrum output.
        fresh = StreamingUpsampler(lf, channels=2)
        fresh.process_block(x1)
        fresh.set_eq(eq)
        y_new = fresh.process_block(x2)
        assert abs(y_s[0, 0] - y_new[0, 0]) > abs(y_s[0, 0] - 2 * y_new[0, 0])

    def test_reset_clears_fade(self, small_filter, rng):
        mesh = make_mesh(n_channel=1, n_time=4)
        sharded = ShardedUpsampler(lf := small_filter, mesh, channels=2,
                                   swap_fade_frames=128)
        x = rng.normal(size=(2, sharded.block_input_frames)).astype(np.float32)
        sharded.process_block(x)
        sharded.set_eq(np.full(sharded.config.n_bins, 0.5))
        sharded.reset()
        y = sharded.process_block(x)
        ref = ShardedUpsampler(lf, mesh, channels=2)
        ref.set_eq(np.full(ref.config.n_bins, 0.5))
        np.testing.assert_allclose(y, ref.process_block(x), rtol=1e-5,
                                   atol=1e-7)


class TestShardedDevicePcm:
    """Sharded engine device-PCM mode: the quantize rides the sharded
    output (per-process drains move int16) and must equal the plain
    engine's device-PCM output bit-exactly."""

    def test_quantizes_sharded_stream_bit_exact(self, small_filter, rng):
        from totton_tpu.io.pcm import PcmFormat, quantize_s16_host

        lf = small_filter
        mesh = make_mesh(n_channel=2, n_time=4)
        sharded = ShardedUpsampler(lf, mesh, channels=4,
                                   device_pcm=PcmFormat.S16_LE)
        sharded_f = ShardedUpsampler(lf, mesh, channels=4)
        per_step = sharded.step_input_frames
        while (per_step // 4) < sharded.config.halo_in:
            per_step *= 2
        x = (rng.normal(size=(4, per_step)) * 0.4).astype(np.float32)

        y_sharded = sharded.process_block(x)
        assert y_sharded.dtype == np.int16
        # The on-device quantize is bit-exact against the engine's OWN
        # float stream (the sharded float stream itself differs from the
        # plain engine's at the ~2e-7 reduction-order level, so plain vs
        # sharded quantized outputs may differ by 1 LSB where a sample
        # sits on a truncation boundary).
        np.testing.assert_array_equal(
            y_sharded, quantize_s16_host(sharded_f.process_block(x)))
        plain = StreamingUpsampler(lf, channels=4,
                                   device_pcm=PcmFormat.S16_LE)
        diff = (y_sharded.astype(np.int32)
                - plain.process_block(x).astype(np.int32))
        assert np.abs(diff).max() <= 1

    def test_faded_swap_stays_quantized(self, small_filter, rng):
        from totton_tpu.io.pcm import PcmFormat, quantize_s16_host

        lf = small_filter
        mesh = make_mesh(n_channel=1, n_time=4)
        q = ShardedUpsampler(lf, mesh, channels=2, swap_fade_frames=128,
                             device_pcm=PcmFormat.S16_LE)
        f = ShardedUpsampler(lf, mesh, channels=2, swap_fade_frames=128)
        per_step = q.step_input_frames
        while (per_step // 4) < q.config.halo_in:
            per_step *= 2
        x = (rng.normal(size=(2, per_step)) * 0.3).astype(np.float32)
        for eng in (q, f):
            eng.process_block(x)
            eng.set_eq(None)  # arm the fade (identical spectrum)
        y_q = q.process_block(x)
        y_f = f.process_block(x)
        assert y_q.dtype == np.int16
        np.testing.assert_array_equal(y_q, quantize_s16_host(y_f))

    def test_rejects_non_s16(self, small_filter):
        from totton_tpu.io.pcm import PcmFormat

        with pytest.raises(ValueError, match="S16_LE only"):
            ShardedUpsampler(small_filter, make_mesh(n_channel=1, n_time=4),
                             channels=2, device_pcm=PcmFormat.S32_LE)


class TestShardedFadeCarry:
    def test_fade_longer_than_step_carries(self, small_filter, rng):
        """A fade window larger than one step's output must continue its
        ramp on the next step (the plain engine's carry semantics), not
        truncate to a mid-ramp amplitude jump."""
        lf = small_filter
        mesh = make_mesh(n_channel=1, n_time=4)
        per_step = ShardedUpsampler(lf, mesh, channels=2).step_input_frames
        while (per_step // 4) < lf.sidecar.taps:  # cover halo comfortably
            per_step *= 2
        out_per_step = per_step * 4  # ratio 4
        fade = out_per_step + out_per_step // 2  # spills into step 2
        sharded = ShardedUpsampler(lf, mesh, channels=2,
                                   swap_fade_frames=fade)
        plain = StreamingUpsampler(lf, channels=2, swap_fade_frames=fade)

        x = (rng.normal(size=(2, 3 * per_step)) * 0.3).astype(np.float32)
        for eng in (sharded, plain):
            eng.process_block(x[:, :per_step])
        # Arm a REAL spectral change so a truncated fade is visible:
        # a mild EQ tilt.
        n_bins = lf.sidecar.fft_size // 2 + 1
        eq = np.linspace(1.0, 0.5, n_bins).astype(np.float64)
        sharded.set_eq(eq)
        plain.set_eq(eq)

        y_s = np.concatenate(
            [sharded.process_block(x[:, per_step:2 * per_step]),
             sharded.process_block(x[:, 2 * per_step:])], axis=1)
        y_p = np.concatenate(
            [plain.process_block(x[:, per_step:2 * per_step]),
             plain.process_block(x[:, 2 * per_step:])], axis=1)
        np.testing.assert_allclose(y_s, y_p, rtol=1e-4, atol=1e-5)
        assert sharded._fade_from is None  # fade completed and cleared


class TestScheduledSwap:
    """Step-synchronized hot swap (schedule_swap): the swap lands at an
    exact step boundary with the crossfade armed there — the multi-host
    divergence-window fix (every process schedules the same apply_at)."""

    def test_applies_at_exact_step(self, small_filter, rng):
        lf = small_filter
        mesh = make_mesh(n_channel=2, n_time=2)
        sharded = ShardedUpsampler(lf, mesh, channels=2)
        step_in = sharded.block_input_frames
        xs = [rng.normal(size=(2, step_in)).astype(np.float32) * 0.3
              for _ in range(5)]
        eq = np.full(sharded.config.n_bins, 0.5, np.float64)
        at = sharded.schedule_swap(eq_response=eq, apply_at_step=3)
        assert at == 3
        got = [sharded.process_block(x) for x in xs]

        # Reference: immediate swap exactly between step 3 and step 4.
        ref_eng = ShardedUpsampler(lf, mesh, channels=2)
        ref = [ref_eng.process_block(x) for x in xs[:3]]
        ref_eng.set_eq(eq)
        ref += [ref_eng.process_block(x) for x in xs[3:]]
        for r, g in zip(ref, got):
            np.testing.assert_allclose(r, g, rtol=1e-5, atol=1e-7)
        assert sharded.swap_deadline_misses == 0
        assert sharded.step_index == 5

    def test_scheduled_swap_fades_at_boundary(self, small_filter, rng):
        """The crossfade arms at the scheduled boundary and equals the
        single-device engine's faded output at the same junction."""
        lf = small_filter
        mesh = make_mesh(n_channel=1, n_time=4)
        fade = 256
        sharded = ShardedUpsampler(lf, mesh, channels=2,
                                   swap_fade_frames=fade)
        single = StreamingUpsampler(lf, channels=2, swap_fade_frames=fade)
        step_in = sharded.block_input_frames
        xs = [rng.normal(size=(2, step_in)).astype(np.float32) * 0.3
              for _ in range(3)]
        eq = np.full(sharded.config.n_bins, 0.5, np.float64)
        sharded.schedule_swap(eq_response=eq, apply_at_step=2)
        y0 = sharded.process_block(xs[0])
        np.testing.assert_allclose(y0, single.process_block(xs[0]),
                                   rtol=1e-5, atol=1e-7)
        y1 = sharded.process_block(xs[1])
        np.testing.assert_allclose(y1, single.process_block(xs[1]),
                                   rtol=1e-5, atol=1e-7)
        single.set_eq(eq)  # immediate on the single engine = boundary 2
        y2 = sharded.process_block(xs[2])
        np.testing.assert_allclose(y2, single.process_block(xs[2]),
                                   rtol=1e-4, atol=1e-6)

    def test_default_margin_stamps_future_step(self, small_filter, rng):
        from totton_tpu.parallel.sharded import SWAP_MARGIN_STEPS

        lf = small_filter
        mesh = make_mesh(n_channel=1, n_time=2)
        sharded = ShardedUpsampler(lf, mesh, channels=2)
        x = rng.normal(
            size=(2, sharded.block_input_frames)).astype(np.float32)
        sharded.process_block(x)
        at = sharded.schedule_swap(
            eq_response=np.full(sharded.config.n_bins, 0.5))
        assert at == 1 + SWAP_MARGIN_STEPS

    def test_deadline_miss_applies_late_and_counts(self, small_filter, rng,
                                                   capsys):
        lf = small_filter
        mesh = make_mesh(n_channel=1, n_time=2)
        sharded = ShardedUpsampler(lf, mesh, channels=2)
        step_in = sharded.block_input_frames
        x = rng.normal(size=(2, step_in)).astype(np.float32) * 0.3
        for _ in range(4):
            sharded.process_block(x)
        eq = np.full(sharded.config.n_bins, 0.5, np.float64)
        sharded.schedule_swap(eq_response=eq, apply_at_step=2)  # passed
        y = sharded.process_block(x)
        assert sharded.swap_deadline_misses == 1
        ref = ShardedUpsampler(lf, mesh, channels=2, eq_response=eq)
        for _ in range(4):
            ref.process_block(x)
        np.testing.assert_allclose(y, ref.process_block(x), rtol=1e-5,
                                   atol=1e-7)

    def test_deadline_miss_bounded_divergence_across_processes(
            self, small_filter, rng):
        """A follower whose control fan-out arrives one step late applies
        the swap at its NEXT boundary: exactly one step diverges from the
        leader, the miss is counted, and — because the carried tail is
        input-domain, spectrum-independent — the very next step
        re-converges sample-exactly. No deadlock anywhere (the whole
        sequence completes synchronously)."""
        lf = small_filter
        mesh = make_mesh(n_channel=1, n_time=2)
        leader = ShardedUpsampler(lf, mesh, channels=2)
        follower = ShardedUpsampler(lf, mesh, channels=2)
        step_in = leader.block_input_frames
        xs = [rng.normal(size=(2, step_in)).astype(np.float32) * 0.3
              for _ in range(5)]
        eq = np.full(leader.config.n_bins, 0.5, np.float64)

        # Leader: schedules before its step-3 dispatch; lands on time.
        leader_out = [leader.process_block(x) for x in xs[:3]]
        leader.schedule_swap(eq_response=eq, apply_at_step=3)
        leader_out += [leader.process_block(x) for x in xs[3:]]
        assert leader.swap_deadline_misses == 0

        # Follower: the published event arrives AFTER its step-3 dispatch
        # (deliberate control-plane delay), so apply_at_step=3 is already
        # in the past when it schedules.
        follower_out = [follower.process_block(x) for x in xs[:4]]
        follower.schedule_swap(eq_response=eq, apply_at_step=3)
        follower_out += [follower.process_block(x) for x in xs[4:]]
        assert follower.swap_deadline_misses == 1

        # Steps 0-2 identical; step 3 is the bounded divergence window
        # (leader swapped, follower not yet); step 4 re-converges exactly.
        for i in (0, 1, 2):
            np.testing.assert_array_equal(leader_out[i], follower_out[i])
        assert not np.allclose(leader_out[3], follower_out[3])
        np.testing.assert_array_equal(leader_out[4], follower_out[4])

    def test_newer_schedule_replaces_pending(self, small_filter, rng):
        lf = small_filter
        mesh = make_mesh(n_channel=1, n_time=2)
        sharded = ShardedUpsampler(lf, mesh, channels=2)
        step_in = sharded.block_input_frames
        x = rng.normal(size=(2, step_in)).astype(np.float32) * 0.3
        sharded.schedule_swap(
            eq_response=np.full(sharded.config.n_bins, 0.25), apply_at_step=1)
        eq = np.full(sharded.config.n_bins, 0.5, np.float64)
        sharded.schedule_swap(eq_response=eq, apply_at_step=1)
        sharded.process_block(x)
        y = sharded.process_block(x)
        ref = ShardedUpsampler(lf, mesh, channels=2)
        ref.process_block(x)
        ref.set_eq(eq)
        np.testing.assert_allclose(y, ref.process_block(x), rtol=1e-5,
                                   atol=1e-7)

    def test_geometry_mismatch_rejected(self, small_filter):
        from totton_tpu.filters.sidecar import FilterSidecar, LoadedFilter

        mesh = make_mesh(n_channel=1, n_time=2)
        sharded = ShardedUpsampler(small_filter, mesh, channels=2)
        other = LoadedFilter(
            taps=np.zeros(17, np.float32),
            sidecar=FilterSidecar(coefficients_bin="<x>", taps=17,
                                  fft_size=64, block_size=48,
                                  upsample_factor=4))
        with pytest.raises(ValueError, match="geometry"):
            sharded.schedule_swap(filt=other)


def test_single_device_mesh_exactly_equals_plain_engine(small_filter, rng):
    """A 1x1 mesh resolves to the PLAIN step program (the shard_map
    wrapper adds a fixed per-step cost for zero semantic effect); the
    sharded engine must stay bit-identical to
    StreamingUpsampler there, including streaming state and fades."""
    import jax

    lf = small_filter
    mesh = make_mesh(n_channel=1, n_time=1, devices=jax.devices()[:1])
    fade = 128
    sharded = ShardedUpsampler(lf, mesh, channels=2, swap_fade_frames=fade)
    plain = StreamingUpsampler(lf, channels=2, swap_fade_frames=fade)
    step_in = sharded.block_input_frames
    xs = [(rng.normal(size=(2, step_in)) * 0.3).astype(np.float32)
          for _ in range(3)]
    np.testing.assert_array_equal(sharded.process_block(xs[0]),
                                  plain.process_block(xs[0]))
    eq = np.full(sharded.config.n_bins, 0.5, np.float64)
    sharded.set_eq(eq)
    plain.set_eq(eq)
    for x in xs[1:]:
        np.testing.assert_allclose(sharded.process_block(x),
                                   plain.process_block(x),
                                   rtol=1e-6, atol=1e-7)
