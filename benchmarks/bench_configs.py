"""Benchmark the five BASELINE.json configurations.

Each config prints one JSON line {"config", "samples_per_s", "realtime_x",
...}. Runs on whatever JAX platform is active (the GPU by default;
TOTTON_PLATFORM=cpu for a smoke run).

Measurement methodology: every timed region is K chained pipeline
evaluations inside one jit — iteration i+1's input depends on iteration
i's full output through a scalar reduction — closed by a host read of the
final scalar.

  python -m benchmarks.bench_configs [--quick]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import totton_tpu  # noqa: F401  (applies TOTTON_PLATFORM before JAX init)
from totton_tpu.io.stream import OFFLINE_BATCH_BLOCKS

K_CHAIN = 10


def _taps(n_taps: int, ratio: int) -> np.ndarray:
    n = np.arange(n_taps) - (n_taps - 1) / 2
    h = np.sinc(n / ratio) * np.kaiser(n_taps, 25.0)
    return h * (ratio * 0.99 / h.sum())


def _loaded_filter(taps: int, ratio: int, fft_size: int):
    from totton_tpu.filters.sidecar import FilterSidecar, LoadedFilter

    return LoadedFilter(
        taps=_taps(taps, ratio).astype(np.float32),
        sidecar=FilterSidecar(
            coefficients_bin="<bench>", taps=taps, fft_size=fft_size,
            block_size=fft_size - (taps - 1), upsample_factor=ratio,
        ),
    )


def _measure_chained(step_y, out_samples_per_iter: int, *operands,
                     k_chain: int = K_CHAIN) -> float:
    """step_y(scale_scalar, *operands) -> output array. Returns samples/s
    over k_chain chained evaluations (best of 3). Configs with small
    per-iteration work pass a longer chain so the fused call's fixed
    host round-trip amortizes the same way it does for the deep-batch
    configs.

    Operands enter the jit as ARGUMENTS, not closure constants: closed-over
    arrays get baked into the compiled executable as constants."""
    import jax
    import jax.numpy as jnp

    def chain(a0, *ops):
        def body(acc, _):
            y = step_y(1.0 + 1e-6 * acc, *ops)
            return acc + jnp.sum(jnp.abs(y)), None

        return jax.lax.scan(body, a0, None, length=k_chain)[0]

    fused = jax.jit(chain)
    v = float(fused(jnp.float32(0), *operands))
    assert np.isfinite(v) and v != 0, "bad bench output"
    best = float("inf")
    for trial in range(3):
        t0 = time.monotonic()
        float(fused(jnp.float32(1e-6 * trial), *operands))
        best = min(best, time.monotonic() - t0)
    return out_samples_per_iter * k_chain / best


def _geom(quick: bool, q_taps: int = 8001, q_fft: int = 16384):
    return (q_taps, q_fft) if quick else (80001, 131072)


def bench_stereo_2x(quick: bool) -> dict:
    """Config 1: stereo 2x upsample, bundled-geometry 80k-tap filter."""
    import jax.numpy as jnp

    from totton_tpu.ops.overlap_save import (
        OverlapSaveConfig, filter_spectrum, upsample_blocks,
    )

    taps, fft = _geom(quick)
    cfg = OverlapSaveConfig(taps=taps, fft_size=fft,
                            block_size=fft - (taps - 1), ratio=2)
    spec = filter_spectrum(_taps(taps, 2), fft)
    blocks = OFFLINE_BATCH_BLOCKS  # the shipped offline dispatch granule
    rng = np.random.default_rng(0)
    x = jnp.asarray(
        (rng.normal(size=(2, cfg.halo_in + blocks * cfg.block_in)) * 0.3)
        .astype(np.float32))
    sps = _measure_chained(
        lambda s, xa, sp: upsample_blocks(xa * s, sp, cfg),
        2 * blocks * cfg.block_size, x, spec)
    return {"config": "stereo_2x_80k", "samples_per_s": sps,
            "realtime_x": sps / (2 * 705600)}


def bench_4x_eq(quick: bool) -> dict:
    """Config 2: 48k family 4x + OPRA-style EQ baked into the spectrum."""
    import jax.numpy as jnp

    from totton_tpu.eq.apo import parse_eq_string
    from totton_tpu.eq.biquad import profile_response_for_fft
    from totton_tpu.ops.overlap_save import (
        OverlapSaveConfig, filter_spectrum, upsample_blocks,
    )

    taps, fft = _geom(quick)
    cfg = OverlapSaveConfig(taps=taps, fft_size=fft,
                            block_size=fft - (taps - 1), ratio=4)
    profile = parse_eq_string(
        "Preamp: -6.4 dB\n"
        "Filter 1: ON PK Fc 200 Hz Gain -2 dB Q 0.6\n"
        "Filter 2: ON LS Fc 105 Hz Gain 4 dB Q 0.7\n"
        "Filter 3: ON HS Fc 8000 Hz Gain -1.5 dB Q 0.7\n"
    )
    eq = profile_response_for_fft(profile, fft, 768000.0)
    spec = filter_spectrum(_taps(taps, 4), fft, eq_response=eq)
    blocks = OFFLINE_BATCH_BLOCKS  # the shipped offline dispatch granule
    rng = np.random.default_rng(0)
    x = jnp.asarray(
        (rng.normal(size=(2, cfg.halo_in + blocks * cfg.block_in)) * 0.3)
        .astype(np.float32))
    sps = _measure_chained(
        lambda s, xa, sp: upsample_blocks(xa * s, sp, cfg),
        2 * blocks * cfg.block_size, x, spec)
    return {"config": "48k_4x_opra_eq", "samples_per_s": sps,
            "realtime_x": sps / (2 * 768000)}


def bench_16x(quick: bool) -> dict:
    """Config 3: 16x 80k-tap single chip (the headline; see bench.py)."""
    import jax.numpy as jnp

    from totton_tpu.ops.overlap_save import (
        OverlapSaveConfig, filter_spectrum, upsample_blocks,
    )

    taps, fft = _geom(quick)
    cfg = OverlapSaveConfig(taps=taps, fft_size=fft,
                            block_size=fft - (taps - 1), ratio=16)
    spec = filter_spectrum(_taps(taps, 16), fft)
    blocks = 16 if quick else OFFLINE_BATCH_BLOCKS
    rng = np.random.default_rng(0)
    x = jnp.asarray(
        (rng.normal(size=(2, cfg.halo_in + blocks * cfg.block_in)) * 0.3)
        .astype(np.float32))
    sps = _measure_chained(
        lambda s, xa, sp: upsample_blocks(xa * s, sp, cfg),
        2 * blocks * cfg.block_size, x, spec)
    return {"config": "16x_80k_single_chip", "samples_per_s": sps,
            "realtime_x": sps / (2 * 705600)}


def bench_8ch_sharded(quick: bool) -> dict:
    """Config 4: 8-channel 8x, channels sharded across available devices."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from totton_tpu.parallel import ShardedUpsampler, make_mesh

    taps, fft = _geom(quick, q_taps=4001, q_fft=8192)
    lf = _loaded_filter(taps, 8, fft)
    n_dev = len(jax.devices())
    n_channel = min(8, n_dev)
    mesh = make_mesh(n_channel=n_channel, n_time=1,
                     devices=jax.devices()[:n_channel])
    ups = ShardedUpsampler(lf, mesh, channels=8)
    per_step = ups.step_input_frames * OFFLINE_BATCH_BLOCKS
    while per_step < ups.config.halo_in:
        per_step *= 2
    rng = np.random.default_rng(0)
    x = jax.device_put(
        (rng.normal(size=(8, per_step)) * 0.3).astype(np.float32),
        NamedSharding(mesh, P("channel", "time")))
    tail, step, spec = ups._tail, ups._step, ups._spectrum
    sps = _measure_chained(
        lambda s, t, xa, sp: step(t, xa * s, sp)[0],
        8 * per_step * 8, tail, x, spec)
    return {"config": "8ch_8x_channel_sharded", "devices": n_channel,
            "samples_per_s": sps, "realtime_x": sps / (8 * 705600)}


def bench_streaming_reload(quick: bool) -> dict:
    """Config 5: streaming 16x with live EQ RELOAD mid-stream, channels x
    time sharded. Measures chained steady state and verifies the reload
    (new spectrum as a traced arg) changes output without recompiling.

    Granule: 32 blocks per step (the live streamer's dispatch granule).
    A realtime source accumulates ~2.3 s of audio per granule; RELOAD
    latency is one in-flight pipeline depth x step time."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from totton_tpu.parallel import ShardedUpsampler, make_mesh

    taps, fft = _geom(quick, q_taps=4001, q_fft=8192)
    lf = _loaded_filter(taps, 16, fft)
    n_dev = len(jax.devices())
    n_time = max(1, n_dev // 2)
    mesh = make_mesh(n_channel=min(2, n_dev), n_time=n_time)
    ups = ShardedUpsampler(lf, mesh, channels=2)
    per_step = ups.step_input_frames * 32
    while per_step // mesh.shape["time"] < ups.config.halo_in:
        per_step *= 2
    rng = np.random.default_rng(0)
    x = jax.device_put(
        (rng.normal(size=(2, per_step)) * 0.3).astype(np.float32),
        NamedSharding(mesh, P("channel", "time")))
    tail, step = ups._tail, ups._step
    # 60x less work per iteration than the batch configs: chain longer
    # so the fixed per-call round-trip amortizes equally (see
    # _measure_chained).
    sps = _measure_chained(
        lambda s, t, xa, sp: step(t, xa * s, sp)[0],
        2 * per_step * 16, tail, x, ups._spectrum, k_chain=60)

    # Live RELOAD: swap the EQ and run one consumed step through the same
    # jitted callable (traced operand -> no recompile).
    s0 = float(jnp.sum(jnp.abs(step(tail, x, ups._spectrum)[0])))
    ups.set_eq(np.full(ups.config.n_bins, 0.5))
    t0 = time.monotonic()
    s1 = float(jnp.sum(jnp.abs(step(tail, x, ups._spectrum)[0])))
    reload_ms = (time.monotonic() - t0) * 1e3
    assert abs(s1 - 0.5 * s0) / s0 < 1e-3, "EQ hot-swap wrong output"
    return {"config": "streaming_16x_live_reload_sharded",
            "mesh": dict(mesh.shape), "samples_per_s": sps,
            "realtime_x": sps / (2 * 705600),
            "reload_step_ms": round(reload_ms, 1)}


BENCHES = [bench_stereo_2x, bench_4x_eq, bench_16x, bench_8ch_sharded,
           bench_streaming_reload]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--quick", action="store_true",
                   help="small filters (CI smoke)")
    args = p.parse_args(argv)
    import jax

    print(f"platform: {jax.devices()[0].platform} x{len(jax.devices())}",
          file=sys.stderr)
    for bench in BENCHES:
        result = bench(args.quick)
        result["samples_per_s"] = round(result["samples_per_s"], 1)
        result["realtime_x"] = round(result["realtime_x"], 1)
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
