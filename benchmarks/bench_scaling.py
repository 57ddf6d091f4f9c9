"""Sharded-step sweep across mesh sizes.

Runs the sharded streaming step at time-mesh sizes 1, 2, 4, ... N and
reports throughput per size. On a virtual CPU mesh the "efficiency" column
reflects host thread scheduling, not interconnect behavior — treat it as a
correctness/scaling-shape sweep only. On a multi-GPU host the same script
exercises the NVLink halo exchange (one ppermute of (taps-1)/ratio x 4 B
per channel per step).

  TOTTON_PLATFORM=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python -m benchmarks.bench_scaling
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import totton_tpu  # noqa: F401  (applies TOTTON_PLATFORM before JAX init)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--taps", type=int, default=4001)
    p.add_argument("--fft", type=int, default=16384)
    p.add_argument("--ratio", type=int, default=16)
    p.add_argument("--channels", type=int, default=2)
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from benchmarks.bench_configs import _loaded_filter
    from totton_tpu.parallel import ShardedUpsampler, make_mesh

    devices = jax.devices()
    print(f"platform: {devices[0].platform} x{len(devices)}", file=sys.stderr)
    if devices[0].platform == "cpu":
        print(
            "note: virtual CPU devices share physical cores — efficiency "
            "here measures host-core contention, not the interconnect; "
            "it validates correctness/compilation of the sharded path, "
            "not scaling. Run on a multi-GPU host for scaling numbers.",
            file=sys.stderr,
        )

    lf = _loaded_filter(args.taps, args.ratio, args.fft)
    sizes = []
    n = 1
    while n <= len(devices):
        sizes.append(n)
        n *= 2

    # Fixed per-device work: T_local constant, so perfect scaling = flat
    # time; report throughput and efficiency.
    base_sps = None
    rng = np.random.default_rng(0)
    for n_time in sizes:
        mesh = make_mesh(n_channel=1, n_time=n_time,
                         devices=devices[:n_time])
        ups = ShardedUpsampler(lf, mesh, channels=args.channels)
        per_shard = ups.config.block_in * 8
        while per_shard < ups.config.halo_in:
            per_shard *= 2
        t = per_shard * n_time
        from jax.sharding import NamedSharding, PartitionSpec as P

        x = jax.device_put(
            (rng.normal(size=(args.channels, t)) * 0.3).astype(np.float32),
            NamedSharding(mesh, P("channel", "time")))
        tail, spec = ups._tail, ups._spectrum
        step = ups._step

        # Chained evaluations inside one jit. Operands are jit arguments,
        # not closure constants.
        def chain(a0, tl, xa, sp):
            def body(acc, _):
                y, _tail = step(tl, xa * (1.0 + 1e-6 * acc), sp)
                return acc + jnp.sum(jnp.abs(y)), None

            return jax.lax.scan(body, a0, None, length=args.iters)[0]

        fused = jax.jit(chain)
        v = float(fused(jnp.float32(0), tail, x, spec))
        assert np.isfinite(v) and v != 0
        best = float("inf")
        for trial in range(3):
            t0 = time.monotonic()
            float(fused(jnp.float32(trial * 1e-6), tail, x, spec))
            best = min(best, time.monotonic() - t0)
        sps = args.channels * t * args.ratio * args.iters / best
        if base_sps is None:
            base_sps = sps
        eff = sps / (base_sps * n_time)
        import jax as _jax

        virtual = _jax.devices()[0].platform == "cpu"
        print(json.dumps({
            "devices": n_time,
            "samples_per_s": round(sps, 1),
            "per_device_samples_per_s": round(sps / n_time, 1),
            # On a virtual CPU mesh this measures host thread scheduling,
            # not the interconnect — see module docstring.
            ("host_thread_efficiency" if virtual else "scaling_efficiency"):
                round(eff, 3),
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
