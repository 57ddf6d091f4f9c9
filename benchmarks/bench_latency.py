"""End-to-end stream latency per filter bank: accumulate + step + drain.

The end-to-end latency a live listener experiences per block is:

  accumulate : block_in / input_rate — the time the host must wait for a
               whole filter block of input to arrive (geometry-fixed;
               the reference's only bank carries >= 72 ms at 16x/44.1k);
  step+drain : wall time of one single-block engine dispatch measured to
               output-in-host-memory (device compute + the device->host
               read of one output block).

Methodology: real chip, one block per dispatch (the live-mode shape),
median + p90 over --reps synchronous process_block calls after warmup.
Numbers are only comparable within one run on one card (power limits and
clocks differ between cards).

Usage: python benchmarks/bench_latency.py [--ratio 16] [--reps 100]
       [--banks 80000,8000]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import totton_tpu  # noqa: F401,E402


def measure(json_path: str, rate: int, reps: int) -> dict:
    from totton_tpu.engine.upsampler import StreamingUpsampler
    from totton_tpu.filters.sidecar import load_filter

    lf = load_filter(json_path)
    eng = StreamingUpsampler(lf, channels=2)
    block_in = eng.config.block_in
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, block_in)) * 0.3).astype(np.float32)
    for _ in range(5):  # compile + warm
        eng.process_block(x)
    times = []
    for _ in range(reps):
        t0 = time.monotonic()
        y = eng.process_block(x)
        times.append(time.monotonic() - t0)
    assert y.shape == (2, eng.config.block_size)
    times_ms = np.asarray(times) * 1e3
    acc_ms = block_in / rate * 1e3
    return {
        "taps": lf.sidecar.taps,
        "fft": lf.sidecar.fft_size,
        "block_in": block_in,
        "accumulate_ms": round(acc_ms, 3),
        "step_drain_ms_p50": round(float(np.percentile(times_ms, 50)), 3),
        "step_drain_ms_p90": round(float(np.percentile(times_ms, 90)), 3),
        "total_ms_p50": round(
            acc_ms + float(np.percentile(times_ms, 50)), 3),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ratio", type=int, default=16)
    ap.add_argument("--rate", type=int, default=44100)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--banks", default="80000,8000")
    ap.add_argument("--filter-dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "data", "coefficients"))
    args = ap.parse_args()

    family = 44 if args.rate % 44100 == 0 else 48
    print(f"{'bank':>7} {'fft':>7} {'block_in':>8} {'accum ms':>9} "
          f"{'step+drain p50':>14} {'p90':>7} {'total p50':>10}")
    for taps in args.banks.split(","):
        path = os.path.join(
            args.filter_dir,
            f"filter_{family}k_{args.ratio}x_{taps}_min_phase.json")
        r = measure(path, args.rate, args.reps)
        print(f"{taps:>7} {r['fft']:>7} {r['block_in']:>8} "
              f"{r['accumulate_ms']:>9} {r['step_drain_ms_p50']:>14} "
              f"{r['step_drain_ms_p90']:>7} {r['total_ms_p50']:>10}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
