"""GPU smoke test: the main path end to end at production width on one card.

  python chip_smoke.py          # one GPU: every phase below
  python chip_smoke.py --four   # four GPUs: only the sharded streamer

Phases (each prints one result line; any failure exits non-zero and no
result line is printed):

1. device  — JAX must see a GPU (no CPU fallback); prints nvidia-smi's
   name and power limit, jax/jaxlib versions and XLA_FLAGS.
2. oracle  — StreamingUpsampler.from_file on 32 blocks of seeded noise at
   16x/80k, 2x/80k, 16x/8k and 1-block dispatches (the serve shape),
   each against a float64 oracle (scipy of the zero-stuffed input);
   gate >= 125 dB, which also catches a float32 product that dropped to
   TF32.
3. file    — totton-stream in-process on a seeded 10 s 44.1 kHz stereo WAV
   at 16x/80k: s32 output against the oracle at the same gate, and s16
   output quantized on the device (ops/device_pcm.py) bit for bit
   against the host conversion (io/pcm.float_to_pcm) of the same
   engine output.
4. serve   — an in-process StreamServer at 16x/80k with four concurrent
   ServeClient streams of 2 s each, every reply against
   engine.upsample_signal of the same input.
5. gpu tests — the tests marked ``gpu`` in tests/test_gpu.py.
6. rate    — output samples/s at 16x stereo, 1024 blocks per dispatch
   (information, not a gate).

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
COEF = os.path.join(ROOT, "data", "coefficients")
BANK_16X = os.path.join(COEF, "filter_44k_16x_80000_min_phase.json")
BANK_2X = os.path.join(COEF, "filter_44k_2x_80000_min_phase.json")
BANK_16X_8K = os.path.join(COEF, "filter_44k_16x_8000_min_phase.json")
RATE = 44100
SNR_GATE_DB = 125.0


def log(msg: str) -> None:
    print(msg, flush=True)


def snr_db(y: np.ndarray, ref: np.ndarray) -> float:
    noise = np.asarray(y, np.float64) - ref
    return float(10 * np.log10(np.sum(ref ** 2)
                               / max(np.sum(noise ** 2), 1e-300)))


def oracle(x: np.ndarray, taps: np.ndarray, ratio: int) -> np.ndarray:
    """float64 reference: zero-stuff [channels, n] and convolve with the
    taps; returns [channels, n * ratio] (stream starts from silence)."""
    from scipy import signal as ssig

    up = np.zeros((x.shape[0], x.shape[1] * ratio))
    up[:, ::ratio] = x
    full = ssig.oaconvolve(up, np.asarray(taps, np.float64)[None], axes=-1)
    return full[:, : x.shape[1] * ratio]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(msg)


def gate(name: str, value: float) -> None:
    if not value >= SNR_GATE_DB:
        raise SystemExit(f"{name}: SNR {value:.2f} dB below the "
                         f"{SNR_GATE_DB} dB gate")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def phase_device(want: int):
    import jax
    import jaxlib

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {devs[0].platform!r}")
    if len(devs) < want:
        raise SystemExit(f"need {want} GPUs, JAX sees {len(devs)}")
    log(f"[device] {devs[0].device_kind} x{len(devs)}; nvidia-smi: "
        f"{nvidia_smi()!r}; jax {jax.__version__} jaxlib "
        f"{jaxlib.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return devs


def phase_oracle() -> None:
    from totton_tpu.engine.upsampler import StreamingUpsampler

    rng = np.random.default_rng(1)
    cases = [("16x_80k", BANK_16X, 32, 32), ("2x_80k", BANK_2X, 32, 32),
             ("16x_8k", BANK_16X_8K, 32, 32), ("16x_80k_1blk", BANK_16X, 32, 1)]
    parts = []
    for name, path, blocks, per_dispatch in cases:
        eng = StreamingUpsampler.from_file(path, channels=2)
        n = blocks * eng.block_input_frames
        x = (rng.normal(size=(2, n)) * 0.3).astype(np.float32)
        step = per_dispatch * eng.block_input_frames
        y = np.concatenate([eng.process_block(x[:, i:i + step])
                            for i in range(0, n, step)], axis=1)
        check(y.shape == (2, n * eng.ratio) and np.isfinite(y).all(),
              f"{name}: output shape {y.shape} or non-finite values")
        s = snr_db(y, oracle(x, eng.filter.taps, eng.ratio))
        gate(name, s)
        parts.append(f"{name} {s:.2f} dB")
    log(f"[oracle] SNR vs float64 (gate {SNR_GATE_DB} dB): "
        + ", ".join(parts))


def phase_file(tmp: str) -> None:
    from totton_tpu.cli import stream as stream_cli
    from totton_tpu.filters.sidecar import load_filter
    from totton_tpu.io.pcm import PcmFormat
    from totton_tpu.io.wav import read_wav, write_wav

    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 10 * RATE)) * 0.1).astype(np.float32)
    in_wav = os.path.join(tmp, "in.wav")
    write_wav(in_wav, x, RATE, PcmFormat.S32_LE)
    x, _ = read_wav(in_wav)  # what the CLI will read
    taps = load_filter(BANK_16X).taps

    outs = {}
    for tag, fmt, dev_pcm in (("s32", "s32", "off"), ("s16_dev", "s16", "on"),
                              ("s16_host", "s16", "off")):
        path = os.path.join(tmp, f"out_{tag}.wav")
        rc = stream_cli.main(["--in", in_wav, "--out", path, "--filter",
                              BANK_16X, "--format", fmt,
                              "--device-pcm", dev_pcm])
        if rc != 0:
            raise SystemExit(f"totton-stream ({tag}) exited {rc}")
        outs[tag] = path
    y, out_rate = read_wav(outs["s32"])
    check(out_rate == 16 * RATE and y.shape == (2, x.shape[1] * 16),
          f"file: output {y.shape} at {out_rate} Hz")
    s = snr_db(y, oracle(x, taps, 16))
    gate("file s32", s)
    # s16: the device quantizer against the host conversion of the same
    # engine output (the off run's sink applies io/pcm.float_to_pcm to
    # the float32 engine output of identical dispatches).
    import wave

    raw = {}
    for tag in ("s16_dev", "s16_host"):
        with wave.open(outs[tag], "rb") as w:
            raw[tag] = w.readframes(w.getnframes())
    if raw["s16_dev"] != raw["s16_host"]:
        a = np.frombuffer(raw["s16_dev"], "<i2")
        b = np.frombuffer(raw["s16_host"], "<i2")
        raise SystemExit(f"device s16 differs from host float_to_pcm at "
                         f"{int(np.sum(a != b))} of {a.size} samples")
    log(f"[file] totton-stream 10 s 16x stereo: s32 SNR {s:.2f} dB; s16 "
        f"device == host float_to_pcm bit for bit ({len(raw['s16_dev'])} "
        "bytes)")


def phase_serve() -> None:
    from totton_tpu.engine.upsampler import upsample_signal
    from totton_tpu.filters.sidecar import load_filter
    from totton_tpu.io.serve_client import ServeClient
    from totton_tpu.serve import StreamServer

    filt = load_filter(BANK_16X)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = StreamServer(filt, f"tcp-listen://127.0.0.1:{port}", RATE,
                          max_streams=4, channels=2)
    server.start()
    rng = np.random.default_rng(3)
    xs = [(rng.normal(size=(2, 2 * RATE)) * 0.3).astype(np.float32)
          for _ in range(4)]
    replies: list = [None] * 4
    errors: list = []

    def run(i: int) -> None:
        try:
            with ServeClient(f"tcp://127.0.0.1:{port}", 2, RATE) as c:
                replies[i] = c.upsample(xs[i])
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads):
            raise SystemExit("serve: a client did not finish in 300 s")
    finally:
        server.drain(timeout_s=30)
        server.stop()
    worst_rel, worst_snr = 0.0, np.inf
    for x, y in zip(xs, replies):
        ref = upsample_signal(x, filt)
        check(y.shape == ref.shape == (2, x.shape[1] * 16),
              f"serve: reply {y.shape}, upsample_signal {ref.shape}")
        # The server batches rows of several streams into dispatches of
        # other shapes than upsample_signal's one call, so the two differ
        # by float32 rounding only: each sits >= 125 dB from the float64
        # oracle, i.e. ~1e-6 of the signal's RMS.
        worst_rel = max(worst_rel,
                        float(np.max(np.abs(y - ref)) / np.max(np.abs(ref))))
        worst_snr = min(worst_snr, snr_db(y, oracle(x, filt.taps, 16)))
    if worst_rel > 1e-5:
        raise SystemExit(f"serve: reply differs from upsample_signal by "
                         f"{worst_rel:.3g} of peak (> 1e-5)")
    gate("serve", worst_snr)
    log(f"[serve] 4 concurrent 2 s streams at 16x: max |reply - "
        f"upsample_signal| = {worst_rel:.3g} of peak (tolerance 1e-5); "
        f"worst SNR vs float64 {worst_snr:.2f} dB")


def phase_gpu_tests() -> None:
    path = os.path.join(ROOT, "tests", "test_gpu.py")
    spec = importlib.util.spec_from_file_location("_gpu_tests", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    names = sorted(n for n in vars(mod) if n.startswith("test_"))
    for n in names:
        getattr(mod, n)()
    log(f"[gpu tests] {len(names)} passed: {', '.join(names)}")


def phase_rate(card: str) -> None:
    import jax

    from totton_tpu.engine.upsampler import StreamingUpsampler
    from totton_tpu.ops.overlap_save import filter_spectrum, make_block_step

    eng = StreamingUpsampler.from_file(BANK_16X, channels=2)
    blocks, k = 1024, 10
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, blocks * eng.block_input_frames)) * 0.3).astype(
        np.float32)
    out = 2 * blocks * eng.config.block_size
    # Engine dispatches (host input copied in per dispatch, output left on
    # the device): dispatch_block is what the file pipeline calls.
    jax.block_until_ready(eng.dispatch_block(x)[0])
    t0 = time.perf_counter()
    for _ in range(k):
        handle = eng.dispatch_block(x)
    jax.block_until_ready(handle[0])
    engine_rate = out * k / (time.perf_counter() - t0)
    # The jitted step alone on device-resident input.
    step = make_block_step(eng.config)
    xd = jax.device_put(x)
    tail = jax.device_put(np.zeros((2, eng.config.halo_in), np.float32))
    spec = filter_spectrum(eng.filter.taps, eng.config.fft_size)
    jax.block_until_ready(step(tail, xd, spec))
    best = np.inf
    for _ in range(3):
        t = tail
        t0 = time.perf_counter()
        for _i in range(k):
            y, t = step(t, xd, spec)
        y.block_until_ready()
        best = min(best, time.perf_counter() - t0)
    log(f"[rate] {card}: 16x stereo, {blocks} blocks/dispatch: device step "
        f"{out * k / best:.6g} output samples/s ({best / k * 1e3:.4g} ms "
        f"per dispatch); engine dispatch_block with host input "
        f"{engine_rate:.6g} samples/s")


def phase_four() -> None:
    """ShardedUpsampler, 8 channels on a 2x2 (channel, time) mesh of four
    GPUs, against the one-device engine on the same input."""
    import jax

    from totton_tpu.engine.upsampler import StreamingUpsampler
    from totton_tpu.filters.sidecar import load_filter
    from totton_tpu.parallel import ShardedUpsampler, make_mesh

    filt = load_filter(BANK_16X)
    mesh = make_mesh(n_channel=2, n_time=2, devices=jax.devices()[:4])
    ups = ShardedUpsampler(filt, mesh, channels=8)
    ref_eng = StreamingUpsampler(filt, channels=8)
    rng = np.random.default_rng(5)
    steps = 6
    per = ups.block_input_frames
    x = (rng.normal(size=(8, steps * per)) * 0.3).astype(np.float32)
    ys, refs = [], []
    for i in range(steps):
        chunk = x[:, i * per:(i + 1) * per]
        ys.append(ups.process_block(chunk))
        refs.append(ref_eng.process_block(chunk))
    y, ref = np.concatenate(ys, axis=1), np.concatenate(refs, axis=1)
    check(y.shape == ref.shape == (8, steps * per * 16),
          f"four: sharded {y.shape}, one-device {ref.shape}")
    rel = float(np.max(np.abs(y - ref)) / np.max(np.abs(ref)))
    # Same transform on other dispatch shapes (each shard runs half the
    # blocks of half the channels), so float32 rounding only.
    if rel > 1e-5:
        raise SystemExit(f"sharded vs one-device engine: {rel:.3g} of peak "
                         "(> 1e-5)")
    s = snr_db(y[:1], oracle(x[:1], filt.taps, 16))
    gate("sharded", s)
    t0 = time.perf_counter()
    for i in range(steps):
        jax.block_until_ready(
            ups.dispatch_block(x[:, i * per:(i + 1) * per])[0])
    dt = (time.perf_counter() - t0) / steps
    log(f"[four] ShardedUpsampler 8 ch on 2x2 mesh, {steps} steps of {per} "
        f"frames: max |sharded - one-device| = {rel:.3g} of peak "
        f"(tolerance 1e-5); ch0 SNR vs float64 {s:.2f} dB; "
        f"{dt * 1e3:.4g} ms per step (host input, output on device)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded streamer on four GPUs")
    args = ap.parse_args(argv)

    devs = phase_device(4 if args.four else 1)
    import totton_tpu  # noqa: F401  (compile-cache setup)

    card = nvidia_smi()
    if args.four:
        phase_four()
    else:
        phase_oracle()
        with tempfile.TemporaryDirectory() as tmp:
            phase_file(tmp)
        phase_serve()
        phase_gpu_tests()
        phase_rate(card.splitlines()[0])
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
