"""Multi-process FULL StreamSession e2e: 2 jax.distributed processes, each
running the real totton-stream CLI over its own channel rows, with the
control daemon on process 0 hot-swapping EQ mid-stream and the published
event fanning out to process 1's follower.

Topology (channel-only mesh — the natural multi-host streaming layout,
zero-communication scaling):

  orchestrator ──paced stdin PCM──> worker 0 (leader: REQ/REP + PUB) ──> out0.wav
               ──paced stdin PCM──> worker 1 (follower: SUB)         ──> out1.wav
               ──RELOAD @ half-stream──> leader ──publish──> follower

Each worker is `python -m totton_tpu.cli.stream --distributed
--shard-time 1 --shard-channel 8` on 4 virtual CPU devices; --channels 8
is the GLOBAL count, each feeds its 4 local rows. The swap is
STEP-SYNCHRONIZED (parallel/sharded.py schedule_swap): the leader stamps
apply_at_step, publishes it, and both processes apply the new spectrum at
that exact step boundary with the crossfade (--swap-fade) armed there.

Validation: every dispatch granule of BOTH outputs matches the float64
no-EQ oracle before the swap granule and the EQ (-12 dB preamp) oracle
after it; the swap granule itself matches the FADE oracle
(old*(1-ramp) + new*ramp, ramp anchored at the granule's first sample);
both processes swap at the SAME granule AND report the same scheduled
step — the round-4 Done criterion (no eventually-consistent window).

Run with no arguments: exits 0 iff validated (wired into the suite by
tests/test_multiprocess.py).
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

_ROOT = str(pathlib.Path(__file__).resolve().parent.parent)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import numpy as np

N_PROC = 2
DEV_PER_PROC = 4
CHANNELS = 8
RATE = 44100
GRANULES = 28          # total dispatch granules fed per worker
RELOAD_AT = 10         # granule after which RELOAD is sent
SWAP_FADE = 512        # output-frame crossfade at the scheduled boundary


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(coord_port: int | None = None) -> int:
    from totton_tpu.eq.apo import parse_eq_file
    from totton_tpu.eq.biquad import profile_response_for_fft
    from totton_tpu.engine.upsampler import upsample_signal
    from totton_tpu.filters.generate import generate_one
    from totton_tpu.filters.sidecar import load_filter
    from totton_tpu.io.pcm import PcmFormat, float_to_pcm, interleave
    from totton_tpu.io.wav import read_wav

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="totton_mp_"))
    coeff = tmp / "coeff"
    coeff.mkdir()
    generate_one("44k_2x", 2000, 25.0, 140.0, "minimum", str(coeff))
    filter_json = next(coeff.glob("filter_44k_2x_*.json"))
    lf = load_filter(filter_json)

    # EQ whose effect is unmistakable per-dispatch: -12 dB broadband.
    eq_path = tmp / "quiet.txt"
    eq_path.write_text("Preamp: -12 dB\n")
    config = tmp / "config.json"
    config.write_text(json.dumps({"eqEnabled": False}))

    coord = coord_port or _free_port()
    pub_port = _free_port()
    endpoint = f"ipc://{tmp}/mp_ctl.sock"

    # The dispatch granule each worker will use (channel-only mesh:
    # local granule == global granule; it must cover the halo).
    from totton_tpu.ops.overlap_save import OverlapSaveConfig

    cfg = OverlapSaveConfig.from_sidecar(lf.sidecar)
    mult = 1
    while mult * cfg.block_in < cfg.halo_in:
        mult *= 2
    granule = cfg.block_in * mult
    total = GRANULES * granule

    rng = np.random.default_rng(11)
    x8 = np.clip(rng.normal(size=(CHANNELS, total)) * 0.25,
                 -0.9, 0.9).astype(np.float32)

    env_base = dict(os.environ)
    env_base.update({
        "JAX_PLATFORMS": "cpu",
        "TOTTON_PLATFORM": "cpu",
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={DEV_PER_PROC}",
        "JAX_CPU_COLLECTIVES_IMPLEMENTATION": "gloo",
    })

    workers = []
    for pid in range(N_PROC):
        args = [
            sys.executable, "-m", "totton_tpu.cli.stream",
            "--in", "-", "--out", str(tmp / f"out{pid}.wav"),
            "--rate", str(RATE), "--channels", str(CHANNELS),
            "--format", "s32",
            "--filter", str(filter_json),
            "--ratio", "2",
            "--config", str(config),
            "--distributed",
            "--coordinator", f"127.0.0.1:{coord}",
            "--num-processes", str(N_PROC), "--process-id", str(pid),
            "--shard-time", "1", "--shard-channel", str(CHANNELS),
            "--swap-fade", str(SWAP_FADE),
            "--control-pub-endpoint", f"tcp://127.0.0.1:{pub_port}",
        ]
        if pid == 0:
            # Leader: serves REQ/REP and binds the PUB endpoint; followers
            # connect their SUB to the same address.
            args += ["--control-endpoint", endpoint]
        workers.append(subprocess.Popen(
            args, env=env_base, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))

    rows = [list(range(0, 4)), list(range(4, 8))]  # contiguous rectangles

    def feed(granule_idx: int) -> None:
        lo, hi = granule_idx * granule, (granule_idx + 1) * granule
        for pid, w in enumerate(workers):
            chunk = x8[rows[pid][0]: rows[pid][-1] + 1, lo:hi]
            w.stdin.write(float_to_pcm(interleave(chunk), PcmFormat.S32_LE))
            w.stdin.flush()

    rc = 0
    try:
        from totton_tpu.control.client import DaemonClient

        client = DaemonClient(endpoint=endpoint, timeout_ms=30000)

        # Feed the first granules; pacing lets every dispatch go out
        # block-at-a-time (stdin is a low-latency source).
        for g in range(RELOAD_AT):
            feed(g)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            if client.ping():
                break
            time.sleep(0.3)
        else:
            raise RuntimeError("leader never served PING")

        # Wait until the pre-reload audio has actually been dispatched:
        # both workers' stdin pipes drain as their sessions consume.
        time.sleep(2.0)

        config.write_text(json.dumps({
            "eqEnabled": True, "eqProfile": "quiet",
            "eqProfilePath": str(eq_path),
        }))
        r = client.reload_config()
        assert r.ok, r.raw
        print("RELOAD sent", flush=True)
        time.sleep(2.0)  # let the published event land on the follower

        for g in range(RELOAD_AT, GRANULES):
            feed(g)
        scheduled_steps = []
        for w in workers:
            w.stdin.close()
        for pid, w in enumerate(workers):
            out = w.stdout.read().decode()
            ok = w.wait(timeout=600) == 0
            print(f"--- worker {pid} rc={w.returncode}")
            import re

            m = re.search(r"Live reload scheduled at step (\d+)", out)
            if not ok or m is None:
                print(out[-4000:])
                rc = 1
            else:
                scheduled_steps.append(int(m.group(1)))
            if pid == 1 and "Control follower" not in out:
                print("follower banner missing:", out[-2000:])
                rc = 1
        # Step synchronization: leader and follower must have scheduled
        # the swap for the SAME engine step.
        if len(scheduled_steps) == N_PROC and len(set(scheduled_steps)) != 1:
            print(f"scheduled steps diverge: {scheduled_steps}")
            rc = 1
        elif scheduled_steps:
            print(f"both processes scheduled swap at step "
                  f"{scheduled_steps[0]}")
    except Exception as e:
        print(f"orchestration failed: {e}")
        for w in workers:
            if w.poll() is None:
                w.kill()
            print(w.stdout.read().decode()[-3000:])
        return 1

    if rc:
        return rc

    # ---- validation: piecewise oracle match per dispatch granule --------
    eq_resp = profile_response_for_fft(
        parse_eq_file(str(eq_path)), cfg.fft_size, RATE * cfg.ratio)
    swapped = []
    for pid in range(N_PROC):
        y, out_rate = read_wav(str(tmp / f"out{pid}.wav"))
        assert out_rate == RATE * 2, out_rate
        x_local = x8[rows[pid][0]: rows[pid][-1] + 1].astype(np.float64)
        # The workers' input was s32-quantized; negligible vs the gates.
        ref_old = upsample_signal(x_local, lf)
        ref_new = upsample_signal(x_local, lf, eq_response=eq_resp)
        assert y.shape == ref_old.shape, (y.shape, ref_old.shape)
        out_g = granule * cfg.ratio
        states = []
        for g in range(GRANULES):
            sl = slice(g * out_g, (g + 1) * out_g)

            def snr(ref, y_sl=None):
                y_here = y[:, sl] if y_sl is None else y_sl
                err = y_here - ref
                p = float(np.sum(ref ** 2))
                return 10 * np.log10(max(p, 1e-300)
                                     / max(float(np.sum(err ** 2)), 1e-300))
            s_old, s_new = snr(ref_old[:, sl]), snr(ref_new[:, sl])
            if s_old > 60 and s_old > s_new:
                states.append("old")
            elif s_new > 60 and s_new > s_old:
                states.append("new")
            else:
                # The swap granule: its first SWAP_FADE samples are the
                # crossfade ramp anchored at the granule's sample 0 (the
                # scheduled step boundary). Matching this oracle asserts
                # the swap landed at EXACTLY that output sample.
                ramp = (np.arange(SWAP_FADE) / SWAP_FADE).astype(np.float64)
                ref_fade = ref_new[:, sl].copy()
                ref_fade[:, :SWAP_FADE] = (
                    ref_old[:, sl][:, :SWAP_FADE] * (1.0 - ramp)
                    + ref_new[:, sl][:, :SWAP_FADE] * ramp)
                s_fade = snr(ref_fade)
                if s_fade > 60:
                    states.append("fade")
                else:
                    print(f"worker {pid} granule {g}: matches no oracle "
                          f"(old {s_old:.1f} dB, new {s_new:.1f} dB, "
                          f"fade {s_fade:.1f} dB)")
                    return 1
        # Monotone old -> fade -> new with all present (the fade granule
        # is where the scheduled boundary landed).
        if "fade" not in states or "old" not in states or \
                "new" not in states:
            print(f"worker {pid}: swap/fade not observed ({states})")
            return 1
        first_swap = states.index("fade")
        expect = (["old"] * first_swap + ["fade"]
                  + ["new"] * (GRANULES - first_swap - 1))
        if states != expect:
            print(f"worker {pid}: non-monotone swap ({states})")
            return 1
        swapped.append(first_swap)
        print(f"worker {pid}: faded swap at granule {first_swap}, "
              f"{states.count('old')} old + {states.count('new')} new, "
              "all granules > 60 dB SNR vs their oracle")

    if len(set(swapped)) != 1:
        print(f"swap landed at DIFFERENT granules across processes: "
              f"{swapped} — step synchronization failed")
        return 1
    print(f"stream_multiprocess: PASS (synchronized faded swap at "
          f"granule {swapped[0]} on all {N_PROC} processes)")
    return 0


if __name__ == "__main__":
    port = int(sys.argv[1]) if len(sys.argv) > 1 else None
    sys.exit(main(port))
