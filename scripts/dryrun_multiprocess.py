"""Multi-PROCESS sharded-engine dryrun: 2 processes x 4 virtual CPU devices.

Complements __graft_entry__.dryrun_multichip (single-process virtual mesh):
this validates the true multi-host path — jax.distributed init, per-process
local-shard ingest via jax.make_array_from_process_local_data (no host ever
holds the global signal), cross-process halo exchange through the gloo CPU
collectives, streaming continuity of the carried tail across steps, and
local-span output drainage — against a float64 scipy oracle.

Run with no arguments: spawns both workers, waits, exits 0 iff both
validated.  (tests/test_multiprocess.py wires this into the suite.)
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import time

# Run as a script path (`python scripts/dryrun_multiprocess.py`), sys.path[0]
# is scripts/, not the repo root — pin the root so totton_tpu imports without
# an installed package or PYTHONPATH.
_ROOT = str(pathlib.Path(__file__).resolve().parent.parent)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

PORT = 19881
N_PROC = 2
DEV_PER_PROC = 4


def worker(pid: int, port: int) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", DEV_PER_PROC)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=N_PROC,
                               process_id=pid)
    assert jax.device_count() == N_PROC * DEV_PER_PROC
    import numpy as np
    from scipy import signal as ssig

    from totton_tpu.filters.sidecar import FilterSidecar, LoadedFilter
    from totton_tpu.parallel import ShardedUpsampler, make_mesh

    ratio, taps_n, fft = 4, 1025, 4096
    n = np.arange(taps_n) - (taps_n - 1) / 2
    taps = (np.sinc(n / ratio) * np.kaiser(taps_n, 12.0)).astype(np.float32)
    taps *= ratio * 0.99 / taps.sum()
    lf = LoadedFilter(taps=taps, sidecar=FilterSidecar(
        coefficients_bin="<dryrun>", taps=taps_n, fft_size=fft,
        block_size=fft - (taps_n - 1), upsample_factor=ratio))

    mesh = make_mesh(n_channel=2, n_time=4)
    ups = ShardedUpsampler(lf, mesh, channels=2)
    assert len(ups._local_time_cols) == 2, ups._local_time_cols

    # Deterministic global signal both processes can regenerate; each feeds
    # only its own time span.
    steps, per_step = 2, ups.block_input_frames
    rng = np.random.default_rng(7)
    x_all = (rng.normal(size=(2, steps * per_step)) * 0.3).astype(np.float32)

    n_time = mesh.shape["time"]
    local_cols = ups._local_time_cols
    span = per_step // n_time * len(local_cols)
    lo = per_step // n_time * local_cols[0]

    outs = []
    for s in range(steps):
        x_step = x_all[:, s * per_step: (s + 1) * per_step]
        x_local = x_step[:, lo: lo + span]
        y_local = ups.process_block(x_local)
        assert y_local.shape == (2, span * ratio), y_local.shape
        outs.append(y_local)

    # Oracle: float64 zero-stuffed convolution of the FULL stream; compare
    # this process's output spans (tests tail continuity + halo exchange).
    for c in range(2):
        up = np.zeros(x_all.shape[1] * ratio)
        up[::ratio] = x_all[c]
        ref = ssig.fftconvolve(up, taps.astype(np.float64))[: len(up)]
        for s in range(steps):
            got = outs[s][c]
            want = ref[(s * per_step + lo) * ratio:
                       (s * per_step + lo + span) * ratio]
            err = got - want
            snr = 10 * np.log10(
                max(np.sum(want ** 2), 1e-300) / max(np.sum(err ** 2), 1e-300))
            assert snr > 100.0, f"proc {pid} step {s} ch {c}: SNR {snr:.1f} dB"
    # --- Channel-only multi-host sharding (n_time=1): each process owns a
    # block of channel ROWS over the full time span — zero-communication
    # scaling, previously a dead end because the
    # single time column spanned both processes.
    mesh_ch = make_mesh(n_channel=8, n_time=1)
    ups_ch = ShardedUpsampler(lf, mesh_ch, channels=8)
    rows = ups_ch._local_channel_rows
    assert len(rows) == 4 and ups_ch.local_channels == 4, (
        rows, ups_ch.local_channels)
    per_step_ch = ups_ch.block_input_frames
    x8 = (rng.normal(size=(8, 2 * per_step_ch)) * 0.3).astype(np.float32)
    outs_ch = []
    for s in range(2):
        x_step = x8[:, s * per_step_ch: (s + 1) * per_step_ch]
        y_local = ups_ch.process_block(x_step[rows[0]: rows[0] + 4])
        assert y_local.shape == (4, per_step_ch * ratio), y_local.shape
        outs_ch.append(y_local)
    for j, c in enumerate(range(rows[0], rows[0] + 4)):
        up = np.zeros(x8.shape[1] * ratio)
        up[::ratio] = x8[c]
        ref = ssig.fftconvolve(up, taps.astype(np.float64))[: len(up)]
        for s in range(2):
            got = outs_ch[s][j]
            want = ref[s * per_step_ch * ratio: (s + 1) * per_step_ch * ratio]
            err = got - want
            snr = 10 * np.log10(
                max(np.sum(want ** 2), 1e-300) / max(np.sum(err ** 2), 1e-300))
            assert snr > 100.0, (
                f"proc {pid} ch-only step {s} ch {c}: SNR {snr:.1f} dB")

    print(f"worker {pid}: ok ({jax.process_count()} processes x "
          f"{jax.local_device_count()} devices, SNR > 100 dB, "
          "time-sharded + channel-only)", flush=True)
    return 0


def orchestrate(port: int) -> int:
    procs = [
        subprocess.Popen([sys.executable, __file__, "--worker", str(i),
                          str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for i in range(N_PROC)
    ]
    deadline = time.monotonic() + 600
    rc = 0
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            rc = 1
        ok = p.returncode == 0 and f"worker {i}: ok" in out
        print(f"--- worker {i} rc={p.returncode} ok={ok}")
        if not ok:
            print(out[-3000:])
            rc = 1
    print("dryrun_multiprocess:", "PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        sys.exit(worker(int(sys.argv[2]), int(sys.argv[3])))
    port = int(sys.argv[1]) if len(sys.argv) > 1 else PORT
    sys.exit(orchestrate(port))
