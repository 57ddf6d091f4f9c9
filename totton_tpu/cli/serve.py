"""totton-serve: multi-stream upsampling server (one chip, many streams).

Serves N independent client audio streams from one batched engine step
(totton_tpu/serve.py design note). Each client opens one duplex TCP/unix
connection, sends the 12-byte totton header + PCM at --rate, and reads
back the upsampled stream at rate*ratio on the same connection:

  totton-serve --listen tcp-listen://:9100 --rate 44100 --ratio 16 \\
      --filter-dir data/coefficients --max-streams 64

With --control-endpoint the server exposes the reference ZMQ command set
(src/zmq/zmq_server_main.cpp:150-221) acting on the LIVE serving plane:
RELOAD re-reads --config (EQ/phase) and swaps the shared spectrum under
every active stream with a per-slot crossfade; PHASE_TYPE_SET flips
min/linear the same way; SOFT_RESET zeroes stream histories; STATS
merges the serve stats file. The reference needs a container restart for
any of these.

Exit codes: 0 ok, 1 runtime failure, 2 bad arguments, 3 recycled
(--recycle-rss-mb cap reached; the supervisor should restart).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

from totton_tpu.engine.selector import FilterSelectionError, resolve_filter_path
from totton_tpu.filters.sidecar import load_filter


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="totton-serve", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--listen", required=True,
                   help="listen endpoint (tcp-listen://[host]:port | "
                        "unix-listen:/path)")
    p.add_argument("--rate", type=int, required=True,
                   help="input sample rate every client must use (Hz)")
    p.add_argument("--ratio", type=int, default=16,
                   choices=[2, 4, 8, 16], help="upsample ratio")
    p.add_argument("--filter", help="filter JSON path")
    p.add_argument("--filter-dir", default="data/coefficients")
    p.add_argument("--phase", default=None,
                   choices=["min", "minimum", "linear"],
                   help="filter phase (default: config.json's "
                        "filter.phaseType when --config is given, else min)")
    p.add_argument("--latency", default="normal", choices=["normal", "low"],
                   help="filter-bank latency mode: 'normal' picks the "
                        "highest tap count, 'low' the lowest (bundled 8k "
                        "bank: ~12 ms block accumulation instead of ~72 ms "
                        "at 16x/44.1k, 237+ dB measured stopband)")
    p.add_argument("--channels", type=int, default=2,
                   help="channels per stream")
    p.add_argument("--max-streams", type=int, default=64,
                   help="concurrent stream slots (static batch rows)")
    p.add_argument("--max-blocks-per-step", type=int, default=16,
                   help="adaptive per-step block depth cap (power of two; "
                        "bursty clients batch up to this many filter "
                        "blocks per dispatch)")
    p.add_argument("--max-input-backlog", type=int, default=32,
                   metavar="BLOCKS",
                   help="per-stream input backlog cap in filter blocks; "
                        "at the cap the reader stops recv'ing and TCP "
                        "flow control throttles the sender (bounded "
                        "memory against flooding clients)")
    p.add_argument("--swap-fade", type=int, default=4096, metavar="FRAMES",
                   help="crossfade length (output frames) each stream "
                        "fades over on a live filter/EQ hot-swap "
                        "(0 = abrupt swap)")
    p.add_argument("--eq-profile",
                   help="Equalizer-APO profile baked into the served "
                        "spectrum (shared by all streams)")
    p.add_argument("--config", dest="config_path",
                   default=os.environ.get("TOTTON_CONFIG_PATH"),
                   help="config.json to track: eqEnabled/eqProfilePath and "
                        "filter.phaseType are read at startup AND re-read "
                        "on every RELOAD, so web-driven EQ/phase changes "
                        "reach the live serving plane (--eq-profile/"
                        "--phase override; default $TOTTON_CONFIG_PATH)")
    p.add_argument("--control-endpoint", metavar="ENDPOINT",
                   help="serve the ZMQ control protocol from inside the "
                        "server (RELOAD/SOFT_RESET/PHASE_TYPE_* act on "
                        "the live serving plane; e.g. "
                        "ipc:///tmp/totton_zmq.sock)")
    p.add_argument("--control-pub-endpoint", metavar="ENDPOINT",
                   help="control-event PUB endpoint (reload/phase events "
                        "with seq numbers + heartbeat)")
    p.add_argument("--control-follow", metavar="ENDPOINT",
                   help="follow a leader serve's PUB endpoint and replay "
                        "its RELOAD/PHASE_TYPE/SHUTDOWN events on this "
                        "serving plane (fleet deployment: one leader + N "
                        "followers behind a load balancer, one control "
                        "surface)")
    p.add_argument("--device-pcm", action="store_true",
                   help="quantize the serve step's output to s16 ON the "
                        "device, halving every stream's share of the "
                        "device->host drain (s16-only serving: clients "
                        "with other wire formats are rejected; bit-exact "
                        "with the host conversion)")
    p.add_argument("--shard-serve", type=int, default=0, metavar="N",
                   help="shard the serve batch's slot rows across N "
                        "devices of the mesh (row-parallel, no "
                        "collectives; N chips serve ~N x the streams of "
                        "one). 0 = single device")
    p.add_argument("--recycle-rss-mb", type=int, default=0, metavar="MB",
                   help="graceful process recycling: when resident memory "
                        "exceeds MB, stop accepting, drain active streams "
                        "(bounded), and exit 3 so the supervisor (systemd "
                        "Restart=, compose restart:) starts a fresh "
                        "process. Containment for host-side leaks below "
                        "this framework (a device runtime that grows per "
                        "dispatch); 0 = off")
    p.add_argument("--recycle-check-s", type=float, default=5.0,
                   metavar="SEC",
                   help="RSS poll interval for --recycle-rss-mb")
    p.add_argument("--recycle-drain-s", type=float, default=300.0,
                   metavar="SEC",
                   help="how long a recycle waits for active streams to "
                        "finish before cutting them (size it to your "
                        "longest stream; live listeners never finish, so "
                        "this is also their cut deadline)")
    p.add_argument("--stats-path",
                   help="write aggregate + per-stream stats JSON here")
    p.add_argument("--duration", type=float,
                   help="serve for this many seconds then exit (tests)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from totton_tpu.control.wiring import (
        persist_phase,
        read_config_phase,
        resolve_eq_response,
        resolve_startup_phase,
    )

    startup_phase = resolve_startup_phase(args.phase, args.config_path)

    def resolve_filter(phase: str):
        """Explicitly pinned --filter stays pinned while the phase is
        unchanged from startup (cli/stream.py reload_filter rule)."""
        if args.filter and phase == startup_phase:
            path = args.filter
        else:
            path = resolve_filter_path(
                filter_path=None, filter_dir=args.filter_dir, phase=phase,
                ratio=args.ratio, input_rate=args.rate,
                latency=args.latency)
        return path, load_filter(path)

    try:
        if args.filter:
            path, loaded = args.filter, load_filter(args.filter)
        else:
            path, loaded = resolve_filter(startup_phase)
    except (FilterSelectionError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    try:
        eq, eq_desc = resolve_eq_response(
            args.eq_profile, args.config_path,
            loaded.sidecar.fft_size, args.rate * loaded.ratio)
    except (OSError, ValueError) as e:
        if args.eq_profile:
            print(f"error: --eq-profile: {e}", file=sys.stderr)
            return 1
        print(f"warning: EQ from config skipped ({e})", file=sys.stderr)
        eq, eq_desc = None, None
    if eq_desc:
        print(f"EQ profile baked in: {eq_desc}", file=sys.stderr)

    mesh = None
    if args.shard_serve:
        from totton_tpu.parallel import make_mesh

        try:
            mesh = make_mesh(n_channel=args.shard_serve, n_time=1)
        except ValueError as e:
            print(f"error: --shard-serve: {e}", file=sys.stderr)
            return 2
        print(f"Sharded serving: slot rows over {args.shard_serve} "
              "devices", file=sys.stderr)

    from totton_tpu.serve import StreamServer

    try:
        server = StreamServer(
            loaded, args.listen, args.rate, max_streams=args.max_streams,
            channels=args.channels, eq_response=eq,
            stats_path=args.stats_path,
            max_blocks_per_step=args.max_blocks_per_step,
            max_input_backlog_blocks=args.max_input_backlog,
            swap_fade_frames=args.swap_fade, mesh=mesh,
            device_pcm=args.device_pcm)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    # In-process control plane acting on the LIVE serving plane (the
    # reference's command set; its shipped daemon is a counter stub and
    # RELOAD restarts the container — SURVEY.md L1 note).
    daemon = None
    follower = None
    is_leader = bool(args.control_endpoint)
    if args.control_endpoint or args.control_follow:
        current_phase = {"value": startup_phase}

        def reload_serving(phase: str) -> dict:
            pth, lf = resolve_filter(phase)
            try:
                eq_resp, desc = resolve_eq_response(
                    args.eq_profile, args.config_path,
                    lf.sidecar.fft_size, args.rate * lf.ratio)
            except (OSError, ValueError) as e:
                print(f"Live reload: EQ skipped ({e})", file=sys.stderr)
                eq_resp, desc = None, None
            server.load_filter(lf, eq_response=eq_resp)
            print(f"Live serve reload: {pth}"
                  + (f" + EQ {desc}" if desc else ""), file=sys.stderr)
            return {}

        def on_reload() -> dict:
            # config.json is the durable truth: RELOAD adopts its
            # filter.phaseType (the settings page PATCHes config then
            # RELOADs).
            ph = read_config_phase(args.config_path)
            if ph is not None and ph != current_phase["value"]:
                current_phase["value"] = ph
                if daemon is not None:
                    daemon.phase_type = ph
            return reload_serving(current_phase["value"])

        def on_phase_change(ph: str) -> dict:
            # Reload FIRST: a failed swap (no such filter on disk /
            # geometry change) propagates to the daemon reply and the
            # reported phase stays what the plane is actually serving.
            extra = reload_serving(ph)
            current_phase["value"] = ph
            persist_phase(ph, args.config_path, is_leader)
            return extra

        if is_leader:
            from totton_tpu.control.daemon import ControlDaemon

            daemon = ControlDaemon(
                endpoint=args.control_endpoint,
                pub_endpoint=args.control_pub_endpoint,
                on_reload=on_reload,
                on_soft_reset=server.soft_reset,
                on_phase_change=on_phase_change,
                stats_path=args.stats_path,
                phase_type=current_phase["value"],
            )
            daemon.start()
            print(f"Control endpoint: {args.control_endpoint}",
                  file=sys.stderr)

            import threading

            threading.Thread(
                target=lambda: (daemon.wait_for_shutdown(),
                                server.request_stop()),
                daemon=True, name="totton-serve-shutdown-watch").start()
        if args.control_follow:
            # Fleet follower: replay the leader's published control
            # events on this serving plane (reload/phase swaps land with
            # this process's own per-stream crossfades).
            from totton_tpu.control.follower import ControlFollower

            follower = ControlFollower(
                args.control_follow,
                on_reload=on_reload,
                on_soft_reset=server.soft_reset,
                on_phase_change=on_phase_change,
                on_shutdown=server.request_stop,
            )
            follower.start()
            print(f"Control follower of {args.control_follow}",
                  file=sys.stderr)

    stop_count = {"n": 0}

    def handle_signal(signum, frame):
        stop_count["n"] += 1
        if stop_count["n"] >= 2:
            os._exit(1)
        # Graceful: stop accepting, let active streams finish (bounded),
        # then stop. Second signal hard-exits.
        import threading

        def _drain():
            server.drain(timeout_s=30.0)
            server.request_stop()

        threading.Thread(target=_drain, daemon=True,
                         name="totton-serve-drain").start()

    signal.signal(signal.SIGINT, handle_signal)
    signal.signal(signal.SIGTERM, handle_signal)

    server.start()
    print(f"Serving on {args.listen}: {args.max_streams} stream slots, "
          f"{args.rate} Hz -> {args.rate * loaded.ratio} Hz "
          f"({loaded.sidecar.taps} taps, {path})", file=sys.stderr)

    recycled = {"hit": False}
    if args.recycle_rss_mb > 0:
        # Bounded-memory serving on runtimes that leak host memory per
        # dispatch below this framework (the serving plane itself is
        # RSS-flat on the CPU backend). Poll RSS; at the cap, drain gracefully and exit 3 so a
        # supervisor restarts a fresh process — the fleet analog of the
        # reference's container-restart lifecycle, but on OUR terms:
        # no accepted stream is cut.
        import threading
        import time as _time

        from totton_tpu.serve import process_rss_mb

        def _recycle_monitor():
            while not server.stopped:
                _time.sleep(args.recycle_check_s)
                rss = process_rss_mb()
                if rss is None:
                    return  # no /proc: feature inert
                if rss >= args.recycle_rss_mb:
                    recycled["hit"] = True
                    print(f"RSS {rss:.0f} MB >= --recycle-rss-mb "
                          f"{args.recycle_rss_mb}: recycling "
                          "(drain, then exit 3)", file=sys.stderr)
                    if not server.drain(timeout_s=args.recycle_drain_s):
                        print(f"recycle drain timed out after "
                              f"{args.recycle_drain_s:.0f}s; cutting "
                              "remaining streams", file=sys.stderr)
                    server.request_stop()
                    return

        threading.Thread(target=_recycle_monitor, daemon=True,
                         name="totton-serve-recycle").start()

    server.wait(args.duration)
    server.stop()
    if daemon is not None:
        daemon.stop()
    if follower is not None:
        follower.stop()
    j = server.stats.to_json(0, [])
    print(f"Served {j['streams']['accepted']} streams "
          f"({j['steps']} steps, {j['frames_out']} frames out, "
          f"{j['spectrum_swaps']} live swaps)", file=sys.stderr)
    if server.failed:
        # Persistent dispatcher failure killed the serving plane; a
        # clean exit here would hide it from supervisors (systemd
        # Restart=on-failure, the entrypoint's `wait -n`).
        print("error: serving stopped on persistent dispatcher failure",
              file=sys.stderr)
        return 1
    if recycled["hit"]:
        print("Serving recycled (RSS cap)", file=sys.stderr)
        return 3
    print("Serving stopped", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
