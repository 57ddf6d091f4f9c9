"""Streaming upsampler CLI — the `alsa_streamer` equivalent.

Flag surface mirrors the reference binary
(src/alsa/alsa_streamer_main.cpp:42-65) with device endpoints generalized to
null/file/WAV/stdio (ALSA hardware is out of scope on GPU hosts):

  totton-stream --in-file in.raw --out-file out.raw --rate 44100 \\
      --filter-dir data/coefficients --ratio 16 --phase min
  totton-stream --in song.wav --out upsampled.wav --ratio 2
  totton-stream --in null --out null --rate 44100 --duration 1

Exit codes: 0 ok, 1 runtime failure, 2 bad arguments.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
from pathlib import Path

import numpy as np

from totton_tpu.engine.selector import FilterSelectionError, resolve_filter_path
from totton_tpu.engine.upsampler import StreamingUpsampler
from totton_tpu.filters.sidecar import load_filter
from totton_tpu.io.devices import open_sink, open_source
from totton_tpu.io.pcm import parse_format
from totton_tpu.io.stream import StreamSession


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="totton-stream",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--in", dest="in_spec",
                   help="input endpoint (null | path.wav | file:path | - | "
                        "tcp://h:p | tcp-listen://[h]:p | unix:/p | "
                        "unix-listen:/p)")
    p.add_argument("--out", dest="out_spec",
                   help="output endpoint (null | path.wav | file:path | - | "
                        "tcp://h:p | tcp-listen://[h]:p | unix:/p | "
                        "unix-listen:/p)")
    p.add_argument("--in-file", dest="in_file", help="raw PCM input file (interleaved)")
    p.add_argument("--out-file", dest="out_file", help="raw PCM output file (interleaved)")
    p.add_argument("--filter", help="filter JSON path (docs/filter_format.md)")
    p.add_argument("--filter-dir", default="data/coefficients",
                   help="filter directory for auto lookup")
    p.add_argument("--phase", default=None, choices=["min", "minimum", "linear"],
                   help="filter phase for auto lookup (default: config.json's "
                        "filter.phaseType when --config is given, else min)")
    p.add_argument("--ratio", type=int, default=1, choices=[1, 2, 4, 8, 16],
                   help="upsample ratio for auto lookup")
    p.add_argument("--latency", default="normal", choices=["normal", "low"],
                   help="filter-bank latency mode for auto lookup: "
                        "'normal' picks the highest tap count (80k bank, "
                        "~72 ms block accumulation at 16x/44.1k); 'low' "
                        "picks the lowest (bundled 8k bank, ~12 ms, "
                        "237+ dB measured stopband)")
    p.add_argument("--rate", type=int, help="input sample rate (Hz)")
    p.add_argument("--channels", type=int, default=2)
    p.add_argument("--format", default="s32",
                   help="PCM format (s16|s24|s32; f32 = lossless float32, "
                        "socket endpoints only)")
    p.add_argument("--period", type=int, default=4096, help="period frames")
    p.add_argument("--buffer", type=int, default=None,
                   help="buffer frames (default period*4)")
    p.add_argument("--eq-profile", help="Equalizer-APO profile to bake in")
    p.add_argument("--config", dest="config_path",
                   default=os.environ.get("TOTTON_CONFIG_PATH"),
                   help="config.json to track: eqEnabled/eqProfilePath are "
                        "read at startup AND re-read on every RELOAD, so "
                        "web-driven EQ activation reaches the live engine "
                        "(--eq-profile overrides; default $TOTTON_CONFIG_PATH)")
    p.add_argument("--dither", action="store_true",
                   help="TPDF-dither the float->PCM output quantization "
                        "(recommended for s16/s24 output)")
    p.add_argument("--device-pcm", choices=["auto", "on", "off"],
                   default="auto",
                   help="quantize float->s16 ON the device (halves the "
                        "device->host transfer bytes, which matters on "
                        "bandwidth-limited host links). auto: enabled for "
                        "s16 output except with --crossfeed (or --dither "
                        "on a sharded mesh); bit-exact with the host "
                        "conversion")
    p.add_argument("--swap-fade", type=int, default=4096, metavar="FRAMES",
                   help="crossfade length (output frames) for live filter/EQ "
                        "hot-swaps — click-free RELOAD (0 = abrupt swap)")
    p.add_argument("--crossfeed",
                   help="crossfeed filter JSON (4-channel LL/LR/RL/RR set) "
                        "applied after upsampling")
    p.add_argument("--batch-blocks", type=int, default=None,
                   help="filter blocks per device dispatch (default auto: "
                        "deep batches for file sources, small for realtime)")
    p.add_argument("--socket-reconnect", type=float, default=0.0,
                   metavar="SECONDS",
                   help="listen-mode socket input only: after the sender "
                        "disconnects (crash, restart, or clean EOF), wait "
                        "this long for a new sender with an identical "
                        "stream header and splice it in (0 = off)")
    p.add_argument("--stats-path", help="write live stats JSON here")
    p.add_argument("--duration", type=float,
                   help="stop after this many seconds of input")
    p.add_argument("--threaded", action="store_true",
                   help="feeder/drainer threads around the device dispatch "
                        "(live-mode pipeline)")
    p.add_argument("--shard-time", type=int, default=0, metavar="N",
                   help="shard time blocks across N devices of the mesh "
                        "(ppermute halo exchange; 0 = single device)")
    p.add_argument("--shard-channel", type=int, default=1, metavar="N",
                   help="shard channels across N devices (with --shard-time)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host: initialize jax.distributed (coordinator "
                        "from --coordinator or JAX_COORDINATOR_ADDRESS env) "
                        "before building the mesh; this process then feeds "
                        "its own channel rows / time span and drains its own "
                        "output (requires --rate; --channels is the GLOBAL "
                        "channel count)")
    p.add_argument("--coordinator", metavar="HOST:PORT",
                   help="jax.distributed coordinator address "
                        "(default $JAX_COORDINATOR_ADDRESS)")
    p.add_argument("--num-processes", type=int,
                   help="total processes (default $JAX_NUM_PROCESSES)")
    p.add_argument("--process-id", type=int,
                   help="this process's id (default $JAX_PROCESS_ID)")
    p.add_argument("--control-endpoint", metavar="ENDPOINT",
                   help="serve the ZMQ control protocol from inside the "
                        "streamer (RELOAD/SOFT_RESET/PHASE_TYPE_* act on "
                        "the live engine; e.g. ipc:///tmp/totton_zmq.sock). "
                        "Multi-host: only process 0 serves it")
    p.add_argument("--control-pub-endpoint", metavar="ENDPOINT",
                   help="control-event PUB endpoint. Multi-host fan-out: "
                        "process 0 binds it and publishes every state-"
                        "changing command; the other processes subscribe and "
                        "replay it on their engine shard (pass the same "
                        "tcp:// value on every host)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    in_spec = args.in_file or args.in_spec
    out_spec = args.out_file or args.out_spec
    if not in_spec or not out_spec:
        print("error: --in/--in-file and --out/--out-file are required",
              file=sys.stderr)
        return 2
    if (args.in_file or args.out_file) and not (args.rate or in_spec.endswith(".wav")):
        print("error: --rate is required in raw file mode", file=sys.stderr)
        return 2

    if args.format.lower() in ("f32", "float32", "float"):
        fmt = None  # raw float32 wire format (socket endpoints only)
    else:
        try:
            fmt = parse_format(args.format)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    # Multi-host init + mesh come BEFORE the endpoints: on a multi-process
    # mesh this process opens a source/sink for only its own channel rows
    # and time span (each host feeds/drains its local block; no host ever
    # holds the global signal — parallel/sharded.py ingest contract).
    mesh = None
    n_procs = 1
    process_index = 0
    local_channels = args.channels
    if args.distributed:
        from totton_tpu.parallel import initialize_distributed

        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)
    if args.shard_time:
        import jax

        from totton_tpu.parallel import make_mesh
        from totton_tpu.parallel.sharded import ShardedUpsampler as _Sharded

        mesh = make_mesh(n_channel=args.shard_channel,
                         n_time=args.shard_time)
        n_procs = jax.process_count()
        process_index = jax.process_index()
        if n_procs > 1:
            try:
                local_channels = _Sharded.local_channel_count(
                    mesh, args.channels)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
    elif args.distributed:
        print("error: --distributed needs a sharded engine "
              "(--shard-time N [--shard-channel M])", file=sys.stderr)
        return 2

    try:
        source = open_source(in_spec, fmt, local_channels, args.rate,
                             socket_reconnect_s=args.socket_reconnect)
    except (OSError, ValueError) as e:
        print(f"error: cannot open input {in_spec}: {e}", file=sys.stderr)
        return 1
    input_rate = source.sample_rate or args.rate
    if not input_rate:
        print("error: input rate unknown; pass --rate", file=sys.stderr)
        return 2

    # Startup phase: explicit --phase > config.json filter.phaseType > min
    # (shared rule: a PHASE_TYPE_SET persisted into config must survive a
    # restart — control/wiring.py).
    from totton_tpu.control.wiring import (
        persist_phase,
        read_config_phase,
        resolve_startup_phase,
    )
    from totton_tpu.control.wiring import resolve_eq_response as _resolve_eq

    phase = resolve_startup_phase(args.phase, args.config_path)

    ratio = args.ratio
    try:
        if args.filter or ratio > 1:
            filter_path = resolve_filter_path(
                filter_path=args.filter,
                filter_dir=args.filter_dir,
                phase=phase,
                ratio=ratio,
                input_rate=input_rate,
                latency=args.latency,
            )
            loaded = load_filter(filter_path)
            print(f"Loaded filter: {filter_path} "
                  f"(taps={loaded.sidecar.taps}, ratio={loaded.ratio})",
                  file=sys.stderr)
        else:
            # Ratio-1 passthrough: identity single-tap filter.
            from totton_tpu.filters.sidecar import FilterSidecar, LoadedFilter

            taps = np.zeros(1025, dtype=np.float32)
            taps[0] = 1.0
            loaded = LoadedFilter(
                taps=taps,
                sidecar=FilterSidecar(
                    coefficients_bin="<identity>", taps=1025, fft_size=4096,
                    block_size=4096 - 1024, upsample_factor=1,
                ),
            )
    except (FilterSelectionError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    def resolve_eq_response(fft_size: int, output_rate: int):
        """EQ baked into the filter spectrum (shared rule,
        control/wiring.py): --eq-profile wins; otherwise config.json's
        eqEnabled/eqProfilePath — re-read on every RELOAD so web-driven
        EQ swaps reach the live engine."""
        return _resolve_eq(args.eq_profile, args.config_path,
                           fft_size, output_rate)

    try:
        eq_response, eq_desc = resolve_eq_response(
            loaded.sidecar.fft_size, input_rate * loaded.ratio)
    except (OSError, ValueError) as e:
        if args.eq_profile:
            # Explicitly requested on the CLI: fail loudly.
            print(f"error: --eq-profile: {e}", file=sys.stderr)
            return 1
        # Stale eqProfilePath in config.json must not block startup.
        print(f"warning: EQ from config skipped ({e})", file=sys.stderr)
        eq_response, eq_desc = None, None
    if eq_desc:
        print(f"EQ profile baked in: {eq_desc}", file=sys.stderr)

    # On-device s16 quantization: the engine emits final int16 samples and
    # the device->host transfer halves (ops/device_pcm.py). Works for the
    # plain AND the sharded engine (where every process's drain halves);
    # the crossfeed chain keeps the float path (its post stages live
    # outside the upsampler), and sharded meshes are undithered by design
    # (parallel/sharded.py note) so --dither keeps them on the float path.
    from totton_tpu.io.pcm import PcmFormat

    pcm_eligible = (fmt is PcmFormat.S16_LE and not args.crossfeed
                    and (mesh is None or not args.dither))
    if args.device_pcm == "on" and not pcm_eligible:
        print("error: --device-pcm on requires --format s16, no "
              "--crossfeed, and no --dither on a sharded mesh",
              file=sys.stderr)
        return 2
    device_pcm_on = (args.device_pcm != "off") and pcm_eligible

    if mesh is not None:
        from totton_tpu.parallel import ShardedUpsampler

        # Multi-process: --channels is the GLOBAL count and the source
        # carries this host's rows; single-process: trust the source
        # (a WAV header may have refined it).
        global_channels = args.channels if n_procs > 1 else source.channels
        try:
            engine = ShardedUpsampler(
                loaded, mesh, channels=global_channels,
                eq_response=eq_response,
                swap_fade_frames=args.swap_fade,
                device_pcm=PcmFormat.S16_LE if device_pcm_on else None)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if device_pcm_on:
            print("Device PCM: s16 quantization on-device (sharded drain)",
                  file=sys.stderr)
        print(f"Sharded engine: mesh {dict(mesh.shape)}, "
              f"process {process_index}/{n_procs}, dispatch granule "
              f"{engine.local_block_input_frames} local input frames "
              f"({engine.local_channels} local channels)", file=sys.stderr)
    else:
        engine = StreamingUpsampler(
            loaded, channels=source.channels,
            eq_response=eq_response,
            swap_fade_frames=args.swap_fade,
            device_pcm=PcmFormat.S16_LE if device_pcm_on else None,
            pcm_dither=args.dither and device_pcm_on)
        if device_pcm_on:
            print("Device PCM: s16 quantization on-device"
                  + (" (TPDF dither)" if args.dither else ""),
                  file=sys.stderr)
    if args.crossfeed:
        from totton_tpu.engine.chain import CrossfeedChain
        from totton_tpu.engine.crossfeed import CrossfeedFilter, CrossfeedProcessor

        if source.channels != 2:
            print("error: --crossfeed requires stereo input", file=sys.stderr)
            return 2
        cf = CrossfeedProcessor(CrossfeedFilter.load(args.crossfeed))
        engine = CrossfeedChain(engine, cf)
        print(f"Crossfeed enabled: {args.crossfeed} "
              f"({cf.filter.taps} taps/channel)", file=sys.stderr)
    try:
        # Device-PCM mode: the engine's samples are final — the sink must
        # not re-dither them.
        sink = open_sink(out_spec, input_rate * engine.ratio, fmt,
                         dither=args.dither and not device_pcm_on)
    except (OSError, ValueError) as e:
        print(f"error: cannot open output {out_spec}: {e}", file=sys.stderr)
        return 1

    session_cls = StreamSession
    if args.threaded:
        from totton_tpu.io.stream import ThreadedStreamSession

        session_cls = ThreadedStreamSession
    session = session_cls(
        source, sink, engine,
        period_frames=args.period,
        max_batch_blocks=args.batch_blocks,
        stats_path=args.stats_path,
    )

    # First signal: graceful stop (drain in-flight dispatch, close files).
    # Second signal: hard exit — the graceful path can block indefinitely
    # behind a hung device dispatch, and a repeated Ctrl-C / TERM must
    # still kill the process.
    signal_count = {"n": 0}

    def handle_signal(signum, frame):
        signal_count["n"] += 1
        if signal_count["n"] >= 2:
            import os

            print("forced exit (second signal)", file=sys.stderr)
            os._exit(1)
        session.stop()

    signal.signal(signal.SIGINT, handle_signal)
    signal.signal(signal.SIGTERM, handle_signal)

    # In-process control plane: unlike the reference (whose shipped daemon
    # is a counter-only stub and RELOAD needs a container restart,
    # SURVEY.md L1 note), these commands act on the live engine.
    daemon = None
    follower = None
    is_leader = process_index == 0
    if (args.control_endpoint and is_leader) or (
            args.control_pub_endpoint and not is_leader):
        from totton_tpu.control.daemon import ControlDaemon

        # Filter/EQ swaps act on the inner upsampler (the chain's post
        # stages are filter-agnostic), but SOFT_RESET must clear the
        # OUTERMOST engine: with --crossfeed the chain carries its own
        # pending/FIFO audio that engine.reset() flushes and a bare
        # upsampler.reset() would leave stale.
        upsampler = getattr(engine, "upsampler", engine)
        current_phase = {"value": phase}  # already normalized

        startup_phase = current_phase["value"]

        def reload_filter(phase: str,
                          apply_at_step: int | None = None) -> dict:
            # An explicitly pinned --filter stays pinned across RELOADs
            # (the reload's purpose is then EQ/config re-read); directory
            # resolution happens only for auto lookup or a phase CHANGE,
            # which a pinned single file can't serve.
            if args.filter and phase == startup_phase:
                path = args.filter
            else:
                path = resolve_filter_path(
                    filter_path=None, filter_dir=args.filter_dir, phase=phase,
                    ratio=upsampler.ratio, input_rate=input_rate,
                    latency=args.latency,
                )
            try:
                eq, desc = resolve_eq_response(
                    upsampler.config.fft_size, input_rate * upsampler.ratio)
            except (OSError, ValueError) as e:
                # A bad/missing EQ file must not take down a live stream;
                # reload the filter clean and report.
                print(f"Live reload: EQ skipped ({e})", file=sys.stderr)
                eq, desc = None, None
            # Multi-process meshes swap STEP-SYNCHRONIZED: the leader's
            # engine stamps apply_at_step (published with the control
            # event); followers schedule the same boundary, so the swap
            # lands at the same output sample on every process and the
            # crossfade stays click-free mesh-wide
            # (parallel/sharded.py schedule_swap). Single process applies
            # immediately (its fade path needs no coordination).
            if n_procs > 1 and hasattr(upsampler, "schedule_swap"):
                at = upsampler.schedule_swap(
                    load_filter(path), eq_response=eq,
                    apply_at_step=apply_at_step)
                print(f"Live reload scheduled at step {at}: {path}"
                      + (f" + EQ {desc}" if desc else ""), file=sys.stderr)
                return {"apply_at_step": at}
            upsampler.load_filter(load_filter(path), eq_response=eq)
            print(f"Live reload: {path}"
                  + (f" + EQ {desc}" if desc else ""), file=sys.stderr)
            return {}

        def on_reload(apply_at_step: int | None = None) -> dict:
            # config.json is the durable truth: RELOAD adopts its
            # filter.phaseType (the settings page PATCHes config then
            # RELOADs), keeping the daemon's reported phase in sync.
            if args.config_path:
                ph = read_config_phase(args.config_path)
                if ph is not None and ph != current_phase["value"]:
                    current_phase["value"] = ph
                    if daemon is not None:
                        daemon.phase_type = ph
                # alsa.dither is live too: the web settings toggle writes
                # config then RELOADs, so swap the sink's ditherer here
                # (round-2 advisor finding: the toggle looked live but
                # only took effect at container restart).
                # In device-PCM mode the ENGINE owns quantization, so the
                # toggle targets it; otherwise the sink.
                from totton_tpu.web.services.config import load_config

                settings = load_config(Path(args.config_path))
                if settings.alsa and settings.alsa.dither is not None:
                    quantizer = (upsampler if device_pcm_on else sink)
                    if quantizer.set_dither(bool(settings.alsa.dither)):
                        print("Live dither: "
                              + ("on" if settings.alsa.dither else "off"),
                              file=sys.stderr)
            return reload_filter(current_phase["value"], apply_at_step)

        def on_phase_change(phase: str,
                            apply_at_step: int | None = None) -> dict:
            # Reload FIRST: if the swap fails (no such filter on disk),
            # the raised error propagates to the daemon (INTERNAL reply)
            # and neither the tracked phase nor config.json moves.
            extra = reload_filter(phase, apply_at_step)
            current_phase["value"] = phase
            # Persist so the next RELOAD / restart keeps this phase
            # (shared leader-only rule, control/wiring.py).
            persist_phase(phase, args.config_path, is_leader)
            return extra

        if is_leader:
            daemon = ControlDaemon(
                endpoint=args.control_endpoint,
                pub_endpoint=args.control_pub_endpoint,
                on_reload=on_reload,
                on_soft_reset=engine.reset,
                on_phase_change=on_phase_change,
                stats_path=args.stats_path,
                phase_type=current_phase["value"],
            )
            daemon.start()
            print(f"Control endpoint: {args.control_endpoint}"
                  + (f" (publishing on {args.control_pub_endpoint})"
                     if args.control_pub_endpoint else ""), file=sys.stderr)

            import threading

            threading.Thread(
                target=lambda: (daemon.wait_for_shutdown(), session.stop()),
                daemon=True, name="totton-shutdown-watch",
            ).start()
        else:
            # Non-leader processes replay the leader's published commands
            # on their local engine shard (multi-host control fan-out) —
            # a swap applied on one host only would diverge the replicated
            # spectrum across the mesh.
            from totton_tpu.control.follower import ControlFollower

            follower = ControlFollower(
                args.control_pub_endpoint,
                on_reload=on_reload,
                on_soft_reset=engine.reset,
                on_phase_change=on_phase_change,
                on_shutdown=session.stop,
            )
            follower.start()
            print(f"Control follower of {args.control_pub_endpoint}",
                  file=sys.stderr)

    max_frames = None
    if args.duration:
        max_frames = int(args.duration * input_rate)

    print("Streaming started "
          f"({input_rate} Hz -> {input_rate * engine.ratio} Hz, "
          f"{source.channels}ch, ratio {engine.ratio})", file=sys.stderr)
    try:
        stats = session.run(max_frames=max_frames)
    finally:
        if daemon is not None:
            daemon.stop()
        if follower is not None:
            follower.stop()
        source.close()
        sink.close()
    print("Streaming stopped", file=sys.stderr)
    print(f"frames_in={stats.frames_in} frames_out={stats.frames_out} "
          f"blocks={stats.blocks_processed} "
          f"realtime_factor={stats.realtime_factor:.1f}x", file=sys.stderr)
    if stats.transport_errors:
        # A mid-stream RST / NIC fault is NOT a clean stop (reference
        # recovery semantics, src/alsa/alsa_common.cpp:269-336): report it
        # and exit nonzero so supervisors can restart the pipeline. A
        # recovered stream (every fault answered by a reconnect splice)
        # still counts as success.
        print(f"transport errors: {stats.transport_errors} "
              f"(reconnects: {stats.reconnects}; "
              f"last: {stats.last_transport_error})", file=sys.stderr)
        if stats.reconnects < stats.transport_errors:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
